"""``python -m dewi`` entry point (parity: reference __main__.py)."""

from .cli import cli

if __name__ == "__main__":
    cli()
