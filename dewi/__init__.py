from typing import Any, List
"""DEWI: an entropy-weighted index for text+image corpora, accelerator-native.

A from-scratch JAX/XLA/Pallas rebuild of the DEWI system
(lexsightllc/DEWI-Design-for-an-Entropy-Weighted-Index-for-Text-Image-Corpora):
every document is scored by "useful surprise" — text LM surprisal, image
reconstruction entropy, cross-modal dependency, redundancy and noise folded
through robust statistics into a DEWI score in [0, 1] — and search results
are re-ranked by ``(1-eta)*sim + eta*dewi + entropy_pref*mean_entropy``.

Public root exports match the reference package root (reference
__init__.py:5-15) plus the ``Signals`` record its README promises.  Exports
resolve lazily (PEP 562), mirroring the reference's lazy-loading discipline
(reference README.md:16, cli.py:21-39): importing ``dewi`` does not pull
in JAX until a symbol is actually used.
"""

__version__ = "0.1.0"

_EXPORTS = {
    "DewiScorer": ("dewi.scorer", "DewiScorer"),
    "RobustStats": ("dewi.scorer", "RobustStats"),
    "local_weights_from_surprisal": (
        "dewi.scorer", "local_weights_from_surprisal"
    ),
    "Weights": ("dewi.types", "Weights"),
    "Payload": ("dewi.types", "Payload"),
    "Signals": ("dewi.types", "Signals"),
    "DewiIndex": ("dewi.index", "DewiIndex"),
    "ExactIndex": ("dewi.index", "ExactIndex"),
    "IVFIndex": ("dewi.index", "IVFIndex"),
    "QuantizedIndex": ("dewi.index", "QuantizedIndex"),
    "IndexBackend": ("dewi.index", "IndexBackend"),
    "DewiConfig": ("dewi.config", "DewiConfig"),
    "get_default_config": ("dewi.config", "get_default_config"),
    "DewiPipeline": ("dewi.pipelines", "DewiPipeline"),
    "Corpus": ("dewi.corpus", "Corpus"),
    "Document": ("dewi.pipelines", "Document"),
    "create_document": ("dewi.pipelines", "create_document"),
    "MicroBatcher": ("dewi.serve", "MicroBatcher"),
    "SearchServer": ("dewi.serve", "SearchServer"),
}

__all__ = sorted(_EXPORTS) + ["__version__"]


def __getattr__(name: str) -> Any:
    try:
        module_name, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        ) from None
    import importlib

    value = getattr(importlib.import_module(module_name), attr)
    globals()[name] = value  # cache for subsequent lookups
    return value


def __dir__() -> List[str]:
    return __all__
