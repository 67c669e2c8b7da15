"""Test harness: virtual 8-device CPU mesh + synthetic fixtures.

Mirrors the reference's test strategy (SURVEY.md §4): seeded synthetic
embeddings/payloads (reference tests/conftest.py:27-51) and env-flag fake
mode for CLI tests.  Multi-chip sharding is validated on a CPU mesh via
``xla_force_host_platform_device_count`` — set before JAX initializes.
"""

import os
import sys

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# Force CPU through the config API (whatever JAX_PLATFORMS says) so tests
# run on the virtual 8-device mesh.
jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(autouse=True)
def _test_mode_env(monkeypatch):
    # Parity with reference conftest.py:12-15 — CLI runs in fake mode.
    monkeypatch.setenv("DEWI_TEST_MODE", "1")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def dummy_embeddings(rng):
    emb = rng.normal(size=(64, 32)).astype(np.float32)
    return emb


@pytest.fixture
def dummy_payloads(rng):
    """Gamma/beta-distributed payloads like the reference's synthetic corpus
    (reference scripts/profile_index.py:34-72, tests/conftest.py:27-51)."""
    from dewi.types import Payload

    n = 64
    return [
        Payload(
            dewi=float(rng.beta(2, 2)),
            ht_mean=float(rng.gamma(2.0, 1.5)),
            ht_q90=float(rng.gamma(2.5, 1.5)),
            hi_mean=float(rng.gamma(2.0, 1.0)),
            hi_q90=float(rng.gamma(2.5, 1.0)),
            I_hat=float(rng.beta(2, 5)),
            redundancy=float(rng.beta(1, 4)),
            noise=float(rng.beta(1, 9)),
        )
        for _ in range(n)
    ]


@pytest.fixture
def signal_rows(rng):
    keys = ("ht_mean", "ht_q90", "hi_mean", "hi_q90", "I_hat", "redundancy", "noise")
    return [
        {k: float(v) for k, v in zip(keys, rng.gamma(2.0, 1.0, size=7))}
        for _ in range(50)
    ]
