"""DEWI^tau training-data sampling + submodular coverage selection.

The reference config promises a training-sampling subsystem
(``TrainingSamplingConfig``: ``tau`` temperature and ``submodular_pick``,
reference config.py:69-74) and its README describes ``p(doc) ∝ DEWI^tau``
sampling, but no implementation exists anywhere in the reference.  This
module makes the capability real, device-native:

* ``dewi_tau_probabilities`` / ``sample_by_dewi`` — temperature-sharpened
  sampling weights and a Gumbel-top-k sampler (one fused XLA call; sampling
  without replacement via the Gumbel-max trick instead of a sequential draw
  loop).
* ``submodular_pick`` — facility-location greedy selection over embeddings
  (coverage-maximizing subset), vectorized: each greedy step is one
  ``[N]``-wide max-update on device, so selecting k of N costs k matvec-size
  ops rather than k·N² Python work.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np


def dewi_tau_probabilities(dewi: np.ndarray, tau: float = 1.0) -> np.ndarray:
    """``p(doc) ∝ dewi^tau`` normalized (tau=0 -> uniform)."""
    d = np.clip(np.asarray(dewi, dtype=np.float64), 1e-12, None)
    w = d ** float(tau)
    return (w / w.sum()).astype(np.float64)


@partial(jax.jit, static_argnames=("k",))
def _gumbel_topk(log_w: jax.Array, key: jax.Array, k: int) -> Any:
    g = -jnp.log(-jnp.log(
        jax.random.uniform(key, log_w.shape, minval=1e-12, maxval=1.0)
    ))
    return jax.lax.top_k(log_w + g, k)


def sample_by_dewi(
    dewi: np.ndarray,
    k: int,
    tau: float = 1.0,
    seed: int = 0,
    replace: bool = False,
) -> np.ndarray:
    """Sample ``k`` doc indices with probability ``∝ dewi^tau``.

    Without replacement uses the Gumbel-top-k trick (equivalent to
    sequential sampling without replacement from the softmax) — one fused
    top-k on device.  With replacement falls back to categorical draws.
    """
    dewi = np.asarray(dewi)
    n = dewi.shape[0]
    if k > n and not replace:
        raise ValueError(f"Cannot draw {k} distinct docs from {n}")
    log_w = jnp.log(jnp.clip(jnp.asarray(dewi, jnp.float32), 1e-12, None)) * tau
    key = jax.random.PRNGKey(seed)
    if replace:
        idx = jax.random.categorical(key, log_w, shape=(k,))
        return np.asarray(idx)
    _, idx = _gumbel_topk(log_w, key, k)
    return np.asarray(idx)


@partial(jax.jit, static_argnames=("k",))
def _facility_location(emb_n: jax.Array, k: int) -> Any:
    """Greedy facility-location: iteratively add the doc that most increases
    ``sum_i max_{s in S} sim(i, s)``.  The N×N similarity matrix is built
    once; each greedy step is one masked argmax + max-update."""
    n = emb_n.shape[0]
    sims = jnp.dot(emb_n, emb_n.T, preferred_element_type=jnp.float32)

    def step(carry: Any, _: Any) -> Any:
        covered, selected_mask = carry
        # Gain of candidate j = sum_i max(0, sim[i, j] - covered[i]).
        gains = jnp.sum(jnp.maximum(sims - covered[None, :], 0.0), axis=1)
        gains = jnp.where(selected_mask, -jnp.inf, gains)
        j = jnp.argmax(gains)
        new_cov = jnp.maximum(covered, sims[j])
        return (new_cov, selected_mask.at[j].set(True)), j

    init = (jnp.zeros((n,)), jnp.zeros((n,), bool))
    (_, _), picks = jax.lax.scan(step, init, None, length=k)
    return picks


def submodular_pick(
    embeddings: np.ndarray,
    k: int,
    dewi: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Coverage-maximizing subset of ``k`` docs (facility location).

    When ``dewi`` is given, similarities are scaled by the candidates' DEWI
    scores so the pick balances coverage with usefulness.
    """
    emb = jnp.asarray(embeddings, jnp.float32)
    emb = emb / jnp.maximum(jnp.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    if dewi is not None:
        emb = emb * jnp.sqrt(
            jnp.clip(jnp.asarray(dewi, jnp.float32), 1e-6, None)
        )[:, None]
    n = emb.shape[0]
    if k >= n:
        return np.arange(n)
    picks = _facility_location(emb, k)
    return np.asarray(picks)


def training_sample(
    dewi: np.ndarray,
    embeddings: Optional[np.ndarray],
    k: int,
    tau: float = 1.0,
    use_submodular: bool = False,
    seed: int = 0,
) -> np.ndarray:
    """Config-driven entry point (``TrainingSamplingConfig`` semantics)."""
    if use_submodular:
        if embeddings is None:
            raise ValueError("submodular_pick requires embeddings")
        return submodular_pick(embeddings, k, dewi=dewi)
    return sample_by_dewi(dewi, k, tau=tau, seed=seed)


__all__ = [
    "dewi_tau_probabilities",
    "sample_by_dewi",
    "submodular_pick",
    "training_sample",
]
