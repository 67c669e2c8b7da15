"""DEWI scorer: robust standardization + weighted utility + sigmoid.

Reimplementation of the reference scorer (reference
scorer.py:11-89).  The math is identical:

* fit: per-signal median and MAD (MAD floored at 1e-8 when zero —
  reference scorer.py:23-25),
* z: ``(v - med) / (1.4826 * mad)`` (reference scorer.py:28-31),
* components: ``Ht = 0.5*(z(ht_mean)+z(ht_q90))``, ``Hi`` likewise, and
  ``I/R/N`` straight z-scores (reference scorer.py:49-58),
* standard mode: ``U = at*Ht + ai*Hi - am*I - ar*R - an*N`` clipped to
  ``±delta`` then sigmoid (reference scorer.py:64-75),
* conditional mode: ``Ht-I`` / ``Hi-I`` and no ``alpha_m`` term
  (reference scorer.py:77-89).

The architecture is not a port: fitting and scoring are single jitted XLA
computations over ``[N, K]`` signal matrices (``fit_stats_matrix`` /
``score_batch``), so scoring a million documents is one fused
median/MAD/z/matvec/sigmoid kernel instead of a per-document Python loop.
Scalar dict-based ``score``/``score_conditional`` are kept for API parity
and produce bitwise-close results (they share fitted stats).

This module also unifies the reference's two divergent ``RobustStats``
(reference scorer.py:11-31 vs robust.py:13-32 — see SURVEY.md §2.4 item 7)
into one class supporting both ``fit(rows)`` and ``from_payloads(payloads)``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np
from functools import partial

from .ops.robust import MAD_CONSISTENCY, median_mad
from .types import (
    SIGNAL_FIELDS,
    Payload,
    RowLike,
    Signals,
    Weights,
    rows_to_matrix,
)

# Keys used by the reference's Payload-based stats variant (robust.py:21).
PAYLOAD_STAT_FIELDS = ("ht_mean", "hi_mean", "redundancy", "noise")


@dataclass
class RobustStats:
    """Median/MAD per signal, fitted on-device in one XLA call.

    ``mads`` are stored already floored (zero -> 1e-8), matching the
    reference's fit-time ``or 1e-8`` (reference scorer.py:23-25).
    """

    medians: Dict[str, float]
    mads: Dict[str, float]
    keys: tuple = field(default=SIGNAL_FIELDS)

    @classmethod
    def fit(cls, rows: Sequence[RowLike]) -> "RobustStats":
        """Fit from dict/Signals rows; key set comes from the first row."""
        if not rows:
            raise ValueError("Cannot fit statistics on an empty dataset")
        first = rows[0] if isinstance(rows[0], Mapping) else rows[0].to_dict()
        keys = tuple(first.keys())
        mat = rows_to_matrix(rows, keys)
        return cls.fit_matrix(mat, keys)

    @classmethod
    def fit_matrix(cls, mat: np.ndarray, keys: Sequence[str]) -> "RobustStats":
        """Fit from an ``[N, K]`` column matrix (the device-native path)."""
        med, mad = median_mad(jnp.asarray(mat, dtype=jnp.float32))
        med = np.asarray(med)
        mad = np.asarray(mad)
        return cls(
            medians={k: float(m) for k, m in zip(keys, med)},
            mads={k: float(m) for k, m in zip(keys, mad)},
            keys=tuple(keys),
        )

    @classmethod
    def from_payloads(
        cls, payloads: Sequence[Payload], keys: Sequence[str] = PAYLOAD_STAT_FIELDS
    ) -> "RobustStats":
        """Payload-based fit (parity: reference robust.py:13-28)."""
        if not payloads:
            raise ValueError("Cannot compute statistics from empty dataset")
        mat = np.array(
            [[float(getattr(p, k)) for k in keys] for p in payloads], dtype=np.float32
        )
        return cls.fit_matrix(mat, keys)

    def z(self, name: str, val: float) -> float:
        return float(
            (val - self.medians[name]) / (MAD_CONSISTENCY * self.mads[name])
        )

    def arrays(self, keys: Optional[Sequence[str]] = None) -> Any:
        keys = tuple(keys or self.keys)
        med = np.array([self.medians[k] for k in keys], dtype=np.float32)
        mad = np.array([self.mads[k] for k in keys], dtype=np.float32)
        return med, mad

    def to_dict(self) -> dict:
        return {"medians": self.medians, "mads": self.mads, "keys": list(self.keys)}

    @classmethod
    def from_dict(cls, d: dict) -> "RobustStats":
        return cls(
            medians=dict(d["medians"]),
            mads=dict(d["mads"]),
            keys=tuple(d.get("keys", SIGNAL_FIELDS)),
        )


@partial(jax.jit, static_argnames=("mode",))
def _score_kernel(
    x: jax.Array,
    med: jax.Array,
    mad: jax.Array,
    alphas: jax.Array,
    delta: jax.Array,
    mode: str = "standard",
) -> jax.Array:
    """Fused z -> components -> clipped utility -> sigmoid over [N, 7].

    Column order is SIGNAL_FIELDS:
    (ht_mean, ht_q90, hi_mean, hi_q90, I_hat, redundancy, noise).
    """
    z = (x.astype(jnp.float32) - med[None, :]) / (MAD_CONSISTENCY * mad[None, :])
    ht = 0.5 * (z[:, 0] + z[:, 1])
    hi = 0.5 * (z[:, 2] + z[:, 3])
    i_hat, red, noise = z[:, 4], z[:, 5], z[:, 6]
    at, ai, am, ar, an = alphas[0], alphas[1], alphas[2], alphas[3], alphas[4]
    if mode == "conditional":
        u = at * (ht - i_hat) + ai * (hi - i_hat) - ar * red - an * noise
    else:
        u = at * ht + ai * hi - am * i_hat - ar * red - an * noise
    u = jnp.clip(u, -delta, delta)
    return jax.nn.sigmoid(u)


class DewiScorer:
    """Robust DEWI scorer with standard and conditional modes.

    API parity with reference scorer.py:34-89, plus the vectorized
    ``fit_stats_matrix`` / ``score_batch`` device path.  Unlike the reference
    (scorer.py:37-39, which silently clobbers ``weights.delta``), an explicit
    ``delta`` argument only overrides when actually provided.
    """

    def __init__(self, weights: Optional[Weights] = None, delta: Optional[float] = None) -> None:
        self.weights = weights or Weights()
        if delta is not None:
            self.weights.delta = float(delta)
        self.stats: Optional[RobustStats] = None

    # ---- fitting -------------------------------------------------------

    def fit_stats(self, rows: Sequence[RowLike]) -> None:
        """Fit robust statistics from signal dicts / Signals rows."""
        self.stats = RobustStats.fit(rows)

    def fit_stats_matrix(
        self, mat: np.ndarray, keys: Sequence[str] = SIGNAL_FIELDS
    ) -> None:
        """Fit from an ``[N, K]`` f32 matrix — the device-native bulk path."""
        self.stats = RobustStats.fit_matrix(mat, keys)

    def is_fitted(self) -> bool:
        return self.stats is not None

    # ---- scalar scoring (API parity) ------------------------------------

    def _components(self, sig: RowLike) -> Dict[str, float]:
        assert self.stats is not None, "Call fit_stats() before scoring."
        s = self.stats
        d = sig if isinstance(sig, Mapping) else sig.to_dict()
        return {
            "Ht": 0.5 * (s.z("ht_mean", d["ht_mean"]) + s.z("ht_q90", d["ht_q90"])),
            "Hi": 0.5 * (s.z("hi_mean", d["hi_mean"]) + s.z("hi_q90", d["hi_q90"])),
            "I": s.z("I_hat", d["I_hat"]),
            "R": s.z("redundancy", d["redundancy"]),
            "N": s.z("noise", d["noise"]),
        }

    @staticmethod
    def _sigmoid(x: float) -> float:
        return float(1.0 / (1.0 + np.exp(-x)))

    def score(self, sig: RowLike) -> float:
        c = self._components(sig)
        w = self.weights
        u = (
            w.alpha_t * c["Ht"]
            + w.alpha_i * c["Hi"]
            - w.alpha_m * c["I"]
            - w.alpha_r * c["R"]
            - w.alpha_n * c["N"]
        )
        u = float(np.clip(u, -w.delta, w.delta))
        return self._sigmoid(u)

    def score_conditional(self, sig: RowLike) -> float:
        c = self._components(sig)
        w = self.weights
        u = (
            w.alpha_t * (c["Ht"] - c["I"])
            + w.alpha_i * (c["Hi"] - c["I"])
            - w.alpha_r * c["R"]
            - w.alpha_n * c["N"]
        )
        u = float(np.clip(u, -w.delta, w.delta))
        return self._sigmoid(u)

    # ---- batch scoring (device path) ------------------------------------

    def score_batch(
        self,
        signals: Union[np.ndarray, jax.Array, Sequence[RowLike]],
        mode: str = "standard",
    ) -> jax.Array:
        """Score N documents in one fused XLA call.

        ``signals`` is an ``[N, 7]`` matrix in SIGNAL_FIELDS column order, or
        a sequence of dict/Signals rows.  Returns a ``[N]`` device array of
        DEWI scores in [0, 1].
        """
        assert self.stats is not None, "Call fit_stats() before scoring."
        if not isinstance(signals, (np.ndarray, jax.Array)):
            signals = rows_to_matrix(signals, SIGNAL_FIELDS)
        med, mad = self.stats.arrays(SIGNAL_FIELDS)
        return _score_kernel(
            jnp.asarray(signals),
            jnp.asarray(med),
            jnp.asarray(mad),
            jnp.asarray(self.weights.alphas()),
            jnp.float32(self.weights.delta),
            mode=mode,
        )

    def fit_and_score(
        self, signals: Union[np.ndarray, Sequence[RowLike]], mode: str = "standard"
    ) -> jax.Array:
        """Fit stats and score in one go — the bulk corpus path."""
        if not isinstance(signals, (np.ndarray, jax.Array)):
            signals = rows_to_matrix(signals, SIGNAL_FIELDS)
        self.fit_stats_matrix(np.asarray(signals))
        return self.score_batch(signals, mode=mode)


def local_weights_from_surprisal(s: Any) -> np.ndarray:
    """Per-token/per-patch surprisal -> positive weights.

    Parity: reference local_weights.py:5-26 (robust z with additive epsilon,
    clip to ±5, softplus via log1p(exp)).  Runs as one jitted kernel.
    """
    from .ops.robust import local_weights_kernel

    return np.asarray(local_weights_kernel(jnp.asarray(s, dtype=jnp.float32)))


__all__ = [
    "DewiScorer",
    "RobustStats",
    "Signals",
    "Weights",
    "local_weights_from_surprisal",
    "PAYLOAD_STAT_FIELDS",
]
