"""Core value types for DEWI.

Capability parity with the reference's ``src/dewi/types.py:8-51`` (``Payload``,
``Weights``) plus the ``Signals`` record that the reference README promises
(README.md:67) but never ships.  All three are plain dataclasses with
dict/bytes serde; the array-native forms used on-device are produced by
:func:`payloads_to_matrix` / :func:`signals_to_matrix` so that scoring and
re-ranking run as single XLA computations over ``[N, K]`` matrices instead of
per-document Python.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, fields
from typing import Dict, Iterable, List, Mapping, Sequence, Union

import numpy as np

# Column order of the on-device payload matrix.  Index 0 (dewi) first so the
# fused re-rank kernel reads it with a contiguous slice.
PAYLOAD_FIELDS = (
    "dewi",
    "ht_mean",
    "ht_q90",
    "hi_mean",
    "hi_q90",
    "I_hat",
    "redundancy",
    "noise",
)

# Column order of the on-device signal matrix consumed by the scorer.
SIGNAL_FIELDS = (
    "ht_mean",
    "ht_q90",
    "hi_mean",
    "hi_q90",
    "I_hat",
    "redundancy",
    "noise",
)


@dataclass
class Payload:
    """Per-document signal record (parity: reference types.py:8-39)."""

    dewi: float = 0.0
    ht_mean: float = 0.0
    ht_q90: float = 0.0
    hi_mean: float = 0.0
    hi_q90: float = 0.0
    I_hat: float = 0.0
    redundancy: float = 0.0
    noise: float = 0.0

    def to_dict(self) -> Dict[str, float]:
        return asdict(self)

    @classmethod
    def from_dict(cls, data: Mapping[str, float]) -> "Payload":
        """Build from a dict, silently dropping unknown keys."""
        names = {f.name for f in fields(cls)}
        return cls(**{k: float(v) for k, v in data.items() if k in names})

    def to_bytes(self) -> bytes:
        return json.dumps(self.to_dict()).encode("utf-8")

    @classmethod
    def from_bytes(cls, data: bytes) -> "Payload":
        return cls.from_dict(json.loads(data.decode("utf-8")))

    def to_array(self) -> np.ndarray:
        return np.array([getattr(self, f) for f in PAYLOAD_FIELDS], dtype=np.float32)

    @classmethod
    def from_array(cls, arr: Sequence[float]) -> "Payload":
        return cls(**{f: float(v) for f, v in zip(PAYLOAD_FIELDS, arr)})


@dataclass
class Signals:
    """The seven raw signals feeding the DEWI score.

    The reference README (README.md:67-135) imports this from ``dewi.scorer``
    but the class does not exist there; this framework makes it real.  Field
    set mirrors the scorer's signal keys (reference scorer.py:49-58).
    """

    ht_mean: float = 0.0
    ht_q90: float = 0.0
    hi_mean: float = 0.0
    hi_q90: float = 0.0
    I_hat: float = 0.0
    redundancy: float = 0.0
    noise: float = 0.0

    def to_dict(self) -> Dict[str, float]:
        return asdict(self)

    @classmethod
    def from_dict(cls, data: Mapping[str, float]) -> "Signals":
        names = {f.name for f in fields(cls)}
        return cls(**{k: float(v) for k, v in data.items() if k in names})

    def to_array(self) -> np.ndarray:
        return np.array([getattr(self, f) for f in SIGNAL_FIELDS], dtype=np.float32)


@dataclass
class Weights:
    """DEWI scoring weights (parity: reference types.py:42-51)."""

    alpha_t: float = 1.0
    alpha_i: float = 1.0
    alpha_m: float = 1.0
    alpha_r: float = 1.0
    alpha_n: float = 1.0
    delta: float = 3.0

    def alphas(self) -> np.ndarray:
        return np.array(
            [self.alpha_t, self.alpha_i, self.alpha_m, self.alpha_r, self.alpha_n],
            dtype=np.float32,
        )


RowLike = Union[Mapping[str, float], Signals, Payload]


def _row_dict(row: RowLike) -> Mapping[str, float]:
    if isinstance(row, Mapping):
        return row
    return row.to_dict()


def rows_to_matrix(rows: Iterable[RowLike], keys: Sequence[str]) -> np.ndarray:
    """Stack dict/Signals/Payload rows into an ``[N, len(keys)]`` f32 matrix."""
    out = [[float(_row_dict(r)[k]) for k in keys] for r in rows]
    return np.asarray(out, dtype=np.float32)


def signals_to_matrix(rows: Iterable[RowLike]) -> np.ndarray:
    return rows_to_matrix(rows, SIGNAL_FIELDS)


def payloads_to_matrix(payloads: Iterable[Payload]) -> np.ndarray:
    return np.stack([p.to_array() for p in payloads]).astype(np.float32)


def matrix_to_payloads(mat: np.ndarray) -> List[Payload]:
    return [Payload.from_array(row) for row in np.asarray(mat)]
