from typing import Any
"""Compatibility shim: Payload-based robust stats.

The reference ships a second, divergent ``RobustStats`` in robust.py:13-32
(fitted from Payloads over four keys) that the package root exports.  This
framework unifies both variants into :class:`dewi.scorer.RobustStats`;
this module keeps the reference's import surface working.
"""

from .scorer import PAYLOAD_STAT_FIELDS, RobustStats
from .ops.robust import MAD_CONSISTENCY


def _robust_standardize(x: Any, med: Any, mad: Any) -> Any:
    """Parity helper (reference robust.py:8-10): additive-epsilon z-score."""
    mad = float(mad) + 1e-8
    return (x - med) / (MAD_CONSISTENCY * mad)


__all__ = ["RobustStats", "PAYLOAD_STAT_FIELDS", "_robust_standardize"]
