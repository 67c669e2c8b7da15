"""Device-native indexing: SoA store, exact fused search, IVF, façade."""

from ..types import Payload  # re-export: parity with `from dewi.index import Payload`
from .base import BaseIndex
from .exact import ExactIndex
from .facade import DewiIndex, IndexBackend
from .ivf import IVFIndex
from .quantized import QuantizedIndex
from .store import DocStore

# Registry for persistence round-trips (replaces the reference's
# ``globals()[metadata['type']]`` dispatch at backends.py:151).  Reference
# class names map onto the device backends that replaced them.
BACKEND_CLASSES = {
    "ExactIndex": ExactIndex,
    "IVFIndex": IVFIndex,
    "QuantizedIndex": QuantizedIndex,
    "HNSWIndex": ExactIndex,
    "FAISSIndex": IVFIndex,
}

__all__ = [
    "Payload",
    "BaseIndex",
    "ExactIndex",
    "IVFIndex",
    "QuantizedIndex",
    "DewiIndex",
    "IndexBackend",
    "DocStore",
    "BACKEND_CLASSES",
]
