"""Reference-compatible backend import surface.

The reference exposes ``dewi.backends`` with BaseIndex/ExactIndex/HNSWIndex/
FAISSIndex/IndexBackend and availability flags (backends.py:18-49).  On an accelerator
the C++ graph/IVF engines are replaced by XLA matmul top-k backends, so the
flags are always True (the capability is always available) and the old class
names alias their device replacements.
"""

from .index import BACKEND_CLASSES, BaseIndex, DocStore, ExactIndex, IndexBackend, IVFIndex

# Aliases for reference code written against hnswlib/FAISS-backed classes.
HNSWIndex = ExactIndex
FAISSIndex = IVFIndex

_HAS_FAISS = True  # IVF backend is always available
_HAS_HNSW = True   # exact matmul top-k subsumes graph ANN here

__all__ = [
    "BaseIndex",
    "ExactIndex",
    "IVFIndex",
    "HNSWIndex",
    "FAISSIndex",
    "IndexBackend",
    "DocStore",
    "BACKEND_CLASSES",
    "_HAS_FAISS",
    "_HAS_HNSW",
]
