"""ctypes bindings for the native C++ runtime (JSONL codec, minhash).

The reference's host-side performance came from third-party C++ wheels
(hnswlib/faiss serde — reference backends.py:104-163, 358-383); this package
builds its own native runtime in-repo (``native/dewi_native.cpp``) and loads
it here.  Everything degrades gracefully to pure Python when the shared
library is absent and can't be built (the same optional-dependency
discipline as the reference's ``_HAS_FAISS`` guards, backends.py:18-30).

Set ``DEWI_NO_NATIVE=1`` to force the Python paths.
"""

from __future__ import annotations

import ctypes
import json
import logging
import os
import subprocess
from pathlib import Path
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ..types import PAYLOAD_FIELDS, Payload

logger = logging.getLogger(__name__)

_LIB_PATH = Path(__file__).parent / "libdewi_native.so"
_SRC_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    """Load (building on first use if needed) the native library."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("DEWI_NO_NATIVE", "").lower() in ("1", "true", "yes"):
        return None
    if (_SRC_DIR / "Makefile").exists():
        # Build when absent OR stale (a cached .so from before a source
        # change would silently lack newer entry points, e.g. the JPEG
        # pool); make itself is a no-op when everything is current.
        try:
            stale = not _LIB_PATH.exists() or any(
                src.stat().st_mtime > _LIB_PATH.stat().st_mtime
                for src in list(_SRC_DIR.glob("*.cpp"))
                + [_SRC_DIR / "Makefile"]
            )
        except OSError:
            stale = not _LIB_PATH.exists()
        if stale:
            try:
                subprocess.run(
                    ["make", "-C", str(_SRC_DIR)],
                    check=True, capture_output=True, timeout=120,
                )
            except Exception as e:  # noqa: BLE001
                logger.warning(
                    "Native build failed (%s); using Python codecs.", e
                )
                if not _LIB_PATH.exists():
                    return None
    if not _LIB_PATH.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.dewi_write_payloads_jsonl.restype = ctypes.c_int64
        lib.dewi_write_payloads_jsonl.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_char_p,
        ]
        lib.dewi_read_payloads_jsonl.restype = ctypes.c_int64
        lib.dewi_read_payloads_jsonl.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.dewi_minhash.restype = ctypes.c_int64
        lib.dewi_minhash.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64),
        ]
        # Older cached builds may predate the JPEG pool; probe before binding.
        if hasattr(lib, "dewi_decode_jpeg_batch"):
            lib.dewi_has_jpeg.restype = ctypes.c_int32
            lib.dewi_has_jpeg.argtypes = []
            lib.dewi_decode_jpeg_batch.restype = ctypes.c_int64
            lib.dewi_decode_jpeg_batch.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint8),
            ]
        _lib = lib
    except OSError as e:
        logger.warning("Native library load failed (%s); using Python.", e)
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


_KEYS_CSV = ",".join(PAYLOAD_FIELDS).encode()


# ---------------------------------------------------------------------------
# payloads.jsonl codec
# ---------------------------------------------------------------------------


def write_payloads_jsonl(
    path: Any, doc_ids: Sequence[str], matrix: np.ndarray
) -> None:
    """Write ``{"doc_id": ..., "payload": {...}}`` lines (native when possible)."""
    matrix = np.ascontiguousarray(matrix, dtype=np.float32)
    n = matrix.shape[0]
    assert matrix.shape[1] == len(PAYLOAD_FIELDS)
    lib = _load()
    if lib is not None and "\n" not in "".join(doc_ids):
        ids_nl = "\n".join(doc_ids).encode("utf-8")
        rc = lib.dewi_write_payloads_jsonl(
            str(path).encode(), ids_nl,
            matrix.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int64(n), _KEYS_CSV,
        )
        if rc >= 0:
            return
        logger.warning("Native JSONL write failed (rc=%d); Python fallback.", rc)
    with open(path, "w", encoding="utf-8") as f:
        for doc_id, row in zip(doc_ids, matrix):
            f.write(
                json.dumps(
                    {"doc_id": doc_id,
                     "payload": Payload.from_array(row).to_dict()}
                )
                + "\n"
            )


def read_payloads_jsonl(path: Any) -> Tuple[List[str], np.ndarray]:
    """Read back (doc_ids, [N, 8] matrix); tolerant of missing/extra keys."""
    path = Path(path)
    lib = _load()
    if lib is not None and _native_read_safe(path):
        # Upper-bound row count by line count of the file.
        data_len = path.stat().st_size
        max_rows = max(1, data_len // 16)
        out = np.zeros((max_rows, len(PAYLOAD_FIELDS)), dtype=np.float32)
        ids_cap = data_len + max_rows + 16
        ids_buf = ctypes.create_string_buffer(ids_cap)
        rc = lib.dewi_read_payloads_jsonl(
            str(path).encode(), _KEYS_CSV,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int64(max_rows), ids_buf, ctypes.c_int64(ids_cap),
        )
        if rc >= 0:
            ids = ids_buf.value.decode("utf-8").split("\n") if rc else []
            return ids[: int(rc)], out[: int(rc)]
        logger.warning("Native JSONL read failed (rc=%d); Python fallback.", rc)
    ids: List[str] = []
    rows: List[np.ndarray] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            ids.append(str(d.get("doc_id", d.get("id", ""))))
            rows.append(Payload.from_dict(d.get("payload", {})).to_array())
    mat = (np.stack(rows) if rows
           else np.zeros((0, len(PAYLOAD_FIELDS)), np.float32))
    return ids, mat


# ---------------------------------------------------------------------------
# minhash
# ---------------------------------------------------------------------------


def _native_read_safe(path: Path) -> bool:
    """Mirror of the writer's newline guard, for the READ side.

    The Python fallback writer legally JSON-escapes ids containing newlines
    (``\\n``) or NULs (``\\u0000``); the C parser unescapes them, which would
    shift the '\\n'-joined ids buffer (newline) or truncate it (NUL).  Any
    such escape in the file routes the read to the Python JSON parser.
    Payload keys/values are fixed identifiers and floats, so these escape
    sequences can only originate from id strings (a literal backslash-n in an
    id arrives double-escaped and merely causes a harmless fallback too).
    """
    try:
        data = path.read_bytes()
    except OSError:
        return False
    return b"\\n" not in data and b"\\u0000" not in data


def minhash_signatures_native(
    texts: Sequence[str], num_hashes: int = 64, seed: int = 0, k: int = 3
) -> Optional[np.ndarray]:
    """Native minhash; returns None when the library is unavailable or the
    inputs contain the record separator."""
    lib = _load()
    if lib is None:
        return None
    if any("\x1e" in t for t in texts):
        return None
    rng = np.random.default_rng(seed)
    p = (1 << 61) - 1
    a = rng.integers(1, p, size=num_hashes, dtype=np.uint64)
    b = rng.integers(0, p, size=num_hashes, dtype=np.uint64)
    sigs = np.full((len(texts), num_hashes), np.iinfo(np.uint64).max,
                   dtype=np.uint64)
    blob = "\x1e".join(texts).encode("utf-8", errors="replace")
    rc = lib.dewi_minhash(
        blob, ctypes.c_int64(len(texts)),
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int64(num_hashes), ctypes.c_int64(k),
        sigs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if rc != len(texts):
        return None
    return sigs


# ---------------------------------------------------------------------------
# JPEG decode pool
# ---------------------------------------------------------------------------


def jpeg_pool_available() -> bool:
    """True when the native library was built against libjpeg."""
    lib = _load()
    return (
        lib is not None
        and hasattr(lib, "dewi_decode_jpeg_batch")
        and bool(lib.dewi_has_jpeg())
    )


def decode_jpeg_batch(
    paths: Sequence[str], size: int, threads: int = 4,
    out: Optional[np.ndarray] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """GIL-free batched JPEG decode: ``([n, size, size, 3] uint8, [n] bool)``.

    The bool mask marks slots that decoded natively; the caller decodes the
    rest (non-JPEG bytes, CMYK, truncated files) through the PIL path.
    Returns ``None`` when the native pool is unavailable (caller falls back
    wholesale).  Decode uses the same DCT-scale draft trick as the PIL path
    (reference image decode is per-estimator and full-resolution,
    reference image_entropy.py:39-49); resize is center-aligned bilinear.
    """
    if not paths or not jpeg_pool_available():
        return None
    if any("\n" in p for p in paths):
        return None
    lib = _load()
    assert lib is not None
    n = len(paths)
    if out is None:
        out = np.empty((n, size, size, 3), dtype=np.uint8)
    else:
        # Decode straight into the caller's buffer (e.g. a pack memmap
        # slice) — failed slots are left untouched for the PIL fallback.
        assert out.shape == (n, size, size, 3) and out.dtype == np.uint8
        assert out.flags["C_CONTIGUOUS"], "out must be C-contiguous"
    ok = np.zeros(n, dtype=np.uint8)
    rc = lib.dewi_decode_jpeg_batch(
        "\n".join(paths).encode("utf-8"), ctypes.c_int64(n),
        ctypes.c_int32(int(size)), ctypes.c_int32(max(1, int(threads))),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc < 0:
        return None
    return out, ok.astype(bool)


__all__ = [
    "available",
    "write_payloads_jsonl",
    "read_payloads_jsonl",
    "minhash_signatures_native",
    "jpeg_pool_available",
    "decode_jpeg_batch",
]
