"""Deferred device→host fetches: one round trip per stage, not per batch.

Every estimator bulk loop used to block on ``np.asarray(result_k)`` once per
superbatch.  JAX dispatch is asynchronous, so the *compute* already
pipelines — but each fetch is a full host↔device round trip that serializes
the host loop behind the device, for tiny [S, bs] aggregates.

:class:`DeferredFetcher` keeps per-dispatch results as device handles,
concatenates them ON DEVICE, and fetches the whole stage's output in ONE
``np.asarray`` at the end.  A byte budget bounds what can accumulate in device memory
(results *and* the un-consumed input buffers of queued dispatches): past the
budget the fetcher flushes — one fetch for everything queued so far — which
also blocks until those dispatches' inputs are consumed and freed.

Call sites with non-sequential write-back (text entropy scatters by doc
index) use the returned row offsets; sequential consumers (embedding
encoders) pass per-part ``keep`` counts to strip pad rows on the host after
the single fetch.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional

import numpy as np

#: Flush budget (MB) for deferred device results + in-flight input buffers.
DEFAULT_BUDGET_MB = int(os.environ.get("DEWI_DEFER_FETCH_MB", 512))


class DeferredFetcher:
    """Accumulates ``[R, ...]`` device row blocks; one host fetch per flush.

    ``append`` returns the global row offset of the part (stable across
    flushes — parts are concatenated in append order), so callers can
    scatter rows to their destinations after :meth:`result`.
    """

    def __init__(self, budget_mb: Optional[int] = None) -> None:
        self._parts: List = []          # un-fetched device arrays
        self._keeps: List[Optional[int]] = []  # rows to keep per part
        self._host: List[np.ndarray] = []      # flushed (kept) host rows
        self._pending_bytes = 0
        self._offset = 0                # global row offset (kept rows only)
        self.budget = (
            DEFAULT_BUDGET_MB if budget_mb is None else int(budget_mb)
        ) << 20

    def append(self, rows: Any, keep: Optional[int] = None,
               cost: int = 0) -> int:
        """Queue a ``[R, ...]`` device block; returns its global row offset.

        ``keep``: number of leading rows that are real (the rest are batch
        padding, dropped on the host after the fetch).  ``cost``: extra
        bytes to charge against the flush budget (e.g. the dispatch's input
        buffers, which stay live in HBM until the computation consumes
        them).
        """
        nkeep = int(rows.shape[0] if keep is None else keep)
        self._parts.append(rows)
        self._keeps.append(None if keep is None else nkeep)
        self._pending_bytes += (
            rows.size * rows.dtype.itemsize + max(0, int(cost))
        )
        off = self._offset
        self._offset += nkeep
        if self._pending_bytes > self.budget:
            self.flush()
        return off

    def flush(self) -> None:
        """Fetch everything queued so far in one round trip."""
        if not self._parts:
            return
        import jax.numpy as jnp

        parts = self._parts
        flat = np.asarray(
            parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)
        )
        pos = 0
        for part, keep in zip(parts, self._keeps):
            r = int(part.shape[0])
            block = flat[pos : pos + r]
            self._host.append(block if keep is None else block[:keep])
            pos += r
        self._parts, self._keeps = [], []
        self._pending_bytes = 0

    def result(self) -> np.ndarray:
        """All kept rows in append order as one host array (final flush)."""
        self.flush()
        if not self._host:
            return np.zeros((0,), np.float32)
        if len(self._host) > 1:
            # concatenate materializes fresh memory; views die with it.
            return np.concatenate(self._host, axis=0)
        out = self._host[0]
        # A pad-stripped single part is a leading view into the flush
        # buffer (contiguous, so ascontiguousarray would pass it through
        # unchanged) — copy it free of the base so the caller doesn't
        # retain the padded buffer for its lifetime.
        if out.base is not None and out.size < out.base.size:
            return out.copy()
        return out


__all__ = ["DeferredFetcher", "DEFAULT_BUDGET_MB"]
