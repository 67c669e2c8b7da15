"""Timing + tracing harness.

The reference's observability is an offline cProfile script producing
``metrics.json`` and ``.prof`` dumps (reference scripts/profile_index.py:
143-175, 288-291).  The device equivalents here:

* :class:`Timer` — wall-clock spans that block on device results, so a span
  measures real device time, not dispatch time;
* :func:`xla_trace` — ``jax.profiler`` context writing a TensorBoard-
  compatible device trace (the replacement for ``.prof`` files);
* :func:`summarize` — the same metrics.json shape the reference emits
  (docs/sec, QPS, latency percentiles).
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np


class Timer:
    """Named wall-clock spans with percentile summaries.

    >>> t = Timer()
    >>> with t.span("search"):
    ...     jax.block_until_ready(index.search_batch(q))
    >>> t.percentile("search", 50)
    """

    def __init__(self) -> None:
        self.spans: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str, result: Any = None) -> Any:
        """Time a block; pass ``result=`` a device array to block on."""
        start = time.perf_counter()
        try:
            yield
        finally:
            if result is not None:
                import jax

                jax.block_until_ready(result)
            self.spans.setdefault(name, []).append(
                (time.perf_counter() - start) * 1e3
            )

    def record(self, name: str, millis: float) -> None:
        self.spans.setdefault(name, []).append(float(millis))

    def percentile(self, name: str, q: float) -> float:
        return float(np.percentile(self.spans[name], q))

    def mean(self, name: str) -> float:
        return float(np.mean(self.spans[name]))

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, vals in self.spans.items():
            out[name] = {
                "count": len(vals),
                "mean_ms": round(float(np.mean(vals)), 4),
                "p50_ms": round(float(np.percentile(vals, 50)), 4),
                "p99_ms": round(float(np.percentile(vals, 99)), 4),
                "total_ms": round(float(np.sum(vals)), 2),
            }
        return out


@contextlib.contextmanager
def xla_trace(trace_dir: Optional[str]) -> Any:
    """``jax.profiler.trace`` context; no-op when ``trace_dir`` is None."""
    if trace_dir is None:
        yield
        return
    import jax

    with jax.profiler.trace(str(trace_dir)):
        yield


def summarize(
    timer: Timer,
    n_docs: int,
    n_queries: int,
    build_span: str = "build",
    query_span: str = "query",
    extra: Optional[dict] = None,
) -> dict:
    """metrics.json shape parity with reference profile_index.py:288-291."""
    metrics: dict = {"n_docs": n_docs, "n_queries": n_queries}
    if build_span in timer.spans:
        build_s = timer.mean(build_span) / 1e3
        metrics["build_seconds"] = round(build_s, 3)
        metrics["docs_per_sec"] = round(n_docs / max(build_s, 1e-9), 1)
    if query_span in timer.spans:
        metrics["mean_latency_ms"] = round(timer.mean(query_span), 4)
        metrics["p50_latency_ms"] = round(timer.percentile(query_span, 50), 4)
        metrics["p99_latency_ms"] = round(timer.percentile(query_span, 99), 4)
        total_s = sum(timer.spans[query_span]) / 1e3
        metrics["queries_per_sec"] = round(
            len(timer.spans[query_span]) / max(total_s, 1e-9), 1
        )
    if extra:
        metrics.update(extra)
    return metrics


def write_metrics(metrics: dict, path: Any) -> None:
    Path(path).write_text(json.dumps(metrics, indent=2), encoding="utf-8")


__all__ = ["Timer", "xla_trace", "summarize", "write_metrics"]
