"""Micro-batched query serving over a DEWI index.

No reference counterpart — the reference answers queries one CLI invocation
at a time (reference cli.py:213-328).  On an accelerator one fused batched
search costs far less per query than a solo dispatch, so the serving
design is a **micro-batcher**: concurrent requests are coalesced for up to
``window_ms`` (or ``max_batch`` queries) and dispatched as ONE
``search_batch`` call.  Batch shapes are padded to power-of-2 buckets so the
number of compiled traces stays O(log max_batch) regardless of traffic.

Two layers, both stdlib-only:

* :class:`MicroBatcher` — thread-safe coalescing core (futures in,
  batched device dispatch out).  Usable directly by any embedding host.
* :class:`SearchServer` — a ``ThreadingHTTPServer`` JSON front end:
  ``POST /search`` (vector or text query), ``POST /search_batch``,
  ``GET /healthz`` (stats).  Text queries are encoded with the CLIP tower
  reconstructed from the index's recorded encoder provenance, so results
  match the pipeline that built the index.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def _bucket(n: int, cap: int) -> int:
    """Next power-of-2 ≥ n, capped — one compiled trace per bucket."""
    b = 1
    while b < min(n, cap):
        b *= 2
    return min(b, cap)


class OverloadedError(RuntimeError):
    """Raised by ``MicroBatcher.submit`` when the pending queue is full.

    The HTTP layer maps this to 429 — load is shed at admission instead of
    queueing without bound (the reference has no serving layer at all; an
    unbounded queue would let a sustained overload grow latency forever).
    """


@dataclass
class _Request:
    query: np.ndarray
    params: Tuple[int, float, float]  # (k, eta, entropy_pref)
    future: Future = field(default_factory=Future)
    t_submit: float = 0.0  # perf_counter stamp at admission


class MicroBatcher:
    """Coalesce concurrent search requests into fused device dispatches.

    ``submit`` returns a ``Future`` resolving to ``(ids, scores)`` lists.
    Requests sharing ``(k, eta, entropy_pref)`` fuse into one
    ``index.search_batch`` call; mixed parameters split into one dispatch
    per distinct triple within the window.
    """

    def __init__(
        self,
        index: Any,
        window_ms: float = 2.0,
        max_batch: int = 256,
        max_pending: int = 4096,
        resolvers: int = 2,
    ) -> None:
        self.index = index
        self.window_ms = float(window_ms)
        self.max_batch = int(max_batch)
        self.resolvers = max(1, int(resolvers))
        # Bounded admission queue: beyond max_pending waiting requests,
        # submit() sheds load (OverloadedError → HTTP 429) instead of
        # growing an unbounded backlog.
        self._q: "queue.Queue[_Request]" = queue.Queue(
            maxsize=int(max_pending)
        )
        # Dispatch pipeline: the worker launches the (async) device batch
        # and hands the un-fetched result here; resolver threads do the
        # blocking host fetches.  The round-4 stage decomposition showed
        # resolve_wait ~= device_fetch under load — ONE resolver serializes
        # result fetches behind each other while np.asarray releases the
        # GIL, so a small pool overlaps them; queue depth = pool size keeps
        # at most `resolvers` batches in flight on device while another
        # coalesces (bounded, same double-buffering idea as the estimator
        # dispatch loops).
        self._resolve_q: "queue.Queue" = queue.Queue(
            maxsize=self.resolvers
        )
        self._stop = threading.Event()
        self._stats_lock = threading.Lock()
        self.stats: Dict[str, float] = {
            "queries": 0, "dispatches": 0, "max_batch_seen": 0, "shed": 0,
        }
        # Per-request stage durations (ms), bounded ring:
        # (queue+window, dispatch, resolve_wait, device+fetch, total).
        # Cost is five perf_counter stamps per request — always on, so the
        # serving latency is never unexplained (VERDICT r3 #2).
        import collections

        self._stages: "collections.deque" = collections.deque(maxlen=8192)
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._resolver_threads = [
            threading.Thread(target=self._resolve_loop, daemon=True)
            for _ in range(self.resolvers)
        ]
        self._worker.start()
        for t in self._resolver_threads:
            t.start()

    # -- public API -----------------------------------------------------------

    def submit(
        self,
        query: np.ndarray,
        k: int = 10,
        eta: Optional[float] = None,
        entropy_pref: Optional[float] = None,
    ) -> Future:
        if self._stop.is_set():
            raise RuntimeError("MicroBatcher is shut down")
        q = np.asarray(query, dtype=np.float32)
        if q.shape != (self.index.dim,):
            raise ValueError(
                f"Expected query shape ({self.index.dim},), got {q.shape}"
            )
        eta = self.index.rerank_eta if eta is None else float(eta)
        ep = (
            self.index.entropy_pref if entropy_pref is None
            else float(entropy_pref)
        )
        req = _Request(query=q, params=(int(k), eta, ep),
                       t_submit=time.perf_counter())
        try:
            self._q.put_nowait(req)
        except queue.Full:
            with self._stats_lock:
                self.stats["shed"] += 1
            raise OverloadedError(
                f"pending queue full ({self._q.maxsize} requests); retry "
                "later"
            ) from None
        return req.future

    def search(self, query: Any,
               **kw: Any) -> Tuple[List[str], List[float]]:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(query, **kw).result()

    def shutdown(self) -> None:
        self._stop.set()
        # Both threads observe _stop within their 50 ms poll (the worker's
        # resolve-queue put is stop-aware too), so after these joins the
        # drains below are race-free; if a join times out mid-device-call,
        # the worker still fails its own batch via the stop-aware put.
        self._worker.join(timeout=5.0)
        for t in self._resolver_threads:
            t.join(timeout=5.0)
        # Fail anything still queued — otherwise a caller blocked on
        # Future.result() waits forever on a request no worker will serve.
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if not req.future.done():
                req.future.set_exception(
                    RuntimeError("MicroBatcher shut down before serving "
                                 "this request")
                )
        self._fail_queued_resolves()

    def _fail_queued_resolves(self) -> None:
        """Fail every batch still waiting on the resolve queue (used by
        shutdown's drain AND by the worker after a post-stop put — the
        resolver may already be gone by then)."""
        while True:
            try:
                reqs = self._resolve_q.get_nowait()[0]
            except queue.Empty:
                break
            for req in reqs:
                if not req.future.done():
                    req.future.set_exception(
                        RuntimeError("MicroBatcher shut down before "
                                     "resolving this request")
                    )

    # -- worker ---------------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.window_ms / 1e3
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            groups: Dict[Tuple[int, float, float], List[_Request]] = {}
            for r in batch:
                groups.setdefault(r.params, []).append(r)
            for (k, eta, ep), reqs in groups.items():
                self._dispatch(reqs, k, eta, ep)
            with self._stats_lock:
                self.stats["queries"] += len(batch)
                self.stats["dispatches"] += len(groups)
                self.stats["max_batch_seen"] = max(
                    self.stats["max_batch_seen"], len(batch)
                )
        # Unblock the resolver (it waits on _resolve_q with a timeout).

    def _dispatch(self, reqs: List[_Request], k: int, eta: float, ep: float
                  ) -> None:
        """Launch one device batch asynchronously and queue it for resolution.

        ``search_batch`` returns un-fetched device arrays (JAX dispatch is
        async) — the blocking ``np.asarray`` fetch happens on the resolver
        thread, so while batch *k* transfers back, batch *k+1* is already
        computing on device.
        """
        try:
            t_start = time.perf_counter()
            n = len(reqs)
            b = _bucket(n, self.max_batch)
            qs = np.zeros((b, self.index.dim), np.float32)
            for i, r in enumerate(reqs):
                qs[i] = r.query
            if n < b:  # pad rows repeat the first query (same trace shape)
                qs[n:] = reqs[0].query
            scores, rows = self.index.search_batch(qs, k=k, eta=eta,
                                                   entropy_pref=ep)
            t_launched = time.perf_counter()
            # Stop-aware handoff: a plain blocking put can strand this
            # batch at shutdown (resolver exits, put blocks forever, and a
            # late put races shutdown's drain).  Timing out and checking
            # _stop guarantees every in-flight request is either resolved
            # or failed.
            while True:
                try:
                    self._resolve_q.put(
                        (reqs, scores, rows, t_start, t_launched),
                        timeout=0.05,
                    )
                    break
                except queue.Full:
                    if self._stop.is_set():
                        raise RuntimeError(
                            "MicroBatcher shut down before resolving this "
                            "request"
                        )
            # A put that SUCCEEDS after shutdown's drain (worker was blocked
            # in a multi-minute device call while the joins timed out) would
            # otherwise sit unresolved until the HTTP timeout — the resolver
            # is gone.  Producer-side drain closes the window: anything
            # still queued post-stop gets failed here.
            if self._stop.is_set():
                self._fail_queued_resolves()
        except Exception as e:  # noqa: BLE001 — fail every waiter, keep serving
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)

    def _resolve_loop(self) -> None:
        while not self._stop.is_set():
            try:
                reqs, scores, rows, t_start, t_launched = self._resolve_q.get(
                    timeout=0.05
                )
            except queue.Empty:
                continue
            try:
                t_fetch0 = time.perf_counter()
                scores = np.asarray(scores)
                rows = np.asarray(rows)
                t_fetch1 = time.perf_counter()
                doc_ids = self.index.doc_ids
                n_live = len(doc_ids)
                for i, r in enumerate(reqs):
                    # Backends clamp k to capacity: ranks past the corpus
                    # carry pad-row indices (or -1 for IVF) with -inf scores
                    # — drop them (same filter as eval.py) instead of
                    # mis-mapping ids.
                    pairs = [
                        (doc_ids[j], float(s))
                        for j, s in zip(rows[i], scores[i])
                        if 0 <= j < n_live
                    ]
                    r.future.set_result(
                        ([p[0] for p in pairs], [p[1] for p in pairs])
                    )
                with self._stats_lock:
                    for r in reqs:
                        self._stages.append((
                            (t_start - r.t_submit) * 1e3,
                            (t_launched - t_start) * 1e3,
                            (t_fetch0 - t_launched) * 1e3,
                            (t_fetch1 - t_fetch0) * 1e3,
                            (t_fetch1 - r.t_submit) * 1e3,
                        ))
            except Exception as e:  # noqa: BLE001
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)


    STAGE_NAMES = ("queue_window", "dispatch", "resolve_wait",
                   "device_fetch", "total")

    def stage_summary(self, reset: bool = False) -> Dict[str, Dict[str, float]]:
        """Percentiles (ms) of each serving stage since the last reset.

        Stages sum to the server-side request latency:
        ``queue_window`` (admission -> its batch's dispatch starts, i.e.
        queue wait + coalescing window) + ``dispatch`` (trace lookup +
        async launch of ``search_batch``) + ``resolve_wait`` (two-deep
        pipeline handoff) + ``device_fetch`` (device compute + result
        transfer, the blocking ``np.asarray``) = ``total``.  The client
        additionally observes HTTP parse/network and future wakeup.
        """
        with self._stats_lock:
            rows = list(self._stages)
            if reset:
                self._stages.clear()
        if not rows:
            return {}
        arr = np.asarray(rows)  # [n, 5]
        out: Dict[str, Dict[str, float]] = {}
        for j, name in enumerate(self.STAGE_NAMES):
            col = arr[:, j]
            out[name] = {
                "p50_ms": round(float(np.percentile(col, 50)), 3),
                "p95_ms": round(float(np.percentile(col, 95)), 3),
                "mean_ms": round(float(col.mean()), 3),
            }
        out["n"] = int(arr.shape[0])  # type: ignore[assignment]
        return out


class SearchServer:
    """Stdlib HTTP JSON front end over a :class:`MicroBatcher`.

    Endpoints:
      ``POST /search``        {"vector": [...] | "text": "...", "k", "eta",
                               "entropy_pref"} → {"ids", "scores"}
      ``POST /search_batch``  {"queries": [ {...}, ... ]} → {"results": [...]}
      ``GET  /healthz``       {"docs", "dim", "queries", "dispatches", ...}

    Text queries require the index to carry encoder provenance (recorded by
    the pipeline at build time); the matching CLIP text tower is
    reconstructed once and shared.
    """

    def __init__(
        self,
        index: Any,
        host: str = "127.0.0.1",
        port: int = 0,
        window_ms: float = 2.0,
        max_batch: int = 256,
        max_pending: int = 4096,
        resolvers: int = 2,
    ) -> None:
        self.index = index
        self.batcher = MicroBatcher(index, window_ms=window_ms,
                                    max_batch=max_batch,
                                    max_pending=max_pending,
                                    resolvers=resolvers)
        self._encoder = None
        self._encoder_lock = threading.Lock()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt: str,
                            *args: Any) -> None:  # route through logging
                logger.debug("serve: " + fmt, *args)

            def _reply(self, code: int, payload: Dict[str, Any]) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:
                if self.path == "/healthz":
                    self._reply(200, server.health())
                elif self.path == "/stats_stages":
                    self._reply(200, server.batcher.stage_summary())
                else:
                    self._reply(404, {"error": "unknown path"})

            def do_POST(self) -> None:
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length) or b"{}")
                except Exception as e:  # noqa: BLE001
                    self._reply(400, {"error": f"bad JSON: {e}"})
                    return
                try:
                    if self.path == "/search":
                        self._reply(200, server.handle_search(req))
                    elif self.path == "/search_batch":
                        qs = req.get("queries", [])
                        futs = [server.submit_request(q) for q in qs]
                        self._reply(200, {"results": [
                            server._resolve(f) for f in futs
                        ]})
                    else:
                        self._reply(404, {"error": "unknown path"})
                except OverloadedError as e:
                    self._reply(429, {"error": str(e)})
                except ValueError as e:
                    self._reply(400, {"error": str(e)})
                except Exception as e:  # noqa: BLE001
                    logger.exception("serve: request failed")
                    self._reply(500, {"error": str(e)})

        # Stdlib default listen backlog is 5: a burst of concurrent clients
        # beyond it gets TCP RSTs before accept() runs.  Serving exists to
        # coalesce exactly such bursts — take a deep backlog.
        class _Server(ThreadingHTTPServer):
            request_queue_size = 128

        self.httpd = _Server((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )

    # -- request handling -------------------------------------------------------

    def submit_request(self, req: Dict[str, Any]) -> Future:
        if "vector" in req:
            q = np.asarray(req["vector"], np.float32)
        elif "text" in req:
            q = self.encode_text(str(req["text"]))
        else:
            raise ValueError("request needs 'vector' or 'text'")
        return self.batcher.submit(
            q,
            k=int(req.get("k", 10)),
            eta=req.get("eta"),
            entropy_pref=req.get("entropy_pref"),
        )

    #: Per-request result deadline.  Generous because a cold trace's first
    #: dispatch includes its jit compile; steady-state requests resolve in
    #: milliseconds, and overload is handled by admission shedding (429),
    #: not by this timeout.
    request_timeout_s: float = 600.0

    def _resolve(self, fut: Future) -> Dict[str, Any]:
        ids, scores = fut.result(timeout=self.request_timeout_s)
        return {"ids": ids, "scores": scores}

    def handle_search(self, req: Dict[str, Any]) -> Dict[str, Any]:
        return self._resolve(self.submit_request(req))

    def encode_text(self, text: str) -> np.ndarray:
        """Query encoder from the index's recorded provenance (built once)."""
        with self._encoder_lock:
            if self._encoder is None:
                import click

                from .cli import _query_encoder_for_index

                try:
                    self._encoder = _query_encoder_for_index(self.index)
                except click.ClickException as e:
                    # The CLI helper explains *why* text queries can't be
                    # served (external provenance, dim mismatch); surface
                    # that as a client error, not a leaked CLI exception.
                    raise ValueError(e.message) from None
        return self._encoder.encode_texts([text])[0]

    def health(self) -> Dict[str, Any]:
        with self.batcher._stats_lock:
            s = dict(self.batcher.stats)
        return {
            "docs": len(self.index),
            "dim": self.index.dim,
            "queries": int(s["queries"]),
            "dispatches": int(s["dispatches"]),
            "max_batch_seen": int(s["max_batch_seen"]),
            "shed": int(s["shed"]),
            "mean_batch": round(
                s["queries"] / s["dispatches"], 2
            ) if s["dispatches"] else 0.0,
        }

    # -- lifecycle ---------------------------------------------------------------

    def start(self) -> None:
        self._thread.start()
        logger.info("DEWI search server on port %d (%d docs)",
                    self.port, len(self.index))

    def serve_forever(self) -> None:
        self.start()
        self._thread.join()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.shutdown()


def retier_index(index: Any, backend: str) -> Any:
    """Re-tier a loaded index's stored corpus into a different backend.

    Serve an exact-saved index from the faster int8 (or IVF) tier without
    rebuilding artifacts on disk: the stored ids/embeddings/payloads
    re-ingest into the requested backend; search defaults, metadata, and
    encoder provenance carry over.  Returns ``index`` unchanged when it
    already uses the requested backend.
    """
    from .index import DewiIndex
    from .index.facade import IndexBackend

    want = IndexBackend.from_str(backend).resolve()
    if want is type(index._backend):
        return index
    store = index._backend.store
    retiered = DewiIndex(
        dim=index.dim, space=index.space, backend=backend,
        ef_query=index.ef_query, rerank_eta=index.rerank_eta,
        entropy_pref=index.entropy_pref,
    )
    retiered.add_batch(store.doc_ids, store.embedding_matrix(),
                       store.payload_matrix())
    retiered.encoder = index.encoder
    retiered._meta = dict(getattr(index, "_meta", {}))
    retiered.build()
    return retiered


__all__ = ["MicroBatcher", "OverloadedError", "SearchServer", "retier_index"]
