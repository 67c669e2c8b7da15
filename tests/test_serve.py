"""Micro-batched serving layer: batching semantics, HTTP endpoints,
correctness vs direct search, and error isolation."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from dewi.index import ExactIndex
from dewi.index.facade import DewiIndex
from dewi.serve import MicroBatcher, SearchServer, _bucket

N, DIM = 200, 16


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(N, DIM)).astype(np.float32)
    pay = rng.gamma(2.0, size=(N, 8)).astype(np.float32)
    idx = DewiIndex(dim=DIM, backend="exact")
    idx.add_batch([f"d{i}" for i in range(N)], emb, pay)
    idx.build()
    return idx


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=30
    ) as r:
        return json.loads(r.read())


class TestBucket:
    def test_powers_of_two(self):
        assert [_bucket(n, 256) for n in (1, 2, 3, 5, 9, 256, 999)] == [
            1, 2, 4, 8, 16, 256, 256,
        ]


class TestMicroBatcher:
    def test_matches_direct_search(self, index):
        mb = MicroBatcher(index, window_ms=1.0)
        try:
            rng = np.random.default_rng(1)
            q = rng.normal(size=DIM).astype(np.float32)
            ids, scores = mb.search(q, k=5, eta=0.25, entropy_pref=0.1)
            direct = index.search(q, k=5, eta=0.25, entropy_pref=0.1)
            assert ids == [r[0] for r in direct]
            np.testing.assert_allclose(
                scores, [r[1] for r in direct], rtol=1e-5
            )
        finally:
            mb.shutdown()

    def test_concurrent_requests_coalesce(self, index):
        mb = MicroBatcher(index, window_ms=25.0, max_batch=64)
        try:
            rng = np.random.default_rng(2)
            qs = rng.normal(size=(32, DIM)).astype(np.float32)
            futs = [mb.submit(q, k=3) for q in qs]
            results = [f.result(timeout=30) for f in futs]
            assert all(len(ids) == 3 for ids, _ in results)
            # All 32 queries shared params: they must have coalesced into
            # far fewer device dispatches than queries.
            assert mb.stats["dispatches"] < mb.stats["queries"]
            assert mb.stats["max_batch_seen"] > 1
            # Results identical to the solo path despite pad-to-bucket.
            s, r = index.search_batch(qs, k=3)
            want = np.asarray(r)
            for i, (ids, _) in enumerate(results):
                assert ids == [index.doc_ids[j] for j in want[i]]
        finally:
            mb.shutdown()

    def test_mixed_params_split(self, index):
        mb = MicroBatcher(index, window_ms=25.0)
        try:
            q = np.ones(DIM, np.float32)
            f1 = mb.submit(q, k=3, eta=0.0)
            f2 = mb.submit(q, k=3, eta=1.0)
            ids1, _ = f1.result(timeout=30)
            ids2, _ = f2.result(timeout=30)
            d1 = [r[0] for r in index.search(q, k=3, eta=0.0)]
            d2 = [r[0] for r in index.search(q, k=3, eta=1.0)]
            assert ids1 == d1 and ids2 == d2
        finally:
            mb.shutdown()

    def test_bad_shape_rejected(self, index):
        mb = MicroBatcher(index)
        try:
            with pytest.raises(ValueError):
                mb.submit(np.ones(DIM + 1, np.float32))
        finally:
            mb.shutdown()

    def test_overload_sheds_with_429_error(self, index):
        from dewi.serve import OverloadedError

        mb = MicroBatcher(index, window_ms=50.0, max_batch=4, max_pending=8)
        # Pause the worker by filling the admission queue faster than the
        # 50 ms window drains it; the 9th+ submissions must shed.
        q = np.ones(DIM, np.float32)
        futs = []
        shed = 0
        try:
            for _ in range(64):
                try:
                    futs.append(mb.submit(q, k=2))
                except OverloadedError:
                    shed += 1
            assert shed > 0
            with mb._stats_lock:
                assert mb.stats["shed"] == shed
            # Admitted requests still complete correctly.
            for f in futs:
                ids, _ = f.result(timeout=30)
                assert len(ids) == 2
        finally:
            mb.shutdown()

    def test_shutdown_never_strands_in_flight_requests(self, index):
        # Round-3 review finding: with two batches in flight at shutdown
        # (one queued for resolution, the worker blocked on the full
        # resolve queue), the late put could race shutdown's drain and
        # strand futures until the HTTP timeout.  Every submitted future
        # must complete (result or shutdown error) promptly.
        rng = np.random.default_rng(5)
        for trial in range(10):
            mb = MicroBatcher(index, window_ms=0.1, max_batch=2)
            futures = [
                mb.submit(rng.normal(size=DIM).astype(np.float32), k=3)
                for _ in range(32)
            ]
            time.sleep(0.002 * trial)  # vary how many batches are in flight
            mb.shutdown()
            for f in futures:
                try:
                    f.result(timeout=10)  # stranded -> this raises Timeout
                except RuntimeError:
                    pass  # shutdown error is the other legal outcome

    def test_pipelined_resolution_preserves_order_and_results(self, index):
        # Dispatch is now two-deep (device launch decoupled from host
        # fetch); results must still match direct search per request.
        mb = MicroBatcher(index, window_ms=1.0, max_batch=16)
        try:
            rng = np.random.default_rng(9)
            qs = rng.normal(size=(40, DIM)).astype(np.float32)
            futs = [mb.submit(q, k=4) for q in qs]
            for q, f in zip(qs, futs):
                ids, _ = f.result(timeout=30)
                assert ids == [r[0] for r in index.search(q, k=4)]
        finally:
            mb.shutdown()


class TestSearchServer:
    @pytest.fixture(scope="class")
    def server(self, index):
        srv = SearchServer(index, port=0, window_ms=5.0)
        srv.start()
        yield srv
        srv.shutdown()

    def test_vector_search(self, server, index):
        q = np.random.default_rng(3).normal(size=DIM).astype(np.float32)
        out = _post(server.port, "/search",
                    {"vector": q.tolist(), "k": 4, "eta": 0.25})
        direct = index.search(q, k=4, eta=0.25)
        assert out["ids"] == [r[0] for r in direct]
        assert len(out["scores"]) == 4

    def test_search_batch_endpoint(self, server):
        rng = np.random.default_rng(4)
        payload = {"queries": [
            {"vector": rng.normal(size=DIM).tolist(), "k": 2}
            for _ in range(6)
        ]}
        out = _post(server.port, "/search_batch", payload)
        assert len(out["results"]) == 6
        assert all(len(r["ids"]) == 2 for r in out["results"])

    def test_healthz(self, server):
        h = _get(server.port, "/healthz")
        assert h["docs"] == N and h["dim"] == DIM
        assert h["queries"] >= 1 and h["dispatches"] >= 1

    def test_bad_request_isolated(self, server, index):
        # Malformed request errors without poisoning the server.
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/search",
            data=b"{not json", headers={"Content-Type": "application/json"},
        )
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 400
        # Missing query key -> 400 too.
        req2 = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/search",
            data=json.dumps({"k": 3}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with pytest.raises(urllib.error.HTTPError) as e2:
            urllib.request.urlopen(req2, timeout=30)
        assert e2.value.code == 400
        # Server still answers afterwards.
        q = np.ones(DIM, np.float32)
        out = _post(server.port, "/search", {"vector": q.tolist(), "k": 2})
        assert len(out["ids"]) == 2

    def test_concurrent_http_load(self, server, index):
        rng = np.random.default_rng(5)
        qs = rng.normal(size=(24, DIM)).astype(np.float32)
        results = [None] * len(qs)

        def hit(i):
            results[i] = _post(server.port, "/search",
                               {"vector": qs[i].tolist(), "k": 3})

        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(len(qs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        _, rows = index.search_batch(qs, k=3)
        rows = np.asarray(rows)
        for i, out in enumerate(results):
            assert out is not None
            assert out["ids"] == [index.doc_ids[j] for j in rows[i]]


class TestServeRetier:
    def test_retier_index_helper(self, tmp_path):
        """retier_index (the function the CLI --backend flag calls)."""
        import numpy as np

        from dewi.index import DewiIndex
        from dewi.index.quantized import QuantizedIndex
        from dewi.serve import retier_index
        from dewi.types import Payload

        rng = np.random.default_rng(0)
        n, d = 64, 16
        idx = DewiIndex(dim=d, backend="exact", rerank_eta=0.4)
        pay = [Payload(dewi=float(x)) for x in rng.uniform(size=n)]
        idx.add_batch([str(i) for i in range(n)],
                      rng.normal(size=(n, d)).astype(np.float32), pay)
        idx.encoder = {"source": "external"}
        idx._meta["0"] = {"k": "v"}
        idx.build()
        idx.save(tmp_path / "idx")

        loaded = DewiIndex.load(tmp_path / "idx")
        retiered = retier_index(loaded, "quantized")
        assert isinstance(retiered._backend, QuantizedIndex)
        assert retiered.encoder == loaded.encoder
        assert retiered.rerank_eta == loaded.rerank_eta
        # no-op when the backend already matches
        assert retier_index(retiered, "quantized") is retiered
        q = rng.normal(size=d).astype(np.float32)
        a = [i for i, _s, _p in loaded.search(q, k=5, eta=0.3)]
        b = [i for i, _s, _p in retiered.search(q, k=5, eta=0.3)]
        assert len(set(a) & set(b)) >= 4


class TestSmallCorpusK:
    def test_k_exceeding_corpus_filters_pad_rows(self):
        """Regression: k > corpus must not map pad-row indices to doc ids."""
        import numpy as np

        from dewi.index import DewiIndex
        from dewi.serve import MicroBatcher
        from dewi.types import Payload

        rng = np.random.default_rng(0)
        n, d = 5, 8
        idx = DewiIndex(dim=d, backend="exact")
        idx.add_batch([f"x{i}" for i in range(n)],
                      rng.normal(size=(n, d)).astype(np.float32),
                      [Payload(dewi=0.5)] * n)
        idx.build()
        b = MicroBatcher(idx, window_ms=1.0)
        try:
            ids, scores = b.search(rng.normal(size=d).astype(np.float32),
                                   k=10)
            assert len(ids) == n  # only real docs, no pad ids
            assert all(i.startswith("x") for i in ids)
            assert all(np.isfinite(s) for s in scores)
        finally:
            b.shutdown()


class TestStageInstrumentation:
    """stage_summary / GET /stats_stages (VERDICT r4 weak #4): the always-on
    per-request stage ring must explain the served latency."""

    def test_stage_summary_rows_sum_to_total(self, index):
        mb = MicroBatcher(index, window_ms=1.0)
        try:
            rng = np.random.default_rng(3)
            for i in range(12):
                mb.search(rng.normal(size=DIM).astype(np.float32), k=3,
                          eta=0.2, entropy_pref=0.0)
            summ = mb.stage_summary()
        finally:
            mb.shutdown()
        assert set(summ) == set(MicroBatcher.STAGE_NAMES) | {"n"}
        assert summ["n"] == 12
        for name in MicroBatcher.STAGE_NAMES:
            row = summ[name]
            assert 0.0 <= row["p50_ms"] <= row["p95_ms"]
            assert row["mean_ms"] >= 0.0
        # Stage p50s are medians so they don't sum exactly; means do
        # (total is stamped as the sum of the four component stamps).
        comp = sum(summ[s]["mean_ms"] for s in MicroBatcher.STAGE_NAMES
                   if s != "total")
        assert comp == pytest.approx(summ["total"]["mean_ms"],
                                     rel=0.05, abs=0.01)

    def test_stage_summary_reset(self, index):
        mb = MicroBatcher(index, window_ms=1.0)
        try:
            mb.search(np.ones(DIM, np.float32), k=3)
            assert mb.stage_summary(reset=True)["n"] == 1
            assert mb.stage_summary() == {}
        finally:
            mb.shutdown()

    def test_stats_stages_endpoint(self, index):
        server = SearchServer(index, port=0, window_ms=1.0)
        server.start()
        try:
            port = server.port
            _post(port, "/search", {"vector": [1.0] * DIM, "k": 3})
            stages = _get(port, "/stats_stages")
            assert stages["n"] >= 1
            assert set(stages) == set(MicroBatcher.STAGE_NAMES) | {"n"}
        finally:
            server.shutdown()
