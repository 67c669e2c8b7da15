"""Quantized (int8 two-stage) index tests: recall vs exact, API parity."""

import numpy as np
import pytest

from dewi import DewiIndex
from dewi.index import ExactIndex, QuantizedIndex
from dewi.metrics import recall_matrix
from dewi.ops.quantized import quantize_rows


def make_corpus(n=512, d=64, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    pay = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
    pay[:, 0] = rng.beta(2, 2, n)
    ids = [str(i) for i in range(n)]
    return ids, emb, pay


class TestQuantizeRows:
    def test_roundtrip_error_small(self):
        x = np.random.default_rng(0).normal(size=(32, 64)).astype(np.float32)
        q, s = quantize_rows(x)
        recon = np.asarray(q, dtype=np.float32) * np.asarray(s)[:, None]
        rel = np.abs(recon - x).max() / np.abs(x).max()
        assert rel < 0.01  # int8: ~1/254 worst-case per row

    def test_zero_rows(self):
        x = np.zeros((4, 8), np.float32)
        q, s = quantize_rows(x)
        assert np.all(np.asarray(q) == 0)
        assert np.all(np.asarray(s) == 0)

    def test_range(self):
        x = np.random.default_rng(1).normal(size=(16, 32)).astype(np.float32)
        q, _ = quantize_rows(x)
        q = np.asarray(q)
        assert q.dtype == np.int8
        assert q.min() >= -127 and q.max() <= 127


class TestQuantizedIndex:
    @pytest.fixture(scope="class")
    def corpus(self):
        return make_corpus()

    def test_recall_vs_exact(self, corpus):
        ids, emb, pay = corpus
        exact = ExactIndex(dim=64)
        exact.add_batch(ids, emb, pay)
        exact.build()
        quant = QuantizedIndex(dim=64, refine_factor=8)
        quant.add_batch(ids, emb, pay)
        quant.build()
        q = np.random.default_rng(7).normal(size=(32, 64)).astype(np.float32)
        _, ei = exact.search_batch(q, k=10, eta=0.25, entropy_pref=0.1)
        _, qi = quant.search_batch(q, k=10, eta=0.25, entropy_pref=0.1)
        rec = recall_matrix(np.asarray(qi), np.asarray(ei))
        assert rec >= 0.99

    def test_int8_queries_recall(self, corpus):
        """s8xs8 stage-1 (query quantized too): stage-2 f32 refinement
        keeps recall vs exact at the gate despite the extra rounding."""
        ids, emb, pay = corpus
        exact = ExactIndex(dim=64)
        exact.add_batch(ids, emb, pay)
        exact.build()
        quant = QuantizedIndex(dim=64, refine_factor=8, int8_queries=True)
        quant.add_batch(ids, emb, pay)
        quant.build()
        q = np.random.default_rng(7).normal(size=(32, 64)).astype(np.float32)
        _, ei = exact.search_batch(q, k=10, eta=0.25, entropy_pref=0.1)
        _, qi = quant.search_batch(q, k=10, eta=0.25, entropy_pref=0.1)
        rec = recall_matrix(np.asarray(qi), np.asarray(ei))
        assert rec >= 0.99
        # Overlapping hits still score exactly (stage-2 is f32).
        er = exact.search(q[0], k=5, eta=0.25, entropy_pref=0.1)
        qr = quant.search(q[0], k=5, eta=0.25, entropy_pref=0.1)
        e_by_id = {d: s for d, s, _ in er}
        for d, s, _ in qr:
            if d in e_by_id:
                assert s == pytest.approx(e_by_id[d], abs=1e-5)

    def test_bf16_scores_recall(self, corpus):
        """bf16 stage-1 score matrix: f32 stage-2 refinement keeps recall
        at the gate despite bf16 rounding of the candidate selection, and
        also under L2 (the per-query column correction must stay bf16)."""
        ids, emb, pay = corpus
        q = np.random.default_rng(7).normal(size=(32, 64)).astype(np.float32)
        for space in ("cosine", "l2"):
            exact = ExactIndex(dim=64, space=space)
            exact.add_batch(ids, emb, pay)
            exact.build()
            quant = QuantizedIndex(dim=64, space=space, refine_factor=8,
                                   bf16_scores=True)
            quant.add_batch(ids, emb, pay)
            quant.build()
            _, ei = exact.search_batch(q, k=10, eta=0.25, entropy_pref=0.1)
            _, qi = quant.search_batch(q, k=10, eta=0.25, entropy_pref=0.1)
            rec = recall_matrix(np.asarray(qi), np.asarray(ei))
            assert rec >= 0.99, space
        # Overlapping hits still score exactly (stage-2 is f32).
        er = exact.search(q[0], k=5, eta=0.25, entropy_pref=0.1)
        qr = quant.search(q[0], k=5, eta=0.25, entropy_pref=0.1)
        e_by_id = {d: s for d, s, _ in er}
        for d, s, _ in qr:
            if d in e_by_id:
                assert s == pytest.approx(e_by_id[d], abs=1e-5)

    def test_blockmax_select_matches_exact_selection(self, corpus):
        """blockmax selection is exact w.r.t. stage-1 scores: on a corpus
        whose capacity is a 128-multiple, its top-k ids must equal the
        m=capacity exact-selection path's (both refine in f32), in both
        spaces and with int8 queries."""
        from dewi.ops.quantized import quantize_rows, quantized_search
        import jax.numpy as jnp

        ids, emb, pay = corpus
        q = np.random.default_rng(7).normal(size=(8, 64)).astype(np.float32)
        for space in ("cosine", "l2"):
            for i8q in (False, True):
                exact_sel = QuantizedIndex(dim=64, space=space,
                                           refine_factor=10**9,
                                           approx_select=False,
                                           int8_queries=i8q)
                exact_sel.add_batch(ids, emb, pay)
                exact_sel.build()
                bm = QuantizedIndex(dim=64, space=space, refine_factor=8,
                                    blockmax_select=True, int8_queries=i8q)
                bm.add_batch(ids, emb, pay)
                bm.build()
                assert bm.store.capacity % 128 == 0  # blockmax path taken
                ve, ie = exact_sel.search_batch(q, k=10, eta=0.25,
                                                entropy_pref=0.1)
                vb, ib = bm.search_batch(q, k=10, eta=0.25, entropy_pref=0.1)
                np.testing.assert_array_equal(np.asarray(ie), np.asarray(ib))
                np.testing.assert_allclose(np.asarray(ve), np.asarray(vb),
                                           rtol=1e-5)

    def test_blockmax_select_recall_and_roundtrip(self, corpus, tmp_path):
        ids, emb, pay = corpus
        exact = ExactIndex(dim=64)
        exact.add_batch(ids, emb, pay)
        exact.build()
        bm = QuantizedIndex(dim=64, refine_factor=8, blockmax_select=True)
        bm.add_batch(ids, emb, pay)
        bm.build()
        q = np.random.default_rng(7).normal(size=(32, 64)).astype(np.float32)
        _, ei = exact.search_batch(q, k=10, eta=0.25, entropy_pref=0.1)
        _, bi = bm.search_batch(q, k=10, eta=0.25, entropy_pref=0.1)
        assert recall_matrix(np.asarray(bi), np.asarray(ei)) >= 0.99
        bm.save(tmp_path / "ix")
        back = QuantizedIndex.load(tmp_path / "ix")
        assert back.blockmax_select is True
        _, i1 = back.search_batch(q[:3], k=5)
        _, i0 = bm.search_batch(q[:3], k=5)
        np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))

    def test_blockmax_select_is_the_default(self):
        """The headline selection tier ships ON by default: it beats the
        approx_max_k fallback on BOTH latency and recall where its shape
        gates hold, and quantized_search falls back automatically when
        they don't (misaligned capacity); above BLOCKMAX_REFINE_MAX_Q it
        switches to the score-gather refine instead of falling back."""
        from dewi.config import IndexConfig

        assert QuantizedIndex(dim=16).blockmax_select is True
        assert IndexConfig().blockmax_select is True

    def test_small_corpus_uses_exact_selection(self, corpus):
        """Below APPROX_SELECT_MIN_CAP, approx_select=True must route
        through exact top_k (approx_max_k's coarse reduction measured
        0.987 recall on a 6k corpus at Q=100 — under the 0.99 gate —
        while exact selection is ~free at that size)."""
        from dewi.ops.quantized import APPROX_SELECT_MIN_CAP

        ids, emb, pay = corpus
        exact = ExactIndex(dim=64)
        exact.add_batch(ids, emb, pay)
        exact.build()
        quant = QuantizedIndex(dim=64, refine_factor=8)  # approx default
        quant.add_batch(ids, emb, pay)
        quant.build()
        assert quant.store.capacity <= APPROX_SELECT_MIN_CAP
        q = np.random.default_rng(11).normal(size=(100, 64)).astype(
            np.float32)
        _, ei = exact.search_batch(q, k=10, eta=0.25, entropy_pref=0.1)
        _, qi = quant.search_batch(q, k=10, eta=0.25, entropy_pref=0.1)
        # exact selection + f32 refine: recall vs exact is 1.0 up to int8
        # stage-1 ties; assert well above the gate approx was missing.
        assert recall_matrix(np.asarray(qi), np.asarray(ei)) >= 0.995

    def test_blockmax_large_batch_score_gather(self, corpus):
        """Q>32 batches take the score-gather refine (winning blocks'
        stage-1 scores -> top-m -> m-row refine): refine traffic matches
        the flat path instead of growing s*128 rows/query, selection
        still covers the stage-1 top-(k+2).  Must hold the recall gate
        and agree with the small-Q block-granular variant on the
        leaders."""
        ids, emb, pay = corpus
        exact = ExactIndex(dim=64)
        exact.add_batch(ids, emb, pay)
        exact.build()
        bm = QuantizedIndex(dim=64, refine_factor=8, blockmax_select=True)
        bm.add_batch(ids, emb, pay)
        bm.build()
        q = np.random.default_rng(9).normal(size=(64, 64)).astype(np.float32)
        _, ei = exact.search_batch(q, k=10, eta=0.25, entropy_pref=0.1)
        sb, bi = bm.search_batch(q, k=10, eta=0.25, entropy_pref=0.1)
        assert recall_matrix(np.asarray(bi), np.asarray(ei)) >= 0.99
        # Per-query agreement with the small-Q (block-granular) variant:
        # same selection tier, different refine gather — leaders must
        # match and scores must be the same f32 stage-2 values.
        for start in (0, 32):
            ss, si = bm.search_batch(q[start:start + 32], k=10, eta=0.25,
                                     entropy_pref=0.1)
            np.testing.assert_array_equal(
                np.asarray(si)[:, 0], np.asarray(bi)[start:start + 32, 0])
            np.testing.assert_allclose(
                np.asarray(ss)[:, 0], np.asarray(sb)[start:start + 32, 0],
                rtol=1e-6)

    def test_bf16_scores_roundtrip(self, corpus, tmp_path):
        ids, emb, pay = corpus
        quant = QuantizedIndex(dim=64, bf16_scores=True)
        quant.add_batch(ids, emb, pay)
        quant.build()
        quant.save(tmp_path / "ix")
        back = QuantizedIndex.load(tmp_path / "ix")
        assert back.bf16_scores is True
        q = np.random.default_rng(1).normal(size=(3, 64)).astype(np.float32)
        _, i0 = quant.search_batch(q, k=5)
        _, i1 = back.search_batch(q, k=5)
        np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))

    def test_int8_queries_roundtrip(self, corpus, tmp_path):
        ids, emb, pay = corpus
        quant = QuantizedIndex(dim=64, int8_queries=True)
        quant.add_batch(ids, emb, pay)
        quant.build()
        quant.save(tmp_path / "ix")
        back = QuantizedIndex.load(tmp_path / "ix")
        assert back.int8_queries is True
        q = np.random.default_rng(1).normal(size=(3, 64)).astype(np.float32)
        v0, i0 = quant.search_batch(q, k=5)
        v1, i1 = back.search_batch(q, k=5)
        np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))

    def test_scores_close_to_exact(self, corpus):
        ids, emb, pay = corpus
        exact = ExactIndex(dim=64)
        exact.add_batch(ids, emb, pay)
        exact.build()
        quant = QuantizedIndex(dim=64, refine_factor=8)
        quant.add_batch(ids, emb, pay)
        quant.build()
        q = np.random.default_rng(3).normal(size=64).astype(np.float32)
        er = exact.search(q, k=5, eta=0.3, entropy_pref=0.05)
        qr = quant.search(q, k=5, eta=0.3, entropy_pref=0.05)
        # Stage-2 scores are exact f32, so overlapping hits score identically.
        e_by_id = {d: s for d, s, _ in er}
        for d, s, _ in qr:
            if d in e_by_id:
                assert s == pytest.approx(e_by_id[d], abs=1e-5)

    def test_search_result_shape(self, corpus):
        ids, emb, pay = corpus
        quant = QuantizedIndex(dim=64)
        quant.add_batch(ids, emb, pay)
        quant.build()
        res = quant.search(np.ones(64, np.float32), k=7)
        assert len(res) == 7
        doc_id, score, payload = res[0]
        assert isinstance(doc_id, str) and isinstance(score, float)

    def test_k_exceeds_corpus(self):
        ids, emb, pay = make_corpus(n=5, d=16)
        quant = QuantizedIndex(dim=16)
        quant.add_batch(ids, emb, pay)
        quant.build()
        res = quant.search(np.ones(16, np.float32), k=50)
        assert len(res) == 5

    def test_empty_index(self):
        quant = QuantizedIndex(dim=8)
        assert quant.search(np.ones(8, np.float32), k=3) == []
        with pytest.raises(ValueError):
            quant.build()

    def test_facade_backend_names(self, corpus):
        ids, emb, pay = corpus
        for name in ("quantized", "int8", "scann"):
            idx = DewiIndex(dim=64, backend=name)
            assert isinstance(idx._backend, QuantizedIndex)
        idx = DewiIndex(dim=64, backend="quantized", refine_factor=4)
        idx.add_batch(ids, emb, pay)
        idx.build()
        res = idx.search(np.ones(64, np.float32), k=3)
        assert len(res) == 3

    def test_save_load_roundtrip(self, corpus, tmp_path):
        ids, emb, pay = corpus
        idx = DewiIndex(dim=64, backend="quantized")
        idx.add_batch(ids, emb, pay)
        idx.build()
        q = np.random.default_rng(5).normal(size=64).astype(np.float32)
        before = [d for d, _, _ in idx.search(q, k=5)]
        idx.save(tmp_path / "qidx")
        loaded = DewiIndex.load(tmp_path / "qidx")
        assert isinstance(loaded._backend, QuantizedIndex)
        after = [d for d, _, _ in loaded.search(q, k=5)]
        assert before == after

    def test_l2_space(self):
        ids, emb, pay = make_corpus(n=128, d=32, seed=2)
        exact = ExactIndex(dim=32, space="l2")
        exact.add_batch(ids, emb, pay)
        exact.build()
        quant = QuantizedIndex(dim=32, space="l2", refine_factor=8)
        quant.add_batch(ids, emb, pay)
        quant.build()
        q = np.random.default_rng(9).normal(size=(8, 32)).astype(np.float32)
        _, ei = exact.search_batch(q, k=5, eta=0.0, entropy_pref=0.0)
        _, qi = quant.search_batch(q, k=5, eta=0.0, entropy_pref=0.0)
        assert recall_matrix(np.asarray(qi), np.asarray(ei)) >= 0.95
