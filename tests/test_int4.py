"""int4 (nibble-packed) quantized tier tests.

Covers the packing contract (ops/quantized.quantize_rows_int4 /
unpack_int4), the Pallas s4 streaming kernels in interpret mode against
numpy oracles, and quantized_search(int4_packed=True) across the XLA
fallback, the streamed scores kernel, the fused stage-1+blockmax kernel,
and the chunked large-batch dispatch — each asserted EXACTLY equal to the
equivalent search over the XLA-unpacked corpus (the integer stage-1 math
is identical; only the HBM layout differs).

Reference workload being accelerated: the reference's ANN query path
(reference src/dewi/backends.py:166-383); int4 is the storage tier below
the int8 ScaNN-style two-stage (docs/DESIGN.md round-4 section: stage 1
is HBM-bound, so halved bytes is the remaining headline lever).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dewi.ops.quantized import (
    quantize_rows,
    quantize_rows_int4,
    quantized_search,
    unpack_int4,
)
from dewi.ops.similarity import l2_normalize


def _unpack_np(packed: np.ndarray) -> np.ndarray:
    """Numpy oracle for the nibble layout (independent of the jnp impl)."""
    b = packed.astype(np.int32)
    hi = b >> 4  # arithmetic shift: low bits are non-negative by contract
    lo = (b & 15) - 8
    return np.concatenate([hi, lo], axis=-1).astype(np.int8)


class TestInt4Pack:
    def test_roundtrip_values(self):
        x = np.random.default_rng(0).normal(size=(32, 64)).astype(np.float32)
        packed, s = quantize_rows_int4(x)
        packed, s = np.asarray(packed), np.asarray(s)
        assert packed.shape == (32, 32) and packed.dtype == np.int8
        vals = _unpack_np(packed)
        assert vals.min() >= -7 and vals.max() <= 7
        # Per-row symmetric grid: values == round(x / scale), clipped.
        expect = np.clip(np.round(x / s[:, None]), -7, 7).astype(np.int8)
        np.testing.assert_array_equal(vals, expect)
        # jnp unpack agrees with the numpy oracle.
        np.testing.assert_array_equal(np.asarray(unpack_int4(packed)), vals)

    def test_reconstruction_error_bound(self):
        x = np.random.default_rng(1).normal(size=(16, 128)).astype(np.float32)
        packed, s = quantize_rows_int4(x)
        recon = _unpack_np(np.asarray(packed)).astype(np.float32) \
            * np.asarray(s)[:, None]
        rel = np.abs(recon - x).max() / np.abs(x).max()
        assert rel < 1.0 / 13.0  # half-step of the 15-level grid (+ eps)

    def test_zero_rows(self):
        x = np.zeros((4, 8), np.float32)
        packed, s = quantize_rows_int4(x)
        assert np.all(np.asarray(s) == 0)
        assert np.all(_unpack_np(np.asarray(packed)) == 0)

    def test_dimension_order_preserved(self):
        # Column j must unpack back to column j (the plane split packs
        # dim j with dim j + D/2 but concatenation restores order).
        x = np.zeros((1, 8), np.float32)
        x[0] = [7, 6, 5, 4, -3, -2, -1, 0]
        packed, s = quantize_rows_int4(x)
        vals = _unpack_np(np.asarray(packed)).astype(np.float32)
        np.testing.assert_allclose(vals[0] * np.asarray(s)[0], x[0],
                                   atol=np.asarray(s)[0] / 2 + 1e-6)
        order = np.argsort(-vals[0])
        np.testing.assert_array_equal(order, np.argsort(-x[0]))


def _mk(cap=2048, d=32, nq=3, seed=11):
    rng = np.random.default_rng(seed)
    emb = np.asarray(l2_normalize(
        jnp.asarray(rng.normal(size=(cap, d)).astype(np.float32))))
    pay = np.abs(rng.normal(size=(cap, 8))).astype(np.float32)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    sqn = np.sum(emb * emb, axis=1).astype(np.float32)
    return emb, pay, q, sqn


class TestS4KernelsInterpret:
    def test_bmax_s4_masks_padding_rows(self):
        from dewi.ops.pallas_search import pallas_bmax

        rng = np.random.default_rng(21)
        cap, d, nq = 1024, 64, 3
        vals = rng.integers(-7, 8, size=(cap, d)).astype(np.int8)
        packed = (vals[:, : d // 2] * 16
                  + (vals[:, d // 2:] + 8)).astype(np.int8)
        mult = rng.uniform(0.5, 1.5, size=cap).astype(np.float32)
        add = rng.normal(size=cap).astype(np.float32)
        add[896:] = -np.inf
        q8 = rng.integers(-127, 128, size=(nq, d)).astype(np.int8)
        qs = rng.uniform(0.01, 0.1, size=nq).astype(np.float32)
        got = np.asarray(pallas_bmax(
            jnp.asarray(packed), jnp.asarray(mult), jnp.asarray(add),
            jnp.asarray(q8), jnp.asarray(qs), mode="s4", interpret=True))
        acc = q8.astype(np.int64) @ vals.astype(np.int64).T
        ref = (acc.astype(np.float32) * (qs[:, None] * mult[None, :])
               + add[None, :]).reshape(nq, cap // 128, 128).max(-1)
        np.testing.assert_allclose(got[:, :7], ref[:, :7],
                                   rtol=1e-5, atol=1e-5)
        assert np.all(np.isneginf(got[:, 7:]))

    def test_bmax_s4_matches_oracle(self):
        from dewi.ops.pallas_search import pallas_bmax

        rng = np.random.default_rng(22)
        cap, d, nq, sub = 2048, 64, 2, 128
        vals = rng.integers(-7, 8, size=(cap, d)).astype(np.int8)
        packed = (vals[:, : d // 2] * 16
                  + (vals[:, d // 2:] + 8)).astype(np.int8)
        mult = rng.uniform(0.5, 1.5, size=cap).astype(np.float32)
        add = rng.normal(size=cap).astype(np.float32)
        q8 = rng.integers(-127, 128, size=(nq, d)).astype(np.int8)
        qs = rng.uniform(0.01, 0.1, size=nq).astype(np.float32)
        got = np.asarray(pallas_bmax(
            jnp.asarray(packed), jnp.asarray(mult), jnp.asarray(add),
            jnp.asarray(q8), jnp.asarray(qs), mode="s4", interpret=True))
        acc = q8.astype(np.int64) @ vals.astype(np.int64).T
        adj = (acc.astype(np.float32) * (qs[:, None] * mult[None, :])
               + add[None, :])
        ref = adj.reshape(nq, cap // sub, sub).max(axis=-1)
        assert got.shape == (nq, cap // sub)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


class TestInt4QuantizedSearch:
    def _search(self, emb, pay, q, sqn, n, **kw):
        e4, sc = quantize_rows_int4(jnp.asarray(emb))
        base = dict(k=10, m=128, normalize=True)
        base.update(kw)
        return quantized_search(
            e4, sc, jnp.asarray(emb), jnp.asarray(sqn), jnp.asarray(pay),
            jnp.asarray(q), jnp.int32(n), jnp.float32(0.3),
            jnp.float32(0.1), int4_packed=True, **base)

    def _search_unpacked(self, emb, pay, q, sqn, n, **kw):
        # Same int4 VALUES and scales, pre-unpacked to [cap, D] int8 —
        # the math oracle for every int4_packed code path.
        e4, sc = quantize_rows_int4(jnp.asarray(emb))
        base = dict(k=10, m=128, normalize=True)
        base.update(kw)
        return quantized_search(
            unpack_int4(e4), sc, jnp.asarray(emb), jnp.asarray(sqn),
            jnp.asarray(pay), jnp.asarray(q), jnp.int32(n),
            jnp.float32(0.3), jnp.float32(0.1), int4_values=True, **base)

    def test_xla_fallback_matches_unpacked(self):
        # No kernel: int4_packed unpacks via XLA up front; must bit-match
        # the search over the pre-unpacked corpus.
        emb, pay, q, sqn = _mk()
        for i8q in (False, True):
            kw = dict(int8_queries=i8q)
            s_p, i_p = self._search(emb, pay, q, sqn, 1900, **kw)
            s_u, i_u = self._search_unpacked(emb, pay, q, sqn, 1900, **kw)
            np.testing.assert_array_equal(np.asarray(i_p), np.asarray(i_u))
            np.testing.assert_allclose(np.asarray(s_p), np.asarray(s_u),
                                       rtol=1e-6)

    def test_scores_kernel_path_matches_unpacked(self):
        # The kernel serves blockmax selection only: with blockmax off a
        # kernel request takes the XLA path, which must bit-match the
        # unpacked s8 path.
        emb, pay, q, sqn = _mk(seed=13)
        s_p, i_p = self._search(
            emb, pay, q, sqn, 1900, bmax_kernel=True, int8_queries=True,
            interpret=True, approx_select=False)
        s_u, i_u = self._search_unpacked(
            emb, pay, q, sqn, 1900, int8_queries=True, approx_select=False)
        np.testing.assert_array_equal(np.asarray(i_p), np.asarray(i_u))
        np.testing.assert_allclose(np.asarray(s_p), np.asarray(s_u),
                                   rtol=1e-6)

    def test_fused_bmax_matches_unpacked(self):
        # The headline int4 path: the fused s4 stage-1+blockmax kernel
        # reading packed nibbles.
        emb, pay, q, sqn = _mk(seed=17)
        kw = dict(int8_queries=True, blockmax_select=True)
        s_p, i_p = self._search(
            emb, pay, q, sqn, 1900, bmax_kernel=True, interpret=True, **kw)
        s_u, i_u = self._search_unpacked(emb, pay, q, sqn, 1900, **kw)
        np.testing.assert_array_equal(np.asarray(i_p), np.asarray(i_u))
        np.testing.assert_allclose(np.asarray(s_p), np.asarray(s_u),
                                   rtol=1e-6)

    def test_fused_bmax_large_batch_chunks(self):
        # Q > BLOCKMAX_REFINE_MAX_Q: the kernel runs the whole batch (the
        # query axis is a grid axis) and the winning blocks are re-scored
        # from the packed rows; must match the unpacked two-pass path.
        from dewi.ops.quantized import BLOCKMAX_REFINE_MAX_Q

        nq = BLOCKMAX_REFINE_MAX_Q + 8
        emb, pay, q, sqn = _mk(nq=nq, seed=19)
        kw = dict(int8_queries=True, blockmax_select=True)
        s_b, i_b = self._search(
            emb, pay, q, sqn, 1900, bmax_kernel=True, interpret=True, **kw)
        s_u, i_u = self._search_unpacked(emb, pay, q, sqn, 1900, **kw)
        np.testing.assert_array_equal(np.asarray(i_b), np.asarray(i_u))
        np.testing.assert_allclose(np.asarray(s_b), np.asarray(s_u),
                                   rtol=1e-6)

    def test_bf16_queries_unpacks_transparently(self):
        # int8_queries=False has no s4 kernel mode: must transparently
        # unpack and still return the bf16-query results.
        emb, pay, q, sqn = _mk(seed=23)
        s_p, i_p = self._search(
            emb, pay, q, sqn, 1900, bmax_kernel=True, int8_queries=False,
            blockmax_select=True, interpret=True)
        s_u, i_u = self._search_unpacked(
            emb, pay, q, sqn, 1900, int8_queries=False, blockmax_select=True)
        np.testing.assert_array_equal(np.asarray(i_p), np.asarray(i_u))

    def test_recall_vs_f32_exact(self):
        # End-to-end gate: int4 stage-1 + wide refine recovers the f32
        # exact top-k.  m=4x the int8 tier's default absorbs the coarser
        # grid (docstring contract; bench gates the 1M shape the same way).
        from dewi.metrics import recall_matrix
        from dewi.ops.similarity import fused_search

        emb, pay, q, sqn = _mk(cap=4096, nq=32, seed=29)
        n = 4000
        _, i_e = fused_search(
            jnp.asarray(emb), jnp.asarray(sqn), jnp.asarray(pay),
            jnp.asarray(q), jnp.int32(n), jnp.float32(0.3),
            jnp.float32(0.1), k=10)
        _, i_4 = self._search(emb, pay, q, sqn, n, m=320,
                              int8_queries=True)
        rec = recall_matrix(np.asarray(i_4), np.asarray(i_e))
        assert rec >= 0.97


class TestInt4Index:
    @pytest.fixture(scope="class")
    def corpus(self):
        rng = np.random.default_rng(31)
        emb = rng.normal(size=(512, 64)).astype(np.float32)
        pay = np.abs(rng.normal(size=(512, 8))).astype(np.float32)
        pay[:, 0] = rng.beta(2, 2, 512)
        return [str(i) for i in range(512)], emb, pay

    def test_recall_vs_exact(self, corpus):
        from dewi.index import ExactIndex, QuantizedIndex
        from dewi.metrics import recall_matrix

        ids, emb, pay = corpus
        exact = ExactIndex(dim=64)
        exact.add_batch(ids, emb, pay)
        exact.build()
        q4 = QuantizedIndex(dim=64, refine_factor=8, int4_storage=True)
        assert q4.int8_queries is True  # implied by int4 storage
        q4.add_batch(ids, emb, pay)
        q4.build()
        # Where the fused kernel runs (the GPU) the corpus stays
        # nibble-packed ([cap, D/2]); elsewhere build caches the unpack
        # ONCE ([cap, D]) so searches never re-unpack per dispatch.
        want = 32 if q4._kernel else 64
        assert q4._q_emb.shape == (q4.store.capacity, want)
        q = np.random.default_rng(7).normal(size=(32, 64)).astype(np.float32)
        _, ei = exact.search_batch(q, k=10, eta=0.25, entropy_pref=0.1)
        _, qi = q4.search_batch(q, k=10, eta=0.25, entropy_pref=0.1)
        assert recall_matrix(np.asarray(qi), np.asarray(ei)) >= 0.99
        # Overlapping hits score exactly (stage 2 is f32).
        er = exact.search(q[0], k=5, eta=0.25, entropy_pref=0.1)
        qr = q4.search(q[0], k=5, eta=0.25, entropy_pref=0.1)
        e_by_id = {d: s for d, s, _ in er}
        for d, s, _ in qr:
            if d in e_by_id:
                assert s == pytest.approx(e_by_id[d], abs=1e-5)

    def test_save_load_roundtrip(self, corpus, tmp_path):
        from dewi.index import QuantizedIndex

        ids, emb, pay = corpus
        q4 = QuantizedIndex(dim=64, int4_storage=True)
        q4.add_batch(ids, emb, pay)
        q4.build()
        q4.save(tmp_path / "ix")
        back = QuantizedIndex.load(tmp_path / "ix")
        assert back.int4_storage is True and back.int8_queries is True
        q = np.random.default_rng(1).normal(size=(3, 64)).astype(np.float32)
        _, i0 = q4.search_batch(q, k=5)
        _, i1 = back.search_batch(q, k=5)
        np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))

    def test_facade_backend_name(self, corpus):
        from dewi import DewiIndex
        from dewi.index import QuantizedIndex

        ids, emb, pay = corpus
        idx = DewiIndex(dim=64, backend="int4")
        assert isinstance(idx._backend, QuantizedIndex)
        assert idx._backend.int4_storage is True
        idx.add_batch(ids, emb, pay)
        idx.build()
        assert len(idx.search(np.ones(64, np.float32), k=3)) == 3

    def test_config_plumbing(self):
        from dewi.config import DewiConfig
        from dewi.pipelines import DewiPipeline

        cfg = DewiConfig()
        cfg.index.ann = "int4"
        pipe = DewiPipeline(config=cfg)
        idx = pipe._make_index(dim=16)
        assert idx._backend.int4_storage is True


class TestInt4Sharded:
    def test_sharded_int4_matches_sharded_exact(self):
        # int4 shard storage on the 8-device CPU mesh: half the per-device
        # stage-1 read; widened margins keep recall vs the sharded exact
        # searcher.
        from dewi.index.store import DocStore
        from dewi.metrics import recall_matrix
        from dewi.parallel import (
            ShardedExactSearcher,
            ShardedQuantizedSearcher,
            make_mesh,
        )

        rng = np.random.default_rng(41)
        n, d = 8 * 64, 32
        emb = rng.normal(size=(n, d)).astype(np.float32)
        pay = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
        ids = [str(i) for i in range(n)]
        mesh = make_mesh(n_data=8, n_model=1)

        s1 = DocStore(dim=d)
        s1.add_batch(ids, emb, pay)
        exact = ShardedExactSearcher(s1, mesh, k=10)
        s2 = DocStore(dim=d)
        s2.add_batch(ids, emb, pay)
        quant = ShardedQuantizedSearcher(s2, mesh, k=10, refine_factor=8,
                                         int4_storage=True)
        assert quant.int8_queries is True  # implied
        want = d // 2 if quant._kernel else d
        assert quant._q_emb.shape[-1] == want  # packed or build-unpacked

        q = rng.normal(size=(6, d)).astype(np.float32)
        _, ei = exact.search_batch(q, eta=0.25, entropy_pref=0.1)
        _, qi = quant.search_batch(q, eta=0.25, entropy_pref=0.1)
        assert recall_matrix(np.asarray(qi), np.asarray(ei)) >= 0.99
