"""Multi-device tests on the virtual 8-device CPU mesh.

Validates that the shard_map distributed search (local fused top-k ->
all_gather -> merge) returns exactly what the single-device kernel returns.
"""

import jax
import numpy as np
import pytest

from dewi.index import ExactIndex
from dewi.index.store import DocStore
from dewi.parallel import ShardedExactSearcher, make_mesh

from tests.test_index import make_payloads, numpy_oracle

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs a multi-device (virtual) mesh"
)


def test_mesh_shapes():
    mesh = make_mesh()
    assert mesh.devices.size == len(jax.devices())
    mesh2 = make_mesh(n_data=len(jax.devices()) // 2, n_model=2)
    assert mesh2.shape["model"] == 2


def test_sharded_search_matches_oracle(rng):
    n, d, k = 512, 16, 10
    emb = rng.normal(size=(n, d)).astype(np.float32)
    pays = make_payloads(rng, n)

    store = DocStore(dim=d, space="cosine")
    store.add_batch([f"d{i}" for i in range(n)], emb, pays)

    mesh = make_mesh()
    searcher = ShardedExactSearcher(store, mesh, k=k)
    qs = rng.normal(size=(5, d)).astype(np.float32)
    scores, idx = searcher.search_batch(qs, eta=0.4, entropy_pref=0.2)
    assert scores.shape == (5, k)
    for qi in range(5):
        oracle_idx, adj = numpy_oracle(emb, pays, qs[qi], k, 0.4, 0.2)
        np.testing.assert_array_equal(np.asarray(idx[qi]), oracle_idx)
        np.testing.assert_allclose(np.asarray(scores[qi]), adj[oracle_idx], atol=1e-4)


def test_sharded_matches_single_device(rng):
    n, d, k = 300, 8, 7  # n not divisible by device count; padding masked
    emb = rng.normal(size=(n, d)).astype(np.float32)
    pays = make_payloads(rng, n)
    ids = [f"d{i}" for i in range(n)]

    single = ExactIndex(dim=d)
    single.add_batch(ids, emb, pays)
    single.build()

    store = DocStore(dim=d)
    store.add_batch(ids, emb, pays)
    searcher = ShardedExactSearcher(store, make_mesh(), k=k)

    q = rng.normal(size=(1, d)).astype(np.float32)
    s_scores, s_idx = single.search_batch(q, k=k, eta=0.6, entropy_pref=-0.3)
    d_scores, d_idx = searcher.search_batch(q, eta=0.6, entropy_pref=-0.3)
    np.testing.assert_array_equal(np.asarray(s_idx), np.asarray(d_idx))
    np.testing.assert_allclose(np.asarray(s_scores), np.asarray(d_scores), atol=1e-4)


def test_l2_sharded(rng):
    n, d, k = 256, 8, 5
    emb = rng.normal(size=(n, d)).astype(np.float32)
    pays = make_payloads(rng, n)
    store = DocStore(dim=d, space="l2")
    store.add_batch([f"d{i}" for i in range(n)], emb, pays)
    searcher = ShardedExactSearcher(store, make_mesh(), k=k)
    q = rng.normal(size=(3, d)).astype(np.float32)
    scores, idx = searcher.search_batch(q, eta=0.2, entropy_pref=0.0)
    for qi in range(3):
        oracle_idx, _ = numpy_oracle(emb, pays, q[qi], k, 0.2, 0.0, space="l2")
        np.testing.assert_array_equal(np.asarray(idx[qi]), oracle_idx)


class TestShardedQuantized:
    def test_matches_sharded_exact(self):
        import numpy as np
        from dewi.index.store import DocStore
        from dewi.metrics import recall_matrix
        from dewi.parallel import (
            ShardedExactSearcher,
            ShardedQuantizedSearcher,
            make_mesh,
        )

        rng = np.random.default_rng(0)
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
        quant = ShardedQuantizedSearcher(s2, mesh, k=10, refine_factor=8)

        q = rng.normal(size=(6, d)).astype(np.float32)
        _, ei = exact.search_batch(q, eta=0.25, entropy_pref=0.1)
        _, qi = quant.search_batch(q, eta=0.25, entropy_pref=0.1)
        assert recall_matrix(np.asarray(qi), np.asarray(ei)) >= 0.99

    def test_int8_queries_matches_sharded_exact(self):
        # s8xs8 stage-1 on the sharded tier: query quantization adds
        # stage-1 rounding only; the per-shard f32 refine keeps recall.
        import numpy as np
        from dewi.index.store import DocStore
        from dewi.metrics import recall_matrix
        from dewi.parallel import (
            ShardedExactSearcher,
            ShardedQuantizedSearcher,
            make_mesh,
        )

        rng = np.random.default_rng(4)
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
                                         int8_queries=True)
        assert quant.int8_queries is True

        q = rng.normal(size=(6, d)).astype(np.float32)
        _, ei = exact.search_batch(q, eta=0.25, entropy_pref=0.1)
        _, qi = quant.search_batch(q, eta=0.25, entropy_pref=0.1)
        assert recall_matrix(np.asarray(qi), np.asarray(ei)) >= 0.99


class TestShardingAfterAttach:
    def test_attach_then_shard(self):
        import jax.numpy as jnp
        import numpy as np
        from dewi.index.store import DocStore
        from dewi.parallel import ShardedExactSearcher, make_mesh

        rng = np.random.default_rng(0)
        n, d = 8 * 16, 16
        emb = rng.normal(size=(n, d)).astype(np.float32)
        pay = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
        store = DocStore(dim=d)
        # Device-attached first, sharded after (the bug: stale placement).
        store.attach_device([str(i) for i in range(n)], jnp.asarray(emb),
                            jnp.asarray(pay))
        mesh = make_mesh(n_data=8, n_model=1)
        searcher = ShardedExactSearcher(store, mesh, k=5)
        q = rng.normal(size=(2, d)).astype(np.float32)
        scores, idx = searcher.search_batch(q, eta=0.0, entropy_pref=0.0)
        # Compare against single-device exact search.
        from dewi.index import ExactIndex

        ref = ExactIndex(dim=d)
        ref.add_batch([str(i) for i in range(n)], emb, pay)
        ref.build()
        _, ridx = ref.search_batch(q, k=5, eta=0.0, entropy_pref=0.0)
        assert set(np.asarray(idx)[0].tolist()) == set(np.asarray(ridx)[0].tolist())


class TestShardedIVF:
    def test_full_probe_matches_exact(self, rng):
        """nprobe_per_shard = local nlist probes every bucket -> exact."""
        from dewi.index.ivf import IVFIndex
        from dewi.parallel import ShardedIVFSearcher

        n, d, k = 600, 16, 10
        emb = rng.normal(size=(n, d)).astype(np.float32)
        pays = make_payloads(rng, n)
        ids = [f"d{i}" for i in range(n)]

        ivf = IVFIndex(dim=d, nlist=16, nprobe=16, kmeans_iters=4,
                       dewi_tier=32)
        ivf.add_batch(ids, emb, pays)
        ivf.build()
        exact = ExactIndex(dim=d)
        exact.add_batch(ids, emb, pays)
        exact.build()

        mesh = make_mesh()
        searcher = ShardedIVFSearcher(ivf, mesh, k=k, nprobe_per_shard=16)
        q = rng.normal(size=(5, d)).astype(np.float32)
        vals, idx = searcher.search_batch(q, eta=0.3, entropy_pref=0.1)
        ev, ei = exact.search_batch(q, eta=0.3, entropy_pref=0.1, k=k)
        np.testing.assert_array_equal(np.asarray(idx), np.asarray(ei))
        np.testing.assert_allclose(np.asarray(vals), np.asarray(ev),
                                   rtol=1e-5, atol=1e-5)

    def test_sharded_bf16_buckets(self, rng):
        """ShardedIVFSearcher over a bf16-bucket index: the dtype flows
        through pad0/shard placement and recall vs local search holds."""
        from dewi.index.ivf import IVFIndex
        from dewi.parallel import ShardedIVFSearcher

        n, d, k = 600, 16, 10
        emb = rng.normal(size=(n, d)).astype(np.float32)
        pays = make_payloads(rng, n)
        ids = [f"d{i}" for i in range(n)]
        ivf = IVFIndex(dim=d, nlist=16, nprobe=16, kmeans_iters=4,
                       dewi_tier=32, probe_dtype="bf16")
        ivf.add_batch(ids, emb, pays)
        ivf.build()

        mesh = make_mesh()
        searcher = ShardedIVFSearcher(ivf, mesh, k=k, nprobe_per_shard=16)
        q = rng.normal(size=(8, d)).astype(np.float32)
        vals, idx = searcher.search_batch(q, eta=0.3, entropy_pref=0.1)
        lv, li = ivf.search_batch(q, eta=0.3, entropy_pref=0.1, k=k)
        # Full probing: same candidate set; bf16 scores identical per doc
        # (same storage dtype in both paths), so rankings must agree.
        np.testing.assert_array_equal(np.asarray(idx), np.asarray(li))

    def test_sharded_k_beyond_probed_pool(self, rng):
        """k past the probed pool (nprobe*cap + overflow) must clamp, not
        crash the per-shard top_k (review finding: the IVFIndex fix had
        not been applied to the sharded caller)."""
        from dewi.index.ivf import IVFIndex
        from dewi.parallel import ShardedIVFSearcher

        n, d = 600, 16
        emb = rng.normal(size=(n, d)).astype(np.float32)
        pays = make_payloads(rng, n)
        ivf = IVFIndex(dim=d, nlist=16, nprobe=2, kmeans_iters=3,
                       dewi_tier=16)
        ivf.add_batch([f"d{i}" for i in range(n)], emb, pays)
        ivf.build()
        searcher = ShardedIVFSearcher(ivf, make_mesh(), k=599,
                                      nprobe_per_shard=2)
        q = rng.normal(size=(4, d)).astype(np.float32)
        vals, idx = searcher.search_batch(q, eta=0.2, entropy_pref=0.1)
        assert idx.shape[0] == 4 and 0 < idx.shape[1] <= 599

    def test_partial_probe_recall(self, rng):
        from dewi.index.ivf import IVFIndex
        from dewi.metrics import recall_matrix
        from dewi.parallel import ShardedIVFSearcher

        n, d, k = 2000, 16, 10
        emb = rng.normal(size=(n, d)).astype(np.float32)
        pays = make_payloads(rng, n)
        ids = [f"d{i}" for i in range(n)]
        ivf = IVFIndex(dim=d, nlist=32, nprobe=8, kmeans_iters=4,
                       dewi_tier=64)
        ivf.add_batch(ids, emb, pays)
        ivf.build()
        exact = ExactIndex(dim=d)
        exact.add_batch(ids, emb, pays)
        exact.build()

        mesh = make_mesh()
        searcher = ShardedIVFSearcher(ivf, mesh, k=k)  # ceil(8/8)=1 per shard
        q = rng.normal(size=(20, d)).astype(np.float32)
        _, idx = searcher.search_batch(q, eta=0.0, entropy_pref=0.0)
        _, ei = exact.search_batch(q, eta=0.0, entropy_pref=0.0, k=k)
        assert recall_matrix(np.asarray(idx), np.asarray(ei)) >= 0.6


class TestShardedQuantizedPallas:
    def test_pallas_stage1_matches_xla_per_shard(self):
        """Interpret-mode fused kernel stage 1 inside shard_map == XLA
        two-pass stage 1 (same blockmax selection per shard)."""
        import numpy as np
        from dewi.index.store import DocStore
        from dewi.parallel import make_mesh
        from dewi.parallel.distributed import make_sharded_quantized_search
        from dewi.ops.quantized import quantize_rows

        rng = np.random.default_rng(4)
        n, d = 8 * 512, 32  # shard_cap = 512 rows/device (4 sub-blocks)
        emb = rng.normal(size=(n, d)).astype(np.float32)
        pay = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
        store = DocStore(dim=d)
        store.add_batch([str(i) for i in range(n)], emb, pay)
        mesh = make_mesh(n_data=8, n_model=1)
        from dewi.parallel.mesh import data_sharding

        store.sharding = data_sharding(mesh, rank=2)
        emb_d, sqn, payd, nv = store.device_arrays()
        qe, sc = quantize_rows(emb_d)
        q = np.asarray(rng.normal(size=(3, d)), np.float32)

        import jax.numpy as jnp

        args = (qe, sc, emb_d, sqn, payd, jnp.asarray(q), nv,
                jnp.float32(0.25), jnp.float32(0.1))
        f_x = make_sharded_quantized_search(mesh, k=10, m=40,
                                            blockmax_select=True)
        f_p = make_sharded_quantized_search(
            mesh, k=10, m=40, blockmax_select=True, bmax_kernel=True,
            interpret=True,
        )
        sx, ix = f_x(*args)
        sp, ip = f_p(*args)
        np.testing.assert_array_equal(np.asarray(ix), np.asarray(ip))
        np.testing.assert_allclose(np.asarray(sx), np.asarray(sp),
                                   rtol=1e-6, atol=1e-6)


class TestShardedQuantizedL2:
    def test_l2_space_matches_sharded_exact(self):
        """Regression: the sharded int8 tier must honor the store's space
        (it hardcoded normalize=True, silently ranking L2 stores by cosine)."""
        import numpy as np
        from dewi.index.store import DocStore
        from dewi.metrics import recall_matrix
        from dewi.parallel import (
            ShardedExactSearcher, ShardedQuantizedSearcher, make_mesh,
        )

        rng = np.random.default_rng(1)
        n, d = 8 * 64, 16
        # Distinct norms so cosine and L2 rankings genuinely differ.
        emb = (rng.normal(size=(n, d)) * rng.uniform(0.2, 5.0, size=(n, 1))
               ).astype(np.float32)
        pay = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
        ids = [str(i) for i in range(n)]
        mesh = make_mesh(n_data=8, n_model=1)

        s1 = DocStore(dim=d, space="l2")
        s1.add_batch(ids, emb, pay)
        exact = ShardedExactSearcher(s1, mesh, k=10)  # reads store.normalize
        s2 = DocStore(dim=d, space="l2")
        s2.add_batch(ids, emb, pay)
        quant = ShardedQuantizedSearcher(s2, mesh, k=10, refine_factor=8)

        q = rng.normal(size=(4, d)).astype(np.float32)
        _, ei = exact.search_batch(q, eta=0.25, entropy_pref=0.1)
        _, qi = quant.search_batch(q, eta=0.25, entropy_pref=0.1)
        assert recall_matrix(np.asarray(qi), np.asarray(ei)) >= 0.95


def test_sharded_blockmax_matches_plain(rng):
    """Per-shard blockmax selection (value-exact) vs flat per-shard top_k.

    Shard capacity must clear fused_search's blockmax gate (>= 512 rows
    per shard), so the corpus is sized to 4096 capacity / 8 devices."""
    n, d, k = 4000, 16, 10
    emb = rng.normal(size=(n, d)).astype(np.float32)
    pays = make_payloads(rng, n)
    ids = [f"d{i}" for i in range(n)]

    mesh = make_mesh()
    plain_store = DocStore(dim=d)
    plain_store.add_batch(ids, emb, pays)
    plain = ShardedExactSearcher(plain_store, mesh, k=k)
    bm_store = DocStore(dim=d)
    bm_store.add_batch(ids, emb, pays)
    bm = ShardedExactSearcher(bm_store, mesh, k=k, blockmax_select=True)

    qs = rng.normal(size=(6, d)).astype(np.float32)
    s0, i0 = plain.search_batch(qs, eta=0.3, entropy_pref=0.1)
    s1, i1 = bm.search_batch(qs, eta=0.3, entropy_pref=0.1)
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
    np.testing.assert_array_equal(np.asarray(s0), np.asarray(s1))
