"""Index tests: exactness, behavioral ranking contracts, persistence, IVF.

The monotone entropy-preference and eta-ordering assertions mirror the
reference's key semantic contracts (reference tests/test_index.py:251-353).
Top-k exactness is checked against a plain-numpy oracle.
"""

import numpy as np
import pytest

from dewi.index import DewiIndex, ExactIndex, IVFIndex, IndexBackend
from dewi.types import Payload


def make_payloads(rng, n):
    return [
        Payload(
            dewi=float(rng.beta(2, 2)),
            ht_mean=float(rng.gamma(2.0, 1.5)),
            ht_q90=float(rng.gamma(2.5, 1.5)),
            hi_mean=float(rng.gamma(2.0, 1.0)),
            hi_q90=float(rng.gamma(2.5, 1.0)),
            I_hat=float(rng.beta(2, 5)),
            redundancy=float(rng.beta(1, 4)),
            noise=float(rng.beta(1, 9)),
        )
        for _ in range(n)
    ]


def numpy_oracle(emb, payloads, q, k, eta, ep, space="cosine"):
    """Plain-numpy adjusted-score ranking over ALL docs (exact re-rank)."""
    emb = emb.astype(np.float32)
    q = q.astype(np.float32)
    if space == "cosine":
        e = emb / np.linalg.norm(emb, axis=1, keepdims=True)
        qn = q / np.linalg.norm(q)
        sim = e @ qn
    else:
        sim = -np.sum((emb - q) ** 2, axis=1)
    dewi = np.array([p.dewi for p in payloads], dtype=np.float32)
    ent = np.array([(p.ht_mean + p.hi_mean) / 2 for p in payloads], dtype=np.float32)
    adj = (1 - eta) * sim + eta * dewi + ep * ent
    order = np.argsort(-adj)[:k]
    return order, adj


@pytest.fixture
def small_index(rng, dummy_embeddings, dummy_payloads):
    idx = DewiIndex(dim=32, space="cosine", backend="exact")
    for i, (e, p) in enumerate(zip(dummy_embeddings, dummy_payloads)):
        idx.add(f"doc{i}", e, p)
    idx.build()
    return idx


class TestExactIndex:
    def test_topk_matches_numpy_oracle(self, rng, dummy_embeddings, dummy_payloads):
        idx = ExactIndex(dim=32)
        idx.add_batch(
            [f"d{i}" for i in range(64)], dummy_embeddings, dummy_payloads
        )
        idx.build()
        q = rng.normal(size=32).astype(np.float32)
        for eta, ep in [(0.0, 0.0), (0.5, 0.0), (0.25, 0.7), (1.0, -0.5)]:
            results = idx.search(q, k=10, eta=eta, entropy_pref=ep)
            oracle_idx, adj = numpy_oracle(dummy_embeddings, dummy_payloads, q, 10, eta, ep)
            got_ids = [r[0] for r in results]
            assert got_ids == [f"d{i}" for i in oracle_idx]
            for r, oi in zip(results, oracle_idx):
                assert r[1] == pytest.approx(float(adj[oi]), abs=1e-4)

    def test_l2_space(self, rng, dummy_embeddings, dummy_payloads):
        idx = ExactIndex(dim=32, space="l2")
        idx.add_batch([f"d{i}" for i in range(64)], dummy_embeddings, dummy_payloads)
        idx.build()
        q = rng.normal(size=32).astype(np.float32)
        results = idx.search(q, k=5, eta=0.3, entropy_pref=0.0)
        oracle_idx, adj = numpy_oracle(
            dummy_embeddings, dummy_payloads, q, 5, 0.3, 0.0, space="l2"
        )
        assert [r[0] for r in results] == [f"d{i}" for i in oracle_idx]

    def test_k_larger_than_corpus(self, rng, dummy_payloads):
        idx = ExactIndex(dim=8)
        for i in range(3):
            idx.add(f"d{i}", rng.normal(size=8).astype(np.float32), dummy_payloads[i])
        idx.build()
        results = idx.search(rng.normal(size=8).astype(np.float32), k=10)
        assert len(results) == 3

    def test_capacity_growth_preserves_results(self, rng, dummy_payloads):
        idx = ExactIndex(dim=8, capacity=4)
        n = 100  # forces several doublings past MIN_CAPACITY floor
        emb = rng.normal(size=(n, 8)).astype(np.float32)
        pays = make_payloads(rng, n)
        for i in range(n):
            idx.add(f"d{i}", emb[i], pays[i])
        idx.build()
        q = rng.normal(size=8).astype(np.float32)
        results = idx.search(q, k=5, eta=0.4, entropy_pref=0.1)
        oracle_idx, _ = numpy_oracle(emb, pays, q, 5, 0.4, 0.1)
        assert [r[0] for r in results] == [f"d{i}" for i in oracle_idx]

    def test_batched_queries(self, rng, dummy_embeddings, dummy_payloads):
        idx = ExactIndex(dim=32)
        idx.add_batch([f"d{i}" for i in range(64)], dummy_embeddings, dummy_payloads)
        idx.build()
        qs = rng.normal(size=(7, 32)).astype(np.float32)
        scores, indices = idx.search_batch(qs, k=4, eta=0.5, entropy_pref=0.2)
        assert scores.shape == (7, 4) and indices.shape == (7, 4)
        for qi in range(7):
            oracle_idx, _ = numpy_oracle(
                dummy_embeddings, dummy_payloads, qs[qi], 4, 0.5, 0.2
            )
            np.testing.assert_array_equal(np.asarray(indices[qi]), oracle_idx)

    def test_empty_search(self):
        idx = ExactIndex(dim=8)
        assert idx.search(np.zeros(8, np.float32), k=5) == []

    def test_add_shape_validation(self):
        idx = ExactIndex(dim=8)
        with pytest.raises(ValueError):
            idx.add("x", np.zeros(9, np.float32), Payload())


class TestExactBlockmax:
    """Exact-tier hierarchical block-max selection (ops/similarity).

    Unlike the quantized tier, selection here runs on the FINAL adjusted
    scores, so result values must be exactly those of the flat lax.top_k
    (top-k blocks by max provably contain the top-k docs at s=k)."""

    def _pair(self, rng, n=600, dim=32, space="cosine"):
        emb = rng.normal(size=(n, dim)).astype(np.float32)
        pays = make_payloads(rng, n)
        ids = [f"d{i}" for i in range(n)]
        plain = ExactIndex(dim=dim, space=space, blockmax_select=False)
        bm = ExactIndex(dim=dim, space=space, blockmax_select=True)
        for idx in (plain, bm):
            idx.add_batch(ids, emb, pays)
            idx.build()
        assert bm._blockmax_ok()  # capacity 1024: gates must hold
        return plain, bm

    def test_matches_plain_topk_cosine(self, rng):
        plain, bm = self._pair(rng)
        q = rng.normal(size=(5, 32)).astype(np.float32)
        for k in (1, 4, 10, 50):
            s0, i0 = plain.search_batch(q, k=k, eta=0.3, entropy_pref=0.2)
            s1, i1 = bm.search_batch(q, k=k, eta=0.3, entropy_pref=0.2)
            np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
            np.testing.assert_allclose(
                np.asarray(s0), np.asarray(s1), rtol=0, atol=0
            )

    def test_matches_plain_topk_l2(self, rng):
        plain, bm = self._pair(rng, space="l2")
        q = rng.normal(size=(3, 32)).astype(np.float32)
        s0, i0 = plain.search_batch(q, k=10, eta=0.4, entropy_pref=0.0)
        s1, i1 = bm.search_batch(q, k=10, eta=0.4, entropy_pref=0.0)
        np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
        np.testing.assert_allclose(np.asarray(s0), np.asarray(s1))

    def test_large_batch_no_q_gate(self, rng):
        """The two-pass variant gathers scores only, so (unlike the
        quantized tier) it engages at ANY batch size."""
        plain, bm = self._pair(rng)
        q = rng.normal(size=(64, 32)).astype(np.float32)
        _, i0 = plain.search_batch(q, k=10, eta=0.25, entropy_pref=0.1)
        _, i1 = bm.search_batch(q, k=10, eta=0.25, entropy_pref=0.1)
        np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))

    def test_hyperparams_roundtrip(self, tmp_path, rng):
        plain, bm = self._pair(rng, n=40)
        bm.save(tmp_path / "bm")
        loaded = ExactIndex.load(tmp_path / "bm")
        assert loaded.blockmax_select is True
        q = rng.normal(size=(2, 32)).astype(np.float32)
        _, i0 = bm.search_batch(q, k=5)
        _, i1 = loaded.search_batch(q, k=5)
        np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
        # the explicit opt-out persists too
        plain.save(tmp_path / "plain")
        assert ExactIndex.load(tmp_path / "plain").blockmax_select is False

    def test_blockmax_is_the_default(self):
        """Value-exact at every batch size and the fix for flat top_k's
        batched collapse — ships ON; no kernel runs on this tier, so the
        saved hyperparameters name only the selection."""
        idx = ExactIndex(dim=16)
        assert idx.blockmax_select is True
        assert idx._hyperparams() == {"blockmax_select": True}


class TestBehavioralContracts:
    """Parity with reference tests/test_index.py:251-353."""

    def test_entropy_pref_monotone(self, rng, small_index):
        q = rng.normal(size=32).astype(np.float32)

        def mean_top_entropy(ep):
            res = small_index.search(q, k=10, eta=0.0, entropy_pref=ep)
            return np.mean([(p.ht_mean + p.hi_mean) / 2 for _, _, p in res])

        high, neutral, low = mean_top_entropy(1.0), mean_top_entropy(0.0), mean_top_entropy(-1.0)
        eps = 1e-6
        assert high >= neutral - eps
        assert neutral >= low - eps

    def test_eta_monotone_dewi(self, rng, small_index):
        q = rng.normal(size=32).astype(np.float32)

        def mean_top_dewi(eta):
            res = small_index.search(q, k=10, eta=eta, entropy_pref=0.0)
            return np.mean([p.dewi for _, _, p in res])

        eps = 1e-6
        assert mean_top_dewi(1.0) >= mean_top_dewi(0.5) - eps
        assert mean_top_dewi(0.5) >= mean_top_dewi(0.0) - eps

    def test_eta_zero_is_pure_similarity(self, rng, dummy_embeddings, dummy_payloads):
        idx = ExactIndex(dim=32)
        idx.add_batch([f"d{i}" for i in range(64)], dummy_embeddings, dummy_payloads)
        idx.build()
        q = dummy_embeddings[7]
        results = idx.search(q, k=1, eta=0.0, entropy_pref=0.0)
        assert results[0][0] == "d7"


class TestDewiIndexFacade:
    def test_defaults_from_ctor(self, rng, dummy_embeddings, dummy_payloads):
        idx = DewiIndex(dim=32, rerank_eta=0.7, entropy_pref=0.3)
        idx.add_batch([f"d{i}" for i in range(64)], dummy_embeddings, dummy_payloads)
        q = rng.normal(size=32).astype(np.float32)
        r_default = idx.search(q, k=5)  # auto-builds
        r_explicit = idx.search(q, k=5, eta=0.7, entropy_pref=0.3)
        assert [x[0] for x in r_default] == [x[0] for x in r_explicit]

    def test_query_shape_validation(self, small_index):
        with pytest.raises(ValueError):
            small_index.search(np.zeros(5, np.float32))

    def test_len_and_accessors(self, small_index, dummy_embeddings):
        assert len(small_index) == 64
        p = small_index.get_payload("doc3")
        assert p is not None
        np.testing.assert_allclose(
            small_index.get_embedding("doc3"), dummy_embeddings[3], rtol=1e-6
        )
        assert small_index.get_payload("nope") is None
        assert small_index.get_embedding("nope") is None

    def test_metadata(self, rng, dummy_payloads):
        idx = DewiIndex(dim=8)
        idx.add("a", rng.normal(size=8).astype(np.float32), dummy_payloads[0], meta={"src": "x"})
        assert idx.get_metadata("a") == {"src": "x"}
        assert idx.get_metadata("b") is None

    def test_backend_enum(self):
        assert IndexBackend.from_str("auto") is IndexBackend.EXACT
        assert IndexBackend.from_str("hnsw").resolve() is ExactIndex
        assert IndexBackend.from_str("faiss_ivfflat").resolve() is IVFIndex
        assert IndexBackend.from_str("ivf").resolve() is IVFIndex

    def test_payload_mutation_propagates_to_search(self, rng, dummy_embeddings, dummy_payloads):
        """README flow: mutate payload via get_payload, re-rank must see it."""
        idx = DewiIndex(dim=32)
        idx.add_batch([f"d{i}" for i in range(64)], dummy_embeddings, dummy_payloads)
        idx.build()
        # Force one doc's dewi to the max; with eta=1 it must rank first.
        p = idx.get_payload("d13")
        p.dewi = 1000.0
        q = rng.normal(size=32).astype(np.float32)
        results = idx.search(q, k=1, eta=1.0, entropy_pref=0.0)
        assert results[0][0] == "d13"


class TestPersistence:
    def test_exact_roundtrip(self, tmp_path, rng, dummy_embeddings, dummy_payloads):
        idx = DewiIndex(dim=32, rerank_eta=0.4, entropy_pref=0.2)
        idx.add_batch([f"d{i}" for i in range(64)], dummy_embeddings, dummy_payloads)
        idx.build()
        q = rng.normal(size=32).astype(np.float32)
        before = idx.search(q, k=5)
        idx.save(tmp_path / "idx")
        loaded = DewiIndex.load(tmp_path / "idx")
        after = loaded.search(q, k=5)
        assert [x[0] for x in before] == [x[0] for x in after]
        assert loaded.rerank_eta == 0.4 and loaded.entropy_pref == 0.2
        assert len(loaded) == 64
        lp = loaded.get_payload("d5")
        assert lp.dewi == pytest.approx(dummy_payloads[5].dewi, abs=1e-6)

    def test_meta_roundtrip(self, tmp_path, rng, dummy_payloads):
        idx = DewiIndex(dim=8)
        idx.add("a", rng.normal(size=8).astype(np.float32), dummy_payloads[0], meta={"k": 1})
        idx.build()
        idx.save(tmp_path / "m")
        loaded = DewiIndex.load(tmp_path / "m")
        assert loaded.get_metadata("a") == {"k": 1}

    def test_add_after_attach_device_buffers_on_device(self, rng,
                                                       dummy_payloads):
        """Adds to a device-resident store buffer and merge on device — no
        per-add host pull of the corpus (VERDICT r1 weak #7)."""
        import jax.numpy as jnp

        from dewi.types import Payload

        emb = rng.normal(size=(64, 32)).astype(np.float32)
        pay = np.stack([p.to_array() for p in dummy_payloads])
        idx = ExactIndex(dim=32)
        idx.store.attach_device(
            [f"d{i}" for i in range(64)], jnp.asarray(emb), jnp.asarray(pay)
        )
        idx.build()

        q = rng.normal(size=32).astype(np.float32)
        new = (q / np.linalg.norm(q)).astype(np.float32)
        idx.add("new", new, Payload(dewi=0.9))
        assert idx.store._host_stale  # still device-resident, no host pull
        idx.build()
        res = idx.search(q, k=1, eta=0.0, entropy_pref=0.0)
        assert res[0][0] == "new"  # exact-match embedding ranks first
        assert len(idx) == 65
        # Host accessors still work (sync folds the buffered row).
        p = idx.get_payload("new")
        assert p.dewi == pytest.approx(0.9, abs=1e-6)

    def test_hyperparams_roundtrip(self, tmp_path, rng):
        # A saved IVF/Quantized index must reload with the hyperparameters it
        # was built with, not constructor defaults (ADVICE.md round 1).
        n, d = 200, 8
        emb = rng.normal(size=(n, d)).astype(np.float32)
        pays = make_payloads(rng, n)
        ids = [f"d{i}" for i in range(n)]

        ivf = IVFIndex(dim=d, nlist=11, nprobe=7, dewi_tier=33, kmeans_iters=3,
                       bucket_load_factor=2.0, train_sample=150, seed=5)
        ivf.add_batch(ids, emb, pays)
        ivf.build()
        ivf.save(tmp_path / "ivf_hp")
        loaded = IVFIndex.load(tmp_path / "ivf_hp")
        assert (loaded.nlist, loaded.nprobe, loaded.dewi_tier) == (11, 7, 33)
        assert loaded.kmeans_iters == 3 and loaded.train_sample == 150
        assert loaded.bucket_load_factor == 2.0 and loaded.seed == 5

        from dewi.index.quantized import QuantizedIndex

        qi = QuantizedIndex(dim=d, refine_factor=17, approx_select=False)
        qi.add_batch(ids, emb, pays)
        qi.build()
        qi.save(tmp_path / "q_hp")
        qloaded = QuantizedIndex.load(tmp_path / "q_hp")
        assert qloaded.refine_factor == 17 and qloaded.approx_select is False
        # Explicit caller overrides still win over saved values.
        qover = QuantizedIndex.load(tmp_path / "q_hp", refine_factor=3)
        assert qover.refine_factor == 3

    def test_jsonl_payload_format(self, tmp_path, rng, dummy_payloads):
        import json

        idx = DewiIndex(dim=8)
        idx.add("a", rng.normal(size=8).astype(np.float32), dummy_payloads[0])
        idx.build()
        idx.save(tmp_path / "j")
        lines = (tmp_path / "j" / "ann_index" / "payloads.jsonl").read_text().splitlines()
        rec = json.loads(lines[0])
        assert rec["doc_id"] == "a"
        assert rec["payload"]["dewi"] == pytest.approx(dummy_payloads[0].dewi, abs=1e-6)


class TestIVFIndex:
    def test_high_nprobe_matches_exact(self, rng):
        n, d = 600, 16
        emb = rng.normal(size=(n, d)).astype(np.float32)
        pays = make_payloads(rng, n)
        ids = [f"d{i}" for i in range(n)]

        exact = ExactIndex(dim=d)
        exact.add_batch(ids, emb, pays)
        exact.build()
        ivf = IVFIndex(dim=d, nlist=16, nprobe=16, kmeans_iters=5)
        ivf.add_batch(ids, emb, pays)
        ivf.build()

        q = rng.normal(size=d).astype(np.float32)
        r_exact = [r[0] for r in exact.search(q, k=10, eta=0.3, entropy_pref=0.1)]
        r_ivf = [r[0] for r in ivf.search(q, k=10, eta=0.3, entropy_pref=0.1)]
        assert r_exact == r_ivf  # probing all lists == exact

    def test_recall_at_moderate_nprobe(self, rng):
        n, d = 2000, 16
        emb = rng.normal(size=(n, d)).astype(np.float32)
        pays = make_payloads(rng, n)
        ids = [f"d{i}" for i in range(n)]
        ivf = IVFIndex(dim=d, nlist=32, nprobe=8, kmeans_iters=5)
        ivf.add_batch(ids, emb, pays)
        ivf.build()
        exact = ExactIndex(dim=d)
        exact.add_batch(ids, emb, pays)
        exact.build()

        hits = total = 0
        qs = rng.normal(size=(20, d)).astype(np.float32)
        for q in qs:
            true = {r[0] for r in exact.search(q, k=10, eta=0.0, entropy_pref=0.0)}
            got = {r[0] for r in ivf.search(q, k=10, eta=0.0, entropy_pref=0.0)}
            hits += len(true & got)
            total += len(true)
        assert hits / total >= 0.7  # nprobe 8/32 on random data

    def test_ivf_roundtrip(self, tmp_path, rng):
        n, d = 300, 8
        emb = rng.normal(size=(n, d)).astype(np.float32)
        pays = make_payloads(rng, n)
        ids = [f"d{i}" for i in range(n)]
        idx = DewiIndex(dim=d, backend="ivf", nlist=8, nprobe=8)
        idx.add_batch(ids, emb, pays)
        idx.build()
        q = rng.normal(size=d).astype(np.float32)
        before = [r[0] for r in idx.search(q, k=5)]
        idx.save(tmp_path / "ivf")
        loaded = DewiIndex.load(tmp_path / "ivf")
        after = [r[0] for r in loaded.search(q, k=5)]
        assert before == after


class TestAttachDevice:
    def test_attach_matches_add_batch(self, rng, dummy_embeddings, dummy_payloads):
        import jax.numpy as jnp
        from dewi.index import ExactIndex
        from dewi.types import payloads_to_matrix

        pay = payloads_to_matrix(dummy_payloads)
        a = ExactIndex(dim=32)
        a.add_batch([str(i) for i in range(64)], dummy_embeddings, pay)
        a.build()
        b = ExactIndex(dim=32)
        b.store.attach_device(
            [str(i) for i in range(64)],
            jnp.asarray(dummy_embeddings),
            jnp.asarray(pay),
        )
        b.build()
        q = rng.normal(size=32).astype("float32")
        ra = a.search(q, k=5, eta=0.3, entropy_pref=0.1)
        rb = b.search(q, k=5, eta=0.3, entropy_pref=0.1)
        assert [r[0] for r in ra] == [r[0] for r in rb]
        for (_, sa, pa), (_, sb, pb) in zip(ra, rb):
            assert sa == pytest.approx(sb, abs=1e-5)
            assert pa.dewi == pytest.approx(pb.dewi, abs=1e-6)

    def test_attach_then_host_accessors(self, rng, dummy_embeddings, dummy_payloads):
        import jax.numpy as jnp
        from dewi.index import ExactIndex
        from dewi.types import payloads_to_matrix

        pay = payloads_to_matrix(dummy_payloads)
        idx = ExactIndex(dim=32)
        idx.store.attach_device(
            [str(i) for i in range(64)],
            jnp.asarray(dummy_embeddings),
            jnp.asarray(pay),
        )
        # Lazy host fetch: payload accessors still work after device attach.
        p = idx.get_payload("3")
        assert p is not None
        assert p.dewi == pytest.approx(float(pay[3, 0]), abs=1e-6)
        assert idx.store.capacity >= 64
        assert len(idx.store.payload_matrix()) == 64

    def test_attach_then_save_load(self, tmp_path, rng, dummy_embeddings,
                                   dummy_payloads):
        import jax.numpy as jnp
        from dewi.index import ExactIndex
        from dewi.types import payloads_to_matrix

        pay = payloads_to_matrix(dummy_payloads)
        idx = ExactIndex(dim=32)
        idx.store.attach_device(
            [str(i) for i in range(64)],
            jnp.asarray(dummy_embeddings),
            jnp.asarray(pay),
        )
        idx.build()
        idx.save(tmp_path / "ix")
        loaded = ExactIndex.load(tmp_path / "ix")
        q = rng.normal(size=32).astype("float32")
        assert [r[0] for r in idx.search(q, k=5)] == \
               [r[0] for r in loaded.search(q, k=5)]

    def test_attach_shape_validation(self):
        import jax.numpy as jnp
        from dewi.index.store import DocStore

        store = DocStore(dim=8)
        with pytest.raises(ValueError):
            store.attach_device(["a"], jnp.zeros((1, 4)), jnp.zeros((1, 8)))
        with pytest.raises(ValueError):
            store.attach_device(["a", "b"], jnp.zeros((1, 8)), jnp.zeros((1, 8)))


class TestBF16Storage:
    def test_bfloat16_store_search_close_to_f32(self, rng, dummy_embeddings,
                                                dummy_payloads):
        import jax.numpy as jnp
        from dewi.index import ExactIndex
        from dewi.metrics import recall_matrix
        from dewi.types import payloads_to_matrix

        pay = payloads_to_matrix(dummy_payloads)
        ids = [str(i) for i in range(64)]
        f32 = ExactIndex(dim=32)
        f32.add_batch(ids, dummy_embeddings, pay)
        f32.build()
        bf16 = ExactIndex(dim=32, dtype=jnp.bfloat16)
        bf16.add_batch(ids, dummy_embeddings, pay)
        bf16.build()
        q = rng.normal(size=(8, 32)).astype("float32")
        _, i32 = f32.search_batch(q, k=5, eta=0.25, entropy_pref=0.1)
        _, i16 = bf16.search_batch(q, k=5, eta=0.25, entropy_pref=0.1)
        import numpy as np
        assert recall_matrix(np.asarray(i16), np.asarray(i32)) >= 0.9


class TestSetDewiScores:
    def test_facade_rescore_changes_ranking(self, rng, dummy_embeddings,
                                            dummy_payloads):
        from dewi import DewiIndex
        from dewi.types import payloads_to_matrix

        pay = payloads_to_matrix(dummy_payloads)
        index = DewiIndex(dim=32)
        index.add_batch([str(i) for i in range(64)], dummy_embeddings, pay)
        index.build()
        q = rng.normal(size=32).astype("float32")
        # eta=1: ranking is purely by dewi -> planting a max wins rank 1.
        scores = np.zeros(64, np.float32)
        scores[41] = 1.0
        index.set_dewi_scores(scores)
        res = index.search(q, k=1, eta=1.0, entropy_pref=0.0)
        assert res[0][0] == "41"


class TestReferenceFormatMigration:
    def test_load_reference_written_index(self, tmp_path, rng):
        """An index directory in the reference's on-disk layout
        (metadata.json + payloads.jsonl with {"id": ...} + embeddings.npy,
        reference backends.py:104-163, 483-556) loads directly — the
        migration path for users switching frameworks."""
        import json as _json

        from dewi.index import BaseIndex, ExactIndex

        n, d = 12, 16
        emb = rng.normal(size=(n, d)).astype("float32")
        ids = [f"ref{i}" for i in range(n)]
        refdir = tmp_path / "ref_index"
        refdir.mkdir()
        (refdir / "metadata.json").write_text(_json.dumps({
            "dim": d, "space": "cosine", "doc_ids": ids,
            "is_trained": True, "type": "ExactIndex",
        }))
        with open(refdir / "payloads.jsonl", "w") as f:
            for i, doc_id in enumerate(ids):
                f.write(_json.dumps({
                    "id": doc_id,   # the reference's key name
                    "payload": {"dewi": i / n, "ht_mean": 1.0 + i,
                                "hi_mean": 0.5},
                }) + "\n")
        np.save(refdir / "embeddings.npy", emb)

        index = BaseIndex.load(refdir)
        assert isinstance(index, ExactIndex)
        assert len(index) == n
        p = index.get_payload("ref3")
        assert p.dewi == pytest.approx(3 / n)
        assert p.ht_mean == pytest.approx(4.0)
        res = index.search(emb[5], k=1, eta=0.0, entropy_pref=0.0)
        assert res[0][0] == "ref5"


class TestIVFDewiTier:
    def test_high_eta_recall_with_tier(self, rng):
        """At eta=1 the ranking is global-by-dewi; the high-DEWI tier must
        keep IVF recall perfect even though buckets are probed by sim."""
        from dewi.index import ExactIndex, IVFIndex
        from dewi.metrics import recall_matrix

        n, d = 4000, 32
        emb = rng.normal(size=(n, d)).astype(np.float32)
        pay = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
        pay[:, 0] = rng.beta(2, 2, n)
        ids = [str(i) for i in range(n)]
        exact = ExactIndex(dim=d)
        exact.add_batch(ids, emb, pay)
        exact.build()
        q = rng.normal(size=(16, d)).astype(np.float32)

        withtier = IVFIndex(dim=d, nlist=64, nprobe=4, dewi_tier=256)
        withtier.add_batch(ids, emb, pay)
        withtier.build()
        _, ei = exact.search_batch(q, k=10, eta=1.0, entropy_pref=0.0)
        _, ti = withtier.search_batch(q, k=10, eta=1.0, entropy_pref=0.0)
        assert recall_matrix(np.asarray(ti), np.asarray(ei)) == pytest.approx(1.0)

        notier = IVFIndex(dim=d, nlist=64, nprobe=4, dewi_tier=0)
        notier.add_batch(ids, emb, pay)
        notier.build()
        _, ni = notier.search_batch(q, k=10, eta=1.0, entropy_pref=0.0)
        # Without the tier, probing by sim misses most global dewi leaders.
        assert recall_matrix(np.asarray(ni), np.asarray(ei)) < 0.9

    def test_tier_does_not_hurt_pure_sim(self, rng):
        from dewi.index import ExactIndex, IVFIndex
        from dewi.metrics import recall_matrix

        n, d, c = 2000, 32, 32
        centers = rng.normal(size=(c, d)).astype(np.float32) * 3
        emb = (centers[rng.integers(0, c, n)]
               + rng.normal(size=(n, d))).astype(np.float32)
        pay = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
        ids = [str(i) for i in range(n)]
        exact = ExactIndex(dim=d)
        exact.add_batch(ids, emb, pay)
        exact.build()
        ivf = IVFIndex(dim=d, nlist=32, nprobe=8, dewi_tier=128)
        ivf.add_batch(ids, emb, pay)
        ivf.build()
        q = (emb[rng.integers(0, n, 16)]
             + 0.1 * rng.normal(size=(16, d))).astype(np.float32)
        _, ei = exact.search_batch(q, k=10, eta=0.0, entropy_pref=0.0)
        _, ii = ivf.search_batch(q, k=10, eta=0.0, entropy_pref=0.0)
        assert recall_matrix(np.asarray(ii), np.asarray(ei)) >= 0.9


class TestBufferedAddPastCapacity:
    def test_add_after_attach_at_exact_capacity(self):
        """Regression: buffered add past the device capacity must not crash
        host-sync accessors (store.py _ensure_capacity on a short mirror)."""
        import numpy as np
        from dewi.index.store import DocStore
        from dewi.types import Payload

        n, d = 1024, 16  # exactly a power-of-two capacity
        s = DocStore(dim=d)
        rng = np.random.default_rng(0)
        s.attach_device([str(i) for i in range(n)],
                        rng.normal(size=(n, d)).astype(np.float32),
                        np.abs(rng.normal(size=(n, 8))).astype(np.float32))
        s.add("extra", np.ones(d, np.float32), Payload(dewi=0.5))
        assert abs(s.get_payload("extra").dewi - 0.5) < 1e-6
        assert s.payload_matrix().shape[0] == n + 1


class TestStaleBuildGuards:
    def test_quantized_rebuilds_after_post_build_adds(self):
        import numpy as np
        from dewi.index.quantized import QuantizedIndex
        from dewi.types import Payload

        rng = np.random.default_rng(0)
        n, d = 100, 16
        qi = QuantizedIndex(dim=d)
        qi.store.add_batch([str(i) for i in range(n)],
                           rng.normal(size=(n, d)).astype(np.float32),
                           np.abs(rng.normal(size=(n, 8))).astype(np.float32))
        qi.build()
        extra = rng.normal(size=d).astype(np.float32)
        qi.store.add("needle", extra / np.linalg.norm(extra),
                     Payload(dewi=0.9))
        # Search FOR the new doc: stale int8 arrays would zero it out.
        _, idx = qi.search_batch(extra[None, :], k=1, eta=0.0)
        assert qi.store.doc_ids[int(np.asarray(idx)[0, 0])] == "needle"

    def test_attach_device_clears_pending_adds(self):
        import numpy as np
        from dewi.index.store import DocStore
        from dewi.types import Payload

        rng = np.random.default_rng(0)
        n, d = 64, 8
        s = DocStore(dim=d)
        s.attach_device([f"a{i}" for i in range(n)],
                        rng.normal(size=(n, d)).astype(np.float32),
                        np.abs(rng.normal(size=(n, 8))).astype(np.float32))
        s.add("ghost", np.ones(d, np.float32), Payload(dewi=0.5))
        # Replace the corpus wholesale: the buffered add must not leak.
        s.attach_device([f"b{i}" for i in range(n)],
                        rng.normal(size=(n, d)).astype(np.float32),
                        np.abs(rng.normal(size=(n, 8))).astype(np.float32))
        emb, _, _, nv = s.device_arrays()
        assert int(nv) == n and len(s) == n
        assert "ghost" not in s.doc_ids
