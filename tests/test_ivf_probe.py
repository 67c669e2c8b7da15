"""IVF probe: the streamed probe against the exact index, the bf16 tier,
and the spill tier."""

import numpy as np
import pytest

from dewi.index import IVFIndex
from dewi.types import Payload


def _build(n=600, d=32, seed=3, **kw):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    pay = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
    ix = IVFIndex(dim=d, nlist=16, nprobe=6, kmeans_iters=4, dewi_tier=32,
                  **kw)
    ix.add_batch([f"doc{i}" for i in range(n)],
                 emb, [Payload.from_array(p) for p in pay])
    ix.build()
    return ix, emb, rng


class TestProbe:
    @pytest.mark.parametrize("space", ["cosine", "l2"])
    def test_full_probe_matches_exact(self, space):
        """nprobe == nlist probes every bucket: the streamed probe returns
        the exact index's rankings, and its scores to f32 tolerance."""
        from dewi.index import ExactIndex

        ix, emb, rng = _build(space=space)
        ix.nprobe = ix.nlist
        exact = ExactIndex(dim=emb.shape[1], space=space)
        exact.add_batch([f"doc{i}" for i in range(len(emb))], emb,
                        ix.store.payload_matrix()[: len(emb)])
        exact.build()
        q = rng.normal(size=(9, emb.shape[1])).astype(np.float32)
        for eta, ep in ((0.0, 0.0), (0.4, 0.2)):
            vi, ii = ix.search_batch(q, k=12, eta=eta, entropy_pref=ep)
            ve, ie = exact.search_batch(q, k=12, eta=eta, entropy_pref=ep)
            np.testing.assert_array_equal(np.asarray(ii), np.asarray(ie))
            np.testing.assert_allclose(
                np.asarray(vi), np.asarray(ve), rtol=1e-5, atol=1e-5
            )

    @pytest.mark.parametrize("impl", ["auto", "scan", "gather"])
    def test_saved_probe_impl_still_loads(self, tmp_path, impl):
        """Indexes saved with the retired probe_impl switch load and search
        the same as a fresh index; the switch is no longer saved."""
        import json

        ix, emb, rng = _build()
        ix.save(tmp_path / "ix")
        meta_path = tmp_path / "ix" / "metadata.json"
        meta = json.loads(meta_path.read_text())
        assert "probe_impl" not in meta["hyperparams"]
        meta["hyperparams"]["probe_impl"] = impl
        meta_path.write_text(json.dumps(meta))
        back = IVFIndex.load(tmp_path / "ix")
        q = rng.normal(size=(6, emb.shape[1])).astype(np.float32)
        _, i0 = ix.search_batch(q, k=8, eta=0.3, entropy_pref=0.1)
        _, i1 = back.search_batch(q, k=8, eta=0.3, entropy_pref=0.1)
        np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))

    def test_k_larger_than_candidate_pool(self):
        """k=corpus on a small nprobe must clamp to the probed pool
        (nprobe*cap + overflow), not crash top_k (found by verify drive)."""
        ix, emb, rng = _build(n=400)
        q = rng.normal(size=(emb.shape[1],)).astype(np.float32)
        res = ix.search(q, k=400, eta=0.2, entropy_pref=0.1)
        assert 0 < len(res) <= 400
        # search_batch agrees and returns the clamped width.
        vals, idx = ix.search_batch(q, k=400)
        assert idx.shape[1] <= 400


class TestBf16Tier:
    def test_bucket_storage_is_bf16(self):
        ix, _, _ = _build(probe_dtype="bf16")
        assert ix.probe_dtype == "bfloat16"
        assert str(ix._dev[1].dtype) == "bfloat16"  # b_emb
        assert str(ix._dev[6].dtype) == "bfloat16"  # o_emb
        assert str(ix._dev[5].dtype) == "float32"   # b_sqn stays f32

    def test_bf16_recall_close_to_f32(self):
        f32_ix, emb, rng = _build(probe_dtype="float32")
        bf_ix, _, _ = _build(probe_dtype="bf16")
        q = rng.normal(size=(32, emb.shape[1])).astype(np.float32)
        _, i32 = f32_ix.search_batch(q, k=10, eta=0.25, entropy_pref=0.1)
        _, ibf = bf_ix.search_batch(q, k=10, eta=0.25, entropy_pref=0.1)
        i32, ibf = np.asarray(i32), np.asarray(ibf)
        overlap = np.mean([
            len(set(i32[r]) & set(ibf[r])) / 10.0 for r in range(q.shape[0])
        ])
        assert overlap >= 0.9

    def test_bad_dtype_rejected(self):
        with pytest.raises(ValueError, match="probe_dtype"):
            IVFIndex(dim=8, probe_dtype="int8")

    def test_auto_follows_store_dtype(self):
        """'auto' (the config default) resolves from the store's embedding
        dtype at build: f32 store -> f32 buckets, bf16 store -> bf16."""
        import jax.numpy as jnp

        ix, _, _ = _build(probe_dtype="auto")
        assert ix.probe_dtype == "auto"           # persisted as given
        assert str(ix._dev[1].dtype) == "float32"
        bx, _, _ = _build(probe_dtype="auto", dtype=jnp.bfloat16)
        assert str(bx._dev[1].dtype) == "bfloat16"

    def test_property_sweep(self):
        """Randomized config sweep: every (space, dtype, nlist, nprobe, k)
        combination must return sorted scores over valid ids
        and recall no worse than a smaller probe budget."""
        rng = np.random.default_rng(17)
        n, d = 500, 24
        emb = rng.normal(size=(n, d)).astype(np.float32)
        pay = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
        pays = [Payload.from_array(p) for p in pay]
        ids = [f"doc{i}" for i in range(n)]
        q = rng.normal(size=(7, d)).astype(np.float32)

        for trial in range(8):
            nlist = int(rng.integers(2, 40))
            nprobe = int(rng.integers(1, nlist + 1))
            k = int(rng.integers(1, 30))
            space = rng.choice(["cosine", "l2"])
            dtype = rng.choice(["float32", "bfloat16", "auto"])
            ix = IVFIndex(dim=d, space=space, nlist=nlist, nprobe=nprobe,
                          kmeans_iters=2, dewi_tier=int(rng.integers(0, 64)),
                          probe_dtype=dtype)
            ix.add_batch(ids, emb, pays)
            ix.build()
            vals, idx = ix.search_batch(q, k=k, eta=0.3, entropy_pref=0.1)
            vals, idx = np.asarray(vals), np.asarray(idx)
            cfg = f"trial={trial} nlist={nlist} nprobe={nprobe} k={k} " \
                  f"{space}/{dtype}"
            assert idx.shape[0] == 7 and 0 < idx.shape[1] <= k, cfg
            valid = idx >= 0
            assert np.all(idx[valid] < n), cfg
            # Scores sorted descending wherever the slot is valid.
            for r in range(7):
                vr = vals[r][valid[r]]
                assert np.all(np.diff(vr) <= 1e-5), (cfg, vr)

    def test_hyperparams_roundtrip(self, tmp_path):
        ix, emb, rng = _build(probe_dtype="bf16")
        ix.save(tmp_path / "ix")
        back = IVFIndex.load(tmp_path / "ix")
        assert back.probe_dtype == "bfloat16"
        q = rng.normal(size=(4, emb.shape[1])).astype(np.float32)
        v0, i0 = ix.search_batch(q, k=5)
        v1, i1 = back.search_batch(q, k=5)
        np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))


class TestSpillTier:
    """Doc-side boundary spill (spill_frac): second-bucket copies + dedup."""

    def test_no_duplicate_ids_in_results(self):
        ix, emb, rng = _build(spill_frac=0.5)
        q = rng.normal(size=(16, 32)).astype(np.float32)
        _, idx = ix.search_batch(q, k=20, eta=0.2, entropy_pref=0.1)
        idx = np.asarray(idx)
        for row in idx:
            live = row[row >= 0]
            assert len(set(live.tolist())) == len(live), row

    def test_spill_recall_dominates_no_spill(self):
        # A clustered corpus with boundary queries: spilled buckets must
        # recover at least the no-spill recall at equal nprobe (strict
        # improvement is measured on the 1M curve; equality-or-better is
        # the invariant a unit-size corpus can assert deterministically).
        from dewi.index import ExactIndex
        from dewi.metrics import recall_matrix

        rng = np.random.default_rng(11)
        modes = rng.normal(size=(24, 32)).astype(np.float32)
        assign = rng.integers(0, 24, 1200)
        emb = (modes[assign] + 0.15 * rng.normal(size=(1200, 32))
               ).astype(np.float32)
        pay = np.abs(rng.normal(size=(1200, 8))).astype(np.float32)
        ids = [f"d{i}" for i in range(1200)]
        exact = ExactIndex(dim=32)
        exact.add_batch(ids, emb, pay)
        exact.build()
        # Boundary queries: midpoints of random mode pairs.
        pairs = rng.integers(0, 24, (64, 2))
        q = ((modes[pairs[:, 0]] + modes[pairs[:, 1]]) / 2.0
             + 0.05 * rng.normal(size=(64, 32))).astype(np.float32)
        _, ei = exact.search_batch(q, k=10, eta=0.1, entropy_pref=0.0)
        recs = {}
        for frac in (0.0, 0.5):
            ix = IVFIndex(dim=32, nlist=24, nprobe=3, kmeans_iters=6,
                          dewi_tier=0, seed=5, spill_frac=frac)
            ix.add_batch(ids, emb, pay)
            ix.build()
            _, ii = ix.search_batch(q, k=10, eta=0.1, entropy_pref=0.0)
            recs[frac] = recall_matrix(np.asarray(ii), np.asarray(ei))
        assert recs[0.5] >= recs[0.0] - 1e-9, recs

    def test_results_match_exact_at_full_probe(self):
        # nprobe == nlist probes everything: spill duplicates must be
        # invisible (dedup) and results equal to the exact index's.
        from dewi.index import ExactIndex

        rng = np.random.default_rng(13)
        emb = rng.normal(size=(400, 16)).astype(np.float32)
        pay = np.abs(rng.normal(size=(400, 8))).astype(np.float32)
        ids = [f"d{i}" for i in range(400)]
        exact = ExactIndex(dim=16)
        exact.add_batch(ids, emb, pay)
        exact.build()
        ix = IVFIndex(dim=16, nlist=8, nprobe=8, kmeans_iters=4,
                      dewi_tier=0, spill_frac=1.0,
                      bucket_load_factor=4.0)
        ix.add_batch(ids, emb, pay)
        ix.build()
        q = rng.normal(size=(8, 16)).astype(np.float32)
        _, ei = exact.search_batch(q, k=10, eta=0.3, entropy_pref=0.1)
        _, ii = ix.search_batch(q, k=10, eta=0.3, entropy_pref=0.1)
        np.testing.assert_array_equal(np.asarray(ii), np.asarray(ei))

    def test_spill_frac_persists(self, tmp_path):
        ix, emb, rng = _build(spill_frac=0.25)
        ix.save(tmp_path / "ix")
        back = IVFIndex.load(tmp_path / "ix")
        assert back.spill_frac == 0.25
        q = rng.normal(size=(4, 32)).astype(np.float32)
        _, i0 = ix.search_batch(q, k=5)
        _, i1 = back.search_batch(q, k=5)
        np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))

    def test_bad_spill_frac_rejected(self):
        with pytest.raises(ValueError):
            IVFIndex(dim=8, spill_frac=1.5)

    def test_tiered_doc_copies_both_overflow(self):
        # A doc in the DEWI tier must not ALSO occupy a bucket slot via its
        # spill copy (the tier mask applies to original ids).
        ix, emb, rng = _build(spill_frac=1.0)
        tier_n = ix.dewi_tier
        b_docidx = np.asarray(ix._dev[4])
        o_docidx = np.asarray(ix._dev[8])
        in_overflow = set(o_docidx[o_docidx >= 0].tolist())
        pay = ix.store.payload_matrix()[: len(ix.store)]
        top_dewi = set(np.argsort(-pay[:, 0])[:tier_n].tolist())
        bucket_ids = set(b_docidx[b_docidx >= 0].ravel().tolist())
        # every top-dewi doc is overflow-scanned and never bucket-resident
        assert top_dewi <= in_overflow
        assert not (top_dewi & bucket_ids)

    def test_dedup_pads_with_minus1_when_pool_exhausted(self):
        # When the probed pool holds fewer than k DISTINCT docs, deduped
        # slots must surface as -1/-inf padding (the exhausted-pool
        # sentinel), never as a repeated id with a -inf score.
        rng = np.random.default_rng(17)
        emb = rng.normal(size=(24, 16)).astype(np.float32)
        pay = np.abs(rng.normal(size=(24, 8))).astype(np.float32)
        ix = IVFIndex(dim=16, nlist=8, nprobe=2, kmeans_iters=4,
                      dewi_tier=0, spill_frac=1.0)
        ix.add_batch([f"d{i}" for i in range(24)], emb, pay)
        ix.build()
        q = rng.normal(size=(8, 16)).astype(np.float32)
        _, idx = ix.search_batch(q, k=12, eta=0.2, entropy_pref=0.0)
        idx = np.asarray(idx)
        for row in idx:
            live = row[row >= 0]
            assert len(set(live.tolist())) == len(live), row

    def test_sharded_searcher_dedups_spill_copies(self):
        # A spill-built index served through ShardedIVFSearcher: a doc's
        # primary and spill buckets can land on DIFFERENT shards, so the
        # merge must dedup too (found by round-5 code review — the
        # per-shard kernel dedup alone returned rows like
        # [164,164,81,81,...] with bit-equal duplicate scores).
        from dewi.parallel import ShardedIVFSearcher, make_mesh

        rng = np.random.default_rng(19)
        n, d, k = 600, 32, 10
        emb = rng.normal(size=(n, d)).astype(np.float32)
        pay = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
        ix = IVFIndex(dim=d, nlist=16, nprobe=16, kmeans_iters=4,
                      dewi_tier=0, spill_frac=1.0)
        ix.add_batch([f"d{i}" for i in range(n)], emb, pay)
        ix.build()
        mesh = make_mesh(n_data=4, n_model=2)
        searcher = ShardedIVFSearcher(ix, mesh, k=k, nprobe_per_shard=4)
        q = rng.normal(size=(8, d)).astype(np.float32)
        vals, idx = searcher.search_batch(q, eta=0.25, entropy_pref=0.1)
        idx = np.asarray(idx)
        for row in idx:
            live = row[row >= 0]
            assert len(set(live.tolist())) == len(live), row
        # Full-probe spill index still matches the local index's ranking.
        _, li = ix.search_batch(q, k=k, eta=0.25, entropy_pref=0.1)
        np.testing.assert_array_equal(idx, np.asarray(li))
