"""Pipeline tests: signals end-to-end, scoring, checkpoints, index handoff."""

import numpy as np
import pytest

from dewi.config import DewiConfig
from dewi.pipelines import Document, DewiPipeline, create_document
from dewi.types import SIGNAL_FIELDS


def tiny_config(**over) -> DewiConfig:
    cfg = DewiConfig.from_dict(
        {
            "text": {"model": "tiny", "batch_size": 4, "max_length": 64},
            "image": {"model": "tiny", "batch_size": 2, "image_size": 32,
                      "patch_size": 8},
            "cross_modal": {"model": "tiny", "batch_size": 4},
            "redundancy": {"block_size": 8},
            **over,
        }
    )
    return cfg


@pytest.fixture(scope="module")
def docs():
    rng = np.random.default_rng(0)
    return [
        create_document("d0", text="the quick brown fox jumps over the dog"),
        create_document("d1", text="the quick brown fox jumps over the dog"),
        Document(doc_id="d2", text="completely different text entirely",
                 image=rng.random((32, 32, 3)).astype(np.float32)),
        Document(doc_id="d3",
                 image=rng.random((32, 32, 3)).astype(np.float32)),
        create_document("d4", text="short",
                        embedding=rng.normal(size=16).astype(np.float32)),
    ]


@pytest.fixture(scope="module")
def pipeline():
    return DewiPipeline(tiny_config())


class TestCreateDocument:
    def test_fields(self):
        d = create_document("x", text="t", image_path="/tmp/a.png")
        assert d.doc_id == "x" and d.text == "t"
        assert d.image_path == "/tmp/a.png"
        assert d.embedding is None

    def test_signals_dict_none_coalescing(self):
        d = create_document("x")
        sd = d.signals_dict()
        assert set(sd) == set(SIGNAL_FIELDS)
        assert all(v == 0.0 for v in sd.values())

    def test_payload(self):
        d = create_document("x")
        d.ht_mean = 2.5
        d.dewi_score = 0.8
        p = d.payload()
        assert p.ht_mean == 2.5 and p.dewi == 0.8


class TestComputeSignals:
    def test_fills_fields_per_modality(self, pipeline, docs):
        out = pipeline.compute_signals(list(docs))
        # Text docs get text entropy; image docs get image entropy.
        assert out[0].ht_mean is not None and out[0].ht_q90 is not None
        assert out[3].ht_mean is None  # no text
        assert out[2].hi_mean is not None and out[2].hi_q90 is not None
        assert out[0].hi_mean is None  # no image
        # Only the multimodal doc gets I_hat.
        assert out[2].I_hat is not None
        assert out[0].I_hat is None
        # Everyone gets redundancy + noise.
        assert all(d.redundancy is not None for d in out)
        assert all(d.noise is not None for d in out)

    def test_duplicate_texts_high_redundancy(self, pipeline, docs):
        out = pipeline.compute_signals(list(docs))
        # d0 and d1 are identical -> identical embeddings -> max redundancy.
        assert out[0].redundancy == pytest.approx(1.0, abs=1e-3)
        assert out[1].redundancy == pytest.approx(1.0, abs=1e-3)

    def test_embeddings_filled_and_normalized(self, pipeline, docs):
        out = pipeline.compute_signals(list(docs))
        for d in out:
            assert d.embedding is not None
        # Provided embedding untouched.
        assert out[4].embedding.shape == (16,)
        # CLIP embeddings unit-norm.
        assert np.linalg.norm(out[0].embedding) == pytest.approx(1.0, abs=1e-4)

    def test_empty_input(self, pipeline):
        assert pipeline.compute_signals([]) == []

    def test_cross_modal_density_raises_multimodal_redundancy(self):
        # Multimodal docs with DISTINCT texts (minhash ~0) but identical
        # images: joint-embedding density catches what lexical hashing
        # misses, and only when the config flag is on.
        rng = np.random.default_rng(7)
        img = rng.random((32, 32, 3)).astype(np.float32)

        def mk():
            return [
                Document(doc_id="m0", text="a photograph of a red barn",
                         image=img.copy()),
                Document(doc_id="m1", text="crimson farm building picture",
                         image=img.copy()),
                Document(doc_id="m2", text="totally unrelated words here",
                         image=img.copy()),
                create_document("t0", text="plain text document no image"),
            ]

        on = DewiPipeline(tiny_config(
            redundancy={"block_size": 8, "cross_modal_density": True,
                        "text_sim": "minhash"},
        )).compute_signals(mk())
        off = DewiPipeline(tiny_config(
            redundancy={"block_size": 8, "cross_modal_density": False,
                        "text_sim": "minhash"},
        )).compute_signals(mk())
        # Same images force high joint density; off-mode minhash sees
        # distinct strings. Density can only raise the max-blended score.
        for i in range(3):
            assert on[i].redundancy >= off[i].redundancy - 1e-6
        assert max(on[i].redundancy for i in range(3)) > 0.5
        # The text-only doc is untouched by the density stage.
        assert on[3].redundancy == pytest.approx(off[3].redundancy, abs=1e-5)

    def test_checkpoint_resume(self, tmp_path):
        pipe = DewiPipeline(tiny_config())
        mk = lambda: [
            create_document(f"d{i}", text=f"document number {i} with words")
            for i in range(4)
        ]
        a = pipe.compute_signals(mk(), checkpoint_dir=tmp_path)
        assert (tmp_path / "text.npz").exists()
        assert (tmp_path / "noise.npz").exists()
        # Resume must reproduce identical signals without recompute.
        b = pipe.compute_signals(mk(), checkpoint_dir=tmp_path)
        for da, db in zip(a, b):
            assert da.ht_mean == pytest.approx(db.ht_mean)
            assert da.redundancy == pytest.approx(db.redundancy)

    def test_checkpoint_size_mismatch_ignored(self, tmp_path):
        pipe = DewiPipeline(tiny_config())
        pipe.compute_signals(
            [create_document("a", text="one two three")],
            checkpoint_dir=tmp_path,
        )
        out = pipe.compute_signals(
            [create_document("a", text="one two three"),
             create_document("b", text="four five six")],
            checkpoint_dir=tmp_path,
        )
        assert out[1].ht_mean is not None


class TestComputeDewiScores:
    def test_scores_in_unit_interval(self, pipeline, docs):
        out = pipeline.compute_signals(list(docs))
        out = pipeline.compute_dewi_scores(out)
        for d in out:
            assert 0.0 <= d.dewi_score <= 1.0

    def test_matches_scalar_scorer(self, pipeline, docs):
        from dewi.scorer import DewiScorer

        out = pipeline.compute_signals(list(docs))
        out = pipeline.compute_dewi_scores(out)
        scorer = DewiScorer()
        rows = [d.signals_dict() for d in out]
        scorer.fit_stats(rows)
        for d, row in zip(out, rows):
            assert d.dewi_score == pytest.approx(scorer.score(row), abs=1e-5)

    def test_conditional_mode(self, pipeline):
        # I_hat must vary moderately so z(I) doesn't saturate the ±delta clip
        # (saturation makes both modes agree by construction).
        rng = np.random.default_rng(3)
        out = []
        for i in range(8):
            d = create_document(f"s{i}")
            for k in SIGNAL_FIELDS:
                setattr(d, k, float(rng.gamma(2.0, 1.0)))
            out.append(d)
        std = [d.dewi_score for d in pipeline.compute_dewi_scores(out)]
        cond = [
            d.dewi_score
            for d in pipeline.compute_dewi_scores(out, mode="conditional")
        ]
        assert std != cond

    def test_weights_override(self, pipeline, docs):
        out = pipeline.compute_signals(list(docs))
        a = [d.dewi_score for d in pipeline.compute_dewi_scores(out)]
        b = [
            d.dewi_score
            for d in pipeline.compute_dewi_scores(
                out, weights={"alpha_t": 5.0, "alpha_i": 1.0, "alpha_m": 1.0,
                              "alpha_r": 1.0, "alpha_n": 1.0}
            )
        ]
        assert a != b


class TestIndexHandoff:
    def test_build_index_and_search_text_query(self, pipeline, docs):
        subset = [d for d in docs if d.embedding is None or d.embedding.shape[0] != 16]
        out = pipeline.compute_signals(list(subset))
        out = pipeline.compute_dewi_scores(out)
        index = pipeline.build_index(out, backend="exact")
        assert len(index) == len(out)
        # The query encoder is the docs' own text tower: a query with the
        # duplicate docs' text lands on their embedding, so at eta=0 both
        # rank above the unrelated ones whatever the (random) weights are.
        q = pipeline.encode_query("the quick brown fox jumps over the dog")
        results = index.search(q, k=2, eta=0.0)
        assert len(results) == 2
        assert {r[0] for r in results} == {"d0", "d1"}
        assert results[0][1] > 0.999

    def test_build_index_empty_raises(self, pipeline):
        with pytest.raises(ValueError):
            pipeline.build_index([])


class TestProcessStream:
    def test_sharded_matches_monolithic(self, tmp_path):
        pipe = DewiPipeline(tiny_config())
        mk = lambda: [
            create_document(f"d{i}", text=f"document number {i} some words here")
            for i in range(10)
        ]
        mono = pipe.compute_dewi_scores(pipe.compute_signals(mk()))
        sharded = pipe.process_stream(mk(), shard_size=3,
                                      checkpoint_dir=tmp_path)
        for a, b in zip(mono, sharded):
            assert a.dewi_score == pytest.approx(b.dewi_score, abs=1e-5)
        # Per-shard checkpoint dirs exist.
        assert (tmp_path / "shard_00000" / "text.npz").exists()
        assert (tmp_path / "shard_00003" / "text.npz").exists()

    def test_resume_skips_recompute(self, tmp_path):
        pipe = DewiPipeline(tiny_config())
        mk = lambda: [
            create_document(f"d{i}", text=f"text number {i} alpha beta")
            for i in range(6)
        ]
        a = pipe.process_stream(mk(), shard_size=2, checkpoint_dir=tmp_path)
        b = pipe.process_stream(mk(), shard_size=2, checkpoint_dir=tmp_path)
        for x, y in zip(a, b):
            assert x.dewi_score == pytest.approx(y.dewi_score)

    def test_empty(self):
        pipe = DewiPipeline(tiny_config())
        assert pipe.process_stream([]) == []

    def test_checkpoint_rejects_different_corpus(self, tmp_path):
        """A same-length but different corpus must NOT reuse cached signals
        (ADVICE r1: corpus digest in stage checkpoints)."""
        pipe = DewiPipeline(tiny_config())
        a = pipe.compute_signals(
            [create_document("d0", text="the quick brown fox jumps")],
            checkpoint_dir=tmp_path,
        )
        b = pipe.compute_signals(
            [create_document("d0", text="completely different words!!")],
            checkpoint_dir=tmp_path,
        )
        assert a[0].ht_mean != pytest.approx(b[0].ht_mean)
        # Same corpus DOES reuse the cache (ht identical).
        c = pipe.compute_signals(
            [create_document("d0", text="completely different words!!")],
            checkpoint_dir=tmp_path,
        )
        assert c[0].ht_mean == pytest.approx(b[0].ht_mean)


class TestBuildIndexBackendKnobs:
    def test_ivf_knobs_forwarded(self):
        from dewi.index.ivf import IVFIndex

        pipe = DewiPipeline(tiny_config(index={"ann": "ivf", "nlist": 7,
                                               "nprobe": 3}))
        docs = [create_document(f"d{i}", text=f"text number {i} here")
                for i in range(5)]
        docs = pipe.compute_signals(docs)
        docs = pipe.compute_dewi_scores(docs)
        index = pipe.build_index(docs)
        assert isinstance(index._backend, IVFIndex)
        assert index._backend.nlist == 7
        assert index._backend.nprobe == 3

    def test_checkpoint_fields_reach_estimators(self, tmp_path):
        """TextConfig/ImageConfig/CrossModalConfig checkpoint+seed plumb into
        the lazy estimator constructors (VERDICT round 1 item 2)."""
        import jax
        import jax.numpy as jnp

        from dewi.models.registry import (
            clip_config, init_clip, init_lm, lm_config, save_params,
        )

        lm_ckpt = tmp_path / "lm.msgpack"
        _, lm_params = init_lm(lm_config("tiny", vocab_size=258), seed=3)
        lm_params = jax.tree.map(lambda x: x * 2.0, lm_params)
        save_params(lm_params, lm_ckpt)

        clip_ckpt = tmp_path / "clip.msgpack"
        _, clip_params = init_clip(clip_config("tiny"), seed=3)
        clip_params = jax.tree.map(lambda x: x * 3.0, clip_params)
        save_params(clip_params, clip_ckpt)

        cfg = tiny_config()
        cfg.text.checkpoint = str(lm_ckpt)
        cfg.text.seed = 3
        cfg.cross_modal.checkpoint = str(clip_ckpt)
        cfg.cross_modal.seed = 3
        pipe = DewiPipeline(cfg)

        got = jax.tree.leaves(pipe.text_entropy.params)
        want = jax.tree.leaves(lm_params)
        assert all(jnp.allclose(g, w) for g, w in zip(got, want))
        got = jax.tree.leaves(pipe.cross_modal.params)
        want = jax.tree.leaves(clip_params)
        assert all(jnp.allclose(g, w) for g, w in zip(got, want))

        prov = pipe.encoder_provenance()
        assert prov["checkpoint"] == str(clip_ckpt)
        assert prov["seed"] == 3 and prov["checkpoint_fingerprint"]

    def test_config_checkpoint_yaml_roundtrip(self, tmp_path):
        cfg = tiny_config()
        cfg.text.checkpoint = "/ckpts/lm.msgpack"
        cfg.image.checkpoint = "/ckpts/mae.msgpack"
        cfg.cross_modal.checkpoint = "/ckpts/clip.msgpack"
        cfg.cross_modal.seed = 11
        path = tmp_path / "cfg.yaml"
        cfg.to_yaml(path)
        back = DewiConfig.from_yaml(path)
        assert back.text.checkpoint == "/ckpts/lm.msgpack"
        assert back.image.checkpoint == "/ckpts/mae.msgpack"
        assert back.cross_modal.checkpoint == "/ckpts/clip.msgpack"
        assert back.cross_modal.seed == 11

    def test_quantized_knob_forwarded(self):
        from dewi.index.quantized import QuantizedIndex

        pipe = DewiPipeline(tiny_config(index={"ann": "quantized",
                                               "refine_factor": 4}))
        docs = [create_document(f"d{i}", text=f"words number {i}")
                for i in range(4)]
        docs = pipe.compute_signals(docs)
        docs = pipe.compute_dewi_scores(docs)
        index = pipe.build_index(docs)
        assert isinstance(index._backend, QuantizedIndex)
        assert index._backend.refine_factor == 4


class TestEmbeddingProvenance:
    def test_external_embeddings_record_external_source(self):
        """Regression: pre-embedded corpora must NOT claim CLIP provenance —
        search would rebuild an unrelated encoder and rank garbage."""
        import numpy as np
        from dewi.config import DewiConfig
        from dewi.pipelines import DewiPipeline, create_document

        cfg = DewiConfig()
        pipe = DewiPipeline(cfg)
        rng = np.random.default_rng(0)
        docs = [
            create_document(f"d{i}", text=f"doc {i}",
                            embedding=rng.normal(size=32).astype(np.float32))
            for i in range(4)
        ]
        for d in docs:
            d.dewi_score = 0.5
        idx = pipe.build_index(docs)
        assert idx.encoder == {"source": "external"}

    def test_pipeline_embeddings_record_cross_modal_source(self):
        import numpy as np
        from dewi.config import DewiConfig
        from dewi.pipelines import DewiPipeline, create_document

        cfg = DewiConfig()
        cfg.cross_modal.model = "tiny"
        cfg.text.model = "tiny"
        pipe = DewiPipeline(cfg)
        docs = [create_document(f"d{i}", text=f"document number {i}")
                for i in range(3)]
        for d in docs:
            d.dewi_score = 0.5
        idx = pipe.build_index(docs)
        assert idx.encoder["source"] == "cross_modal"
        assert idx.encoder["model"] == "tiny"


class TestProgressReporting:
    def test_meter_prints_rate_and_eta(self, capsys):
        import io

        from dewi.utils.progress import ProgressMeter

        buf = io.StringIO()
        m = ProgressMeter(100, "stage", enabled=True, interval=0.0,
                          stream=buf)
        m.update(40)
        m.update(60)
        m.close()
        out = buf.getvalue()
        assert "stage: 40/100" in out and "docs/s" in out
        assert "100/100" in out

    def test_meter_close_bypasses_throttle(self):
        # An undercounting stage (done < total at close) must still get a
        # final line even when the interval throttle suppressed the last
        # update (round-3 review: close()'s update(0) was throttled too).
        import io

        from dewi.utils.progress import ProgressMeter

        import time

        buf = io.StringIO()
        m = ProgressMeter(100, "stage", enabled=True, interval=3600.0,
                          stream=buf)
        m.update(40)
        m._printed = True  # as if something was reported
        m._last_print = time.perf_counter()  # throttle window just opened
        m.update(10)   # throttled for sure
        m.close()      # must still print the final 50/100 state
        assert "stage: 50/100" in buf.getvalue()

    def test_meter_disabled_is_silent(self):
        import io

        from dewi.utils.progress import ProgressMeter

        buf = io.StringIO()
        m = ProgressMeter(100, "stage", enabled=False, stream=buf)
        m.update(100)
        m.close()
        assert buf.getvalue() == ""

    def test_compute_signals_progress_smoke(self, capsys):
        # progress=True must run end to end and report stage liveness.
        pipe = DewiPipeline(tiny_config())
        docs = [create_document(f"p{i}", text=f"words number {i} here")
                for i in range(6)]
        pipe.compute_signals(docs, progress=True)
        out = capsys.readouterr().out
        assert "text entropy" in out
