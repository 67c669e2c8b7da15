"""Signal estimator tests: contracts, fallbacks, and behavioral properties."""

import numpy as np
import pytest

from dewi.signals import (
    ByteTokenizer,
    CrossModalDependency,
    ImageEntropyEstimator,
    NoiseEstimator,
    RedundancyEstimator,
    TextEntropyEstimator,
    bucket_length,
    max_offdiag_similarity,
)
from dewi.signals.redundancy import minhash_signatures, simhash_bits


class TestTokenizer:
    def test_byte_roundtrip_ids(self):
        tok = ByteTokenizer()
        ids = tok.encode("Hi!", max_len=16)
        assert ids[0] == tok.bos_id
        assert bytes(ids[1:]) == b"Hi!"

    def test_batch_padding(self):
        tok = ByteTokenizer()
        ids, mask = tok.encode_batch(["a", "abcdef"], max_len=32)
        assert ids.shape == mask.shape
        assert mask[0].sum() == 2  # BOS + 1 byte
        assert mask[1].sum() == 7

    def test_bucket_lengths(self):
        assert bucket_length(5) == 32
        assert bucket_length(33) == 64
        assert bucket_length(100, max_len=512) == 128
        assert bucket_length(9999, max_len=512) == 512


@pytest.fixture(scope="module")
def text_est():
    return TextEntropyEstimator(model_name="tiny", batch_size=4, max_length=128)


class TestTextEntropy:
    def test_result_fields(self, text_est):
        r = text_est.compute_entropy("hello world, this is a test")
        assert len(r.token_entropies) > 0
        assert r.mean_entropy == pytest.approx(
            float(np.mean(r.token_entropies)), rel=1e-5
        )
        assert r.q90_entropy <= r.q99_entropy + 1e-6
        d = r.to_dict()
        assert set(d) == {"mean", "quantiles", "token_entropies"}

    def test_batch_matches_single(self, text_est):
        texts = ["alpha beta gamma", "x", "the quick brown fox " * 3]
        batch = text_est.batch_compute(texts)
        for t, r in zip(texts, batch):
            single = text_est.compute_entropy(t)
            assert r.mean_entropy == pytest.approx(single.mean_entropy, abs=1e-4)
            assert len(r.token_entropies) == len(single.token_entropies)

    def test_quantile_matches_numpy(self, text_est):
        r = text_est.compute_entropy("some moderately long sentence for quantiles")
        toks = np.asarray(r.token_entropies)
        assert r.q90_entropy == pytest.approx(
            float(np.quantile(toks, 0.9)), abs=1e-4
        )

    def test_empty_text(self, text_est):
        r = text_est.compute_entropy("")
        assert r.token_entropies == []
        assert r.mean_entropy == 0.0
        assert r.q90_entropy == 0.0

    def test_domain_relative(self):
        est = TextEntropyEstimator(
            model_name="tiny", domain_model_name="tiny", batch_size=2,
            max_length=64,
        )
        base = est.compute_entropy("hello world", relative_to_domain=False)
        rel = est.compute_entropy("hello world", relative_to_domain=True)
        # Different seeds -> different models -> relative differs from base.
        assert rel.mean_entropy != pytest.approx(base.mean_entropy, abs=1e-6)

    def test_call_alias(self, text_est):
        assert text_est("abc").mean_entropy == pytest.approx(
            text_est.compute_entropy("abc").mean_entropy
        )


class TestImageEntropy:
    def test_mae_scores_positive(self):
        est = ImageEntropyEstimator(model_name="tiny", batch_size=2)
        rng = np.random.default_rng(0)
        imgs = [rng.random((32, 32, 3)).astype(np.float32) for _ in range(3)]
        scores = est.batch_compute(imgs)
        assert len(scores) == 3
        assert all(s > 0 for s in scores)

    def test_deterministic(self):
        est = ImageEntropyEstimator(model_name="tiny", batch_size=2)
        img = np.random.default_rng(1).random((32, 32, 3)).astype(np.float32)
        assert est.score(img, seed=3) == pytest.approx(est.score(img, seed=3))

    def test_pixel_proxy_mode(self):
        est = ImageEntropyEstimator(model_name="pixel")
        flat = np.full((16, 16, 3), 0.7, np.float32)
        noisy = np.random.default_rng(0).random((16, 16, 3)).astype(np.float32)
        assert est.score(noisy) > est.score(flat)

    def test_resize_handles_other_shapes(self):
        est = ImageEntropyEstimator(model_name="tiny", batch_size=1)
        img = np.random.default_rng(2).random((50, 70, 3)).astype(np.float32)
        assert est.score(img) > 0


@pytest.fixture(scope="module")
def clip_est():
    return CrossModalDependency(model_name="tiny", batch_size=4)


class TestCrossModal:
    def test_result_range(self, clip_est):
        img = np.random.default_rng(0).random((32, 32, 3)).astype(np.float32)
        r = clip_est.compute_similarity("a photo", img)
        assert -1.0 - 1e-5 <= r.info_nce_score <= 1.0 + 1e-5
        assert r.text_to_image_sim == r.info_nce_score
        assert r.image_to_text_sim == r.info_nce_score

    def test_batch_is_diagonal_of_matrix(self, clip_est):
        rng = np.random.default_rng(1)
        texts = ["one", "two", "three"]
        imgs = [rng.random((32, 32, 3)).astype(np.float32) for _ in range(3)]
        batch = clip_est.batch_compute(texts, imgs)
        mat = clip_est.similarity_matrix(texts, imgs)
        for i, r in enumerate(batch):
            assert r.info_nce_score == pytest.approx(float(mat[i, i]), abs=1e-5)

    def test_length_mismatch_raises(self, clip_est):
        with pytest.raises(ValueError):
            clip_est.batch_compute(["a"], [])

    def test_encode_texts_normalized(self, clip_est):
        e = clip_est.encode_texts(["hello", "world"])
        np.testing.assert_allclose(np.linalg.norm(e, axis=1), 1.0, atol=1e-5)

    def test_image_size_override(self):
        """config.cross_modal.image_size runs the vision tower at the
        corpus resolution (no 224px upscale tax for small corpora)."""
        from dewi.signals.cross_modal import CrossModalDependency

        est = CrossModalDependency(model_name="small", image_size=64,
                                   batch_size=4)
        assert est.cfg.image_size == 64
        img = np.random.default_rng(2).integers(
            0, 256, (2, 64, 64, 3), dtype=np.uint8
        )
        e = est.encode_images(list(img))
        assert e.shape == (2, est.cfg.d_embed)
        np.testing.assert_allclose(np.linalg.norm(e, axis=1), 1.0, atol=1e-5)

    def test_image_size_not_patch_multiple_raises(self):
        from dewi.signals.cross_modal import CrossModalDependency

        with pytest.raises(ValueError, match="patch size"):
            CrossModalDependency(model_name="small", image_size=50)

    def test_image_size_conflicts_with_checkpoint(self, tmp_path):
        """An imported checkpoint's positional embeddings fix the
        resolution; an override must be a hard error, not silent drift."""
        from dewi.signals.cross_modal import CrossModalDependency
        from dewi.models.registry import clip_config, init_clip, \
            save_params
        from dewi.models.import_hf import write_sidecar_config

        cfg = clip_config("tiny", vocab_size=258)
        _, params = init_clip(cfg, seed=0)
        ckpt = tmp_path / "clip_tiny.msgpack"
        save_params(params, ckpt)
        write_sidecar_config(ckpt, "clip", cfg)
        with pytest.raises(ValueError, match="positional embeddings"):
            CrossModalDependency(checkpoint=str(ckpt), image_size=64)


class TestRedundancy:
    def test_max_offdiag_finds_duplicate(self):
        rng = np.random.default_rng(0)
        emb = rng.normal(size=(20, 16)).astype(np.float32)
        emb[7] = emb[3]  # exact duplicate pair
        scores = max_offdiag_similarity(emb, block=8)
        assert scores[3] == pytest.approx(1.0, abs=1e-5)
        assert scores[7] == pytest.approx(1.0, abs=1e-5)
        assert scores.shape == (20,)

    def test_single_doc_zero(self):
        assert max_offdiag_similarity(np.ones((1, 4), np.float32))[0] == 0.0

    def test_fit_score(self):
        rng = np.random.default_rng(1)
        emb = rng.normal(size=(10, 8)).astype(np.float32)
        est = RedundancyEstimator(block_size=4)
        scores = est.fit(emb).score()
        assert scores.shape == (10,)
        assert np.all(scores <= 1.0 + 1e-5)

    def test_minhash_identical_texts(self):
        texts = ["the cat sat on the mat today", "the cat sat on the mat today",
                 "completely different words entirely here now"]
        sigs = minhash_signatures(texts)
        assert np.array_equal(sigs[0], sigs[1])
        assert not np.array_equal(sigs[0], sigs[2])

    def test_score_texts_minhash(self):
        texts = ["aaa bbb ccc ddd eee fff", "aaa bbb ccc ddd eee fff",
                 "zzz yyy xxx www vvv uuu"]
        est = RedundancyEstimator(text_sim="minhash")
        scores = est.score_texts(texts)
        assert scores[0] == pytest.approx(1.0)
        assert scores[1] == pytest.approx(1.0)
        assert scores[2] < 0.5

    def test_simhash_mode(self):
        texts = ["alpha beta gamma delta epsilon zeta", "alpha beta gamma delta epsilon zeta",
                 "one two three four five six"]
        fps = simhash_bits(texts)
        assert fps[0] == fps[1]
        est = RedundancyEstimator(text_sim="simhash")
        scores = est.score_texts(texts)
        assert scores[0] == pytest.approx(1.0)

    def test_near_duplicate_clusters(self):
        texts = ["the cat sat on the mat today fine", "the cat sat on the mat today fine",
                 "some other sentence entirely different now"]
        est = RedundancyEstimator(threshold=0.9)
        clusters = est.near_duplicate_clusters(texts=texts)
        sizes = sorted(len(c) for c in clusters)
        assert sizes == [1, 2]

    def test_topk_density_duplicates_densest(self):
        from dewi.signals.redundancy import topk_density

        rng = np.random.default_rng(3)
        emb = rng.normal(size=(24, 16)).astype(np.float32)
        emb[5] = emb[4]  # dense cluster of 3 near-identical rows
        emb[6] = emb[4] + 0.01 * rng.normal(size=16).astype(np.float32)
        d = topk_density(emb, top=2, block=8)
        assert d.shape == (24,)
        assert np.all(d <= 1.0 + 1e-5)
        # Cluster members' top-2 neighborhoods are ~identical rows.
        assert d[4] > 0.95 and d[5] > 0.95
        assert d[4] > np.median(d) + 0.1

    def test_topk_density_matches_max_when_top1(self):
        from dewi.signals.redundancy import topk_density

        rng = np.random.default_rng(4)
        emb = rng.normal(size=(15, 8)).astype(np.float32)
        np.testing.assert_allclose(
            topk_density(emb, top=1, block=8),
            max_offdiag_similarity(emb, block=8),
            atol=1e-5,
        )

    def test_cross_modal_density_scores(self):
        est = RedundancyEstimator(block_size=8)
        rng = np.random.default_rng(5)
        emb = rng.normal(size=(10, 12)).astype(np.float32)
        emb[8] = emb[0]
        emb[9] = emb[0]  # trio of identical joint embeddings
        d = est.cross_modal_density_scores(emb, top=2)
        assert d.shape == (10,)
        assert d[0] > 0.9 and d[8] > 0.9 and d[9] > 0.9

    def test_embedding_clusters(self):
        rng = np.random.default_rng(2)
        emb = rng.normal(size=(6, 8)).astype(np.float32)
        emb[5] = emb[0] * 2.0  # same direction
        est = RedundancyEstimator(threshold=0.99, block_size=3)
        clusters = est.near_duplicate_clusters(embeddings=emb)
        assert any(set(c) == {0, 5} for c in clusters)


class TestBatchedImageNoise:
    """Device-batched blur + skin kernel (ops/image_noise.py) vs the scalar
    per-image path it replaces in pre-decoded/packed corpora."""

    def _imgs(self, n=6, size=64, seed=0):
        rng = np.random.default_rng(seed)
        imgs = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
        imgs[0] = 128  # flat -> decisively blurry
        return imgs

    def test_kernel_matches_scalar_components(self):
        from dewi.ops.image_noise import batched_image_noise
        from dewi.signals.noise import skin_fraction_risk

        est = NoiseEstimator()
        imgs = self._imgs()
        blur, skin = batched_image_noise(imgs)
        for i in range(len(imgs)):
            want_blur = est.blur_score(imgs[i])
            # Scalar path quantizes the PIL-upscaled image to uint8 before
            # the luma dot; the batched path stays in f32 (documented).
            assert blur[i] == pytest.approx(want_blur, abs=0.05, rel=0.1)
            want_risk = skin_fraction_risk(imgs[i])
            got_risk = float(np.clip((skin[i] - 0.3) / 0.5, 0.0, 1.0))
            assert got_risk == pytest.approx(want_risk, abs=1e-5)

    def test_batch_compute_fastpath_matches_scalar_loop(self, monkeypatch):
        imgs = list(self._imgs())
        texts = [f"some doc {i}" for i in range(len(imgs))]
        texts[2] = None
        imgs[3] = None
        est = NoiseEstimator()
        fast = est.batch_compute(texts=texts, images=imgs)
        monkeypatch.setattr(est, "_batch_image_parts", lambda images: None)
        slow = est.batch_compute(texts=texts, images=imgs)
        # Decisively-sharp/flat inputs: the blur indicator agrees, skin is
        # exact at 64 px, so the combined scores match to float noise.
        np.testing.assert_allclose(fast, slow, atol=1e-5)

    def test_mixed_shapes_grouped(self):
        rng = np.random.default_rng(3)
        imgs = [
            rng.integers(0, 256, (64, 64, 3), dtype=np.uint8),
            rng.integers(0, 256, (96, 96, 3), dtype=np.uint8),
            None,
        ]
        est = NoiseEstimator()
        part = est._batch_image_parts(imgs)
        assert part is not None
        assert np.isfinite(part[0]) and np.isfinite(part[1])
        assert np.isnan(part[2])

    def test_ineligible_inputs_fall_back(self):
        est = NoiseEstimator()
        # float image -> scalar loop
        assert est._batch_image_parts(
            [np.zeros((16, 16, 3), np.float32)]
        ) is None
        # oversized image -> scalar loop (PIL area downscale differs)
        assert est._batch_image_parts(
            [np.zeros((512, 512, 3), np.uint8)]
        ) is None
        # custom nsfw_fn -> scalar loop
        est2 = NoiseEstimator(nsfw_fn=lambda im: 0.9)
        assert est2._batch_image_parts(
            [np.zeros((16, 16, 3), np.uint8)]
        ) is None


class TestNoise:
    def test_text_quality_heuristics(self):
        est = NoiseEstimator()
        assert est.check_text_quality("") == 0.0
        assert est.check_text_quality("A normal clean sentence.") == pytest.approx(1.0)
        assert est.check_text_quality("!@#$%^&*()!@#$%^&*()") < 0.6

    def test_language_neutral_without_detector(self):
        est = NoiseEstimator()
        if est._lang_detect is None:
            assert est.check_language("hello there friend") == 0.5
        assert est.check_language("") == 0.5

    def test_nsfw_fallback_zero(self):
        est = NoiseEstimator()
        img = np.zeros((16, 16, 3), np.float32)
        assert est.detect_nsfw(img) == 0.0

    def test_nsfw_injectable(self):
        est = NoiseEstimator(nsfw_fn=lambda im: 0.9)
        assert est.detect_nsfw(None) == pytest.approx(0.9)
        est_off = NoiseEstimator(nsfw_fn=lambda im: 0.9, nsfw_filter="none")
        assert est_off.detect_nsfw(None) == 0.0

    def test_ocr_fallback_empty(self):
        est = NoiseEstimator()
        if est.ocr is None:
            assert est.ocr_text(None) == ""

    def test_combined_score_ordering(self):
        est = NoiseEstimator()
        clean = est.score(text="A perfectly normal readable sentence.")
        junk = est.score(text="#$%@!#$%@!#$%@!#$%@!")
        assert 0.0 <= clean < junk <= 1.0

    def test_blur_score_sharp_vs_flat(self):
        est = NoiseEstimator()
        flat = np.full((64, 64, 3), 0.5, np.float32)
        rng = np.random.default_rng(0)
        sharp = rng.random((64, 64, 3)).astype(np.float32)
        assert est.blur_score(flat) < est.blur_score(sharp)

    def test_batch_compute(self):
        est = NoiseEstimator()
        out = est.batch_compute(texts=["good text here", ""])
        assert len(out) == 2
        assert all(0.0 <= v <= 1.0 for v in out)

    def test_nsfw_lite_skin_heuristic(self):
        """nsfw_filter='lite' does something measurable (VERDICT r1 item 7):
        a skin-toned frame scores higher risk than a blue one."""
        from dewi.signals.noise import skin_fraction_risk

        skin = np.broadcast_to(
            np.array([0.91, 0.65, 0.52], np.float32), (32, 32, 3)
        ).copy()
        blue = np.broadcast_to(
            np.array([0.1, 0.2, 0.9], np.float32), (32, 32, 3)
        ).copy()
        assert skin_fraction_risk(skin) > 0.8
        assert skin_fraction_risk(blue) == 0.0

        est = NoiseEstimator(nsfw_filter="lite")
        assert est.detect_nsfw(skin) > est.detect_nsfw(blue)
        # none-mode stays inert; injected fn still wins over the heuristic.
        assert NoiseEstimator(nsfw_filter="none").detect_nsfw(skin) == 0.0
        assert NoiseEstimator(nsfw_fn=lambda im: 0.33).detect_nsfw(skin) == (
            pytest.approx(0.33)
        )

    def test_ocr_coverage_penalty_wired(self, monkeypatch):
        """ocr_min_coverage now gates a noise penalty for image docs whose
        OCR text is garbled (VERDICT r1 item 6 / reference noise.py:91-97
        dead-end resolved)."""
        est = NoiseEstimator(ocr_min_coverage=0.9, nsfw_filter="none")
        img = np.full((32, 32, 3), 0.5, np.float32)

        monkeypatch.setattr(est, "ocr_text", lambda im: "")
        assert est.ocr_coverage_penalty(img) == 0.0  # no text = neutral

        monkeypatch.setattr(est, "ocr_text",
                            lambda im: "A clean readable sentence.")
        clean_pen = est.ocr_coverage_penalty(img)

        monkeypatch.setattr(est, "ocr_text", lambda im: "#$%@!#" * 10)
        garbled_pen = est.ocr_coverage_penalty(img)
        assert garbled_pen > clean_pen >= 0.0
        # and it reaches the combined score for image docs
        noisy = est.score(image=img)
        monkeypatch.setattr(est, "ocr_text", lambda im: "")
        assert est.score(image=img) <= noisy


class TestPerceptualHash:
    def test_phash_invariant_to_small_noise(self):
        from dewi.signals.redundancy import phash64, phash_similarity

        rng = np.random.default_rng(0)
        base = rng.random((64, 64, 3)).astype(np.float32)
        near = np.clip(base + rng.normal(0, 0.01, base.shape), 0, 1).astype(
            np.float32
        )
        other = rng.random((64, 64, 3)).astype(np.float32)
        h0, h1, h2 = phash64(base), phash64(near), phash64(other)
        assert phash_similarity(h0, h1) > 0.9
        assert phash_similarity(h0, h2) < phash_similarity(h0, h1)

    def test_score_images_flags_duplicates(self):
        from dewi.signals.redundancy import RedundancyEstimator

        rng = np.random.default_rng(1)
        imgs = [rng.random((64, 64, 3)).astype(np.float32) for _ in range(5)]
        imgs.append(imgs[0].copy())  # exact duplicate of image 0
        est = RedundancyEstimator(image_sim="phash")
        scores = est.score_images(imgs)
        assert scores[0] == pytest.approx(1.0)
        assert scores[5] == pytest.approx(1.0)
        assert scores[1] < 1.0

    def test_pipeline_phash_mode(self):
        from dewi.pipelines import Document, DewiPipeline
        from tests.test_pipeline import tiny_config

        rng = np.random.default_rng(2)
        img = rng.random((32, 32, 3)).astype(np.float32)
        docs = [
            Document(doc_id="i0", image=img),
            Document(doc_id="i1", image=img.copy()),
            Document(doc_id="i2",
                     image=rng.random((32, 32, 3)).astype(np.float32)),
            Document(doc_id="t0", text="some text document"),
        ]
        cfg = tiny_config(redundancy={"image_sim": "phash", "block_size": 4})
        pipe = DewiPipeline(cfg)
        pipe.compute_signals(docs)
        assert docs[0].redundancy == pytest.approx(1.0)
        assert docs[1].redundancy == pytest.approx(1.0)
        assert docs[2].redundancy < 1.0
        assert docs[3].redundancy is not None  # text fell back to embedding


class TestLongDocuments:
    def test_window_merge_covers_all_tokens(self):
        est = TextEntropyEstimator(model_name="tiny", batch_size=2,
                                   max_length=32)
        text = "alpha beta gamma " * 40  # far beyond 32 tokens
        r = est.compute_entropy(text)
        full = len(est.tokenizer.encode(text, 1 << 30))
        assert len(r.token_entropies) == full - 1
        assert r.mean_entropy == pytest.approx(
            float(np.mean(r.token_entropies)), rel=1e-4
        )

    def test_long_matches_quantile_definition(self):
        est = TextEntropyEstimator(model_name="tiny", batch_size=2,
                                   max_length=32)
        r = est.compute_entropy("xyz " * 50)
        toks = np.asarray(r.token_entropies)
        assert r.q90_entropy == pytest.approx(float(np.quantile(toks, 0.9)),
                                              abs=1e-4)

    def test_mixed_long_and_short_batch(self):
        est = TextEntropyEstimator(model_name="tiny", batch_size=2,
                                   max_length=32)
        long_text = "gamma delta " * 60
        out = est.batch_compute([long_text, "tiny", ""])
        full = len(est.tokenizer.encode(long_text, 1 << 30))
        assert len(out[0].token_entropies) == full - 1
        assert len(out[1].token_entropies) == len(
            est.compute_entropy("tiny").token_entropies
        )
        assert out[2].token_entropies == []


class TestBatchStats:
    def test_stats_match_full_path(self):
        est = TextEntropyEstimator(model_name="tiny", batch_size=4,
                                   max_length=64)
        texts = ["alpha beta gamma delta", "x", "some longer text here " * 3,
                 ""]
        full = est.batch_compute(texts)
        means, q90s, q99s = est.batch_compute_stats(texts)
        for i, r in enumerate(full):
            assert means[i] == pytest.approx(r.mean_entropy, abs=1e-4)
            assert q90s[i] == pytest.approx(r.q90_entropy, abs=1e-4)
            assert q99s[i] == pytest.approx(r.q99_entropy, abs=1e-4)

    def test_stats_long_docs(self):
        est = TextEntropyEstimator(model_name="tiny", batch_size=2,
                                   max_length=32)
        long_text = "word " * 80
        full = est.compute_entropy(long_text)
        means, q90s, _ = est.batch_compute_stats([long_text, "short"])
        assert means[0] == pytest.approx(full.mean_entropy, abs=1e-4)
        assert q90s[0] == pytest.approx(full.q90_entropy, abs=1e-4)

    def test_stats_empty(self):
        est = TextEntropyEstimator(model_name="tiny", batch_size=2,
                                   max_length=32)
        m, a, b = est.batch_compute_stats([])
        assert len(m) == 0


class TestImageSuperbatch:
    def test_superbatch_matches_single_path(self):
        est = ImageEntropyEstimator(model_name="tiny", batch_size=2)
        rng = np.random.default_rng(0)
        imgs = [rng.random((32, 32, 3)).astype(np.float32) for _ in range(20)]
        m_all, q_all = est.batch_compute_stats(imgs, seed=5)  # 10 batches: 8 super + 2 single
        assert len(m_all) == 20
        # Determinism across calls.
        m2, q2 = est.batch_compute_stats(imgs, seed=5)
        np.testing.assert_allclose(m_all, m2, rtol=1e-6)
        np.testing.assert_allclose(q_all, q2, rtol=1e-6)
        assert np.all(m_all > 0)


class TestCLIPSuperbatch:
    def test_encode_texts_many_chunks(self, clip_est):
        # 40 texts at batch_size=4 -> 10 chunks: 8 superbatched + 2 single.
        texts = [f"caption number {i}" for i in range(40)]
        e = clip_est.encode_texts(texts)
        assert e.shape == (40, clip_est.cfg.d_embed)
        np.testing.assert_allclose(np.linalg.norm(e, axis=1), 1.0, atol=1e-4)
        # Per-text embeddings must not depend on chunking.
        single = clip_est.encode_texts(texts[7:8])
        np.testing.assert_allclose(e[7], single[0], atol=1e-5)

    def test_encode_images_many_chunks(self, clip_est):
        rng = np.random.default_rng(0)
        imgs = [rng.random((32, 32, 3)).astype(np.float32) for _ in range(40)]
        e = clip_est.encode_images(imgs)
        assert e.shape == (40, clip_est.cfg.d_embed)
        single = clip_est.encode_images(imgs[13:14])
        np.testing.assert_allclose(e[13], single[0], atol=1e-5)


class TestPackedTransfer:
    def test_packed_superbatch_matches_masked(self):
        """uint16 ids + device-derived mask == int32 ids + f32 mask."""
        import jax.numpy as jnp
        import numpy as np

        from dewi.signals.text_entropy import TextEntropyEstimator

        est = TextEntropyEstimator(model_name="tiny", batch_size=4)
        assert est._packed_ok
        texts = ["hello world", "a", "the quick brown fox", ""] * 2
        ids, mask = est.tokenizer.encode_batch(texts[:4], 32, pad_to=32)
        ids3 = np.stack([ids, ids])
        mask3 = np.stack([mask, mask])
        m1, q1 = est._score_super(est.params, jnp.asarray(ids3),
                                  jnp.asarray(mask3))
        m2, q2 = est._score_super_packed(
            est.params, jnp.asarray(ids3.astype(np.uint16)))
        np.testing.assert_allclose(np.asarray(m1), np.asarray(m2),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(q1), np.asarray(q2),
                                   rtol=1e-5, atol=1e-6)

    def test_cross_modal_packed_matches_masked(self):
        import jax.numpy as jnp
        import numpy as np

        from dewi.signals.cross_modal import CrossModalDependency

        cm = CrossModalDependency(model_name="tiny", batch_size=4)
        assert cm._packed_ok
        texts = ["solar panels", "fox", "", "entropy weighted index"]
        tl = cm.cfg.text_len
        ids, mask = cm.tokenizer.encode_batch(texts, tl, pad_to=tl)
        ids3 = np.stack([ids, ids])
        mask3 = np.stack([mask, mask])
        e1 = np.asarray(cm._encode_text_super(
            cm.params, jnp.asarray(ids3), jnp.asarray(mask3)))
        e2 = np.asarray(cm._encode_text_super_packed(
            cm.params, jnp.asarray(ids3.astype(np.uint16))))
        np.testing.assert_allclose(e1, e2, rtol=1e-5, atol=1e-6)

    def test_encode_batch_u16_matches_encode_batch(self):
        from dewi.signals.tokenizer import ByteTokenizer

        tok = ByteTokenizer()
        texts = ["hello", "", "a longer text with more bytes", "é ü 漢"]
        ids, _ = tok.encode_batch(texts, 32, pad_to=32)
        u16 = tok.encode_batch_u16(texts, 32, pad_to=32)
        assert u16.dtype == np.uint16
        np.testing.assert_array_equal(ids, u16.astype(np.int32))
