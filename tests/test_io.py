"""Image input pipeline: decode, prefetch ordering, cache, dtype flow.

The loader (dewi/io/images.py) replaces the reference's inline
per-stage, per-image decoding (reference image_entropy.py:39-49,
cross_modal.py:55-60) with threaded decode + prefetched uint8 batches.
"""

import numpy as np
import pytest

from dewi.io import (
    ImageCache,
    decode_batch,
    decode_image_uint8,
    iter_padded_batches,
    resize_uint8,
)

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402


def _write_images(tmp_path, n, size=96, fmt="PNG"):
    paths = []
    rng = np.random.default_rng(0)
    for i in range(n):
        arr = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        p = tmp_path / f"img_{i:03d}.{fmt.lower()}"
        Image.fromarray(arr).save(p, format=fmt)
        paths.append(str(p))
    return paths


class TestDecode:
    def test_png_roundtrip_exact(self, tmp_path):
        # PNG is lossless: decode at native size must be bit-exact.
        arr = np.random.default_rng(1).integers(
            0, 256, (64, 64, 3), dtype=np.uint8
        )
        p = tmp_path / "x.png"
        Image.fromarray(arr).save(p)
        out = decode_image_uint8(str(p), 64)
        np.testing.assert_array_equal(out, arr)

    def test_resize_shapes(self, tmp_path):
        (p,) = _write_images(tmp_path, 1, size=100)
        assert decode_image_uint8(p, 32).shape == (32, 32, 3)
        assert decode_image_uint8(p, 224).shape == (224, 224, 3)

    def test_jpeg_draft_close_to_full_decode(self, tmp_path):
        # Draft-mode decode (DCT-space downscale) must stay visually close
        # to the full decode + resize path.
        rng = np.random.default_rng(2)
        base = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
        smooth = np.asarray(
            Image.fromarray(base).resize((512, 512), Image.BILINEAR)
        )
        p = tmp_path / "big.jpg"
        Image.fromarray(smooth).save(p, quality=92)
        drafted = decode_image_uint8(str(p), 64).astype(np.float32)
        with Image.open(p) as img:  # full decode, no draft
            img.load()
            full = np.asarray(
                img.convert("RGB").resize((64, 64), Image.BILINEAR),
                dtype=np.float32,
            )
        assert np.abs(drafted - full).mean() < 16.0

    def test_array_inputs(self):
        f01 = np.random.default_rng(3).random((40, 40, 3)).astype(np.float32)
        out = decode_image_uint8(f01, 40)
        np.testing.assert_allclose(
            out.astype(np.float32) / 255.0, f01, atol=1 / 255.0 + 1e-6
        )
        u8 = (f01 * 255).astype(np.uint8)
        np.testing.assert_array_equal(decode_image_uint8(u8, 40), u8)
        gray = np.random.default_rng(4).random((16, 16)).astype(np.float32)
        assert decode_image_uint8(gray, 16).shape == (16, 16, 3)

    def test_resize_uint8_upsample(self):
        arr = np.random.default_rng(5).integers(
            0, 256, (8, 8, 3), dtype=np.uint8
        )
        assert resize_uint8(arr, 32).shape == (32, 32, 3)


class TestBatchAndPrefetch:
    def test_decode_batch_ordered(self, tmp_path):
        paths = _write_images(tmp_path, 7, size=48)
        got = decode_batch(paths, 48, threads=4)
        assert got.shape == (7, 48, 48, 3) and got.dtype == np.uint8
        for i, p in enumerate(paths):
            np.testing.assert_array_equal(got[i], decode_image_uint8(p, 48))

    @pytest.mark.parametrize("threads", [1, 4])
    def test_iter_padded_batches(self, tmp_path, threads):
        paths = _write_images(tmp_path, 10, size=32)
        batches = list(
            iter_padded_batches(paths, 32, batch_size=4, threads=threads)
        )
        assert [pad for _, pad in batches] == [0, 0, 2]
        flat = np.concatenate([b[: 4 - pad] for b, pad in batches])
        np.testing.assert_array_equal(flat, decode_batch(paths, 32, threads=1))
        # Padding rows are zeros.
        assert not batches[-1][0][2:].any()

    def test_prefetch_error_surfaces(self, tmp_path):
        paths = _write_images(tmp_path, 5, size=32) + ["/nonexistent.png"] * 3
        with pytest.raises(Exception):
            list(iter_padded_batches(paths, 32, batch_size=2, threads=4))

    def test_early_break_does_not_hang(self, tmp_path):
        paths = _write_images(tmp_path, 12, size=32)
        it = iter_padded_batches(paths, 32, batch_size=2, threads=4, depth=1)
        next(it)
        it.close()  # generator closed mid-stream: producer must unwind


class TestNativeJpegPool:
    """GIL-free libjpeg decode pool (native/dewi_jpeg.cpp)."""

    @pytest.fixture(autouse=True)
    def _need_pool(self):
        from dewi import native

        if not native.jpeg_pool_available():
            pytest.skip("native jpeg pool unavailable")

    def test_batch_matches_pil_closely(self, tmp_path):
        from dewi import native

        paths = _write_images(tmp_path, 5, size=96, fmt="JPEG")
        res = native.decode_jpeg_batch(paths, 48, threads=2)
        assert res is not None
        dec, ok = res
        assert dec.shape == (5, 48, 48, 3) and dec.dtype == np.uint8
        assert ok.all()
        for i, p in enumerate(paths):
            # Same libjpeg decode; only the resize filters differ slightly.
            pil = decode_image_uint8(p, 48).astype(np.float32)
            assert np.abs(dec[i].astype(np.float32) - pil).mean() < 8.0

    def test_draft_scale_engages(self, tmp_path):
        # 512 -> 64 is a 1/8 DCT-space decode on both paths.
        from dewi import native

        rng = np.random.default_rng(5)
        base = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
        smooth = np.asarray(
            Image.fromarray(base).resize((512, 512), Image.BILINEAR)
        )
        p = tmp_path / "big.jpg"
        Image.fromarray(smooth).save(p, quality=92)
        dec, ok = native.decode_jpeg_batch([str(p)], 64)
        assert ok.all()
        pil = decode_image_uint8(str(p), 64).astype(np.float32)
        assert np.abs(dec[0].astype(np.float32) - pil).mean() < 4.0

    def test_non_jpeg_and_missing_flagged(self, tmp_path):
        from dewi import native

        paths = _write_images(tmp_path, 2, size=32, fmt="PNG")
        paths.append(str(tmp_path / "missing.jpg"))
        dec, ok = native.decode_jpeg_batch(paths, 32)
        assert not ok.any()

    def test_truncated_and_garbage_jpeg_no_crash(self, tmp_path):
        # libjpeg's default error handler exit()s the process; the pool's
        # setjmp error manager must contain per-file failures instead.
        from dewi import native

        (good,) = _write_images(tmp_path, 1, size=64, fmt="JPEG")
        data = (tmp_path / "img_000.jpeg").read_bytes() \
            if (tmp_path / "img_000.jpeg").exists() else open(good, "rb").read()
        trunc = tmp_path / "trunc.jpg"
        trunc.write_bytes(data[: len(data) // 2])
        garbage = tmp_path / "garbage.jpg"
        garbage.write_bytes(bytes(np.random.default_rng(0).integers(
            0, 256, 4096, dtype=np.uint8)))
        empty = tmp_path / "empty.jpg"
        empty.write_bytes(b"")
        dec, ok = native.decode_jpeg_batch(
            [good, str(trunc), str(garbage), str(empty)], 32, threads=2
        )
        assert ok[0]            # the valid file still decodes
        assert not ok[2] and not ok[3]
        # (truncated JPEGs may decode partially or fail; either is fine —
        # the only contract is no crash and a set flag)
        # Through decode_batch, an undecodable slot falls back to PIL which
        # keeps the existing raise-on-garbage contract.
        with pytest.raises(Exception):
            decode_batch([good, str(garbage)], 32)

    def test_decode_batch_mixed_fallback(self, tmp_path):
        # JPEGs decode natively; the PNG slot falls back to PIL bit-exactly.
        jpgs = _write_images(tmp_path, 2, size=64, fmt="JPEG")
        arr = np.random.default_rng(9).integers(
            0, 256, (32, 32, 3), dtype=np.uint8
        )
        png = tmp_path / "exact.png"
        Image.fromarray(arr).save(png)
        got = decode_batch(jpgs + [str(png)], 32, threads=2)
        assert got.shape == (3, 32, 32, 3)
        np.testing.assert_array_equal(got[2], arr)
        for i, p in enumerate(jpgs):
            pil = decode_image_uint8(p, 32).astype(np.float32)
            assert np.abs(got[i].astype(np.float32) - pil).mean() < 8.0


class TestImageCache:
    def test_cache_serves_all_sizes(self, tmp_path):
        paths = _write_images(tmp_path, 6, size=64)
        cache = ImageCache(paths, base_size=64, threads=2)
        assert len(cache) == 6
        np.testing.assert_array_equal(
            cache.at(64), decode_batch(paths, 64, threads=1)
        )
        small = cache.at(32)
        assert small.shape == (6, 32, 32, 3)
        # Derived arrays are cached (same object on second call).
        assert cache.at(32) is small
        with pytest.raises(ValueError):
            cache.at(128)

    def test_fits_budget(self):
        assert ImageCache.fits(10, 224, budget_mb=8)
        assert not ImageCache.fits(100_000, 224, budget_mb=1024)


class TestEstimatorIntegration:
    def test_image_entropy_uint8_matches_f32(self):
        from dewi.signals.image_entropy import ImageEntropyEstimator

        est = ImageEntropyEstimator(model_name="tiny", batch_size=2)
        sz = est.image_size
        rng = np.random.default_rng(6)
        u8 = rng.integers(0, 256, (3, sz, sz, 3), dtype=np.uint8)
        f32 = u8.astype(np.float32) / 255.0
        m_u8, q_u8 = est.batch_compute_stats(u8)
        m_f32, q_f32 = est.batch_compute_stats(list(f32))
        np.testing.assert_allclose(m_u8, m_f32, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(q_u8, q_f32, rtol=1e-4, atol=1e-5)

    def test_clip_encode_uint8_matches_f32(self):
        from dewi.signals.cross_modal import CrossModalDependency

        est = CrossModalDependency(model_name="tiny", batch_size=2)
        sz = est.cfg.image_size
        rng = np.random.default_rng(7)
        u8 = rng.integers(0, 256, (5, sz, sz, 3), dtype=np.uint8)
        f32 = u8.astype(np.float32) / 255.0
        e_u8 = est.encode_images(u8)
        e_f32 = est.encode_images(list(f32))
        np.testing.assert_allclose(e_u8, e_f32, rtol=1e-3, atol=1e-4)

    def test_pipeline_uses_cache_paths(self, tmp_path):
        from dewi.config import DewiConfig
        from dewi.pipelines import DewiPipeline, create_document

        paths = _write_images(tmp_path, 4, size=48)
        cfg = DewiConfig.from_dict({
            "text": {"model": "tiny", "batch_size": 2},
            "image": {"model": "tiny", "batch_size": 2, "image_size": 32,
                      "patch_size": 8},
            "cross_modal": {"model": "tiny", "batch_size": 2},
        })
        pipe = DewiPipeline(cfg)
        docs = [
            create_document(f"d{i}", text=f"sample text {i}", image_path=p)
            for i, p in enumerate(paths)
        ]
        pipe.compute_signals(docs)
        for d in docs:
            assert d.hi_mean is not None and d.hi_mean > 0
            assert d.I_hat is not None
            assert d.noise is not None

    def test_pipeline_streaming_fallback_matches_cache(self, tmp_path):
        from dewi.config import DewiConfig
        from dewi.pipelines import DewiPipeline, create_document

        paths = _write_images(tmp_path, 4, size=48)

        def run(decode_cache_mb):
            cfg = DewiConfig.from_dict({
                "text": {"model": "tiny", "batch_size": 2},
                "image": {"model": "tiny", "batch_size": 2, "image_size": 32,
                          "patch_size": 8},
                "cross_modal": {"model": "tiny", "batch_size": 2},
                "runtime": {"decode_cache_mb": decode_cache_mb},
            })
            pipe = DewiPipeline(cfg)
            docs = [
                create_document(f"d{i}", text=f"t {i}", image_path=p)
                for i, p in enumerate(paths)
            ]
            pipe.compute_signals(docs)
            return docs

        cached = run(decode_cache_mb=64)
        streamed = run(decode_cache_mb=0)  # cache never fits -> streaming
        for a, b in zip(cached, streamed):
            assert a.hi_mean == pytest.approx(b.hi_mean, rel=1e-5)
            assert a.I_hat == pytest.approx(b.I_hat, rel=1e-4, abs=1e-5)
            assert a.noise == pytest.approx(b.noise, rel=1e-5)


class TestCorpusBatchNormalization:
    def test_float_255_array_matches_list_of_arrays(self):
        """Regression: a 4D float array in [0,255] must score like the same
        images passed as a list (the fast path skipped /255)."""
        import numpy as np
        from dewi.signals.image_entropy import ImageEntropyEstimator

        rng = np.random.default_rng(0)
        imgs = rng.uniform(0, 255, size=(4, 32, 32, 3)).astype(np.float32)
        est = ImageEntropyEstimator(model_name="tiny", batch_size=4,
                                    image_size=32)
        a = np.asarray(est.batch_compute(imgs))
        b = np.asarray(est.batch_compute([imgs[i] for i in range(4)]))
        # list path round-trips uint8 decode; only quantization noise remains
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-3)


class TestPackedCorpus:
    def test_pack_and_mmap_roundtrip(self, tmp_path):
        from dewi.io.packed import PackedImages, is_packed_corpus, pack_images

        paths = _write_images(tmp_path, 6, size=64)
        out = tmp_path / "corpus.npy"
        meta = pack_images(paths, 32, out, workers=0)
        assert meta["n_images"] == 6 and meta["size"] == 32
        assert is_packed_corpus(out)
        pack = PackedImages(out)
        assert len(pack) == 6 and pack.base_size == 32
        # Rows match a direct decode exactly.
        from dewi.io import decode_image_uint8

        np.testing.assert_array_equal(pack[3], decode_image_uint8(paths[3], 32))

    def test_interrupted_pack_leaves_no_corpus(self, tmp_path):
        """pack_images writes to a temp file and renames at the end: a
        decode failure mid-pack must not leave a structurally valid
        all-zeros corpus at the final path (is_packed_corpus would accept
        it and later runs would silently score zero images)."""
        from dewi.io.packed import is_packed_corpus, pack_images

        paths = _write_images(tmp_path, 4, size=64)
        paths[2] = tmp_path / "missing.jpg"  # decode raises mid-pack
        out = tmp_path / "corpus.npy"
        with pytest.raises(Exception):
            pack_images(paths, 32, out, workers=0)
        assert not out.exists()
        assert not is_packed_corpus(out)
        assert not (tmp_path / "corpus.npy.tmp.npy").exists()

    def test_rows_full_range_zero_copy(self, tmp_path):
        from dewi.io.packed import PackedImages, pack_images

        paths = _write_images(tmp_path, 4, size=48)
        out = tmp_path / "c.npy"
        pack_images(paths, 32, out, workers=0)
        pack = PackedImages(out)
        full = pack.rows(list(range(4)), 32)
        assert full is pack.data  # the mapping itself, no copy
        sub = pack.rows([1, 3], 16)
        assert sub.shape == (2, 16, 16, 3) and sub.dtype == np.uint8

    def test_rows_oversize_warns_and_serves_base(self, tmp_path, caplog):
        from dewi.io.packed import PackedImages, pack_images

        paths = _write_images(tmp_path, 2, size=48)
        out = tmp_path / "c.npy"
        pack_images(paths, 32, out, workers=0)
        pack = PackedImages(out)
        import logging

        with caplog.at_level(logging.WARNING):
            got = pack.rows([0, 1], 64)
        assert got.shape[1] == 32
        assert any("Re-pack" in r.message for r in caplog.records)

    def test_rows_oversize_full_range_zero_copy(self, tmp_path):
        # size > base with a full-range request must serve the mapping
        # itself — a fancy-index here copies the whole file into RAM.
        from dewi.io.packed import PackedImages, pack_images

        paths = _write_images(tmp_path, 3, size=48)
        out = tmp_path / "c.npy"
        pack_images(paths, 32, out, workers=0)
        pack = PackedImages(out)
        assert pack.rows(list(range(3)), 64) is pack.data

    def test_corpus_scale_downscale_is_lazy(self, tmp_path, monkeypatch):
        # Downscale requests past MATERIALIZE_ROWS stream row-by-row
        # instead of pre-allocating [N, size, size, 3] host RAM.
        from dewi.io.packed import PackedImages, _ResizedRows, pack_images

        paths = _write_images(tmp_path, 5, size=48)
        out = tmp_path / "c.npy"
        pack_images(paths, 32, out, workers=0)
        pack = PackedImages(out)
        monkeypatch.setattr(PackedImages, "MATERIALIZE_ROWS", 2)
        lazy = pack.rows(list(range(5)), 16)
        assert isinstance(lazy, _ResizedRows) and len(lazy) == 5
        eager = np.stack([lazy[j] for j in range(5)])
        # Per-item, sliced, iterated, and small-eager access all agree.
        np.testing.assert_array_equal(lazy[1:3], eager[1:3])
        np.testing.assert_array_equal(np.stack(list(lazy)), eager)
        monkeypatch.setattr(PackedImages, "MATERIALIZE_ROWS", 8192)
        np.testing.assert_array_equal(pack.rows(list(range(5)), 16), eager)
        # The streaming batch iterator consumes the lazy view unchanged.
        from dewi.io.images import iter_corpus_batches

        chunks = [
            c[: len(c) - p] for c, p in
            iter_corpus_batches(lazy, 16, batch_size=2, threads=1)
        ]
        got = np.concatenate([np.asarray(c) for c in chunks])
        assert got.shape == (5, 16, 16, 3)

    def test_is_packed_rejects_other_npy(self, tmp_path):
        from dewi.io.packed import is_packed_corpus

        p = tmp_path / "other.npy"
        np.save(p, np.zeros((4, 8), np.float32))
        assert not is_packed_corpus(p)
        assert not is_packed_corpus(tmp_path / "missing.npy")

    def test_as_documents_views(self, tmp_path):
        from dewi.io.packed import PackedImages, pack_images

        paths = _write_images(tmp_path, 3, size=32)
        out = tmp_path / "c.npy"
        pack_images(paths, 32, out, workers=0)
        pack = PackedImages(out)
        docs = pack.as_documents(texts=["a", None, "c"])
        assert len(docs) == 3
        assert docs[0].text == "a" and docs[1].text is None
        src = docs[2].image_source()
        np.testing.assert_array_equal(np.asarray(src), pack[2])

    def test_signals_from_packed_documents(self, tmp_path):
        # End-to-end: packed rows flow through compute_signals untouched.
        from dewi.config import DewiConfig
        from dewi.io.packed import PackedImages, pack_images
        from dewi.pipelines import DewiPipeline

        paths = _write_images(tmp_path, 4, size=48)
        out = tmp_path / "c.npy"
        pack_images(paths, 32, out, workers=0)
        pack = PackedImages(out)
        cfg = DewiConfig.from_dict({
            "text": {"model": "tiny", "batch_size": 2, "max_length": 32},
            "image": {"model": "tiny", "batch_size": 2, "image_size": 32,
                      "patch_size": 8},
            "cross_modal": {"model": "tiny", "batch_size": 2},
        })
        docs = DewiPipeline(cfg).compute_signals(pack.as_documents())
        assert all(d.hi_mean is not None for d in docs)


class TestEffectiveThreads:
    def test_array_sources_serial(self):
        from dewi.io.images import effective_threads

        arrs = [np.zeros((8, 8, 3), np.uint8)] * 4
        assert effective_threads(8, arrs) == 1

    def test_single_core_serial(self, monkeypatch):
        import dewi.io.images as m

        monkeypatch.setattr(m.os, "cpu_count", lambda: 1)
        assert m.effective_threads(8, ["a.jpg"]) == 1

    def test_multicore_paths_clamped(self, monkeypatch):
        import dewi.io.images as m

        monkeypatch.setattr(m.os, "cpu_count", lambda: 4)
        assert m.effective_threads(8, ["a.jpg"]) == 4
        assert m.effective_threads(2, ["a.jpg"]) == 2


def test_effective_threads_accepts_array_sources():
    """A dense [N, H, W, 3] corpus is one ndarray, whose truth value is
    ambiguous: the pool clamp must test its length, not its truthiness."""
    from dewi.io.images import effective_threads

    imgs = np.zeros((4, 8, 8, 3), np.uint8)
    assert effective_threads(4, imgs) == 1
    assert effective_threads(4, list(imgs)) == 1
    assert effective_threads(4, []) >= 1
