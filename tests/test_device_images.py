"""Device-resident image corpus (io/device_images.py): upload once, every
stage slices HBM.  Covers slice/resize parity with the host helpers, the
budget gate, and full columnar-pipeline numeric parity device vs host."""

import numpy as np
import pytest

import dewi.io.device_images as di_mod
from dewi.config import DewiConfig
from dewi.corpus import Corpus
from dewi.io.device_images import DeviceImages, device_images_or_none
from dewi.io.images import iter_corpus_batches, resize_f32
from dewi.pipelines import DewiPipeline


def make_corpus(n=6, size=32, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    texts = [f"document number {i} with some words" for i in range(n)]
    return Corpus(ids=[f"d{i}" for i in range(n)], texts=texts, images=imgs)


def tiny_config():
    return DewiConfig.from_dict({
        "text": {"model": "tiny", "batch_size": 4, "max_length": 64},
        "image": {"model": "tiny", "batch_size": 2, "image_size": 32,
                  "patch_size": 8},
        "cross_modal": {"model": "tiny", "batch_size": 4, "image_size": 32},
        "redundancy": {"block_size": 8},
    })


class TestDeviceImages:
    def test_rows_at_same_size_is_exact(self):
        imgs = np.random.default_rng(1).integers(
            0, 256, (5, 16, 16, 3), dtype=np.uint8
        )
        dev = DeviceImages(imgs)
        np.testing.assert_array_equal(np.asarray(dev.rows_at(1, 4, 16)),
                                      imgs[1:4])

    def test_rows_at_resize_matches_resize_f32(self):
        imgs = np.random.default_rng(2).integers(
            0, 256, (3, 24, 24, 3), dtype=np.uint8
        )
        dev = DeviceImages(imgs)
        got = np.asarray(dev.rows_at(0, 3, 16))
        want = np.stack([
            resize_f32(im.astype(np.float32) / 255.0, 16) for im in imgs
        ])
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_gather_rows(self):
        imgs = np.random.default_rng(3).integers(
            0, 256, (6, 8, 8, 3), dtype=np.uint8
        )
        sub = DeviceImages(imgs).gather(np.array([4, 0, 2]))
        np.testing.assert_array_equal(np.asarray(sub.base), imgs[[4, 0, 2]])

    def test_iter_corpus_batches_matches_host(self):
        imgs = np.random.default_rng(4).integers(
            0, 256, (7, 16, 16, 3), dtype=np.uint8
        )
        host = list(iter_corpus_batches(imgs, 16, 3))
        dev = list(iter_corpus_batches(DeviceImages(imgs), 16, 3))
        assert [p for _, p in host] == [p for _, p in dev]
        for (hb, _), (db, _) in zip(host, dev):
            np.testing.assert_array_equal(hb, np.asarray(db))

    def test_budget_and_dtype_gates(self, monkeypatch):
        imgs = np.zeros((2, 8, 8, 3), np.uint8)
        assert device_images_or_none(imgs) is not None
        monkeypatch.setattr(di_mod, "MAX_BYTES", 0)
        assert device_images_or_none(imgs) is None
        monkeypatch.setattr(di_mod, "MAX_BYTES", 1 << 30)
        assert device_images_or_none(imgs.astype(np.float32)) is None
        assert device_images_or_none([imgs[0], imgs[1]]) is None


class TestNoisePresentMask:
    def test_array_path_matches_per_doc_list(self):
        from dewi.signals.noise import NoiseEstimator

        rng = np.random.default_rng(5)
        imgs = rng.integers(0, 256, (5, 32, 32, 3), dtype=np.uint8)
        present = np.array([True, False, True, True, False])
        texts = ["good plain text here", None, "x" * 10, None,
                 "another document"]
        est = NoiseEstimator()
        got = est.batch_compute(texts=texts, images=imgs, present=present)
        want = est.batch_compute(
            texts=texts,
            images=[imgs[i] if present[i] else None for i in range(5)],
        )
        np.testing.assert_allclose(got, want, atol=1e-6)


class TestColumnarDeviceParity:
    def test_process_corpus_device_vs_host(self, monkeypatch):
        # Same pipeline config, same seeds: the device-resident corpus path
        # must reproduce the host path bit-for-bit up to float tolerance.
        pipe_dev = DewiPipeline(tiny_config())
        c_dev = pipe_dev.process_corpus(make_corpus())
        assert pipe_dev._device_corpus(make_corpus()) is not None

        monkeypatch.setattr(di_mod, "MAX_BYTES", 0)
        pipe_host = DewiPipeline(tiny_config())
        c_host = pipe_host.process_corpus(make_corpus())
        assert pipe_host._device_corpus(make_corpus()) is None

        np.testing.assert_allclose(c_dev.signals, c_host.signals, atol=1e-4)
        np.testing.assert_allclose(c_dev.embeddings, c_host.embeddings,
                                   atol=1e-5)
        np.testing.assert_allclose(c_dev.dewi, c_host.dewi, atol=1e-4)

    def test_device_corpus_from_cache_positions(self):
        # Per-doc source lists decode into an img_idx-aligned cache; the
        # device wrapper must carry the doc->row map so subset gathers hit
        # the right rows.
        rng = np.random.default_rng(6)
        srcs = [None, rng.integers(0, 256, (32, 32, 3), dtype=np.uint8),
                None, rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)]
        c = Corpus(ids=["a", "b", "c", "d"],
                   texts=["t"] * 4, images=srcs)
        pipe = DewiPipeline(tiny_config())
        cache = pipe._decode_sources(
            [srcs[1], srcs[3]], [1, 3]
        )
        dev = pipe._device_corpus(c, cache)
        if dev is None:
            pytest.skip("no device available")
        dimgs, pos = dev
        assert pos is not None and pos[3] == 1
        rows = pipe._corpus_rows(c, [3], 32, cache, dev=dev)
        np.testing.assert_array_equal(
            np.asarray(rows.base)[0],
            cache.cache.base[1],
        )
