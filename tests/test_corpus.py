"""Columnar Corpus path: numerics parity with the Document pipeline,
index handoff, and the veneer round-trip."""

import numpy as np
import pytest

from dewi.config import DewiConfig
from dewi.corpus import COL, Corpus
from dewi.pipelines import DewiPipeline, Document, create_document
from dewi.types import SIGNAL_FIELDS


def tiny_config(**over) -> DewiConfig:
    return DewiConfig.from_dict({
        "text": {"model": "tiny", "batch_size": 4, "max_length": 64},
        "image": {"model": "tiny", "batch_size": 2, "image_size": 32,
                  "patch_size": 8},
        "cross_modal": {"model": "tiny", "batch_size": 4},
        "redundancy": {"block_size": 8},
        **over,
    })


def make_docs():
    rng = np.random.default_rng(0)
    return [
        create_document("d0", text="the quick brown fox jumps over the dog"),
        create_document("d1", text="the quick brown fox jumps over the dog"),
        Document(doc_id="d2", text="completely different text entirely",
                 image=rng.random((32, 32, 3)).astype(np.float32)),
        Document(doc_id="d3",
                 image=rng.random((32, 32, 3)).astype(np.float32)),
        create_document("d4", text="short words here"),
    ]


class TestCorpusContainer:
    def test_from_documents_round_trip(self):
        docs = make_docs()
        c = Corpus.from_documents(docs)
        assert len(c) == 5
        assert list(c.has_text) == [True, True, True, False, True]
        assert list(c.has_image) == [False, False, True, True, False]
        back = c.to_documents()
        assert [d.doc_id for d in back] == [d.doc_id for d in docs]
        assert back[3].text is None and back[3].image is not None

    def test_mixed_dim_external_embeddings_raise(self):
        """One malformed embedding must fail loudly, not silently discard
        every user vector and re-encode the corpus in CLIP space."""
        from dewi.pipelines import Document

        docs = [
            Document(doc_id="a", text="x", embedding=np.zeros(8, np.float32)),
            Document(doc_id="b", text="y", embedding=np.zeros(9, np.float32)),
        ]
        with pytest.raises(ValueError, match="mixed"):
            Corpus.from_documents(docs)

    def test_columnar_ctor_validation(self):
        with pytest.raises(ValueError):
            Corpus(ids=["a", "b"], texts=["x"])
        with pytest.raises(ValueError):
            Corpus(ids=["a"], signals=np.zeros((2, 7), np.float32))

    def test_payload_matrix_order(self):
        c = Corpus(ids=["a", "b"])
        c.signals[:] = np.arange(14, dtype=np.float32).reshape(2, 7)
        c.dewi = np.array([0.5, 0.9], np.float32)
        pm = c.payload_matrix()
        assert pm.shape == (2, 8)
        assert pm[0, 0] == 0.5 and pm[1, 0] == pytest.approx(0.9)
        np.testing.assert_array_equal(pm[:, 1:], c.signals)


class TestColumnarParity:
    @pytest.fixture(scope="class")
    def both_paths(self):
        # Same pipeline (shared estimators/seeds) run over both code paths.
        pipe = DewiPipeline(tiny_config())
        obj_docs = pipe.compute_dewi_scores(
            pipe.compute_signals(make_docs())
        )
        corpus = pipe.process_corpus(Corpus.from_documents(make_docs()))
        return obj_docs, corpus

    def test_signals_match_document_path(self, both_paths):
        obj_docs, corpus = both_paths
        for i, d in enumerate(obj_docs):
            for name in SIGNAL_FIELDS:
                want = float(getattr(d, name) or 0.0)
                got = float(corpus.signals[i, COL[name]])
                assert got == pytest.approx(want, abs=1e-4), (d.doc_id, name)

    def test_scores_match_document_path(self, both_paths):
        obj_docs, corpus = both_paths
        for i, d in enumerate(obj_docs):
            assert float(corpus.dewi[i]) == pytest.approx(
                d.dewi_score, abs=1e-5
            )

    def test_embeddings_match_document_path(self, both_paths):
        obj_docs, corpus = both_paths
        emb_obj = np.stack([d.embedding for d in obj_docs])
        np.testing.assert_allclose(
            corpus.embeddings, emb_obj, atol=1e-5
        )


class TestColumnarStream:
    def test_sharded_matches_monolithic(self):
        # Global redundancy + global fit: sharding must not change any
        # signal or score (same contract as object process_stream).
        pipe = DewiPipeline(tiny_config())
        mono = pipe.process_corpus(Corpus.from_documents(make_docs()))
        pipe2 = DewiPipeline(tiny_config())
        shard = pipe2.process_stream_corpus(
            Corpus.from_documents(make_docs()), shard_size=2
        )
        np.testing.assert_allclose(shard.signals, mono.signals, atol=1e-4)
        np.testing.assert_allclose(shard.dewi, mono.dewi, atol=1e-5)
        np.testing.assert_allclose(
            shard.embeddings, mono.embeddings, atol=1e-5
        )
        assert getattr(shard, "clip_embedded", False)

    def test_shard_resume_skips_completed(self, tmp_path):
        pipe = DewiPipeline(tiny_config())
        first = pipe.process_stream_corpus(
            Corpus.from_documents(make_docs()), shard_size=2,
            checkpoint_dir=tmp_path,
        )
        assert len(list(tmp_path.glob("shard_*.npz"))) == 3
        # Second run must not recompute any shard's signals.
        pipe2 = DewiPipeline(tiny_config())
        calls = []
        orig = pipe2.compute_signals_corpus
        pipe2.compute_signals_corpus = (
            lambda *a, **k: calls.append(1) or orig(*a, **k)
        )
        second = pipe2.process_stream_corpus(
            Corpus.from_documents(make_docs()), shard_size=2,
            checkpoint_dir=tmp_path,
        )
        assert calls == []  # every shard resumed from its checkpoint
        np.testing.assert_allclose(second.signals, first.signals, atol=1e-6)
        np.testing.assert_allclose(second.dewi, first.dewi, atol=1e-6)
        np.testing.assert_allclose(
            second.embeddings, first.embeddings, atol=1e-6
        )

    def test_shard_digest_mismatch_recomputes(self, tmp_path):
        pipe = DewiPipeline(tiny_config())
        pipe.process_stream_corpus(
            Corpus.from_documents(make_docs()), shard_size=2,
            checkpoint_dir=tmp_path,
        )
        docs = make_docs()
        docs[0].text = "edited text, same doc count"  # changes shard 0
        pipe2 = DewiPipeline(tiny_config())
        calls = []
        orig = pipe2.compute_signals_corpus
        pipe2.compute_signals_corpus = (
            lambda *a, **k: calls.append(1) or orig(*a, **k)
        )
        pipe2.process_stream_corpus(
            Corpus.from_documents(docs), shard_size=2,
            checkpoint_dir=tmp_path,
        )
        assert len(calls) == 1  # only the edited shard recomputed

    def test_shard_digest_same_length_edit_recomputes(self, tmp_path):
        # Digest covers text CONTENT (same contract as _StageCheckpoint) —
        # a same-length edit must invalidate the shard cache.
        pipe = DewiPipeline(tiny_config())
        pipe.process_stream_corpus(
            Corpus.from_documents(make_docs()), shard_size=2,
            checkpoint_dir=tmp_path,
        )
        docs = make_docs()
        assert len(docs[0].text) == len(docs[1].text)
        docs[0].text = docs[0].text[:-1] + "X"  # same length, new content
        pipe2 = DewiPipeline(tiny_config())
        calls = []
        orig = pipe2.compute_signals_corpus
        pipe2.compute_signals_corpus = (
            lambda *a, **k: calls.append(1) or orig(*a, **k)
        )
        pipe2.process_stream_corpus(
            Corpus.from_documents(docs), shard_size=2,
            checkpoint_dir=tmp_path,
        )
        assert len(calls) == 1  # shard 0 recomputed, others resumed

    def test_shard_digest_no_field_aliasing(self):
        # id/text boundaries are delimited: ('x', '12') != ('x1', '2').
        from dewi.pipelines import DewiPipeline as P

        c1 = Corpus(ids=["x"], texts=["12"])
        c2 = Corpus(ids=["x1"], texts=["2"])
        assert P._corpus_shard_digest(c1, 0, 1) != \
            P._corpus_shard_digest(c2, 0, 1)

    def test_sharded_dense_image_corpus(self):
        # _slice_images must hand shards real row views of a dense
        # [N, S, S, 3] corpus (an ndarray's .data memoryview is NOT one).
        rng = np.random.default_rng(7)
        imgs = (rng.random((5, 32, 32, 3)) * 255).astype(np.uint8)
        pipe = DewiPipeline(tiny_config())
        corpus = Corpus(
            ids=[f"i{k}" for k in range(5)],
            texts=[None] * 5,
            images=imgs,
        )
        pipe.process_stream_corpus(corpus, shard_size=2)
        assert np.all(corpus.signals[:, COL["hi_mean"]] != 0)

    def test_sharded_build_index_does_not_reencode(self):
        # After the sharded pass filled every row, build_index_corpus must
        # not silently redo the full monolithic tower encode.
        pipe = DewiPipeline(tiny_config())
        dim = pipe.cross_modal.cfg.d_embed
        ext = np.random.default_rng(9).normal(size=(1, dim)).astype(
            np.float32
        )
        docs = [
            create_document("t0", text="the quick brown fox"),
            create_document("e0", text=None, embedding=ext[0]),
            create_document("t1", text="lazy dogs sleep"),
        ]
        corpus = pipe.process_stream_corpus(
            Corpus.from_documents(docs), shard_size=2
        )
        filled = corpus.embeddings.copy()
        pipe.cross_modal.encode_texts = None  # any re-encode would crash
        idx = pipe.build_index_corpus(corpus)
        assert idx.encoder["source"] == "mixed"
        np.testing.assert_array_equal(corpus.embeddings, filled)

    def test_partial_external_embeddings_sharded(self):
        # The partial-embeddings contract holds across shard boundaries.
        pipe = DewiPipeline(tiny_config())
        dim = pipe.cross_modal.cfg.d_embed
        rng = np.random.default_rng(3)
        ext = rng.normal(size=(2, dim)).astype(np.float32)
        docs = [
            create_document("t0", text="the quick brown fox"),
            create_document("e0", text=None, embedding=ext[0]),
            create_document("t1", text="lazy dogs sleep all day"),
            create_document("e1", text=None, embedding=ext[1]),
        ]
        corpus = pipe.process_stream_corpus(
            Corpus.from_documents(docs), shard_size=3
        )
        np.testing.assert_array_equal(corpus.embeddings[1], ext[0])
        np.testing.assert_array_equal(corpus.embeddings[3], ext[1])
        idx = pipe.build_index_corpus(corpus)
        assert idx.encoder["source"] == "mixed"


class TestColumnarIndexHandoff:
    def test_build_index_corpus_matches_build_index(self):
        pipe = DewiPipeline(tiny_config())
        obj_docs = pipe.compute_dewi_scores(pipe.compute_signals(make_docs()))
        idx_obj = pipe.build_index(obj_docs)

        pipe2 = DewiPipeline(tiny_config())
        corpus = pipe2.process_corpus(Corpus.from_documents(make_docs()))
        idx_col = pipe2.build_index_corpus(corpus)

        assert len(idx_col) == len(idx_obj) == 5
        q = pipe2.encode_query("quick brown fox")
        ro = idx_obj.search(q, k=3)
        rc = idx_col.search(q, k=3)
        assert [r[0] for r in rc] == [r[0] for r in ro]
        np.testing.assert_allclose(
            [r[1] for r in rc], [r[1] for r in ro], atol=1e-5
        )
        assert idx_col.encoder["source"] == "cross_modal"

    def test_external_embeddings_provenance(self):
        pipe = DewiPipeline(tiny_config())
        rng = np.random.default_rng(1)
        c = Corpus(
            ids=[f"e{i}" for i in range(4)],
            texts=[f"text {i}" for i in range(4)],
            embeddings=rng.normal(size=(4, 16)).astype(np.float32),
        )
        pipe.process_corpus(c)
        idx = pipe.build_index_corpus(c)
        assert idx.encoder == {"source": "external"}

    def test_partial_external_skips_covered_tower_rows(self):
        """Text docs that already carry external embeddings (and aren't
        cross-modal pairs) must not ride the CLIP text tower — review
        finding: all of tidx was encoded, then 90% discarded."""
        pipe = DewiPipeline(tiny_config())
        dim = pipe.cross_modal.cfg.d_embed
        rng = np.random.default_rng(4)
        ext = rng.normal(size=(2, dim)).astype(np.float32)
        docs = [
            create_document("t0", text="needs clip fill"),
            create_document("t1", text="this one too"),
            create_document("x0", text="has external vector",
                            embedding=ext[0]),
            create_document("x1", text="also external", embedding=ext[1]),
        ]
        corpus = Corpus.from_documents(docs)
        sizes = []
        orig = pipe.cross_modal.encode_texts

        def spy(texts, *a, **kw):
            sizes.append(len(texts))
            return orig(texts, *a, **kw)

        pipe.cross_modal.encode_texts = spy
        pipe.process_corpus(corpus)
        # Only the 2 fill rows hit the tower (no image docs -> no pairs).
        assert sizes and max(sizes) <= 2, sizes
        np.testing.assert_array_equal(corpus.embeddings[2:], ext)
        norms = np.linalg.norm(corpus.embeddings[:2], axis=1)
        np.testing.assert_allclose(norms, 1.0, atol=1e-5)

    def test_partial_external_embeddings_preserved(self):
        # CLI scenario: --texts dir/ plus --embeddings file.npz loads text
        # docs WITHOUT embeddings alongside embedding-only docs; the
        # columnar path must keep the supplied vectors and CLIP-fill only
        # the missing rows (round-3 review finding: they were zeroed).
        pipe = DewiPipeline(tiny_config())
        dim = pipe.cross_modal.cfg.d_embed
        rng = np.random.default_rng(2)
        ext = rng.normal(size=(2, dim)).astype(np.float32)
        docs = [
            create_document("t0", text="the quick brown fox"),
            create_document("t1", text="lazy dogs sleep all day"),
            create_document("e0", text=None, embedding=ext[0]),
            create_document("e1", text=None, embedding=ext[1]),
        ]
        corpus = Corpus.from_documents(docs)
        assert corpus.embeddings is not None
        assert list(corpus.ext_embedding_mask) == [False, False, True, True]
        pipe.process_corpus(corpus)
        # Supplied rows untouched, text rows CLIP-filled (unit norm).
        np.testing.assert_array_equal(corpus.embeddings[2:], ext)
        norms = np.linalg.norm(corpus.embeddings[:2], axis=1)
        np.testing.assert_allclose(norms, 1.0, atol=1e-5)
        back = corpus.apply_to_documents(docs)
        np.testing.assert_array_equal(back[2].embedding, ext[0])
        idx = pipe.build_index_corpus(corpus)
        assert idx.encoder["source"] == "mixed"
        # Parity: the object path records the same mixed provenance.
        docs2 = [
            create_document("t0", text="the quick brown fox"),
            create_document("t1", text="lazy dogs sleep all day"),
            create_document("e0", text=None, embedding=ext[0]),
            create_document("e1", text=None, embedding=ext[1]),
        ]
        pipe2 = DewiPipeline(tiny_config())
        idx2 = pipe2.build_index(
            pipe2.compute_dewi_scores(pipe2.compute_signals(docs2))
        )
        assert idx2.encoder["source"] == "mixed"
        np.testing.assert_array_equal(docs2[2].embedding, ext[0])

    def test_partial_external_dim_mismatch_raises(self):
        pipe = DewiPipeline(tiny_config())
        docs = [
            create_document("t0", text="some text"),
            create_document(
                "e0", text=None,
                embedding=np.ones(7, np.float32),  # != d_embed
            ),
        ]
        corpus = Corpus.from_documents(docs)
        with pytest.raises(ValueError, match="dim"):
            pipe.ensure_embeddings_corpus(corpus)

    def test_empty_corpus_raises(self):
        pipe = DewiPipeline(tiny_config())
        with pytest.raises(ValueError):
            pipe.build_index_corpus(Corpus(ids=[]))


class TestColumnarPacked:
    def test_packed_corpus_flows(self, tmp_path):
        PIL = pytest.importorskip("PIL")
        from PIL import Image

        from dewi.io.packed import PackedImages, pack_images

        rng = np.random.default_rng(2)
        paths = []
        for i in range(4):
            arr = rng.integers(0, 256, (48, 48, 3), dtype=np.uint8)
            p = tmp_path / f"{i}.png"
            Image.fromarray(arr).save(p)
            paths.append(str(p))
        out = tmp_path / "c.npy"
        pack_images(paths, 32, out, workers=0)
        pack = PackedImages(out)
        c = Corpus(ids=[f"p{i}" for i in range(4)],
                   texts=[f"caption {i}" for i in range(4)],
                   images=pack)
        pipe = DewiPipeline(tiny_config())
        pipe.process_corpus(c)
        assert np.all(c.signals[:, COL["hi_mean"]] != 0.0)
        assert np.all(c.dewi >= 0.0) and np.all(c.dewi <= 1.0)


class TestSingleEncode:
    def test_towers_encode_once_per_modality(self):
        """I_hat and embeddings share ONE encode per CLIP tower (the
        double-encode was the dominant cost of image corpora)."""
        pipe = DewiPipeline(tiny_config())
        rng = np.random.default_rng(3)
        c = Corpus(
            ids=[f"m{i}" for i in range(4)],
            texts=[f"caption number {i}" for i in range(4)],
            images=rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8),
        )
        cm = pipe.cross_modal
        calls = {"texts": 0, "images": 0}
        orig_t, orig_v = cm.encode_texts, cm.encode_images

        def count_t(*a, **k):
            calls["texts"] += 1
            return orig_t(*a, **k)

        def count_v(*a, **k):
            calls["images"] += 1
            return orig_v(*a, **k)

        cm.encode_texts, cm.encode_images = count_t, count_v
        try:
            pipe.process_corpus(c)
        finally:
            cm.encode_texts, cm.encode_images = orig_t, orig_v
        assert calls["images"] == 1, calls
        assert calls["texts"] == 1, calls
        assert np.all(c.signals[:, COL["I_hat"]] != 0.0)
        assert c.embeddings is not None
