"""Framework integration: every subsystem in one flow on the CPU mesh.

corpus -> signals -> scores -> index -> (single-chip + sharded) search ->
eval -> DEWI^tau sampling -> LM training -> re-score with trained weights.
"""

import numpy as np
import pytest

from dewi import DewiConfig, DewiPipeline, create_document
from dewi.eval import evaluate_index
from dewi.sampling import sample_by_dewi, submodular_pick


@pytest.fixture(scope="module")
def flow():
    cfg = DewiConfig.from_dict({
        "text": {"model": "tiny", "batch_size": 4, "max_length": 64},
        "cross_modal": {"model": "tiny", "batch_size": 4},
        "redundancy": {"block_size": 8},
        "index": {"ann": "quantized", "refine_factor": 8},
    })
    pipe = DewiPipeline(cfg)
    corpus = [
        "the aurora is caused by solar particles striking the atmosphere",
        "the aurora is caused by solar particles striking the atmosphere",
        "quantum error correction encodes logical qubits redundantly",
        "fermentation converts sugars to ethanol in yeast metabolism",
        "buy cheap watches now !!! $$$ limited offer",
        "plate tectonics drives earthquakes along continental faults",
        "neural networks approximate functions with composed linear maps",
        "a b a b a b a b a b a b a b a b",
    ]
    docs = [create_document(f"d{i}", text=t) for i, t in enumerate(corpus)]
    docs = pipe.compute_signals(docs)
    docs = pipe.compute_dewi_scores(docs)
    index = pipe.build_index(docs)
    return cfg, pipe, docs, index


class TestFullStack:
    def test_signals_and_scores_complete(self, flow):
        _, _, docs, _ = flow
        for d in docs:
            assert d.ht_mean is not None
            assert d.redundancy is not None
            assert 0.0 <= d.dewi_score <= 1.0
        # The duplicate pair is maximally redundant.
        assert docs[0].redundancy == pytest.approx(1.0, abs=1e-3)
        assert docs[1].redundancy == pytest.approx(1.0, abs=1e-3)

    def test_quantized_backend_from_config(self, flow):
        from dewi.index import QuantizedIndex

        _, _, _, index = flow
        assert isinstance(index._backend, QuantizedIndex)

    def test_text_query_search_and_eval(self, flow):
        _, pipe, docs, index = flow
        # Random-init CLIP weights: only (near-)verbatim text maps to a
        # nearby embedding, so query with the document sentence itself.
        q = pipe.encode_query(docs[0].text)
        hits = index.search(q, k=2, eta=0.0)
        assert hits[0][0] in ("d0", "d1")
        report = evaluate_index(index, np.stack([q]), {"q0": ["d0", "d1"]})
        assert report["recall@5"] == pytest.approx(1.0)

    def test_sharded_search_matches_single_chip(self, flow):
        from dewi.index import ExactIndex
        from dewi.index.store import DocStore
        from dewi.parallel import ShardedExactSearcher, make_mesh

        _, pipe, docs, _ = flow
        emb = np.stack([d.embedding for d in docs]).astype(np.float32)
        pay = np.stack([d.payload().to_array() for d in docs])
        ids = [d.doc_id for d in docs]

        single = ExactIndex(dim=emb.shape[1])
        single.add_batch(ids, emb, pay)
        single.build()
        store = DocStore(dim=emb.shape[1])
        store.add_batch(ids, emb, pay)
        mesh = make_mesh(n_data=8, n_model=1)
        sharded = ShardedExactSearcher(store, mesh, k=3)

        q = pipe.encode_query("qubits and error correction")
        _, si = single.search_batch(q[None], k=3, eta=0.25, entropy_pref=0.1)
        _, di = sharded.search_batch(q[None], eta=0.25, entropy_pref=0.1)
        assert set(np.asarray(si)[0].tolist()) == set(np.asarray(di)[0].tolist())

    def test_sampling_over_scores(self, flow):
        _, _, docs, _ = flow
        dewi = np.array([d.dewi_score for d in docs])
        emb = np.stack([d.embedding for d in docs])
        picks = sample_by_dewi(dewi, k=4, tau=2.0, seed=0)
        assert len(set(picks.tolist())) == 4
        cover = submodular_pick(emb, k=3)
        assert len(set(cover.tolist())) == 3

    def test_training_then_rescore(self, flow, tmp_path):
        from dewi.models import init_lm, lm_config
        from dewi.signals import TextEntropyEstimator
        from dewi.training import train_lm

        _, _, docs, _ = flow
        corpus = [d.text for d in docs] * 4
        cfg = lm_config("tiny", max_len=64)
        model, params = init_lm(cfg, seed=0)
        ckpt = tmp_path / "lm.msgpack"
        state = train_lm(model, params, corpus, steps=40, batch_size=8,
                         lr=3e-3, checkpoint=str(ckpt), log_every=10)
        assert state.losses[-1] < state.losses[0]
        trained = TextEntropyEstimator(model_name="tiny", max_length=64,
                                       batch_size=4, checkpoint=str(ckpt))
        # Corpus-like text surprises the trained model less than gibberish.
        seen = trained.compute_entropy(docs[0].text).mean_entropy
        novel = trained.compute_entropy("zzqx jvwp ktrr mmnb").mean_entropy
        assert seen < novel
