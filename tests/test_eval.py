"""Eval harness tests: config-driven metric suite over a live index."""

import numpy as np
import pytest

from dewi import DewiIndex
from dewi.config import EvalConfig
from dewi.eval import evaluate_index, recall_vs_exact
from dewi.index import ExactIndex, QuantizedIndex


@pytest.fixture(scope="module")
def indexed_corpus():
    rng = np.random.default_rng(0)
    n, d = 128, 32
    emb = rng.normal(size=(n, d)).astype(np.float32)
    pay = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
    pay[:, 0] = rng.beta(2, 2, n)
    ids = [f"d{i}" for i in range(n)]
    index = DewiIndex(dim=d)
    index.add_batch(ids, emb, pay)
    index.build()
    # Queries = noisy copies of known docs -> ground truth is that doc.
    q_src = [3, 17, 42, 99]
    queries = emb[q_src] + 0.01 * rng.normal(size=(4, d)).astype(np.float32)
    gt = {f"q{i}": [f"d{s}"] for i, s in enumerate(q_src)}
    return index, queries.astype(np.float32), gt, emb, pay, ids


class TestEvaluateIndex:
    def test_report_fields(self, indexed_corpus):
        index, queries, gt, *_ = indexed_corpus
        report = evaluate_index(index, queries, gt)
        assert {"recall@1", "recall@5", "recall@10", "ndcg@10", "mrr",
                "dewi_bins", "n_queries"} <= set(report)

    def test_self_retrieval_perfect(self, indexed_corpus):
        index, queries, gt, *_ = indexed_corpus
        report = evaluate_index(index, queries, gt, eta=0.0)
        assert report["recall@1"] == pytest.approx(1.0)
        assert report["mrr"] == pytest.approx(1.0)
        assert report["ndcg@10"] == pytest.approx(1.0, abs=1e-6)

    def test_dewi_bins_sum_to_one(self, indexed_corpus):
        index, queries, gt, *_ = indexed_corpus
        report = evaluate_index(index, queries, gt)
        assert sum(report["dewi_bins"].values()) == pytest.approx(1.0)

    def test_custom_config(self, indexed_corpus):
        index, queries, gt, *_ = indexed_corpus
        cfg = EvalConfig(recall_k=[2], ndcg_k=[3], mrr=False, dewi_bins=[])
        report = evaluate_index(index, queries, gt, config=cfg)
        assert "recall@2" in report and "ndcg@3" in report
        assert "mrr" not in report and "dewi_bins" not in report


class TestRecallVsExact:
    def test_quantized_acceptance(self, indexed_corpus):
        _, queries, _, emb, pay, ids = indexed_corpus
        exact = ExactIndex(dim=32)
        exact.add_batch(ids, emb, pay)
        exact.build()
        quant = QuantizedIndex(dim=32, refine_factor=8)
        quant.add_batch(ids, emb, pay)
        quant.build()
        rng = np.random.default_rng(1)
        q = rng.normal(size=(16, 32)).astype(np.float32)
        assert recall_vs_exact(quant, exact, q, k=10) >= 0.99
