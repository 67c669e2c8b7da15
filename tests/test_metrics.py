"""Metrics library tests (behavior parity with reference metrics.py:9-212)."""

import numpy as np
import pytest

from dewi.metrics import (
    cluster_coverage,
    dcg_at_k,
    duplicate_rate,
    mrr,
    mrr_matrix,
    ndcg_at_k,
    recall_at_k,
    recall_matrix,
    stratify_by_dewi,
)


class TestRecall:
    def test_perfect(self):
        gt = {"q1": ["a", "b"], "q2": ["c"]}
        rk = {"q1": ["a", "b", "x"], "q2": ["c", "y"]}
        assert recall_at_k(gt, rk, k=3) == pytest.approx(1.0)

    def test_micro_average(self):
        # 1 of 2 + 0 of 1 hits out of 3 total relevant => 1/3 (micro).
        gt = {"q1": ["a", "b"], "q2": ["c"]}
        rk = {"q1": ["a", "x", "y"], "q2": ["z"]}
        assert recall_at_k(gt, rk, k=3) == pytest.approx(1 / 3)

    def test_missing_query_counts_in_denominator(self):
        gt = {"q1": ["a"], "q2": ["b"]}
        rk = {"q1": ["a"]}
        assert recall_at_k(gt, rk, k=1) == pytest.approx(0.5)

    def test_k_cutoff(self):
        gt = {"q": ["a"]}
        rk = {"q": ["x", "y", "a"]}
        assert recall_at_k(gt, rk, k=2) == 0.0
        assert recall_at_k(gt, rk, k=3) == pytest.approx(1.0)

    def test_empty(self):
        assert recall_at_k({}, {}, k=5) == 0.0


class TestDCG:
    def test_exponential_gain(self):
        # rel [3, 2]: (2^3-1)/log2(2) + (2^2-1)/log2(3)
        expected = 7.0 / 1.0 + 3.0 / np.log2(3.0)
        assert dcg_at_k([3, 2]) == pytest.approx(expected, rel=1e-6)

    def test_empty(self):
        assert dcg_at_k([]) == 0.0

    def test_zero_relevance(self):
        assert dcg_at_k([0, 0, 0]) == 0.0


class TestNDCG:
    def test_perfect_ranking(self):
        gt = {"q": {"a": 3, "b": 2, "c": 1}}
        rk = {"q": ["a", "b", "c"]}
        assert ndcg_at_k(gt, rk, k=3) == pytest.approx(1.0, abs=1e-6)

    def test_worse_ranking_lower(self):
        gt = {"q": {"a": 3, "b": 2, "c": 1}}
        good = ndcg_at_k(gt, {"q": ["a", "b", "c"]}, k=3)
        bad = ndcg_at_k(gt, {"q": ["c", "b", "a"]}, k=3)
        assert bad < good

    def test_no_queries(self):
        assert ndcg_at_k({}, {}, k=10) == 0.0


class TestMRR:
    def test_first_hit(self):
        gt = {"q1": ["a"], "q2": ["b"]}
        rk = {"q1": ["a", "x"], "q2": ["x", "b"]}
        assert mrr(gt, rk) == pytest.approx((1.0 + 0.5) / 2)

    def test_no_hit_is_zero(self):
        assert mrr({"q": ["a"]}, {"q": ["x", "y"]}) == 0.0

    def test_empty(self):
        assert mrr({}, {}) == 0.0


class TestStratify:
    def test_proportions(self):
        bins = [0.0, 0.5, 1.0]
        dewi = {"a": 0.1, "b": 0.6, "c": 0.9}
        rk = {"q": ["a", "b", "c"]}
        out = stratify_by_dewi(bins, dewi, rk)
        assert out[(0.0, 0.5)] == pytest.approx(1 / 3)
        assert out[(0.5, 1.0)] == pytest.approx(2 / 3)

    def test_last_bin_inclusive(self):
        out = stratify_by_dewi([0.0, 0.5, 1.0], {"a": 1.0}, {"q": ["a"]})
        assert out[(0.5, 1.0)] == pytest.approx(1.0)

    def test_missing_doc_scores_zero(self):
        out = stratify_by_dewi([0.0, 0.5, 1.0], {}, {"q": ["ghost"]})
        assert out[(0.0, 0.5)] == pytest.approx(1.0)

    def test_requires_two_edges(self):
        with pytest.raises(ValueError):
            stratify_by_dewi([0.5], {}, {})


class TestClusters:
    def test_duplicate_rate(self):
        # 2 singletons out of 3 clusters -> 1 - 2/3
        clusters = [["a"], ["b"], ["c", "d", "e"]]
        assert duplicate_rate(clusters) == pytest.approx(1 / 3)

    def test_duplicate_rate_empty(self):
        assert duplicate_rate([]) == 0.0

    def test_all_singletons(self):
        assert duplicate_rate([["a"], ["b"]]) == 0.0

    def test_cluster_coverage(self):
        clusters = [["a", "b"], ["c"], ["d"]]
        assert cluster_coverage(["a", "d"], clusters) == pytest.approx(2 / 3)

    def test_cluster_coverage_empty(self):
        assert cluster_coverage(["a"], []) == 0.0


class TestMatrixVariants:
    def test_recall_matrix_identity(self):
        idx = np.array([[0, 1, 2], [3, 4, 5]])
        assert recall_matrix(idx, idx) == pytest.approx(1.0)

    def test_recall_matrix_order_invariant(self):
        a = np.array([[0, 1, 2]])
        b = np.array([[2, 0, 1]])
        assert recall_matrix(a, b) == pytest.approx(1.0)

    def test_recall_matrix_partial(self):
        a = np.array([[0, 1, 9]])
        b = np.array([[0, 1, 2]])
        assert recall_matrix(a, b) == pytest.approx(2 / 3)

    def test_mrr_matrix(self):
        retrieved = np.array([[7, 3, 1], [2, 9, 4]])
        first_rel = np.array([3, 5])  # rank 2 hit, no hit
        assert mrr_matrix(retrieved, first_rel) == pytest.approx(0.25)
