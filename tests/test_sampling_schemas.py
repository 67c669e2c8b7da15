"""Tests for DEWI^tau sampling, submodular pick, and schema export."""

import json

import numpy as np
import pytest

from dewi.sampling import (
    dewi_tau_probabilities,
    sample_by_dewi,
    submodular_pick,
    training_sample,
)


class TestTauProbabilities:
    def test_normalized(self):
        p = dewi_tau_probabilities(np.array([0.1, 0.5, 0.9]), tau=2.0)
        assert p.sum() == pytest.approx(1.0)
        assert p[2] > p[1] > p[0]

    def test_tau_zero_uniform(self):
        p = dewi_tau_probabilities(np.array([0.1, 0.5, 0.9]), tau=0.0)
        np.testing.assert_allclose(p, 1 / 3, rtol=1e-9)

    def test_higher_tau_sharper(self):
        d = np.array([0.2, 0.8])
        p1 = dewi_tau_probabilities(d, tau=1.0)
        p4 = dewi_tau_probabilities(d, tau=4.0)
        assert p4[1] > p1[1]


class TestSampleByDewi:
    def test_without_replacement_distinct(self):
        d = np.random.default_rng(0).beta(2, 2, size=100)
        idx = sample_by_dewi(d, k=20, tau=1.0, seed=1)
        assert len(set(idx.tolist())) == 20

    def test_k_too_large_raises(self):
        with pytest.raises(ValueError):
            sample_by_dewi(np.ones(5), k=6)

    def test_bias_toward_high_dewi(self):
        # One doc with overwhelming weight should almost always be drawn.
        d = np.full(50, 1e-4)
        d[17] = 1.0
        hits = sum(
            17 in sample_by_dewi(d, k=5, tau=1.0, seed=s) for s in range(20)
        )
        assert hits == 20

    def test_with_replacement(self):
        d = np.ones(4)
        idx = sample_by_dewi(d, k=10, replace=True, seed=0)
        assert idx.shape == (10,)
        assert set(idx.tolist()) <= {0, 1, 2, 3}

    def test_deterministic_per_seed(self):
        d = np.random.default_rng(1).random(30)
        a = sample_by_dewi(d, k=5, seed=7)
        b = sample_by_dewi(d, k=5, seed=7)
        np.testing.assert_array_equal(a, b)


class TestSubmodularPick:
    def test_covers_clusters(self):
        rng = np.random.default_rng(0)
        # Three well-separated clusters; a coverage pick of 3 hits all three.
        centers = np.eye(3, 8, dtype=np.float32) * 10
        emb = np.concatenate(
            [centers[i] + 0.05 * rng.normal(size=(5, 8)) for i in range(3)]
        ).astype(np.float32)
        picks = submodular_pick(emb, k=3)
        clusters = set(int(p) // 5 for p in picks)
        assert clusters == {0, 1, 2}

    def test_k_geq_n_returns_all(self):
        emb = np.random.default_rng(0).normal(size=(4, 4)).astype(np.float32)
        np.testing.assert_array_equal(submodular_pick(emb, k=10), np.arange(4))

    def test_no_duplicate_picks(self):
        emb = np.random.default_rng(2).normal(size=(20, 8)).astype(np.float32)
        picks = submodular_pick(emb, k=8)
        assert len(set(picks.tolist())) == 8

    def test_training_sample_dispatch(self):
        d = np.random.default_rng(0).random(20)
        emb = np.random.default_rng(1).normal(size=(20, 4)).astype(np.float32)
        a = training_sample(d, emb, k=5, tau=2.0, use_submodular=False)
        b = training_sample(d, emb, k=5, use_submodular=True)
        assert len(a) == len(b) == 5
        with pytest.raises(ValueError):
            training_sample(d, None, k=5, use_submodular=True)


class TestSchemas:
    def test_export_writes_files(self, tmp_path):
        from dewi.schemas import export

        paths = export(tmp_path)
        assert len(paths) == 4
        for p in paths:
            schema = json.loads(p.read_text())
            assert "properties" in schema or "$defs" in schema

    def test_config_schema_has_sections(self, tmp_path):
        from dewi.schemas import export

        export(tmp_path)
        schema = json.loads((tmp_path / "dewi_config.schema.json").read_text())
        props = schema.get("properties", {})
        for section in ("text", "image", "scoring", "index", "mesh"):
            assert section in props
