"""Scorer parity tests: golden numpy formulas vs the JAX kernels.

The golden implementations below transcribe the reference's math
(reference scorer.py:18-89, robust.py:8-32, local_weights.py:5-26) in plain
numpy; the framework must match them bitwise-close.
"""

import numpy as np
import pytest

from dewi.scorer import DewiScorer, RobustStats, local_weights_from_surprisal
from dewi.types import SIGNAL_FIELDS, Payload, Signals, Weights


def golden_fit(rows):
    keys = list(rows[0].keys())
    med, mad = {}, {}
    for k in keys:
        v = np.asarray([r[k] for r in rows], dtype=np.float32)
        med[k] = float(np.median(v))
        mad[k] = float(np.median(np.abs(v - med[k]))) or 1e-8
    return med, mad


def golden_score(sig, med, mad, w: Weights, mode="standard"):
    def z(name):
        return float((sig[name] - med[name]) / (1.4826 * mad[name]))

    ht = 0.5 * (z("ht_mean") + z("ht_q90"))
    hi = 0.5 * (z("hi_mean") + z("hi_q90"))
    i_hat, r, n = z("I_hat"), z("redundancy"), z("noise")
    if mode == "conditional":
        u = w.alpha_t * (ht - i_hat) + w.alpha_i * (hi - i_hat) - w.alpha_r * r - w.alpha_n * n
    else:
        u = w.alpha_t * ht + w.alpha_i * hi - w.alpha_m * i_hat - w.alpha_r * r - w.alpha_n * n
    u = float(np.clip(u, -w.delta, w.delta))
    return float(1.0 / (1.0 + np.exp(-u)))


class TestRobustStats:
    def test_fit_matches_golden(self, signal_rows):
        stats = RobustStats.fit(signal_rows)
        med, mad = golden_fit(signal_rows)
        for k in SIGNAL_FIELDS:
            assert stats.medians[k] == pytest.approx(med[k], abs=1e-6)
            assert stats.mads[k] == pytest.approx(mad[k], abs=1e-6)

    def test_z_matches_golden(self, signal_rows):
        stats = RobustStats.fit(signal_rows)
        med, mad = golden_fit(signal_rows)
        v = 3.14
        for k in SIGNAL_FIELDS:
            expected = (v - med[k]) / (1.4826 * mad[k])
            assert stats.z(k, v) == pytest.approx(expected, rel=1e-6)

    def test_mad_floor_on_constant_column(self):
        rows = [{"a": 1.0, "b": float(i)} for i in range(10)]
        stats = RobustStats.fit(rows)
        assert stats.mads["a"] == pytest.approx(1e-8)
        assert stats.mads["b"] > 0.1

    def test_from_payloads(self, dummy_payloads):
        stats = RobustStats.from_payloads(dummy_payloads)
        assert set(stats.keys) == {"ht_mean", "hi_mean", "redundancy", "noise"}
        vals = np.array([p.ht_mean for p in dummy_payloads], dtype=np.float32)
        assert stats.medians["ht_mean"] == pytest.approx(float(np.median(vals)), abs=1e-6)

    def test_from_payloads_empty_raises(self):
        with pytest.raises(ValueError):
            RobustStats.from_payloads([])

    def test_fit_empty_raises(self):
        with pytest.raises(ValueError):
            RobustStats.fit([])

    def test_serde_roundtrip(self, signal_rows):
        stats = RobustStats.fit(signal_rows)
        again = RobustStats.from_dict(stats.to_dict())
        assert again.medians == stats.medians
        assert again.mads == stats.mads


class TestDewiScorer:
    def test_scalar_matches_golden_both_modes(self, signal_rows):
        w = Weights(alpha_t=0.7, alpha_i=1.2, alpha_m=0.9, alpha_r=1.1, alpha_n=0.8)
        scorer = DewiScorer(w, delta=2.5)
        scorer.fit_stats(signal_rows)
        med, mad = golden_fit(signal_rows)
        for sig in signal_rows[:10]:
            assert scorer.score(sig) == pytest.approx(
                golden_score(sig, med, mad, scorer.weights), rel=1e-5
            )
            assert scorer.score_conditional(sig) == pytest.approx(
                golden_score(sig, med, mad, scorer.weights, "conditional"), rel=1e-5
            )

    def test_batch_matches_scalar(self, signal_rows):
        scorer = DewiScorer(Weights(), delta=3.0)
        scorer.fit_stats(signal_rows)
        batch_std = np.asarray(scorer.score_batch(signal_rows, mode="standard"))
        batch_cond = np.asarray(scorer.score_batch(signal_rows, mode="conditional"))
        for i, sig in enumerate(signal_rows):
            assert batch_std[i] == pytest.approx(scorer.score(sig), abs=1e-5)
            assert batch_cond[i] == pytest.approx(scorer.score_conditional(sig), abs=1e-5)

    def test_fit_and_score_matrix_path(self, signal_rows):
        from dewi.types import rows_to_matrix

        mat = rows_to_matrix(signal_rows, SIGNAL_FIELDS)
        scorer = DewiScorer()
        scores = np.asarray(scorer.fit_and_score(mat))
        assert scores.shape == (len(signal_rows),)
        assert np.all((scores >= 0) & (scores <= 1))

    def test_scores_in_unit_interval_and_clip(self, signal_rows):
        scorer = DewiScorer(Weights(), delta=0.5)
        scorer.fit_stats(signal_rows)
        scores = np.asarray(scorer.score_batch(signal_rows))
        lo = 1.0 / (1.0 + np.exp(0.5))
        hi = 1.0 / (1.0 + np.exp(-0.5))
        assert np.all(scores >= lo - 1e-6) and np.all(scores <= hi + 1e-6)

    def test_accepts_signals_objects(self, rng):
        rows = [
            Signals(**{k: float(v) for k, v in zip(SIGNAL_FIELDS, rng.gamma(2, 1, 7))})
            for _ in range(20)
        ]
        scorer = DewiScorer(Weights())
        scorer.fit_stats(rows)
        s = scorer.score(rows[0])
        assert 0.0 <= s <= 1.0

    def test_explicit_delta_overrides_weights(self):
        w = Weights(delta=7.0)
        assert DewiScorer(w).weights.delta == 7.0  # no silent clobber
        assert DewiScorer(w, delta=2.0).weights.delta == 2.0

    def test_unfitted_raises(self):
        with pytest.raises(AssertionError):
            DewiScorer().score({k: 0.0 for k in SIGNAL_FIELDS})


class TestLocalWeights:
    def test_matches_golden(self, rng):
        s = rng.gamma(2.0, 1.0, size=200).astype(np.float32)
        med = np.median(s)
        mad = np.median(np.abs(s - med)) + 1e-8
        z = np.clip((s - med) / (1.4826 * mad), -5, 5)
        expected = np.log1p(np.exp(z))
        got = local_weights_from_surprisal(s)
        # XLA's f32 exp/log1p differ from numpy's in the last few ulps.
        np.testing.assert_allclose(got, expected, rtol=5e-4)

    def test_positive(self, rng):
        w = local_weights_from_surprisal(rng.normal(size=64))
        assert np.all(w > 0)


def test_readme_quickstart_flow(rng):
    """The reference README quick start (README.md:65-135), now actually runnable."""
    from dewi.index import DewiIndex

    ids = [f"doc{i}" for i in range(8)]
    embeddings = [rng.random(16).astype(np.float32) for _ in ids]
    index = DewiIndex(dim=16, space="cosine")
    rows = []
    for i, doc_id in enumerate(ids):
        signals = Signals(
            ht_mean=float(rng.uniform(0, 10)),
            ht_q90=float(rng.uniform(0, 15)),
            hi_mean=float(rng.uniform(0, 5)),
            hi_q90=float(rng.uniform(0, 8)),
            I_hat=float(rng.uniform(0, 1)),
            redundancy=float(rng.uniform(0, 1)),
            noise=float(rng.uniform(0, 0.2)),
        )
        rows.append(signals)
        index.add(doc_id, embeddings[i], Payload(dewi=0.0, **signals.__dict__))

    scorer = DewiScorer(Weights())
    scorer.fit_stats(rows)
    for doc_id in ids:
        payload = index.get_payload(doc_id)
        signals = Signals(**{k: getattr(payload, k) for k in Signals.__annotations__})
        payload.dewi = scorer.score(signals)

    index.build()
    results = index.search(rng.random(16).astype(np.float32), k=5, entropy_pref=0.5, eta=0.3)
    assert len(results) == 5
    for doc_id, score, payload in results:
        assert doc_id in ids
        assert 0.0 <= payload.dewi <= 1.0


class TestMaskedQuantileOp:
    def test_matches_np_quantile_interpolation(self, rng):
        import jax.numpy as jnp
        from dewi.ops.robust import masked_mean_and_quantiles

        vals = rng.normal(size=(3, 40)).astype("float32")
        mask = np.zeros((3, 40), "float32")
        mask[0, :40] = 1.0
        mask[1, :17] = 1.0
        mask[2, :1] = 1.0
        qs = jnp.asarray([0.5, 0.9, 0.99], jnp.float32)
        mean, q = masked_mean_and_quantiles(
            jnp.asarray(vals), jnp.asarray(mask), qs
        )
        mean, q = np.asarray(mean), np.asarray(q)
        for row, n in enumerate((40, 17, 1)):
            valid = vals[row, :n]
            assert mean[row] == pytest.approx(valid.mean(), abs=1e-5)
            for j, qq in enumerate((0.5, 0.9, 0.99)):
                assert q[row, j] == pytest.approx(
                    np.quantile(valid, qq), abs=1e-5
                )

    def test_all_masked_row_is_zero(self):
        import jax.numpy as jnp
        from dewi.ops.robust import masked_mean_and_quantiles

        mean, q = masked_mean_and_quantiles(
            jnp.ones((1, 8)), jnp.zeros((1, 8)), jnp.asarray([0.9])
        )
        assert float(mean[0]) == 0.0
        assert float(q[0, 0]) == 0.0


def test_reference_quickstart_verbatim(rng):
    """The reference README's quick start (README.md:63-135) must run as a
    drop-in with only import paths changed — including the `Signals`
    introspection and in-place payload mutation it uses."""
    from dewi.index import DewiIndex, Payload
    from dewi.scorer import DewiScorer, Signals, Weights

    ids = ["doc1", "doc2", "doc3"]
    embeddings = [rng.random(768) for _ in range(3)]
    index = DewiIndex(dim=768, space="cosine")
    rows = []
    for i, doc_id in enumerate(ids):
        signals = Signals(
            ht_mean=rng.uniform(0, 10), ht_q90=rng.uniform(0, 15),
            hi_mean=rng.uniform(0, 5), hi_q90=rng.uniform(0, 8),
            I_hat=rng.uniform(0, 1), redundancy=rng.uniform(0, 1),
            noise=rng.uniform(0, 0.2),
        )
        rows.append(signals)
        index.add(doc_id, embeddings[i], Payload(dewi=0.0, **signals.__dict__))

    scorer = DewiScorer(Weights())
    scorer.fit_stats(rows)
    for doc_id in ids:
        payload = index.get_payload(doc_id)
        if payload:
            signals = Signals(
                **{k: getattr(payload, k) for k in Signals.__annotations__}
            )
            payload.dewi = scorer.score(signals)
    index.build()

    results = index.search(rng.random(768), k=5, entropy_pref=0.5, eta=0.3)
    assert len(results) == 3
    for doc_id, score, payload in results:
        assert 0.0 <= payload.dewi <= 1.0
