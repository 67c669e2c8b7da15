"""Ring attention parity tests (sequence axis sharded on the CPU mesh)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from dewi.parallel.ring import ring_attention


def ref_attention(q, k, v, causal, pad=None):
    scale = 1.0 / np.sqrt(q.shape[-1])
    sc = np.einsum("bhqd,bhkd->bhqk", q, k) * scale
    t = q.shape[2]
    mask = np.ones((t, t), bool)
    if causal:
        mask = np.tril(mask)
    mask = mask[None, None]
    if pad is not None:
        mask = mask & (pad[:, None, None, :] > 0)
    sc = np.where(mask, sc, -1e30)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    p = p / np.maximum(p.sum(-1, keepdims=True), 1e-30)
    # fully-masked rows contribute 0
    alive = mask.any(-1)
    out = np.einsum("bhqk,bhkd->bhqd", p, v)
    return np.where(alive[..., None], out, 0.0)


def make_mesh(n=4):
    return Mesh(np.array(jax.devices()[:n]).reshape(1, n), ("data", "model"))


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    b, h, t, dh = 2, 3, 32, 16
    q = rng.normal(size=(b, h, t, dh)).astype(np.float32)
    k = rng.normal(size=(b, h, t, dh)).astype(np.float32)
    v = rng.normal(size=(b, h, t, dh)).astype(np.float32)
    return q, k, v


class TestRingAttention:
    def test_causal_matches_full(self, qkv):
        q, k, v = qkv
        mesh = make_mesh(4)
        out = ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             mesh, causal=True)
        ref = ref_attention(q, k, v, causal=True)
        np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-4, atol=2e-5)

    def test_bidirectional_matches_full(self, qkv):
        q, k, v = qkv
        mesh = make_mesh(8)
        out = ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             mesh, causal=False)
        ref = ref_attention(q, k, v, causal=False)
        np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-4, atol=2e-5)

    def test_pad_mask(self, qkv):
        q, k, v = qkv
        b, t = q.shape[0], q.shape[2]
        pad = np.ones((b, t), np.float32)
        pad[:, 24:] = 0.0
        mesh = make_mesh(4)
        out = ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             mesh, causal=True, pad_mask=jnp.asarray(pad))
        ref = ref_attention(q, k, v, causal=True, pad=pad)
        np.testing.assert_allclose(np.asarray(out)[:, :, :24], ref[:, :, :24],
                                   rtol=2e-4, atol=2e-5)

    def test_single_device_degenerate(self, qkv):
        q, k, v = qkv
        mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                    ("data", "model"))
        out = ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             mesh, causal=True)
        ref = ref_attention(q, k, v, causal=True)
        np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-4, atol=2e-5)


class TestRingLM:
    def test_logits_match_plain_forward(self):
        from dewi.models import init_lm, lm_config
        from dewi.parallel.ring import ring_lm_logits

        cfg = lm_config("tiny", max_len=32)
        cfg = type(cfg)(**{**cfg.__dict__, "dtype": "float32"})
        model, params = init_lm(cfg, seed=0)
        rng = np.random.default_rng(0)
        ids = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
        pad = np.ones_like(ids, np.float32)
        ref = model.apply(params, jnp.asarray(ids), jnp.asarray(pad))
        mesh = make_mesh(4)
        got = ring_lm_logits(cfg, params, ids, pad, mesh)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=2e-4, atol=2e-4)

    def test_padded_long_doc(self):
        from dewi.models import init_lm, lm_config
        from dewi.models.lm import token_nll
        from dewi.parallel.ring import ring_lm_logits

        cfg = lm_config("tiny", max_len=64)
        cfg = type(cfg)(**{**cfg.__dict__, "dtype": "float32"})
        model, params = init_lm(cfg, seed=0)
        rng = np.random.default_rng(1)
        ids = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
        pad = np.ones_like(ids, np.float32)
        pad[:, 48:] = 0.0
        ref = model.apply(params, jnp.asarray(ids), jnp.asarray(pad))
        mesh = make_mesh(8)
        got = ring_lm_logits(cfg, params, ids, pad, mesh)
        # NLL over valid positions must agree (pad columns are free).
        nr, vr = token_nll(ref, jnp.asarray(ids), jnp.asarray(pad))
        ng, vg = token_nll(got, jnp.asarray(ids), jnp.asarray(pad))
        mr = np.asarray(nr)[np.asarray(vr)]
        mg = np.asarray(ng)[np.asarray(vg)]
        np.testing.assert_allclose(mg, mr, rtol=2e-4, atol=2e-4)


class TestRingLongDoc:
    def test_estimator_ring_mode_matches_direct_forward(self):
        """Docs past chip_len score exactly via ring (not windows)."""
        from jax.sharding import Mesh

        from dewi.signals.text_entropy import TextEntropyEstimator

        mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4),
                    ("data", "model"))
        text = "the quick brown fox jumps over the lazy dog " * 3  # ~130 toks

        ring_est = TextEntropyEstimator(
            model_name="tiny", max_length=256, chip_len=64, ring_mesh=mesh)
        # chip_len < len(text) <= max_len -> ring path
        n = ring_est._token_count(text, 1 << 30)
        assert ring_est.chip_len < n <= ring_est.cfg.max_len
        r_ring = ring_est.compute_entropy(text)

        plain_est = TextEntropyEstimator(model_name="tiny", max_length=256)
        r_plain = plain_est.compute_entropy(text)

        assert abs(r_ring.mean_entropy - r_plain.mean_entropy) < 2e-2
        assert abs(r_ring.q90_entropy - r_plain.q90_entropy) < 5e-2
        np.testing.assert_allclose(
            np.asarray(r_ring.token_entropies),
            np.asarray(r_plain.token_entropies), rtol=3e-2, atol=3e-2)

    def test_windows_fallback_past_positional_capacity(self):
        from jax.sharding import Mesh

        from dewi.signals.text_entropy import TextEntropyEstimator

        mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4),
                    ("data", "model"))
        est = TextEntropyEstimator(
            model_name="tiny", max_length=64, chip_len=32, ring_mesh=mesh)
        text = "word " * 300  # way past max_len -> window fallback
        r = est.compute_entropy(text)
        assert np.isfinite(r.mean_entropy) and r.mean_entropy > 0

    def test_ring_mode_on_data_parallel_mesh(self):
        """Regression: a [1, T] long-doc batch on a data>1 mesh must
        replicate the batch dim, not crash in device_put."""
        from jax.sharding import Mesh

        from dewi.signals.text_entropy import TextEntropyEstimator

        mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                    ("data", "model"))
        est = TextEntropyEstimator(
            model_name="tiny", max_length=256, chip_len=64, ring_mesh=mesh)
        text = "the quick brown fox jumps over the lazy dog " * 3
        r = est.compute_entropy(text)
        assert np.isfinite(r.mean_entropy) and r.mean_entropy > 0

    def test_forward_cached_across_docs(self):
        """Same (cfg, mesh, axis) must reuse one jitted forward."""
        from dewi.parallel.ring import _cached_lm_fwd
        from dewi.models.registry import lm_config
        from jax.sharding import Mesh

        mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4),
                    ("data", "model"))
        cfg = lm_config("tiny", max_len=64)
        assert _cached_lm_fwd(cfg, mesh, "model") is _cached_lm_fwd(
            cfg, mesh, "model")
