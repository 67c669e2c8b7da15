"""Flax backbone tests: LM NLL, MAE reconstruction, CLIP towers, checkpoints."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dewi.models import (
    clip_config,
    init_clip,
    init_lm,
    init_mae,
    lm_config,
    load_params,
    mae_config,
    param_count,
    patchify,
    pixel_entropy_proxy,
    save_params,
    token_nll,
)


@pytest.fixture(scope="module")
def lm():
    cfg = lm_config("tiny")
    model, params = init_lm(cfg, seed=0)
    return cfg, model, params


class TestCausalLM:
    def test_logits_shape(self, lm):
        cfg, model, params = lm
        ids = jnp.zeros((2, 16), jnp.int32)
        mask = jnp.ones((2, 16), jnp.float32)
        logits = model.apply(params, ids, mask)
        assert logits.shape == (2, 16, cfg.vocab_size)
        assert logits.dtype == jnp.float32

    def test_nll_near_log_vocab_at_init(self, lm):
        cfg, model, params = lm
        rng = np.random.default_rng(0)
        ids = jnp.asarray(rng.integers(0, cfg.vocab_size, (4, 32)), jnp.int32)
        mask = jnp.ones((4, 32), jnp.float32)
        nll, valid = token_nll(model.apply(params, ids, mask), ids, mask)
        assert nll.shape == (4, 31)
        mean = float(nll[valid].mean())
        assert abs(mean - np.log(cfg.vocab_size)) < 1.5

    def test_causality(self, lm):
        """Changing a future token must not change past-position logits."""
        cfg, model, params = lm
        rng = np.random.default_rng(1)
        ids = np.asarray(rng.integers(0, cfg.vocab_size, (1, 16)), np.int32)
        mask = jnp.ones((1, 16), jnp.float32)
        base = model.apply(params, jnp.asarray(ids), mask)
        ids2 = ids.copy()
        ids2[0, -1] = (ids2[0, -1] + 1) % cfg.vocab_size
        pert = model.apply(params, jnp.asarray(ids2), mask)
        np.testing.assert_allclose(
            np.asarray(base[0, :8]), np.asarray(pert[0, :8]), atol=2e-2
        )

    def test_nll_targets_are_shifted(self, lm):
        cfg, model, params = lm
        ids = jnp.asarray([[1, 2, 3, 4]], jnp.int32)
        mask = jnp.asarray([[1.0, 1.0, 1.0, 0.0]])
        logits = model.apply(params, ids, mask)
        nll, valid = token_nll(logits, ids, mask)
        # Last target (index 3) is padding -> masked out.
        assert valid.shape == (1, 3)
        assert bool(valid[0, -1]) is False


class TestMAE:
    def test_patchify_roundtrip_stats(self):
        imgs = np.random.default_rng(0).random((2, 32, 32, 3)).astype(np.float32)
        p = patchify(jnp.asarray(imgs), 8)
        assert p.shape == (2, 16, 8 * 8 * 3)
        np.testing.assert_allclose(
            float(p.mean()), float(imgs.mean()), rtol=1e-5
        )

    def test_loss_positive_and_deterministic(self):
        cfg = mae_config("tiny")
        model, params = init_mae(cfg, seed=0)
        imgs = jnp.asarray(
            np.random.default_rng(0).random((2, 32, 32, 3)), jnp.float32
        )
        l1 = model.apply(params, imgs, jax.random.PRNGKey(7))
        l2 = model.apply(params, imgs, jax.random.PRNGKey(7))
        assert l1.shape == (2,)
        assert np.all(np.asarray(l1) > 0)
        np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))

    def test_pixel_proxy_flat_vs_textured(self):
        flat = np.full((1, 16, 16, 3), 0.5, np.float32)
        textured = np.random.default_rng(0).random((1, 16, 16, 3)).astype(np.float32)
        pf = float(pixel_entropy_proxy(jnp.asarray(flat))[0])
        pt = float(pixel_entropy_proxy(jnp.asarray(textured))[0])
        assert pf < 1e-6
        assert pt > pf


class TestCLIP:
    def test_towers_normalized(self):
        cfg = clip_config("tiny")
        model, params = init_clip(cfg, seed=0)
        ids = jnp.zeros((3, cfg.text_len), jnp.int32)
        mask = jnp.ones((3, cfg.text_len), jnp.float32)
        imgs = jnp.asarray(
            np.random.default_rng(0).random((3, cfg.image_size, cfg.image_size, 3)),
            jnp.float32,
        )
        t, v, scale = model.apply(params, ids, mask, imgs)
        assert t.shape == (3, cfg.d_embed) and v.shape == (3, cfg.d_embed)
        np.testing.assert_allclose(np.linalg.norm(np.asarray(t), axis=1), 1.0,
                                   atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(np.asarray(v), axis=1), 1.0,
                                   atol=1e-5)

    def test_text_pooling_uses_last_valid(self):
        """Appending padding after the last valid token must not change the
        embedding."""
        cfg = clip_config("tiny")
        model, params = init_clip(cfg, seed=0)
        ids = np.zeros((1, cfg.text_len), np.int32)
        ids[0, :5] = [256, 72, 73, 33, 10]
        m1 = np.zeros((1, cfg.text_len), np.float32)
        m1[0, :5] = 1.0
        e1 = model.apply(params, jnp.asarray(ids), jnp.asarray(m1),
                         method=model.encode_text)
        ids2 = ids.copy()
        ids2[0, 5:] = 99  # garbage after the valid prefix
        e2 = model.apply(params, jnp.asarray(ids2), jnp.asarray(m1),
                         method=model.encode_text)
        np.testing.assert_allclose(np.asarray(e1), np.asarray(e2), atol=1e-5)


class TestCheckpoints:
    def test_save_load_roundtrip(self, tmp_path, lm):
        cfg, model, params = lm
        path = tmp_path / "lm.msgpack"
        save_params(params, path)
        _, fresh = init_lm(cfg, seed=99)
        loaded = load_params(fresh, path)
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(loaded)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_param_count_positive(self, lm):
        assert param_count(lm[2]) > 10_000


class TestOrbaxCheckpoints:
    def test_orbax_roundtrip(self, tmp_path, lm):
        cfg, model, params = lm
        path = tmp_path / "lm_orbax"   # no suffix -> orbax format
        save_params(params, path)
        assert path.is_dir()
        _, fresh = init_lm(cfg, seed=123)
        loaded = load_params(fresh, path)
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(loaded)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_msgpack_still_default_for_suffixed(self, tmp_path, lm):
        cfg, model, params = lm
        path = tmp_path / "lm.msgpack"
        save_params(params, path)
        assert path.is_file()
