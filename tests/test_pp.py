"""Pipeline-parallel (GPipe schedule) tests on the 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh

from dewi.models import init_lm, lm_config, token_nll
from dewi.parallel.pp import (
    pipelined_lm_logits,
    pp_train_step,
    shard_stacked_params,
    stack_block_params,
    unstack_block_params,
)


def make_mesh_2d(n_data=2, n_stage=4):
    devs = np.array(jax.devices()[: n_data * n_stage]).reshape(n_data, n_stage)
    return Mesh(devs, ("data", "stage"))


@pytest.fixture(scope="module")
def setup():
    cfg = lm_config("tiny", max_len=16)
    cfg = type(cfg)(**{**cfg.__dict__, "dtype": "float32", "n_layers": 4})
    model, params = init_lm(cfg, seed=0)
    rng = np.random.default_rng(0)
    ids = jnp.asarray(rng.integers(0, cfg.vocab_size, (8, 12)), jnp.int32)
    pad = jnp.ones_like(ids, jnp.float32)
    return cfg, model, params, ids, pad


class TestStacking:
    def test_roundtrip(self, setup):
        cfg, model, params, ids, pad = setup
        stacked, rest = stack_block_params(params, cfg.n_layers)
        back = unstack_block_params(stacked, rest, cfg.n_layers)
        a = jax.tree.leaves(params)
        b = jax.tree.leaves(back)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


class TestPipelineForward:
    def test_logits_match_plain_forward(self, setup):
        cfg, model, params, ids, pad = setup
        ref = model.apply(params, ids, pad)
        mesh = make_mesh_2d()
        stacked, rest = stack_block_params(params, cfg.n_layers)
        stacked = shard_stacked_params(stacked, mesh)
        got = pipelined_lm_logits(cfg, stacked, rest, ids, pad, mesh,
                                  n_microbatches=4)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=2e-4, atol=2e-4)

    def test_single_microbatch_and_stage_only_mesh(self, setup):
        cfg, model, params, ids, pad = setup
        ref = model.apply(params, ids, pad)
        devs = np.array(jax.devices()[:4]).reshape(4)
        mesh = Mesh(devs, ("stage",))
        stacked, rest = stack_block_params(params, cfg.n_layers)
        got = pipelined_lm_logits(cfg, stacked, rest, ids, pad, mesh,
                                  n_microbatches=1, data_axis=None)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=2e-4, atol=2e-4)

    def test_pad_mask_respected(self, setup):
        cfg, model, params, ids, pad = setup
        pad2 = pad.at[:, 8:].set(0.0)
        ref = model.apply(params, ids, pad2)
        mesh = make_mesh_2d()
        stacked, rest = stack_block_params(params, cfg.n_layers)
        got = pipelined_lm_logits(cfg, stacked, rest, ids, pad2, mesh,
                                  n_microbatches=2)
        # Compare only positions attention can see (padding cols are free).
        np.testing.assert_allclose(np.asarray(got)[:, :8], np.asarray(ref)[:, :8],
                                   rtol=2e-4, atol=2e-4)


class TestPipelineBackward:
    def test_grads_match_plain_model(self, setup):
        cfg, model, params, ids, pad = setup

        def plain_loss(p):
            logits = model.apply(p, ids, pad)
            nll, valid = token_nll(logits, ids, pad)
            v = valid.astype(jnp.float32)
            return jnp.sum(nll * v) / jnp.sum(v)

        mesh = make_mesh_2d()
        stacked, rest = stack_block_params(params, cfg.n_layers)

        def pp_loss(sr):
            s, r = sr
            logits = pipelined_lm_logits(cfg, s, r, ids, pad, mesh,
                                         n_microbatches=4)
            nll, valid = token_nll(logits, ids, pad)
            v = valid.astype(jnp.float32)
            return jnp.sum(nll * v) / jnp.sum(v)

        l0, g_plain = jax.value_and_grad(plain_loss)(params)
        l1, (gs, gr) = jax.value_and_grad(pp_loss)((stacked, rest))
        assert abs(float(l0) - float(l1)) < 1e-4
        # Grads of the stacked blocks == stacked grads of the plain blocks.
        gs_plain, gr_plain = stack_block_params(g_plain, cfg.n_layers)
        for a, b in zip(jax.tree.leaves(gs_plain), jax.tree.leaves(gs)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=5e-3, atol=1e-4)
        for a, b in zip(jax.tree.leaves(gr_plain), jax.tree.leaves(gr)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=5e-3, atol=1e-4)


class TestPPTrainStep:
    def test_loss_decreases(self, setup):
        cfg, model, params, ids, pad = setup
        mesh = make_mesh_2d()
        stacked, rest = stack_block_params(params, cfg.n_layers)
        stacked = shard_stacked_params(stacked, mesh)
        opt = optax.adam(1e-2)
        step = pp_train_step(cfg, opt, mesh, n_microbatches=4)
        state = opt.init((stacked, rest))
        p = (stacked, rest)
        losses = []
        for _ in range(5):
            p, state, loss = step(p, state, ids, pad)
            losses.append(float(loss))
        assert np.isfinite(losses).all()
        assert losses[-1] < losses[0]
        # Stage sharding preserved through the update.
        leaf = jax.tree.leaves(p[0])[0]
        assert "stage" in str(leaf.sharding.spec)
