"""MoE (Switch top-1) layer and expert-parallelism tests (CPU mesh)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh

from dewi.models.lm import token_nll
from dewi.models.moe import (
    MoECausalLM,
    MoEMLP,
    load_balance_loss,
    shard_expert_params,
)
from dewi.models.registry import lm_config


def f32_cfg(**over):
    cfg = lm_config("tiny", max_len=16)
    return type(cfg)(**{**cfg.__dict__, "dtype": "float32", **over})


def np_gelu(x):
    # tanh-approx gelu (nn.gelu default), numpy oracle
    return 0.5 * x * (1 + np.tanh(np.sqrt(2 / np.pi) * (x + 0.044715 * x**3)))


class TestMoEMLP:
    def test_single_expert_equals_dense_mlp(self):
        cfg = f32_cfg()
        m = MoEMLP(cfg, n_experts=1, capacity_factor=2.0)
        x = jnp.asarray(
            np.random.default_rng(0).normal(size=(2, 8, cfg.d_model)),
            jnp.float32,
        )
        params = m.init(jax.random.PRNGKey(0), x)
        out, _ = m.apply(params, x, mutable=["aux_loss"])
        p = params["params"]
        ref = np_gelu(np.asarray(x) @ np.asarray(p["w_in"][0])
                      + np.asarray(p["b_in"][0]))
        ref = ref @ np.asarray(p["w_out"][0]) + np.asarray(p["b_out"][0])
        np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-4, atol=1e-4)

    def test_routing_matches_numpy_oracle(self):
        cfg = f32_cfg()
        e, cf = 4, 1.5
        m = MoEMLP(cfg, n_experts=e, capacity_factor=cf)
        rng = np.random.default_rng(3)
        x = jnp.asarray(rng.normal(size=(3, 8, cfg.d_model)), jnp.float32)
        params = m.init(jax.random.PRNGKey(1), x)
        out, _ = m.apply(params, x, mutable=["aux_loss"])
        p = jax.tree.map(np.asarray, params["params"])

        n, d = 24, cfg.d_model
        xf = np.asarray(x).reshape(n, d)
        logits = xf @ p["router"]["kernel"] + p["router"]["bias"]
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        expert = probs.argmax(-1)
        gate = probs.max(-1)
        import math
        cap = max(1, int(math.ceil(n / e * cf)))
        counts = np.zeros(e, int)
        ref = np.zeros((n, d), np.float32)
        for i in range(n):
            ei = expert[i]
            if counts[ei] < cap:
                counts[ei] += 1
                h = np_gelu(xf[i] @ p["w_in"][ei] + p["b_in"][ei])
                ref[i] = gate[i] * (h @ p["w_out"][ei] + p["b_out"][ei])
        np.testing.assert_allclose(np.asarray(out).reshape(n, d), ref,
                                   rtol=2e-3, atol=2e-3)

    def test_overflow_tokens_drop_to_zero(self):
        cfg = f32_cfg()
        # capacity_factor tiny -> cap = 1 slot per expert
        m = MoEMLP(cfg, n_experts=2, capacity_factor=0.01)
        x = jnp.asarray(
            np.random.default_rng(5).normal(size=(1, 16, cfg.d_model)),
            jnp.float32,
        )
        params = m.init(jax.random.PRNGKey(2), x)
        out, _ = m.apply(params, x, mutable=["aux_loss"])
        zero_rows = np.sum(np.all(np.abs(np.asarray(out)[0]) < 1e-12, axis=-1))
        assert zero_rows >= 14  # at most 2 tokens (1 per expert) served

    def test_load_balance_loss_uniform_bound(self):
        cfg = f32_cfg()
        m = MoEMLP(cfg, n_experts=4)
        x = jnp.asarray(
            np.random.default_rng(7).normal(size=(4, 16, cfg.d_model)),
            jnp.float32,
        )
        params = m.init(jax.random.PRNGKey(3), x)
        _, mut = m.apply(params, x, mutable=["aux_loss"])
        aux = float(load_balance_loss(mut))
        # >= 1.0 with equality iff perfectly uniform routing.
        assert 0.99 <= aux < 4.0


class TestExpertParallel:
    def test_sharded_forward_matches_replicated(self):
        cfg = f32_cfg()
        model = MoECausalLM(cfg, n_experts=8)
        rng = np.random.default_rng(0)
        ids = jnp.asarray(rng.integers(0, cfg.vocab_size, (4, 12)), jnp.int32)
        pad = jnp.ones_like(ids, jnp.float32)
        params = model.init(jax.random.PRNGKey(0), ids, pad)
        ref, _ = model.apply(params, ids, pad, mutable=["aux_loss"])

        mesh = Mesh(np.array(jax.devices()[:8]).reshape(1, 8),
                    ("data", "model"))
        ep_params = shard_expert_params(params, mesh, axis="model")
        leaf = ep_params["params"]["block_0"]["moe"]["w_in"]
        assert "model" in str(leaf.sharding.spec)
        with jax.set_mesh(mesh):
            got, _ = jax.jit(
                lambda p, i, m: model.apply(p, i, m, mutable=["aux_loss"])
            )(ep_params, ids, pad)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=2e-4, atol=2e-4)


class TestMoETraining:
    def test_loss_decreases_with_aux(self):
        cfg = f32_cfg(n_layers=2)
        model = MoECausalLM(cfg, n_experts=4)
        rng = np.random.default_rng(0)
        ids = jnp.asarray(rng.integers(0, cfg.vocab_size, (8, 12)), jnp.int32)
        pad = jnp.ones_like(ids, jnp.float32)
        params = model.init(jax.random.PRNGKey(0), ids, pad)
        opt = optax.adam(1e-2)
        state = opt.init(params)

        @jax.jit
        def step(params, state):
            def loss_fn(p):
                logits, mut = model.apply(p, ids, pad, mutable=["aux_loss"])
                nll, valid = token_nll(logits, ids, pad)
                v = valid.astype(jnp.float32)
                main = jnp.sum(nll * v) / jnp.sum(v)
                return main + 0.01 * load_balance_loss(mut)

            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, state = opt.update(grads, state, params)
            return optax.apply_updates(params, updates), state, loss

        losses = []
        for _ in range(5):
            params, state, loss = step(params, state)
            losses.append(float(loss))
        assert np.isfinite(losses).all() and losses[-1] < losses[0]


class TestPadMaskRouting:
    def test_pads_excluded_from_capacity_and_aux(self):
        """Masked rows must not consume expert capacity or skew aux stats:
        a half-padded batch behaves like the unpadded half."""
        cfg = f32_cfg()
        # Generous capacity: overflow would otherwise differ between the
        # [8]-token and [4]-token shapes (cap scales with n).
        m = MoEMLP(cfg, n_experts=2, capacity_factor=4.0)
        rng = np.random.default_rng(9)
        half = rng.normal(size=(1, 4, cfg.d_model)).astype(np.float32)
        full = np.concatenate([half, rng.normal(
            size=(1, 4, cfg.d_model)).astype(np.float32)], axis=1)
        pad = np.array([[1, 1, 1, 1, 0, 0, 0, 0]], np.float32)
        params = m.init(jax.random.PRNGKey(0), jnp.asarray(full))
        out_f, mut_f = m.apply(params, jnp.asarray(full),
                               jnp.asarray(pad), mutable=["aux_loss"])
        out_h, mut_h = m.apply(params, jnp.asarray(half),
                               mutable=["aux_loss"])
        # Real-token outputs identical (MoEMLP has no positional coupling).
        np.testing.assert_allclose(np.asarray(out_f)[:, :4],
                                   np.asarray(out_h), rtol=1e-5, atol=1e-5)
        # Pad rows produce zero output (dropped from dispatch entirely).
        assert np.all(np.abs(np.asarray(out_f)[:, 4:]) < 1e-12)
        from dewi.models.moe import load_balance_loss
        a_f = float(load_balance_loss(mut_f))
        a_h = float(load_balance_loss(mut_h))
        np.testing.assert_allclose(a_f, a_h, rtol=1e-5)
