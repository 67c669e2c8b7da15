"""Sequence-parallel LM forward tests (GSPMD context parallelism)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dewi.models import init_lm, lm_config, token_nll
from dewi.parallel import make_mesh
from dewi.parallel.sp import sequence_sharded_nll, shard_tokens
from dewi.parallel.tp import shard_params


@pytest.fixture(scope="module")
def lm64():
    cfg = lm_config("tiny", max_len=64)
    model, params = init_lm(cfg, seed=0)
    return cfg, model, params


class TestSequenceParallel:
    def test_matches_replicated(self, lm64):
        cfg, model, params = lm64
        mesh = make_mesh(n_data=2, n_model=4)
        rng = np.random.default_rng(0)
        ids = rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
        mask = np.ones((4, 64), np.float32)
        nll_sp, valid = sequence_sharded_nll(model, params, ids, mask, mesh)
        nll_ref, _ = token_nll(
            model.apply(params, jnp.asarray(ids), jnp.asarray(mask)),
            jnp.asarray(ids), jnp.asarray(mask),
        )
        sp_mean = float(np.asarray(nll_sp)[np.asarray(valid)].mean())
        ref_mean = float(np.asarray(nll_ref)[np.asarray(valid)].mean())
        assert sp_mean == pytest.approx(ref_mean, rel=1e-3)

    def test_shard_tokens_layout(self, lm64):
        mesh = make_mesh(n_data=4, n_model=2)
        ids = np.zeros((8, 32), np.int32)
        mask = np.ones((8, 32), np.float32)
        ids_s, _ = shard_tokens(ids, mask, mesh)
        # 4x2 mesh -> 8 shards of [2, 16].
        assert len(ids_s.addressable_shards) == 8
        assert ids_s.addressable_shards[0].data.shape == (2, 16)

    def test_composes_with_tensor_parallel(self, lm64):
        cfg, model, params = lm64
        mesh = make_mesh(n_data=2, n_model=4)
        tp_params = shard_params(params, mesh)
        rng = np.random.default_rng(1)
        ids = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
        mask = np.ones((2, 64), np.float32)
        nll_sp, valid = sequence_sharded_nll(model, tp_params, ids, mask, mesh)
        nll_ref, _ = token_nll(
            model.apply(params, jnp.asarray(ids), jnp.asarray(mask)),
            jnp.asarray(ids), jnp.asarray(mask),
        )
        sp_mean = float(np.asarray(nll_sp)[np.asarray(valid)].mean())
        ref_mean = float(np.asarray(nll_ref)[np.asarray(valid)].mean())
        assert sp_mean == pytest.approx(ref_mean, rel=5e-3)
