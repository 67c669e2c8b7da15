"""Training-loop tests: losses decrease, checkpoints load into estimators."""

import numpy as np
import pytest

from dewi.models import init_clip, init_lm, init_mae, lm_config, mae_config, clip_config
from dewi.training import train_clip, train_lm, train_mae

CORPUS = [
    "the cat sat on the mat",
    "the dog sat on the log",
    "the cat and the dog sat together",
    "a mat and a log in the sun",
] * 8


class TestTrainLM:
    def test_loss_decreases(self):
        cfg = lm_config("tiny", max_len=64)
        model, params = init_lm(cfg, seed=0)
        state = train_lm(model, params, CORPUS, steps=60, batch_size=8,
                         lr=3e-3, log_every=10)
        assert state.step == 60
        assert state.losses[-1] < state.losses[0] - 0.5

    def test_checkpoint_loads_into_estimator(self, tmp_path):
        from dewi.signals import TextEntropyEstimator

        cfg = lm_config("tiny", max_len=64)
        model, params = init_lm(cfg, seed=0)
        ckpt = tmp_path / "lm.msgpack"
        train_lm(model, params, CORPUS, steps=40, batch_size=8, lr=3e-3,
                 checkpoint=str(ckpt))
        trained = TextEntropyEstimator(model_name="tiny", max_length=64,
                                       batch_size=4, checkpoint=str(ckpt))
        fresh = TextEntropyEstimator(model_name="tiny", max_length=64,
                                     batch_size=4)
        # A corpus-like sentence must surprise the trained model less.
        text = "the cat sat on the mat"
        assert (trained.compute_entropy(text).mean_entropy
                < fresh.compute_entropy(text).mean_entropy)


class TestTrainMAE:
    def test_loss_decreases(self):
        cfg = mae_config("tiny")
        model, params = init_mae(cfg, seed=0)
        rng = np.random.default_rng(0)
        # Structured images (smooth gradients) so reconstruction is learnable.
        base = np.linspace(0, 1, 32, dtype=np.float32)
        imgs = np.stack([
            np.tile(base * float(rng.random()), (32, 1))[..., None].repeat(3, -1)
            for _ in range(32)
        ])
        state = train_mae(model, params, imgs, steps=50, batch_size=8,
                          lr=3e-3, log_every=10)
        assert state.losses[-1] < state.losses[0]


class TestTrainCLIP:
    def test_loss_decreases_and_aligns(self):
        cfg = clip_config("tiny")
        model, params = init_clip(cfg, seed=0)
        rng = np.random.default_rng(0)
        # 4 distinct (caption, image) concepts, repeated.
        concepts = []
        for c in range(4):
            img = np.full((32, 32, 3), c / 4.0, np.float32)
            img[:, : 8 * (c + 1)] = 1.0 - c / 4.0
            concepts.append((f"concept number {c} caption", img))
        texts = [concepts[i % 4][0] for i in range(32)]
        imgs = np.stack([concepts[i % 4][1] for i in range(32)])
        state = train_clip(model, params, texts, imgs, steps=60,
                           batch_size=8, lr=3e-3, log_every=10)
        assert state.losses[-1] < state.losses[0]

    def test_mismatched_lengths_raise(self):
        cfg = clip_config("tiny")
        model, params = init_clip(cfg, seed=0)
        with pytest.raises(ValueError):
            train_clip(model, params, ["a"], np.zeros((2, 32, 32, 3)),
                       steps=1)


class TestMoETraining:
    def test_train_moe_lm_loss_decreases(self):
        from dewi.models.moe import MoECausalLM
        from dewi.models.registry import lm_config
        from dewi.training.loops import train_moe_lm

        import jax

        cfg = lm_config("tiny", max_len=32)
        model = MoECausalLM(cfg, n_experts=2)
        import numpy as np
        import jax.numpy as jnp

        ids0 = jnp.zeros((1, 8), jnp.int32)
        params = model.init(jax.random.PRNGKey(0),
                            ids0, jnp.ones_like(ids0, jnp.float32))
        texts = ["the quick brown fox jumps over the lazy dog"] * 64
        state = train_moe_lm(model, params, texts, steps=12, batch_size=8,
                             seq_len=32, lr=1e-2, log_every=4)
        assert state.losses and state.losses[-1] < state.losses[0]
