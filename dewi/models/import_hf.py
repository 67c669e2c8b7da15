"""HuggingFace → DEWI weight importer.

The reference gets semantic signals by loading hub weights through torch
(reference text_entropy.py:31-38, image_entropy.py:39-41, cross_modal.py:30).
This framework is hermetic by default (deterministic init); this module makes
*pretrained* weights a first-class path: it maps HF GPT-2 / CLIP / ViT-MAE
torch state dicts onto the in-repo Flax module layouts (``CausalLM``,
``CLIPDualEncoder``, ``ViTMAE``) with exact-numerics configs (LN epsilon,
activation), so an imported model reproduces the HF forward bit-for-bit in
f32 (verified by the parity tests in ``tests/test_import_hf.py``).

Usage (requires torch + a local/cached HF model — no network in this repo's
test environment, so tests exercise random-init HF models):

    from transformers import GPT2LMHeadModel
    from dewi.models.import_hf import import_gpt2
    from dewi.models.registry import save_params

    cfg, params = import_gpt2(GPT2LMHeadModel.from_pretrained("gpt2"))
    save_params(params, "gpt2.msgpack")
    # then: TextConfig(model="gpt2", tokenizer="gpt2", checkpoint="gpt2.msgpack")

Everything here is host-side, one-time conversion work — no jit, no device.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from .clip import CLIPConfig
from .mae import MAEConfig
from .transformer import TransformerConfig


def _to_numpy_state(model_or_state: Any) -> Dict[str, np.ndarray]:
    """torch module / state_dict -> {name: float32 ndarray}."""
    if hasattr(model_or_state, "state_dict"):
        state = model_or_state.state_dict()
    else:
        state = model_or_state
    out = {}
    for k, v in state.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v, dtype=np.float32)
    return out


def _split_heads(w: np.ndarray, n_heads: int) -> np.ndarray:
    """[d_in, d_out] kernel -> [d_in, n_heads, head_dim] (flax DenseGeneral)."""
    d_in, d_out = w.shape
    return w.reshape(d_in, n_heads, d_out // n_heads)


def _attn_params(q_w: np.ndarray, k_w: np.ndarray, v_w: np.ndarray,
                 o_w: np.ndarray, q_b: np.ndarray, k_b: np.ndarray,
                 v_b: np.ndarray, o_b: np.ndarray, n_heads: int) -> dict:
    """Build flax ``nn.MultiHeadDotProductAttention`` params from per-head
    projection kernels ``[d, d]`` (flax orientation: kernel[in, out])."""
    d = q_w.shape[0]
    hd = d // n_heads

    def qkv(w: np.ndarray, b: np.ndarray) -> Any:
        return {"kernel": _split_heads(w, n_heads),
                "bias": b.reshape(n_heads, hd)}

    return {
        "query": qkv(q_w, q_b),
        "key": qkv(k_w, k_b),
        "value": qkv(v_w, v_b),
        "out": {"kernel": o_w.reshape(n_heads, hd, d), "bias": o_b},
    }


def _ln(state: Dict[str, np.ndarray], prefix: str) -> dict:
    return {"scale": state[f"{prefix}.weight"], "bias": state[f"{prefix}.bias"]}


def _linear(state: Dict[str, np.ndarray], prefix: str) -> dict:
    """torch nn.Linear (weight [out, in]) -> flax Dense (kernel [in, out])."""
    p = {"kernel": state[f"{prefix}.weight"].T}
    if f"{prefix}.bias" in state:
        p["bias"] = state[f"{prefix}.bias"]
    return p


def _conv_patch_embed(weight: np.ndarray) -> np.ndarray:
    """Conv2d patch projection [d, c, p, p] -> Dense kernel [p*p*c, d]
    matching :func:`dewi.models.mae.patchify`'s (row, col, channel)
    flattening order."""
    d = weight.shape[0]
    return weight.transpose(2, 3, 1, 0).reshape(-1, d)


# ---------------------------------------------------------------------------
# GPT-2  →  CausalLM
# ---------------------------------------------------------------------------


def import_gpt2(model_or_state: Any,
                hf_config: Any = None) -> Tuple[TransformerConfig, dict]:
    """Map an HF ``GPT2LMHeadModel`` onto :class:`~.lm.CausalLM`.

    Returns ``(TransformerConfig, params)`` such that
    ``CausalLM(cfg).apply(params, ids, mask)`` reproduces the HF logits
    (f32, tied LM head, gelu_new, ln_eps=1e-5).
    """
    if hf_config is None:
        hf_config = model_or_state.config
    state = _to_numpy_state(model_or_state)
    # Strip the tied lm_head / leading "transformer." prefix.
    state = {k[len("transformer."):] if k.startswith("transformer.") else k: v
             for k, v in state.items() if not k.startswith("lm_head.")}

    if getattr(hf_config, "scale_attn_by_inverse_layer_idx", False):
        raise ValueError("scale_attn_by_inverse_layer_idx is not supported")
    if getattr(hf_config, "activation_function", "gelu_new") not in (
        "gelu_new", "gelu_pytorch_tanh"
    ):
        raise ValueError(
            f"Unsupported GPT-2 activation {hf_config.activation_function!r}"
        )

    n_heads = int(hf_config.n_head)
    cfg = TransformerConfig(
        vocab_size=int(hf_config.vocab_size),
        d_model=int(hf_config.n_embd),
        n_heads=n_heads,
        n_layers=int(hf_config.n_layer),
        d_ff=int(getattr(hf_config, "n_inner", None) or 4 * hf_config.n_embd),
        max_len=int(hf_config.n_positions),
        causal=True,
        ln_eps=float(hf_config.layer_norm_epsilon),
        activation="gelu",
        dtype="float32",
    )

    blocks = {}
    for i in range(cfg.n_layers):
        p = f"h.{i}"
        # GPT-2 Conv1D stores weight [in, out] — already flax orientation.
        c_attn_w = state[f"{p}.attn.c_attn.weight"]
        c_attn_b = state[f"{p}.attn.c_attn.bias"]
        d = cfg.d_model
        q_w, k_w, v_w = c_attn_w[:, :d], c_attn_w[:, d:2 * d], c_attn_w[:, 2 * d:]
        q_b, k_b, v_b = c_attn_b[:d], c_attn_b[d:2 * d], c_attn_b[2 * d:]
        blocks[f"block_{i}"] = {
            "ln_attn": _ln(state, f"{p}.ln_1"),
            "attn": _attn_params(
                q_w, k_w, v_w, state[f"{p}.attn.c_proj.weight"],
                q_b, k_b, v_b, state[f"{p}.attn.c_proj.bias"], n_heads,
            ),
            "ln_mlp": _ln(state, f"{p}.ln_2"),
            "mlp": {
                "fc_in": {"kernel": state[f"{p}.mlp.c_fc.weight"],
                          "bias": state[f"{p}.mlp.c_fc.bias"]},
                "fc_out": {"kernel": state[f"{p}.mlp.c_proj.weight"],
                           "bias": state[f"{p}.mlp.c_proj.bias"]},
            },
        }
    params = {
        "params": {
            "wte": {"embedding": state["wte.weight"]},
            "wpe": {"embedding": state["wpe.weight"]},
            "encoder": {**blocks, "ln_final": _ln(state, "ln_f")},
        }
    }
    return cfg, params


# ---------------------------------------------------------------------------
# CLIP  →  CLIPDualEncoder
# ---------------------------------------------------------------------------


def import_clip(model_or_state: Any,
                hf_config: Any = None) -> Tuple[CLIPConfig, dict]:
    """Map an HF ``CLIPModel`` onto :class:`~.clip.CLIPDualEncoder`.

    Returns ``(CLIPConfig, params)`` reproducing HF's text/image embeddings
    (quick_gelu, ln_eps from config, vision pre-LN).  Text pooling matches
    HF when the EOS token is the last valid (unpadded) token — which is how
    this framework's tokenizers emit CLIP text batches.
    """
    if hf_config is None:
        hf_config = model_or_state.config
    state = _to_numpy_state(model_or_state)
    tc, vc = hf_config.text_config, hf_config.vision_config

    act = {"quick_gelu": "quick_gelu", "gelu": "gelu_exact"}.get(
        tc.hidden_act
    )
    if act is None:
        raise ValueError(f"Unsupported CLIP activation {tc.hidden_act!r}")

    cfg = CLIPConfig(
        vocab_size=int(tc.vocab_size),
        text_len=int(tc.max_position_embeddings),
        d_text=int(tc.hidden_size),
        text_heads=int(tc.num_attention_heads),
        text_layers=int(tc.num_hidden_layers),
        image_size=int(vc.image_size),
        patch_size=int(vc.patch_size),
        d_image=int(vc.hidden_size),
        image_heads=int(vc.num_attention_heads),
        image_layers=int(vc.num_hidden_layers),
        d_embed=int(hf_config.projection_dim),
        ln_eps=float(tc.layer_norm_eps),
        activation=act,
        image_pre_ln=True,
        text_ff=int(tc.intermediate_size),
        image_ff=int(vc.intermediate_size),
        dtype="float32",
    )

    def tower_blocks(prefix: str, n_layers: int, n_heads: int) -> dict:
        blocks = {}
        for i in range(n_layers):
            p = f"{prefix}.encoder.layers.{i}"
            q = _linear(state, f"{p}.self_attn.q_proj")
            k = _linear(state, f"{p}.self_attn.k_proj")
            v = _linear(state, f"{p}.self_attn.v_proj")
            o = _linear(state, f"{p}.self_attn.out_proj")
            blocks[f"block_{i}"] = {
                "ln_attn": _ln(state, f"{p}.layer_norm1"),
                "attn": _attn_params(
                    q["kernel"], k["kernel"], v["kernel"], o["kernel"],
                    q["bias"], k["bias"], v["bias"], o["bias"], n_heads,
                ),
                "ln_mlp": _ln(state, f"{p}.layer_norm2"),
                "mlp": {
                    "fc_in": _linear(state, f"{p}.mlp.fc1"),
                    "fc_out": _linear(state, f"{p}.mlp.fc2"),
                },
            }
        return blocks

    text_params = {
        "wte": {"embedding":
                state["text_model.embeddings.token_embedding.weight"]},
        "wpe": {"embedding":
                state["text_model.embeddings.position_embedding.weight"]},
        "encoder": {
            **tower_blocks("text_model", cfg.text_layers, cfg.text_heads),
            "ln_final": _ln(state, "text_model.final_layer_norm"),
        },
        "text_proj": {"kernel": state["text_projection.weight"].T},
    }

    d_im = cfg.d_image
    patch_kernel = _conv_patch_embed(
        state["vision_model.embeddings.patch_embedding.weight"]
    )
    image_params = {
        "cls": state["vision_model.embeddings.class_embedding"].reshape(
            1, 1, d_im
        ),
        "pos": state["vision_model.embeddings.position_embedding.weight"],
        "patch_embed": {
            "kernel": patch_kernel,
            # CLIP's patch conv has no bias; our Dense does — zero it.
            "bias": state.get(
                "vision_model.embeddings.patch_embedding.bias",
                np.zeros(d_im, np.float32),
            ),
        },
        "pre_ln": _ln(state, "vision_model.pre_layrnorm"),
        "encoder": {
            **tower_blocks("vision_model", cfg.image_layers, cfg.image_heads),
            "ln_final": _ln(state, "vision_model.post_layernorm"),
        },
        "image_proj": {"kernel": state["visual_projection.weight"].T},
    }

    params = {
        "params": {
            "text_tower": text_params,
            "image_tower": image_params,
            "logit_scale": state["logit_scale"].reshape(()),
        }
    }
    return cfg, params


# ---------------------------------------------------------------------------
# ViT-MAE  →  ViTMAE
# ---------------------------------------------------------------------------


def import_vit_mae(model_or_state: Any,
                   hf_config: Any = None) -> Tuple[MAEConfig, dict]:
    """Map an HF ``ViTMAEForPreTraining`` onto :class:`~.mae.ViTMAE`.

    Returns ``(MAEConfig, params)`` reproducing HF's per-patch reconstruction
    losses given the same masking noise (``use_cls=True``, fixed sincos
    position embeddings imported as constants).
    """
    if hf_config is None:
        hf_config = model_or_state.config
    state = _to_numpy_state(model_or_state)

    if hf_config.hidden_act not in ("gelu",):
        raise ValueError(f"Unsupported MAE activation {hf_config.hidden_act!r}")

    cfg = MAEConfig(
        image_size=int(hf_config.image_size),
        patch_size=int(hf_config.patch_size),
        d_model=int(hf_config.hidden_size),
        n_heads=int(hf_config.num_attention_heads),
        n_layers=int(hf_config.num_hidden_layers),
        d_ff=int(hf_config.intermediate_size),
        dec_d_model=int(hf_config.decoder_hidden_size),
        dec_n_heads=int(hf_config.decoder_num_attention_heads),
        dec_n_layers=int(hf_config.decoder_num_hidden_layers),
        dec_d_ff=int(hf_config.decoder_intermediate_size),
        mask_ratio=float(hf_config.mask_ratio),
        norm_pix=bool(hf_config.norm_pix_loss),
        ln_eps=float(hf_config.layer_norm_eps),
        activation="gelu_exact",
        use_cls=True,
        dtype="float32",
    )

    def vit_blocks(prefix: str, n_layers: int, n_heads: int) -> dict:
        blocks = {}
        for i in range(n_layers):
            p = f"{prefix}.{i}"
            q = _linear(state, f"{p}.attention.attention.query")
            k = _linear(state, f"{p}.attention.attention.key")
            v = _linear(state, f"{p}.attention.attention.value")
            o = _linear(state, f"{p}.attention.output.dense")
            blocks[f"block_{i}"] = {
                "ln_attn": _ln(state, f"{p}.layernorm_before"),
                "attn": _attn_params(
                    q["kernel"], k["kernel"], v["kernel"], o["kernel"],
                    q["bias"], k["bias"], v["bias"], o["bias"], n_heads,
                ),
                "ln_mlp": _ln(state, f"{p}.layernorm_after"),
                "mlp": {
                    "fc_in": _linear(state, f"{p}.intermediate.dense"),
                    "fc_out": _linear(state, f"{p}.output.dense"),
                },
            }
        return blocks

    enc_pos = state["vit.embeddings.position_embeddings"][0]  # [P+1, d]
    dec_pos = state["decoder.decoder_pos_embed"][0]           # [P+1, dd]
    params = {
        "params": {
            "cls": state["vit.embeddings.cls_token"],
            "enc_pos": enc_pos,
            "patch_embed": {
                "kernel": _conv_patch_embed(
                    state["vit.embeddings.patch_embeddings.projection.weight"]
                ),
                "bias": state[
                    "vit.embeddings.patch_embeddings.projection.bias"
                ],
            },
            "encoder": {
                **vit_blocks("vit.encoder.layer", cfg.n_layers, cfg.n_heads),
                "ln_final": _ln(state, "vit.layernorm"),
            },
            "dec_embed": _linear(state, "decoder.decoder_embed"),
            "mask_token": state["decoder.mask_token"],
            "dec_pos": dec_pos,
            "decoder": {
                **vit_blocks(
                    "decoder.decoder_layers", cfg.dec_n_layers, cfg.dec_n_heads
                ),
                "ln_final": _ln(state, "decoder.decoder_norm"),
            },
            "dec_pred": _linear(state, "decoder.decoder_pred"),
        }
    }
    return cfg, params


# ---------------------------------------------------------------------------
# One-call conversion entry point
# ---------------------------------------------------------------------------

_IMPORTERS = {"gpt2": import_gpt2, "clip": import_clip, "vit-mae": import_vit_mae}


def convert_pretrained(name_or_path: str, kind: str, out_path: str) -> dict:
    """Load an HF checkpoint (local path or cached hub name) via
    ``transformers``, convert to the in-repo layout, and save with
    :func:`~.registry.save_params`.  Returns a provenance summary dict."""
    from .registry import save_params

    kind = kind.lower()
    if kind not in _IMPORTERS:
        raise ValueError(f"kind must be one of {sorted(_IMPORTERS)}")
    if kind == "gpt2":
        from transformers import GPT2LMHeadModel as Cls
    elif kind == "clip":
        from transformers import CLIPModel as Cls
    else:
        from transformers import ViTMAEForPreTraining as Cls
    model = Cls.from_pretrained(name_or_path)
    cfg, params = _IMPORTERS[kind](model)
    save_params(params, out_path)
    sidecar = write_sidecar_config(out_path, kind, cfg)
    return {"kind": kind, "source": name_or_path, "out": str(out_path),
            "config": cfg.__class__.__name__, "sidecar": str(sidecar)}


def write_sidecar_config(out_path: Any, kind: str, cfg: Any) -> "Path":
    """Write ``<checkpoint>.config.json`` describing the exact architecture.

    Estimators consult this sidecar when given ``checkpoint=`` so imported
    models run with their true config (ln_eps, activation, dims) rather
    than the nearest named preset."""
    import dataclasses
    import json
    from pathlib import Path

    sidecar = Path(str(out_path) + ".config.json")
    sidecar.write_text(
        json.dumps({"kind": kind, "config": dataclasses.asdict(cfg)}),
        encoding="utf-8",
    )
    return sidecar


def sidecar_config(checkpoint: Any) -> dict | None:
    """Read the sidecar written by :func:`write_sidecar_config`, if any."""
    import json
    from pathlib import Path

    if checkpoint is None:
        return None
    p = Path(str(checkpoint) + ".config.json")
    if not p.exists():
        return None
    return json.loads(p.read_text(encoding="utf-8"))


__all__ = [
    "import_gpt2",
    "import_clip",
    "import_vit_mae",
    "convert_pretrained",
    "write_sidecar_config",
    "sidecar_config",
]
