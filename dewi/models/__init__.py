"""Plain-JAX backbones for DEWI signals: causal LM, ViT-MAE, CLIP dual encoder.

Hermetic replacements for the torch/transformers models the
reference downloads at runtime (SURVEY.md §2.2).  See ``registry`` for
presets, deterministic init, and msgpack checkpoints.
"""

from .clip import CLIPConfig, CLIPDualEncoder
from .lm import CausalLM, token_nll
from .mae import MAEConfig, ViTMAE, patchify, pixel_entropy_proxy
from .registry import (
    clip_config,
    init_clip,
    init_lm,
    init_mae,
    lm_config,
    load_params,
    mae_config,
    param_count,
    save_params,
)
from .transformer import Encoder, TransformerConfig

__all__ = [
    "CausalLM",
    "token_nll",
    "ViTMAE",
    "MAEConfig",
    "patchify",
    "pixel_entropy_proxy",
    "CLIPDualEncoder",
    "CLIPConfig",
    "Encoder",
    "TransformerConfig",
    "lm_config",
    "mae_config",
    "clip_config",
    "init_lm",
    "init_mae",
    "init_clip",
    "save_params",
    "load_params",
    "param_count",
]
