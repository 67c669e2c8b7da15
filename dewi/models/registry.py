"""Model presets, deterministic init, and checkpoint save/load.

The reference pulls architectures+weights from the HuggingFace hub at
runtime (reference text_entropy.py:31-38, image_entropy.py:39-41,
cross_modal.py:30).  This framework is hermetic: named presets define
architectures, parameters initialize deterministically (seeded) and can be
saved/loaded as msgpack checkpoints (``flax.serialization``, imported only
when a checkpoint is read or written) — zero network, zero torch.  Estimators accept ``checkpoint=`` to load trained weights.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from .clip import CLIPConfig, CLIPDualEncoder
from .lm import CausalLM
from .mae import MAEConfig, ViTMAE
from .transformer import TransformerConfig

PathLike = Union[str, Path]

# Dims are multiples of 64 where they matter (d_model, d_ff) so the matmuls
# tile without padding waste.
LM_PRESETS = {
    "tiny": dict(d_model=64, n_heads=2, n_layers=2, d_ff=256, max_len=128),
    "small": dict(d_model=256, n_heads=4, n_layers=4, d_ff=1024, max_len=512),
    "base": dict(d_model=768, n_heads=12, n_layers=12, d_ff=3072, max_len=1024),
    # Reference-compat aliases (reference config.py:10, text_entropy.py:19)
    "gpt2": dict(d_model=768, n_heads=12, n_layers=12, d_ff=3072, max_len=1024),
    "distilroberta-base": dict(
        d_model=768, n_heads=12, n_layers=6, d_ff=3072, max_len=512
    ),
}

MAE_PRESETS = {
    "tiny": dict(
        image_size=32, patch_size=8, d_model=64, n_heads=2, n_layers=2,
        d_ff=256, dec_d_model=64, dec_n_heads=2, dec_n_layers=1, dec_d_ff=256,
    ),
    "small": dict(
        image_size=224, patch_size=16, d_model=256, n_heads=4, n_layers=4,
        d_ff=1024, dec_d_model=128, dec_n_heads=4, dec_n_layers=2, dec_d_ff=512,
    ),
    "base": dict(
        image_size=224, patch_size=16, d_model=768, n_heads=12, n_layers=12,
        d_ff=3072, dec_d_model=512, dec_n_heads=16, dec_n_layers=8, dec_d_ff=2048,
    ),
}
MAE_PRESETS["vit-mae-base"] = MAE_PRESETS["base"]          # reference config.py:17
MAE_PRESETS["facebook/vit-mae-base"] = MAE_PRESETS["base"]  # reference image_entropy.py:29

CLIP_PRESETS = {
    "tiny": dict(
        text_len=32, d_text=64, text_heads=2, text_layers=2,
        image_size=32, patch_size=8, d_image=64, image_heads=2, image_layers=2,
        d_embed=64,
    ),
    "small": dict(
        text_len=77, d_text=256, text_heads=4, text_layers=4,
        image_size=224, patch_size=32, d_image=256, image_heads=4,
        image_layers=4, d_embed=256,
    ),
    "base": dict(
        text_len=77, d_text=512, text_heads=8, text_layers=12,
        image_size=224, patch_size=32, d_image=768, image_heads=12,
        image_layers=12, d_embed=512,
    ),
}
CLIP_PRESETS["clip-vit-base-patch32"] = CLIP_PRESETS["base"]        # reference config.py:24
CLIP_PRESETS["openai/clip-vit-base-patch32"] = CLIP_PRESETS["base"]  # reference cross_modal.py:21


def _preset(table: dict, name: str, kind: str) -> dict:
    if name not in table:
        raise ValueError(
            f"Unknown {kind} preset {name!r}; choose from {sorted(table)}"
        )
    return dict(table[name])


def lm_config(name: str = "small", vocab_size: int = 258,
              **over: Any) -> TransformerConfig:
    kw = _preset(LM_PRESETS, name, "LM")
    kw.update(over)
    return TransformerConfig(vocab_size=vocab_size, causal=True, **kw)


def mae_config(name: str = "small", **over: Any) -> MAEConfig:
    kw = _preset(MAE_PRESETS, name, "MAE")
    kw.update(over)
    return MAEConfig(**kw)


def clip_config(name: str = "small", vocab_size: int = 258,
                **over: Any) -> CLIPConfig:
    kw = _preset(CLIP_PRESETS, name, "CLIP")
    kw.update(over)
    return CLIPConfig(vocab_size=vocab_size, **kw)


# ---------------------------------------------------------------------------
# Init + checkpoints
# ---------------------------------------------------------------------------


def _host_init(init_fn: Any) -> Any:
    """Run a model ``init`` on the host CPU backend, then move the params to
    the default accelerator.

    Param creation is one-time O(params) work that runs op by op; on the
    host it compiles nothing for the accelerator.  The final
    ``device_put`` is essential: arrays committed to the CPU device would be
    re-transferred on every jitted apply, not just the first.
    """
    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError:
        return init_fn()
    with jax.default_device(cpu):
        params = init_fn()
    return _to_default_device(params)


def _to_default_device(params: Any) -> Any:
    """Move a param pytree to the default backend's first device (no-op cost
    when already there; uncommitted numpy/CPU trees would otherwise be
    shipped host->device on every dispatch)."""
    dev = jax.local_devices()[0]
    if dev.platform == "cpu":
        return params
    return jax.device_put(params, dev)


def init_lm(cfg: TransformerConfig, seed: int = 0) -> Any:
    model = CausalLM(cfg)
    ids = jnp.zeros((1, min(8, cfg.max_len)), dtype=jnp.int32)
    mask = jnp.ones_like(ids, dtype=jnp.float32)
    params = _host_init(
        lambda: model.init(jax.random.PRNGKey(seed), ids, mask)
    )
    return model, params


def init_mae(cfg: MAEConfig, seed: int = 0) -> Any:
    model = ViTMAE(cfg)
    img = jnp.zeros((1, cfg.image_size, cfg.image_size, 3), dtype=jnp.float32)
    params = _host_init(
        lambda: model.init(jax.random.PRNGKey(seed), img, jax.random.PRNGKey(seed + 1))
    )
    return model, params


def init_clip(cfg: CLIPConfig, seed: int = 0) -> Any:
    model = CLIPDualEncoder(cfg)
    ids = jnp.zeros((1, cfg.text_len), dtype=jnp.int32)
    mask = jnp.ones_like(ids, dtype=jnp.float32)
    img = jnp.zeros((1, cfg.image_size, cfg.image_size, 3), dtype=jnp.float32)
    params = _host_init(
        lambda: model.init(jax.random.PRNGKey(seed), ids, mask, img)
    )
    return model, params


def save_params(params: Any, path: PathLike) -> None:
    """Write a param pytree checkpoint.

    Paths ending in ``/`` or with no suffix use orbax (sharded, async-safe —
    the production format for large param trees); otherwise flax msgpack
    (single file, good for small backbones).
    """
    path = Path(path)
    if _is_orbax_path(path):
        import orbax.checkpoint as ocp

        with ocp.StandardCheckpointer() as ckptr:
            ckptr.save(path.resolve(), params, force=True)
        return
    from flax import serialization

    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(serialization.to_bytes(params))


def load_params(template: Any, path: PathLike) -> Any:
    """Read a checkpoint into the structure of ``template`` (orbax dirs or
    msgpack files — see :func:`save_params`)."""
    path = Path(path)
    if _is_orbax_path(path) or path.is_dir():
        import orbax.checkpoint as ocp

        with ocp.StandardCheckpointer() as ckptr:
            return ckptr.restore(path.resolve(), template)
    from flax import serialization

    return serialization.from_bytes(template, path.read_bytes())


def _is_orbax_path(path: Path) -> bool:
    return path.suffix == "" or str(path).endswith("/")


def maybe_load(params: Any, checkpoint: Optional[PathLike]) -> Any:
    if checkpoint is None:
        return params
    # Restored trees are host numpy arrays; pin them to the accelerator so
    # dispatches don't re-transfer the checkpoint every call.
    return _to_default_device(load_params(params, checkpoint))


def param_count(params: Any) -> int:
    return int(sum(math.prod(np.shape(x)) for x in jax.tree.leaves(params)))


def checkpoint_fingerprint(path: Optional[PathLike]) -> Optional[str]:
    """Cheap stable fingerprint of a checkpoint for provenance records.

    Files: sha256 of (size || first 8 MiB).  Orbax dirs: sha256 of the sorted
    (relative-name, size) manifest.  Returns None for a missing/None path —
    callers record the path regardless and treat a None fingerprint as
    "unverifiable", not as a mismatch.
    """
    if path is None:
        return None
    import hashlib

    p = Path(path)
    h = hashlib.sha256()
    if p.is_file():
        h.update(str(p.stat().st_size).encode())
        with open(p, "rb") as f:
            h.update(f.read(8 << 20))
        return h.hexdigest()[:16]
    if p.is_dir():
        for sub in sorted(p.rglob("*")):
            if sub.is_file():
                h.update(str(sub.relative_to(p)).encode())
                h.update(str(sub.stat().st_size).encode())
        return h.hexdigest()[:16]
    return None


__all__ = [
    "LM_PRESETS",
    "MAE_PRESETS",
    "CLIP_PRESETS",
    "lm_config",
    "mae_config",
    "clip_config",
    "init_lm",
    "init_mae",
    "init_clip",
    "save_params",
    "load_params",
    "maybe_load",
    "param_count",
    "checkpoint_fingerprint",
]
