"""Layered configuration system.

Parity with the reference's nested dataclass config (reference
config.py:8-155): same section names, field names, defaults, YAML round-trip
with unknown-key filtering, and preset mutations — plus device-specific
``mesh`` and ``runtime`` sections (no reference counterpart; they configure
the device mesh, shardings, and ingest pipeline introduced by this rebuild).
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, List, Optional, Union

import yaml


@dataclass
class TextConfig:
    """Text signal computation (reference config.py:8-13).

    ``checkpoint``/``domain_checkpoint`` point at trained LM weights
    (msgpack file or orbax dir — :func:`dewi.models.registry.save_params`);
    without them the backbone initializes deterministically from ``seed``.
    """

    model: str = "gpt2"
    quantiles: List[float] = field(default_factory=lambda: [0.9, 0.99])
    batch_size: int = 64
    max_length: int = 512
    domain_model: Optional[str] = None
    tokenizer: str = "byte"  # "byte" (hermetic) or an HF tokenizer name
    checkpoint: Optional[str] = None
    domain_checkpoint: Optional[str] = None
    seed: int = 0


@dataclass
class ImageConfig:
    """Image signal computation (reference config.py:15-20)."""

    model: str = "vit-mae-base"
    patch_size: int = 16
    batch_size: int = 64
    image_size: int = 224
    mask_ratio: float = 0.75
    checkpoint: Optional[str] = None
    seed: int = 0


@dataclass
class CrossModalConfig:
    """Cross-modal signal computation (reference config.py:22-26).

    The CLIP towers double as the corpus/query embedding source, so
    ``checkpoint``/``seed`` are also recorded as embedding provenance in any
    index built from this config (search refuses mismatched encoders).
    """

    model: str = "clip-vit-base-patch32"
    batch_size: int = 128
    checkpoint: Optional[str] = None
    seed: int = 0
    # Vision-tower input resolution override (None = model preset, 224).
    # Corpora stored below 224px pay a 12x host-resize + transfer + matmul tax
    # when upscaled to the default; with non-checkpoint towers, set this to
    # the corpus resolution instead.  Rejected for imported checkpoints
    # (their positional embeddings fix the resolution).
    image_size: Optional[int] = None


@dataclass
class RedundancyConfig:
    """Redundancy detection (reference config.py:28-33).

    Unlike the reference (which promises minhash/simhash/phash but ships only
    a CLIP similarity matrix — SURVEY.md §2.4 item 8), all listed modes are
    implemented: embedding-space near-dup plus hash-based text dedup.
    """

    text_sim: str = "embedding"  # "embedding" | "minhash" | "simhash"
    image_sim: str = "embedding"  # "embedding" | "phash"
    cross_modal_density: bool = True
    block_size: int = 4096
    threshold: float = 0.9


@dataclass
class NoiseConfig:
    """Noise detection (reference config.py:35-40)."""

    blur_threshold: float = 0.25
    ocr_min_coverage: float = 0.6
    nsfw_filter: str = "lite"  # "lite" | "strict" | "none"
    expected_language: str = "en"


@dataclass
class ScoringWeights:
    """DEWI component weights (reference config.py:42-49)."""

    alpha_t: float = 1.0
    alpha_i: float = 1.0
    alpha_m: float = 1.0
    alpha_r: float = 1.0
    alpha_n: float = 1.0


@dataclass
class ScoringConfig:
    """Scoring (reference config.py:51-56)."""

    weights: ScoringWeights = field(default_factory=ScoringWeights)
    delta: float = 3.0
    mode: str = "standard"  # "standard" | "conditional"


@dataclass
class IndexConfig:
    """Index construction/query (reference config.py:58-67)."""

    ann: str = "auto"  # "auto" | "exact" | "ivf" | "bruteforce" | reference names
    metric: str = "cosine"
    ef_construction: int = 200
    M: int = 32
    ef_query: int = 200
    rerank_eta: float = 0.25
    entropy_pref: float = 0.0
    nlist: int = 1024
    nprobe: int = 32
    dewi_tier: int = 1024   # IVF: top-dewi docs always scanned exactly
    refine_factor: int = 8  # quantized backend: top-(refine_factor*k) refine
    int8_queries: bool = False  # quantized: int8 x int8 stage 1
    bf16_scores: bool = False   # quantized: bf16 stage-1 score matrix
    # quantized: nibble-packed int4 corpus storage — half the stage-1 HBM
    # stream (the scan's binding resource); implies int8_queries and a
    # 4x-wider stage-2 refine margin.  Select with ann="int4" or this flag.
    int4_storage: bool = False
    # hierarchical sub-block-max candidate selection.  Quantized tier:
    # exact w.r.t. stage-1 scores, and on the GPU its stage 1 is the fused
    # kernel (ops/pallas_search.py); misaligned capacities fall back
    # automatically.  Exact tier: value-exact at EVERY batch size
    # (selection runs on the final adjusted scores) and the fix for flat
    # lax.top_k's collapse on batched queries.  Default ON.
    blockmax_select: bool = True
    # IVF bucket storage: auto (follow mesh.dtype) | float32 | bfloat16
    probe_dtype: str = "auto"
    # IVF doc-side boundary spill: this fraction of docs (smallest top-2
    # centroid margin) is ALSO written to its runner-up bucket, recovering
    # boundary-query recall the probe set misses; duplicates dedup at
    # top-k.  scripts/profile_ivf_recall_curve.py measures the
    # recall/latency curve per spill fraction; the adversarial boundary
    # family may stay under the 0.99 bar at every dial — for such
    # workloads use the quantized/int4 tier.
    spill_frac: float = 0.5


@dataclass
class TrainingSamplingConfig:
    """DEWI^tau training-data sampling (reference config.py:69-74)."""

    tau: float = 1.0
    submodular_pick: bool = False


@dataclass
class EvalConfig:
    """Evaluation (reference config.py:76-81)."""

    recall_k: List[int] = field(default_factory=lambda: [1, 5, 10])
    ndcg_k: List[int] = field(default_factory=lambda: [10])
    mrr: bool = True
    dewi_bins: List[float] = field(default_factory=lambda: [0.0, 0.33, 0.66, 1.0])


@dataclass
class MeshConfig:
    """Device mesh layout (no reference counterpart — green-field, SURVEY.md §2.3)."""

    data: int = -1   # -1: all remaining devices
    model: int = 1
    dtype: str = "float32"  # index storage dtype: "float32" | "bfloat16"
    # Run the signal-extraction estimator forwards (LM, MAE, CLIP towers)
    # data-parallel over the mesh: params replicate, batches shard over the
    # 'data' axis (parallel/signals.py).  Off by default — single-chip runs
    # gain nothing, and the knob makes multi-chip an explicit choice.
    data_parallel_signals: bool = False


@dataclass
class RuntimeConfig:
    """Host-side runtime knobs (all consumed by the CLI ``process`` path).

    ``io_threads``: thread-pool width for corpus file reads.
    ``shard_size``: corpora larger than this process in resumable shards.
    ``checkpoint_every``: docs between checkpoint flushes (0 = off); forces
    sharded processing with per-shard stage checkpoints under
    ``<out>/checkpoints``.
    ``profile``: wrap processing in a ``jax.profiler`` trace written to
    ``<out>/profile``.
    ``decode_cache_mb``: RAM budget for the decode-once image cache (uint8,
    shared by every signal stage — see :class:`dewi.io.ImageCache`);
    corpora whose decoded size exceeds it stream through the prefetching
    loader instead, re-decoding per stage.
    """

    io_threads: int = 4
    shard_size: int = 100_000
    checkpoint_every: int = 0
    profile: bool = False
    decode_cache_mb: int = 4096


@dataclass
class DewiConfig:
    """Top-level configuration (reference config.py:84-144)."""

    text: TextConfig = field(default_factory=TextConfig)
    image: ImageConfig = field(default_factory=ImageConfig)
    cross_modal: CrossModalConfig = field(default_factory=CrossModalConfig)
    redundancy: RedundancyConfig = field(default_factory=RedundancyConfig)
    noise: NoiseConfig = field(default_factory=NoiseConfig)
    scoring: ScoringConfig = field(default_factory=ScoringConfig)
    index: IndexConfig = field(default_factory=IndexConfig)
    training_sampling: TrainingSamplingConfig = field(
        default_factory=TrainingSamplingConfig
    )
    eval: EvalConfig = field(default_factory=EvalConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    @classmethod
    def from_yaml(cls, path: Union[str, Path]) -> "DewiConfig":
        with open(path, "r") as f:
            return cls.from_dict(yaml.safe_load(f) or {})

    @classmethod
    def from_dict(cls, data: dict) -> "DewiConfig":
        """Nested construction with unknown-key filtering (reference
        config.py:104-125)."""

        def create(klass: type, d: dict) -> Any:
            if d is None:
                return klass()
            names = {f.name for f in dataclasses.fields(klass) if f.init}
            kwargs = {}
            for k, v in d.items():
                if k not in names:
                    continue
                f = next(f for f in dataclasses.fields(klass) if f.name == k)
                if dataclasses.is_dataclass(f.type) and isinstance(v, dict):
                    v = create(f.type, v)
                kwargs[k] = v
            return klass(**kwargs)

        out = {}
        for f in dataclasses.fields(cls):
            section = data.get(f.name)
            sub = f.default_factory  # all sections have factories
            klass = type(sub())
            if f.name == "scoring" and isinstance(section, dict):
                sec = dict(section)
                w = sec.pop("weights", None)
                cfg = create(ScoringConfig, sec)
                if isinstance(w, dict):
                    cfg.weights = create(ScoringWeights, w)
                out[f.name] = cfg
            else:
                out[f.name] = create(klass, section)
        return cls(**out)

    def to_dict(self) -> dict:
        def conv(obj: Any) -> Any:
            if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
                return {k: conv(v) for k, v in vars(obj).items()}
            if isinstance(obj, (list, tuple)):
                return [conv(x) for x in obj]
            if isinstance(obj, dict):
                return {k: conv(v) for k, v in obj.items()}
            return obj

        return conv(self)

    def to_yaml(self, path: Union[str, Path]) -> None:
        with open(path, "w") as f:
            yaml.dump(self.to_dict(), f, default_flow_style=False, sort_keys=False)


PRESETS = ("default", "web", "product", "balanced")


def apply_preset(cfg: DewiConfig, preset: str) -> DewiConfig:
    """Preset mutations (reference cli.py:66-89)."""
    if preset == "web":
        cfg.scoring.weights.alpha_t = 0.7
        cfg.scoring.weights.alpha_r = 0.3
    elif preset == "product":
        cfg.scoring.weights.alpha_t = 0.6
        cfg.scoring.weights.alpha_r = 0.4
    elif preset == "balanced":
        cfg.scoring.weights.alpha_t = 0.5
        cfg.scoring.weights.alpha_r = 0.5
    elif preset != "default":
        raise ValueError(f"Unknown preset {preset!r}; choose from {PRESETS}")
    return cfg


default_config = DewiConfig()


def get_default_config() -> DewiConfig:
    """Deep copy of the module default (reference config.py:147-152)."""
    return copy.deepcopy(default_config)
