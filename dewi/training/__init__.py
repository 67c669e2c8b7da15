"""Training loops for the DEWI signal backbones.

The reference consumes hub-pretrained torch weights (reference
text_entropy.py:31-38, cross_modal.py:30, image_entropy.py:39-41); this
framework is hermetic, so it must be able to *produce* weights.  Three
optax-based loops — causal-LM next-token CE, MAE reconstruction, CLIP
InfoNCE — each a single jitted donated train step over the mesh-ready
models in :mod:`dewi.models`.  Checkpoints land in the same
msgpack/orbax formats the estimators load via ``checkpoint=``.
"""

from .loops import TrainState, train_clip, train_lm, train_mae, train_moe_lm

__all__ = ["TrainState", "train_lm", "train_mae", "train_clip", "train_moe_lm"]
