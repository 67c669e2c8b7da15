"""Host-side input pipeline (decode, prefetch, caching, packed corpora).

The data-loading layer the reference never had: its estimators decode
inputs inline on the calling thread (reference image_entropy.py:39-49,
cross_modal.py:55-60).  Here ingestion is a pipeline stage of its own,
designed to keep the device fed: threaded decode, bounded prefetch queues
that overlap host IO with device compute, uint8 transport with on-device
normalization, a decode-once cache shared by every signal stage, and a
packed pre-decoded corpus format (decode once offline, mmap at run time)
for image corpora whose decode cost would otherwise dwarf device compute.
"""

from .images import (
    ImageCache,
    decode_batch,
    decode_image_uint8,
    iter_padded_batches,
    resize_f32,
    resize_uint8,
)
from .packed import PackedImages, is_packed_corpus, pack_images

__all__ = [
    "ImageCache",
    "PackedImages",
    "decode_batch",
    "decode_image_uint8",
    "is_packed_corpus",
    "iter_padded_batches",
    "pack_images",
    "resize_f32",
    "resize_uint8",
]
