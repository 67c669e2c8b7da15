"""Signal estimators: text entropy, image entropy, cross-modal, redundancy, noise.

Rebuild of the reference signal layer (reference signals/, 5
modules — SURVEY.md §1 layer 3) with one coherent estimator contract
(resolving the §2.4 API mismatches).  Import guards keep the reference's
optional-dependency discipline (reference signals/__init__.py:11-34) even
though the JAX stack is always present here.
"""

try:
    from .text_entropy import TextEntropyEstimator, TextEntropyResult
except Exception:  # pragma: no cover
    TextEntropyEstimator = None  # type: ignore
    TextEntropyResult = None  # type: ignore

try:
    from .image_entropy import ImageEntropyEstimator, to_image_array
except Exception:  # pragma: no cover
    ImageEntropyEstimator = None  # type: ignore
    to_image_array = None  # type: ignore

try:
    from .cross_modal import CrossModalDependency, CrossModalResult
except Exception:  # pragma: no cover
    CrossModalDependency = None  # type: ignore
    CrossModalResult = None  # type: ignore

try:
    from .redundancy import RedundancyEstimator, max_offdiag_similarity
except Exception:  # pragma: no cover
    RedundancyEstimator = None  # type: ignore
    max_offdiag_similarity = None  # type: ignore

try:
    from .noise import NoiseEstimator
except Exception:  # pragma: no cover
    NoiseEstimator = None  # type: ignore

from .tokenizer import ByteTokenizer, bucket_length, get_tokenizer

__all__ = [
    "TextEntropyEstimator",
    "TextEntropyResult",
    "ImageEntropyEstimator",
    "CrossModalDependency",
    "CrossModalResult",
    "RedundancyEstimator",
    "NoiseEstimator",
    "ByteTokenizer",
    "get_tokenizer",
    "bucket_length",
    "to_image_array",
    "max_offdiag_similarity",
]
