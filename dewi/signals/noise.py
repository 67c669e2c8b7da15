"""Noise / quality estimation with graceful optional dependencies.

API parity with the reference estimator (reference noise.py:39-97):
``detect_nsfw`` / ``check_text_quality`` / ``check_language`` / ``ocr_text``
with identical heuristics and neutral fallbacks (0.0 / 0.5 / "").  This
module additionally defines the coherent combined ``score``/``batch_compute``
contract the reference pipeline calls but never implemented
(pipelines.py:156 — SURVEY.md §2.4 item 5), plus the blur detector its
config promises (``blur_threshold``, reference config.py:36).

Everything here is host-side by design — string heuristics and optional
classifiers are not device work (SURVEY.md §2.2: tesseract stays a host-side
CPU step); only the blur Laplacian is vectorized with numpy.
"""

from __future__ import annotations

import logging
from typing import Any, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

#: Native resolution of the Laplacian blur detector; pre-decoded images
#: below this lose high-frequency content and shift the blur verdict.
BLUR_SIZE = 224

# ASCII classification LUTs for the text-quality heuristic: byte-level
# equivalents of str.isalnum / "symbol" (not alnum, not whitespace), exact
# for ASCII input (non-ASCII falls back to the per-char path).
_ALNUM_LUT = np.zeros(256, bool)
for _c in range(256):
    _ALNUM_LUT[_c] = chr(_c).isalnum() if _c < 128 else False
_SYMBOL_LUT = np.zeros(256, bool)
for _c in range(128):
    _SYMBOL_LUT[_c] = (not chr(_c).isalnum()) and chr(_c) not in " \n\t\r"
# int32 variants: fancy-indexing with these feeds np.add.reduceat directly
# (a bool LUT would need a full-corpus astype copy before summing).
_ALNUM_LUT_I32 = _ALNUM_LUT.astype(np.int32)
_SYMBOL_LUT_I32 = _SYMBOL_LUT.astype(np.int32)


def _try_langdetect() -> Any:
    try:  # optional dependency (parity: reference noise.py:21-27)
        from langdetect import detect

        return detect
    except Exception:
        return None


def _try_tesseract() -> Any:
    try:  # optional dependency (parity: reference noise.py:30-36)
        import pytesseract

        return pytesseract
    except Exception:
        return None


def skin_fraction_risk(image: Any) -> float:
    """Lite NSFW risk proxy: fraction of skin-toned pixels (YCbCr gate).

    The honest in-repo baseline behind ``nsfw_filter: "lite"`` — a
    deterministic, dependency-free stand-in for the reference's hub
    classifier (reference noise.py:11-18).  Risk ramps from 0 at <30% skin
    pixels to 1 at >80%; inject ``nsfw_fn=`` for a trained classifier.
    """
    from .image_entropy import to_image_array

    arr = to_image_array(image, 64)  # [64, 64, 3] floats in [0, 1]
    r, g, b = arr[..., 0], arr[..., 1], arr[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 0.564 * (b - y) + 0.5
    cr = 0.713 * (r - y) + 0.5
    skin = (
        (cb > 0.30) & (cb < 0.50) & (cr > 0.52) & (cr < 0.68) & (y > 0.15)
    )
    frac = float(skin.mean())
    return float(np.clip((frac - 0.3) / 0.5, 0.0, 1.0))


class NoiseEstimator:
    """Text-quality + image-noise heuristics with neutral fallbacks.

    Accepts the union of the reference ctor (noise.py:40) and the kwargs its
    pipeline passes (pipelines.py:77-81).  ``nsfw_fn`` is an injectable
    classifier callable (image -> risk in [0,1]); absent, NSFW risk is 0.0 —
    the same graceful-absence contract as the reference's hub pipeline
    (noise.py:47-50).
    """

    def __init__(
        self,
        expected_language: str = "en",
        device: Optional[str] = None,
        enable_nsfw: bool = True,
        blur_threshold: float = 0.25,
        ocr_min_coverage: float = 0.6,
        nsfw_filter: str = "lite",
        nsfw_fn: Any = None,
        **_: object,
    ) -> None:
        del device
        self.expected_language = expected_language
        self.blur_threshold = float(blur_threshold)
        self.ocr_min_coverage = float(ocr_min_coverage)
        self.nsfw_filter = nsfw_filter
        if not enable_nsfw or nsfw_filter == "none":
            self.nsfw_fn = None
        elif nsfw_fn is not None:
            self.nsfw_fn = nsfw_fn
        elif nsfw_filter in ("lite", "strict"):
            # Built-in lite scorer (skin-fraction heuristic) so the config
            # mode does something measurable without an injected classifier;
            # "strict" additionally warns that a real classifier is advised.
            self.nsfw_fn = skin_fraction_risk
            if nsfw_filter == "strict":
                logger.warning(
                    "nsfw_filter='strict' with no injected classifier; using "
                    "the lite skin-fraction heuristic (pass nsfw_fn= for a "
                    "real model)."
                )
        else:
            self.nsfw_fn = None
        self.ocr = _try_tesseract()
        self._lang_detect = _try_langdetect()

    # -- parity methods (reference noise.py:47-97) ----------------------------

    def detect_nsfw(self, image: Any) -> float:
        if self.nsfw_fn is None:
            return 0.0
        try:
            return float(np.clip(self.nsfw_fn(image), 0.0, 1.0))
        except Exception as e:  # noqa: BLE001
            logger.debug("NSFW detection failed: %s", e)
            return 0.0

    def check_text_quality(self, text: str) -> float:
        """Alnum/symbol-ratio heuristic (parity: reference noise.py:65-78)."""
        if not text:
            return 0.0
        total = max(len(text), 1)
        if text.isascii():
            # Byte LUT: identical classification to str.isalnum for ASCII,
            # ~10x faster than the per-char Python loop (the noise stage's
            # dominant cost at corpus scale).
            b = np.frombuffer(text.encode("ascii"), np.uint8)
            alnum = int(_ALNUM_LUT[b].sum())
            symbol = int(_SYMBOL_LUT[b].sum())
        else:
            alnum = sum(c.isalnum() for c in text)
            symbol = sum(
                (not c.isalnum()) and c not in " \n\t\r" for c in text
            )
        score = 1.0
        if alnum / total < 0.3:
            score -= 0.4
        if symbol / total > 0.5:
            score -= 0.2
        return float(np.clip(score, 0.0, 1.0))

    def check_language(self, text: str) -> float:
        """1.0 match / 0.0 mismatch / 0.5 unknown (parity: noise.py:80-89)."""
        if not text or len(text.strip()) < 2:
            return 0.5
        if self._lang_detect is None:
            return 0.5
        try:
            return 1.0 if self._lang_detect(text) == self.expected_language else 0.0
        except Exception:
            return 0.5

    def ocr_text(self, image: Any) -> str:
        """OCR extraction, "" when tesseract absent (parity: noise.py:91-97)."""
        if self.ocr is None:
            return ""
        try:
            return self.ocr.image_to_string(image) or ""
        except Exception:
            return ""

    # -- blur (promised by reference config.py:36, never implemented) ---------

    def blur_score(self, image: Any) -> float:
        """Laplacian-variance sharpness in [0, ~): below ``blur_threshold``
        means blurry.  Scale-invariant via luma normalization to [0, 1]."""
        from .image_entropy import to_image_array

        arr = to_image_array(image, BLUR_SIZE)
        luma = 0.299 * arr[..., 0] + 0.587 * arr[..., 1] + 0.114 * arr[..., 2]
        lap = (
            -4.0 * luma[1:-1, 1:-1]
            + luma[:-2, 1:-1]
            + luma[2:, 1:-1]
            + luma[1:-1, :-2]
            + luma[1:-1, 2:]
        )
        return float(lap.var() * 1e3)  # rescaled so ~0.25 separates blurry

    def ocr_coverage_penalty(self, image: Any) -> float:
        """Penalty in [0, 0.3] for images whose embedded text OCRs badly.

        When tesseract is available and an image yields OCR text, the text's
        alnum/symbol quality below ``ocr_min_coverage`` marks a garbled scan
        (the reference accepted the knob but never consumed it — reference
        noise.py:91-97).  Images with no OCR text (or no tesseract) are
        neutral: absence of text is not noise.
        """
        txt = self.ocr_text(image)
        if not txt or not txt.strip():
            return 0.0
        quality = self.check_text_quality(txt)
        if quality >= self.ocr_min_coverage:
            return 0.0
        return 0.3 * (1.0 - quality / max(self.ocr_min_coverage, 1e-6))

    # -- coherent combined contract -------------------------------------------

    def score(self, text: Optional[str] = None,
              image: Any = None) -> float:
        """Combined noise in [0, 1]; higher = noisier.

        Deterministic blend of the available components:
        text: ``1 - (0.7*quality + 0.3*language)``;
        image: ``max(nsfw_risk, blurry_indicator, ocr_coverage_penalty)``;
        result = mean over present modalities.
        """
        parts: List[float] = []
        if text is not None:
            q = self.check_text_quality(text)
            lang = self.check_language(text)
            parts.append(1.0 - (0.7 * q + 0.3 * lang))
        if image is not None:
            nsfw = self.detect_nsfw(image)
            blurry = 1.0 if self.blur_score(image) < self.blur_threshold else 0.0
            parts.append(
                max(nsfw, 0.5 * blurry, self.ocr_coverage_penalty(image))
            )
        if not parts:
            return 0.0
        return float(np.clip(np.mean(parts), 0.0, 1.0))

    def _batch_text_parts(self, texts: Sequence[Optional[str]]) -> np.ndarray:
        """Vectorized text-noise component: ``1 - (0.7*quality + 0.3*lang)``
        per doc, NaN where text is None.  One LUT pass over the concatenated
        ASCII bytes (``np.add.reduceat``) instead of per-doc Python — the
        noise stage's scalar path costs ~50 µs/doc in numpy scalar ops
        alone, which caps corpora at ~20k docs/s.
        """
        n = len(texts)
        quality = np.zeros(n, np.float32)
        part = np.full(n, np.nan, np.float32)
        ascii_idx: List[int] = []
        blobs: List[bytes] = []
        for i, t in enumerate(texts):
            if t is None:
                continue
            part[i] = 0.0  # mark present; value filled below
            if t and t.isascii():
                ascii_idx.append(i)
                blobs.append(t.encode("ascii"))
            elif t:
                quality[i] = self.check_text_quality(t)
            # empty string: quality stays 0.0 (parity)
        if blobs:
            lens = np.fromiter(map(len, blobs), np.int64, count=len(blobs))
            buf = np.frombuffer(b"".join(blobs), np.uint8)
            starts = np.zeros(len(blobs), np.int64)
            np.cumsum(lens[:-1], out=starts[1:])
            alnum = np.add.reduceat(_ALNUM_LUT_I32[buf], starts)
            symbol = np.add.reduceat(_SYMBOL_LUT_I32[buf], starts)
            q = (
                1.0
                - 0.4 * (alnum / lens < 0.3)
                - 0.2 * (symbol / lens > 0.5)
            )
            quality[np.asarray(ascii_idx)] = np.clip(q, 0.0, 1.0)
        if self._lang_detect is None:
            lang = np.full(n, 0.5, np.float32)  # unknown for every doc
        else:
            lang = np.array(
                [self.check_language(t) if t is not None else 0.5
                 for t in texts],
                np.float32,
            )
        present = ~np.isnan(part)
        part[present] = (
            1.0 - (0.7 * quality[present] + 0.3 * lang[present])
        )
        return part

    def _batch_image_parts(self, images: Sequence) -> Optional[np.ndarray]:
        """Device-batched image-noise component, NaN where image is None.

        Eligible when every present image is a uniform-dtype uint8 HxWx3
        array, OCR is absent (the penalty needs per-image host OCR), and the
        NSFW scorer is the built-in skin heuristic or off — i.e. the
        production pre-decoded/packed corpus path.  Returns ``None`` when
        ineligible so :meth:`batch_compute` falls back to the scalar loop.
        Images are grouped by shape; each group runs blur + skin as one
        jitted program per chunk (ops/image_noise.py).
        """
        if self.ocr is not None:
            return None
        if self.nsfw_fn is not None and self.nsfw_fn is not skin_fraction_risk:
            return None
        groups: dict = {}
        for i, im in enumerate(images):
            if im is None:
                continue
            if not (
                isinstance(im, np.ndarray)
                and im.dtype == np.uint8
                and im.ndim == 3
                and im.shape[-1] == 3
                and 2 <= im.shape[0] <= BLUR_SIZE
                and 2 <= im.shape[1] <= BLUR_SIZE
                # Upscale-or-equal only: the kernel's 2-tap bilinear matrix
                # matches PIL for upsampling but aliases on downscale
                # (PIL's BILINEAR uses adaptive-support area filtering).
            ):
                return None
            groups.setdefault(im.shape[:2], []).append(i)
        if not groups:
            return None
        part = np.full(len(images), np.nan, np.float32)
        # Stack per dispatch chunk, not per shape group: a corpus-scale
        # group (e.g. 1M same-shape mmap rows) stacked at once would
        # materialize the whole corpus in host RAM before the kernel's own
        # chunking ever sees it.
        from ..ops.image_noise import CHUNK

        for idx_list in groups.values():
            for s in range(0, len(idx_list), CHUNK):
                ids = idx_list[s : s + CHUNK]
                batch = np.stack([images[i] for i in ids])
                sub = self._array_image_parts(batch, None)
                if sub is None:  # pragma: no cover - eligibility above
                    return None
                part[np.asarray(ids)] = sub
        return part

    def _array_image_parts(
        self, imgs: Any, present: Optional[np.ndarray]
    ) -> Optional[np.ndarray]:
        """Fast path for a uniform ``[N, H, W, 3]`` uint8 batch — host
        ndarray or device-resident ``jax.Array`` (no re-upload).  Same
        eligibility rules as :meth:`_batch_image_parts`; ``present`` rows
        set to False come back NaN (doc has no image)."""
        if self.ocr is not None:
            return None
        if self.nsfw_fn is not None and self.nsfw_fn is not skin_fraction_risk:
            return None
        if imgs.ndim != 4 or imgs.shape[-1] != 3 or imgs.dtype != np.uint8:
            return None
        h, w = imgs.shape[1], imgs.shape[2]
        if not (2 <= h <= BLUR_SIZE and 2 <= w <= BLUR_SIZE):
            return None
        from ..ops.image_noise import batched_image_noise

        blur, skin = batched_image_noise(imgs, blur_size=BLUR_SIZE)
        if self.nsfw_fn is skin_fraction_risk:
            nsfw = np.clip((skin - 0.3) / 0.5, 0.0, 1.0)
        else:
            nsfw = np.zeros_like(skin)
        part = np.maximum(
            nsfw, 0.5 * (blur < self.blur_threshold).astype(np.float32)
        )
        if present is not None:
            part = np.where(np.asarray(present, bool), part, np.nan)
        return part.astype(np.float32)

    def batch_compute(
        self,
        texts: Optional[Sequence[Optional[str]]] = None,
        images: Optional[Sequence] = None,
        progress: Any = None,
        present: Optional[np.ndarray] = None,
    ) -> List[float]:
        """Per-doc combined noise.  ``images`` may be a per-doc sequence
        (entries None where absent) or one uniform ``[N, H, W, 3]`` uint8
        array — host or device-resident — with ``present`` marking which
        rows actually carry an image (default: all)."""
        arr_part: Optional[np.ndarray] = None
        if images is not None and hasattr(images, "ndim") and \
                getattr(images, "ndim", 0) == 4:
            arr_part = self._array_image_parts(images, present)
            if arr_part is None:
                host = np.asarray(images)  # device input: one transfer
                keep = (
                    np.asarray(present, bool) if present is not None
                    else np.ones(len(host), bool)
                )
                images = [host[i] if keep[i] else None
                          for i in range(len(host))]
        n = len(texts) if texts is not None else len(images)  # type: ignore[arg-type]
        texts = texts if texts is not None else [None] * n
        if arr_part is not None:
            text_part = self._batch_text_parts(texts)
            both = np.stack([text_part, arr_part])
            cnt = (~np.isnan(both)).sum(axis=0)
            vals = np.where(
                cnt > 0, np.nansum(both, axis=0) / np.maximum(cnt, 1), 0.0
            )
            vals = np.clip(vals, 0.0, 1.0)
            if progress is not None:
                progress(n)
            return vals.astype(float).tolist()
        images = images if images is not None else [None] * n
        text_part = self._batch_text_parts(texts)
        if all(im is None for im in images):
            # Pure-text corpus: fully vectorized, no per-doc loop at all.
            vals = np.clip(np.nan_to_num(text_part, nan=0.0), 0.0, 1.0)
            if progress is not None:
                progress(n)
            return vals.astype(float).tolist()
        img_part = self._batch_image_parts(images)
        if img_part is not None:
            # Pre-decoded corpus: both components vectorized; per-doc mean
            # over the present modalities, identical to the scalar combine.
            both = np.stack([text_part, img_part])
            present = (~np.isnan(both)).sum(axis=0)
            vals = np.where(
                present > 0,
                np.nansum(both, axis=0) / np.maximum(present, 1),
                0.0,
            )
            vals = np.clip(vals, 0.0, 1.0)
            if progress is not None:
                progress(n)
            return vals.astype(float).tolist()
        out: List[float] = []
        for i, im in enumerate(images):
            parts = []
            if not np.isnan(text_part[i]):
                parts.append(float(text_part[i]))
            if im is not None:
                nsfw = self.detect_nsfw(im)
                blurry = (
                    1.0 if self.blur_score(im) < self.blur_threshold else 0.0
                )
                parts.append(
                    max(nsfw, 0.5 * blurry, self.ocr_coverage_penalty(im))
                )
            out.append(
                min(max(sum(parts) / len(parts), 0.0), 1.0) if parts else 0.0
            )
            if progress is not None:
                progress(1)
        return out


__all__ = ["NoiseEstimator", "skin_fraction_risk"]
