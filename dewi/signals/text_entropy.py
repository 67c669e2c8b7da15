"""Text entropy (token surprisal) via a jitted causal LM.

API parity with the reference estimator (reference text_entropy.py:14-125):
``TextEntropyResult`` fields, ``compute_entropy`` / ``batch_compute`` /
``__call__``, and the domain-relative mode (base NLL − domain NLL,
reference text_entropy.py:76-84).

Architecture is device-first instead of a port: texts are grouped into
power-of-2 length buckets, padded, and scored as whole ``[B, T]`` batches in
one fused forward + gather-CE + masked mean/quantile XLA program per bucket
shape — replacing the reference's per-document Python loop
(text_entropy.py:117-121, the throughput bottleneck named in SURVEY.md §3.1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..models.lm import token_nll
from ..models.registry import init_lm, lm_config, maybe_load
from ..ops.robust import masked_mean_and_quantiles
from .tokenizer import bucket_length, get_tokenizer


@dataclass
class TextEntropyResult:
    """Per-document surprisal record (parity: reference text_entropy.py:7-12)."""

    token_entropies: List[float]
    mean_entropy: float
    q90_entropy: float
    q99_entropy: float

    def to_dict(self) -> Dict[str, object]:
        """Pipeline-facing view: the dict shape the reference pipeline expects
        (reference pipelines.py:113-114) but never actually received —
        SURVEY.md §2.4 item 2 resolved by supporting both."""
        return {
            "mean": self.mean_entropy,
            "quantiles": {0.9: self.q90_entropy, 0.99: self.q99_entropy},
            "token_entropies": self.token_entropies,
        }


class TextEntropyEstimator:
    """LM token-NLL estimator with bucketed batch inference.

    Accepts the union of the reference's estimator ctor (text_entropy.py:17-22)
    and the kwargs its pipeline passes (pipelines.py:47-52) — one coherent
    contract (SURVEY.md §2.4 item 1).
    """

    def __init__(
        self,
        model_name: str = "small",
        device: Optional[str] = None,  # accepted for parity; JAX places arrays
        domain_model_name: Optional[str] = None,
        quantiles: Sequence[float] = (0.9, 0.99),
        batch_size: int = 64,
        max_length: int = 512,
        tokenizer: str = "byte",
        checkpoint: Optional[str] = None,
        domain_checkpoint: Optional[str] = None,
        seed: int = 0,
        ring_mesh: Any = None,
        chip_len: Optional[int] = None,
        mesh: Any = None,
    ) -> None:
        """``ring_mesh`` + ``chip_len`` enable the exact multi-chip long-doc
        path: docs longer than ``chip_len`` tokens (default ``max_length``)
        but within the model's positional capacity are scored in ONE ring-
        attention forward over the mesh (`parallel/ring.py`) instead of the
        single-chip overlapping-window approximation; only docs beyond
        ``max_length`` fall back to windows.

        ``mesh``: a ``(data, model)`` device mesh for DATA-PARALLEL batch
        execution — params replicate, every scored batch shards over the
        ``data`` axis, so the jitted forwards run on all devices
        (parallel/signals.py; replaces the reference's single-GPU loop,
        text_entropy.py:101-121)."""
        del device
        self.quantiles = tuple(float(q) for q in quantiles)
        self.batch_size = int(batch_size)
        self._dp = None
        if mesh is not None:
            from ..parallel.signals import DataParallel

            self._dp = DataParallel(mesh)
            self.batch_size = self._dp.round_batch(self.batch_size)
        self.tokenizer = get_tokenizer(tokenizer)
        # Imported checkpoints carry a sidecar describing their exact
        # architecture (dewi.models.import_hf) — it overrides the preset.
        from ..models.import_hf import sidecar_config

        side = sidecar_config(checkpoint)
        if side is not None:
            from ..models.transformer import TransformerConfig

            cfg = TransformerConfig(**side["config"])
            if cfg.vocab_size != self.tokenizer.vocab_size:
                # Hard error (VERDICT r2 #5): a structurally-valid forward
                # over the wrong tokenizer returns meaningless surprisal
                # with no other symptom — refuse instead of warning.
                raise ValueError(
                    f"Checkpoint {checkpoint!r} expects a "
                    f"{cfg.vocab_size}-token vocabulary but tokenizer "
                    f"{tokenizer!r} has {self.tokenizer.vocab_size}. "
                    f"Configure the matching tokenizer (e.g. text.tokenizer"
                    f": gpt2 for an imported GPT-2 checkpoint)."
                )
        else:
            cfg = lm_config(model_name, vocab_size=self.tokenizer.vocab_size)
            if max_length != cfg.max_len:
                cfg = lm_config(
                    model_name, vocab_size=self.tokenizer.vocab_size,
                    max_len=int(max_length),
                )
        self.cfg = cfg
        self.ring_mesh = ring_mesh
        self.chip_len = min(int(chip_len or cfg.max_len), cfg.max_len)
        self.model, params = init_lm(cfg, seed=seed)
        self.params = maybe_load(params, checkpoint)
        if self._dp is not None:
            self.params = self._dp.replicate(self.params)

        self.domain_params = None
        if domain_model_name or domain_checkpoint:
            dcfg = lm_config(
                domain_model_name or model_name,
                vocab_size=self.tokenizer.vocab_size,
                max_len=cfg.max_len,
            )
            self.domain_cfg = dcfg
            self.domain_model, dparams = init_lm(dcfg, seed=seed + 1)
            self.domain_params = maybe_load(dparams, domain_checkpoint)
            if self._dp is not None:
                self.domain_params = self._dp.replicate(self.domain_params)

        qarr = jnp.asarray(self.quantiles, dtype=jnp.float32)

        def _nll(params: Any, model: Any, ids: jax.Array,
                 mask: jax.Array) -> Any:
            logits = model.apply(params, ids, mask)
            return token_nll(logits, ids, mask)

        @jax.jit
        def _score_batch(params: Any, ids: jax.Array,
                         mask: jax.Array) -> Any:
            nll, valid = _nll(params, self.model, ids, mask)
            mean, qs = masked_mean_and_quantiles(
                nll, valid.astype(jnp.float32), qarr
            )
            return nll, valid, mean, qs

        @jax.jit
        def _score_batch_relative(params: Any, dparams: Any,
                                  ids: jax.Array,
                                  mask: jax.Array) -> Any:
            nll, valid = _nll(params, self.model, ids, mask)
            dnll, _ = _nll(dparams, self.domain_model, ids, mask)
            rel = nll - dnll
            mean, qs = masked_mean_and_quantiles(
                rel, valid.astype(jnp.float32), qarr
            )
            return rel, valid, mean, qs

        self._score_batch = _score_batch
        self._score_batch_relative = _score_batch_relative

        # Superbatch: S batches scored in ONE dispatch via lax.map — host
        # round-trips per corpus drop by S (fewer launches win).
        @jax.jit
        def _score_super(params: Any, ids3: jax.Array,
                         mask3: jax.Array) -> Any:
            def one(xm: Any) -> Any:
                ids, mask = xm
                nll, valid = _nll(params, self.model, ids, mask)
                return masked_mean_and_quantiles(
                    nll, valid.astype(jnp.float32), qarr
                )

            return jax.lax.map(one, (ids3, mask3))

        @jax.jit
        def _score_super_relative(params: Any, dparams: Any,
                                  ids3: jax.Array,
                                  mask3: jax.Array) -> Any:
            def one(xm: Any) -> Any:
                ids, mask = xm
                nll, valid = _nll(params, self.model, ids, mask)
                dnll, _ = _nll(dparams, self.domain_model, ids, mask)
                return masked_mean_and_quantiles(
                    nll - dnll, valid.astype(jnp.float32), qarr
                )

            return jax.lax.map(one, (ids3, mask3))

        self._score_super = _score_super
        self._score_super_relative = _score_super_relative

        # Packed transfer: uint16 ids, NO mask — the pad mask is derived on
        # device (pad_id never collides with a real token for the byte
        # tokenizer), so host->device traffic drops from 8 bytes/token
        # (int32 ids + f32 mask) to 2 over PCIe.
        pad_id = int(self.tokenizer.pad_id)

        def _expand(ids_u16: jax.Array) -> Any:
            ids = ids_u16.astype(jnp.int32)
            mask = (ids != pad_id).astype(jnp.float32)
            # HF adapters pad with an out-of-vocab sentinel (vocab_size);
            # zero those ids before the embedding gather.  Pad positions
            # are attention-masked and loss-masked, so this is a no-op on
            # outputs for any tokenizer (incl. the in-vocab byte PAD).
            if pad_id >= cfg.vocab_size:
                ids = jnp.where(ids != pad_id, ids, 0)
            return ids, mask

        @jax.jit
        def _score_super_packed(params: Any,
                                ids3_u16: jax.Array) -> Any:
            def one(ids_u16: jax.Array) -> Any:
                ids, mask = _expand(ids_u16)
                nll, valid = _nll(params, self.model, ids, mask)
                return masked_mean_and_quantiles(
                    nll, valid.astype(jnp.float32), qarr
                )

            return jax.lax.map(one, ids3_u16)

        @jax.jit
        def _score_super_relative_packed(params: Any, dparams: Any,
                                         ids3_u16: jax.Array) -> Any:
            def one(ids_u16: jax.Array) -> Any:
                ids, mask = _expand(ids_u16)
                nll, valid = _nll(params, self.model, ids, mask)
                dnll, _ = _nll(dparams, self.domain_model, ids, mask)
                return masked_mean_and_quantiles(
                    nll - dnll, valid.astype(jnp.float32), qarr
                )

            return jax.lax.map(one, ids3_u16)

        self._score_super_packed = _score_super_packed
        self._score_super_relative_packed = _score_super_relative_packed
        self._packed_ok = bool(
            getattr(self.tokenizer, "pad_is_exclusive", False)
        )
        self.superbatch = 8

    # -- public API ---------------------------------------------------------

    def _dev(self, arr: Any, batch_axis: int = 0) -> Any:
        """Batch placement: plain device array, or sharded over the mesh's
        data axis when this estimator runs data-parallel."""
        if self._dp is None:
            return jnp.asarray(arr)
        return self._dp.put(arr, batch_axis)

    def _token_count(self, text: str, max_len: int) -> int:
        """Tokenized length, without materializing ids when the tokenizer
        supports it (the byte tokenizer answers from the UTF-8 byte count —
        this probe runs once per corpus document)."""
        fast = getattr(self.tokenizer, "encode_length", None)
        if fast is not None:
            return fast(text, max_len)
        return len(self.tokenizer.encode(text, max_len))

    def compute_entropy(
        self, text: str, relative_to_domain: bool = False
    ) -> TextEntropyResult:
        """Single-document surprisal (parity: reference text_entropy.py:40-99)."""
        return self.batch_compute([text], relative_to_domain)[0]

    def batch_compute(
        self,
        texts: Sequence[str],
        relative_to_domain: bool = False,
        batch_size: Optional[int] = None,
    ) -> List[TextEntropyResult]:
        """Bucketed, vectorized surprisal for N documents.

        Documents longer than ``max_length`` tokens are scored over
        overlapping fixed windows and their per-token streams merged
        (the reference silently truncates to one forward —
        text_entropy.py:55-73; SURVEY.md §5 long-context gap).
        """
        if not len(texts):
            return []
        bs = int(batch_size or self.batch_size)
        use_domain = relative_to_domain and self.domain_params is not None

        long_idx = [
            i for i, t in enumerate(texts)
            if self._token_count(t, 1 << 30) > self.chip_len
        ]
        results_long: Dict[int, TextEntropyResult] = {
            i: self._compute_long(texts[i], relative_to_domain, bs)
            for i in long_idx
        }
        short = [i for i in range(len(texts)) if i not in results_long]

        # Group doc indices by padded bucket length.
        buckets: Dict[int, List[int]] = {}
        for i in short:
            n = self._token_count(texts[i], self.chip_len)
            b = bucket_length(max(n, 2), max_len=self.chip_len)
            buckets.setdefault(b, []).append(i)

        results: List[Optional[TextEntropyResult]] = [None] * len(texts)
        for blen, idxs in sorted(buckets.items()):
            for start in range(0, len(idxs), bs):
                chunk = idxs[start : start + bs]
                ids, mask = self.tokenizer.encode_batch(
                    [texts[i] for i in chunk], self.cfg.max_len, pad_to=blen
                )
                # Pad the batch dim so every bucket uses one trace shape.
                pad_rows = bs - len(chunk)
                if pad_rows:
                    ids = np.concatenate(
                        [ids, np.full((pad_rows, blen), self.tokenizer.pad_id,
                                      dtype=np.int32)]
                    )
                    pad_mask = np.zeros((pad_rows, blen), dtype=np.float32)
                    pad_mask[:, :2] = 1.0  # >=2 valid tokens keeps stats finite
                    mask = np.concatenate([mask, pad_mask])
                if use_domain:
                    nll, valid, mean, qs = self._score_batch_relative(
                        self.params, self.domain_params,
                        self._dev(ids), self._dev(mask),
                    )
                else:
                    nll, valid, mean, qs = self._score_batch(
                        self.params, self._dev(ids), self._dev(mask)
                    )
                nll = np.asarray(nll)
                valid = np.asarray(valid)
                mean = np.asarray(mean)
                qs = np.asarray(qs)
                for row, doc_i in enumerate(chunk):
                    toks = nll[row][valid[row]].tolist()
                    q = {
                        self.quantiles[j]: float(qs[row, j])
                        for j in range(len(self.quantiles))
                    }
                    results[doc_i] = TextEntropyResult(
                        token_entropies=toks,
                        mean_entropy=float(mean[row]),
                        q90_entropy=float(q.get(0.9, qs[row, 0])),
                        q99_entropy=float(q.get(0.99, qs[row, -1])),
                    )
        for i, r in results_long.items():
            results[i] = r
        return results  # type: ignore[return-value]

    def _compute_long_ring(
        self, ids_full: List[int], relative_to_domain: bool
    ) -> TextEntropyResult:
        """Exact long-doc surprisal: one ring-attention forward over the mesh.

        The sequence axis shards over the mesh's model axis; K/V blocks
        rotate by ppermute (parallel/ring.py), so no chip ever holds the
        full attention matrix and the result equals a single-device forward
        over the whole document (no window approximation)."""
        from ..parallel.ring import ring_lm_logits

        s_axis = self.ring_mesh.shape["model"]
        n = len(ids_full)
        # Power-of-2 bucket (trace reuse across docs), rounded to a multiple
        # of the mesh's sequence-shard count.
        b = bucket_length(max(n, 2), max_len=self.cfg.max_len)
        t = max(((b + s_axis - 1) // s_axis) * s_axis, 2 * s_axis)
        ids = np.full((1, t), self.tokenizer.pad_id, dtype=np.int32)
        ids[0, :n] = ids_full
        pad = (np.arange(t) < n).astype(np.float32)[None, :]

        logits = ring_lm_logits(self.cfg, self.params, ids, pad,
                                self.ring_mesh)
        nll, valid = token_nll(logits, jnp.asarray(ids), jnp.asarray(pad))
        if relative_to_domain and self.domain_params is not None:
            dlogits = ring_lm_logits(self.domain_cfg, self.domain_params,
                                     ids, pad, self.ring_mesh)
            dnll, _ = token_nll(dlogits, jnp.asarray(ids), jnp.asarray(pad))
            nll = nll - dnll
        stream = np.asarray(nll)[np.asarray(valid)]
        if stream.size == 0:
            return TextEntropyResult([], 0.0, 0.0, 0.0)
        return TextEntropyResult(
            token_entropies=stream.tolist(),
            mean_entropy=float(stream.mean()),
            q90_entropy=float(np.quantile(stream, 0.9)),
            q99_entropy=float(np.quantile(stream, 0.99)),
        )

    def _compute_long(
        self, text: str, relative_to_domain: bool, bs: int
    ) -> TextEntropyResult:
        """Long-document path: overlapping fixed windows, merged token stream.

        Windows of ``max_len`` tokens advance by ``max_len - overlap``; each
        window's first ``overlap`` targets are context-only (discarded except
        in the first window), so every kept token has at least ``overlap``
        tokens of left context.  All windows are scored as ONE padded batch
        (static shapes; no per-window Python forwards).
        """
        ids_full = self.tokenizer.encode(text, 1 << 30)
        if (
            self.ring_mesh is not None
            and len(ids_full) <= self.cfg.max_len
        ):
            # Within the model's positional capacity: score the WHOLE doc
            # exactly in one ring-attention forward over the mesh.
            return self._compute_long_ring(ids_full, relative_to_domain)
        t = self.chip_len
        overlap = t // 4
        stride = t - overlap
        windows = []
        starts = list(range(0, max(len(ids_full) - overlap, 1), stride))
        for s in starts:
            windows.append(ids_full[s : s + t])

        import numpy as _np

        nq = len(windows)
        ids = _np.full((nq, t), self.tokenizer.pad_id, dtype=_np.int32)
        mask = _np.zeros((nq, t), dtype=_np.float32)
        for w, win in enumerate(windows):
            ids[w, : len(win)] = win
            mask[w, : len(win)] = 1.0

        use_domain = relative_to_domain and self.domain_params is not None
        toks: List[float] = []
        for start in range(0, nq, bs):
            chunk_ids = ids[start : start + bs]
            chunk_mask = mask[start : start + bs]
            pad_rows = bs - chunk_ids.shape[0]
            if pad_rows:
                chunk_ids = _np.concatenate(
                    [chunk_ids, _np.full((pad_rows, t), self.tokenizer.pad_id,
                                         _np.int32)]
                )
                chunk_mask = _np.concatenate(
                    [chunk_mask, _np.zeros((pad_rows, t), _np.float32)]
                )
            if use_domain:
                nll, valid, _, _ = self._score_batch_relative(
                    self.params, self.domain_params,
                    self._dev(chunk_ids), self._dev(chunk_mask),
                )
            else:
                nll, valid, _, _ = self._score_batch(
                    self.params, self._dev(chunk_ids), self._dev(chunk_mask)
                )
            nll = np.asarray(nll)
            valid = np.asarray(valid)
            for row in range(min(bs - pad_rows, nq - start)):
                w = start + row
                stream = nll[row][valid[row]]
                if w > 0:
                    stream = stream[overlap - 1 :]  # drop context-only targets
                toks.extend(stream.tolist())

        arr = np.asarray(toks, dtype=np.float32)
        if arr.size == 0:
            return TextEntropyResult([], 0.0, 0.0, 0.0)
        return TextEntropyResult(
            token_entropies=arr.tolist(),
            mean_entropy=float(arr.mean()),
            q90_entropy=float(np.quantile(arr, 0.9)),
            q99_entropy=float(np.quantile(arr, 0.99)),
        )

    def batch_compute_stats(
        self,
        texts: Sequence[str],
        relative_to_domain: bool = False,
        batch_size: Optional[int] = None,
        progress: Optional[Callable[[int], None]] = None,
    ) -> Any:
        """Bulk corpus path: per-doc ``(mean, q90, q99)`` arrays ONLY.

        Skips materializing per-token entropy lists on the host — that
        Python extraction dominates wall time at corpus scale (the
        aggregates are computed on device by the same fused kernel).
        Long documents fall back to the windowed path.
        """
        if not len(texts):
            z = np.zeros(0, np.float32)
            return z, z.copy(), z.copy()
        bs = int(batch_size or self.batch_size)
        use_domain = relative_to_domain and self.domain_params is not None

        means = np.zeros(len(texts), np.float32)
        q90s = np.zeros(len(texts), np.float32)
        q99s = np.zeros(len(texts), np.float32)

        buckets: Dict[int, List[int]] = {}
        long_idx = []
        # Batch token counts where the tokenizer supports it: one fast-path
        # call for the whole corpus instead of a per-doc encode probe.
        fast_counts = getattr(self.tokenizer, "encode_lengths", None)
        counts = (
            fast_counts(texts, self.chip_len + 1)
            if fast_counts is not None
            else [self._token_count(t, self.chip_len + 1) for t in texts]
        )
        for i, n in enumerate(counts):
            if n > self.chip_len:
                long_idx.append(i)
                continue
            b = bucket_length(max(int(n), 2), max_len=self.chip_len)
            buckets.setdefault(b, []).append(i)

        for i in long_idx:
            r = self._compute_long(texts[i], relative_to_domain, bs)
            means[i], q90s[i], q99s[i] = r.mean_entropy, r.q90_entropy, r.q99_entropy
            if progress is not None:
                progress(1)

        q90_col = self.quantiles.index(0.9) if 0.9 in self.quantiles else 0
        S = max(1, int(self.superbatch))

        # Deferred fetches: every dispatch's [.., bs] aggregates stay on
        # device; placements record where each batch's rows land, and ONE
        # fetch at the end of the corpus replaces a blocking round trip per
        # supergroup.
        from ..utils.deferred import DeferredFetcher

        d_mean = DeferredFetcher()
        d_qs = DeferredFetcher()
        placements: List[tuple] = []  # (flat row offset, chunk doc indices)

        def defer(chunks: Any, mean_dev: Any, qs_dev: Any,
                  in_bytes: int) -> None:
            # mean_dev: [G, bs] or [bs]; qs_dev: [G, bs, Q] or [bs, Q].
            nq = qs_dev.shape[-1]
            off = d_mean.append(mean_dev.reshape(-1), cost=in_bytes)
            d_qs.append(qs_dev.reshape(-1, nq))
            for s, chunk in enumerate(chunks):
                placements.append((off + s * bs, chunk))
            if progress is not None:
                progress(sum(len(c) for c in chunks))

        def encode_padded(chunk: Any, blen: int) -> Any:
            ids, mask = self.tokenizer.encode_batch(
                [texts[i] for i in chunk], self.cfg.max_len, pad_to=blen
            )
            pad_rows = bs - len(chunk)
            if pad_rows:
                ids = np.concatenate(
                    [ids, np.full((pad_rows, blen), self.tokenizer.pad_id,
                                  dtype=np.int32)]
                )
                mask = np.concatenate(
                    [mask, np.zeros((pad_rows, blen), np.float32)]
                )
            return ids, mask

        def encode_padded_u16(chunk: Any, blen: int) -> Any:
            # Mask-free uint16 fast path: no f32 mask allocation, no
            # int32 -> uint16 downcast copy.
            ids = self.tokenizer.encode_batch_u16(
                [texts[i] for i in chunk], self.cfg.max_len, pad_to=blen
            )
            pad_rows = bs - len(chunk)
            if pad_rows:
                ids = np.concatenate(
                    [ids, np.full((pad_rows, blen), self.tokenizer.pad_id,
                                  dtype=np.uint16)]
                )
            return ids

        for blen, idxs in sorted(buckets.items()):
            batches = [idxs[s : s + bs] for s in range(0, len(idxs), bs)]
            pos = 0
            # Full superbatches: S padded batches scored per dispatch.  JAX
            # dispatch is async, so the host tokenizes and launches the next
            # supergroup while earlier ones run on device; results are NOT
            # fetched here (see `defer`), so the only host stalls are the
            # fetcher's budget flushes.
            while len(batches) - pos >= S:
                group = batches[pos : pos + S]
                if self._packed_ok:
                    ids3_u16 = np.stack(
                        [encode_padded_u16(c, blen) for c in group]
                    )
                    if use_domain:
                        mean3, qs3 = self._score_super_relative_packed(
                            self.params, self.domain_params,
                            self._dev(ids3_u16, 1),
                        )
                    else:
                        mean3, qs3 = self._score_super_packed(
                            self.params, self._dev(ids3_u16, 1)
                        )
                    in_bytes = ids3_u16.nbytes
                else:
                    enc3 = [encode_padded(c, blen) for c in group]
                    ids3 = np.stack([e[0] for e in enc3])
                    mask3 = np.stack([e[1] for e in enc3])
                    if use_domain:
                        mean3, qs3 = self._score_super_relative(
                            self.params, self.domain_params,
                            self._dev(ids3, 1), self._dev(mask3, 1),
                        )
                    else:
                        mean3, qs3 = self._score_super(
                            self.params, self._dev(ids3, 1), self._dev(mask3, 1)
                        )
                    in_bytes = ids3.nbytes + mask3.nbytes
                defer(group, mean3, qs3, in_bytes)
                pos += S
            # Remainder: per-batch dispatches.  The packed path rides the
            # superbatch kernel with a leading G=1 axis — same mask-free
            # uint16 transfer (4x fewer bytes than int32+mask) and the
            # same lax.map body, one [1, bs, blen] trace per bucket.
            for chunk in batches[pos:]:
                if self._packed_ok:
                    ids1 = encode_padded_u16(chunk, blen)[None]
                    if use_domain:
                        mean1, qs1 = self._score_super_relative_packed(
                            self.params, self.domain_params,
                            self._dev(ids1, 1),
                        )
                    else:
                        mean1, qs1 = self._score_super_packed(
                            self.params, self._dev(ids1, 1)
                        )
                    defer([chunk], mean1, qs1, ids1.nbytes)
                    continue
                ids, mask = encode_padded(chunk, blen)
                if use_domain:
                    _, _, mean, qs = self._score_batch_relative(
                        self.params, self.domain_params,
                        self._dev(ids), self._dev(mask),
                    )
                else:
                    _, _, mean, qs = self._score_batch(
                        self.params, self._dev(ids), self._dev(mask)
                    )
                defer([chunk], mean, qs, ids.nbytes + mask.nbytes)
        if placements:
            flat_mean = d_mean.result()
            flat_qs = d_qs.result()
            for off, chunk in placements:
                cidx = np.asarray(chunk)
                rows = np.arange(len(chunk)) + off
                means[cidx] = flat_mean[rows]
                q90s[cidx] = flat_qs[rows, q90_col]
                q99s[cidx] = flat_qs[rows, -1]
        return means, q90s, q99s

    def __call__(self, text: str, **kwargs: Any) -> TextEntropyResult:
        return self.compute_entropy(text, **kwargs)


__all__ = ["TextEntropyEstimator", "TextEntropyResult"]
