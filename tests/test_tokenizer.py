"""Tokenizer layer: byte tokenizer invariants + the first-class BPE path.

The BPE tests build a REAL byte-level BPE tokenizer locally (trained with
the bundled `tokenizers` library — no hub files, no network) and run it
through the HF adapter, so the fast-batch encode, the uint16 packed
transfer with the out-of-vocab pad sentinel, and the estimator integration
are all exercised with genuine Rust-tokenizer semantics.
"""

import numpy as np
import pytest

from dewi.signals.tokenizer import (
    BOS_ID,
    PAD_ID,
    ByteTokenizer,
    bucket_length,
    get_tokenizer,
    make_hf_adapter,
)

TEXTS = [
    "the quick brown fox jumps over the lazy dog",
    "entropy weighted index for text image corpora",
    "a",
    "useful surprise is the signal worth keeping today",
]


@pytest.fixture(scope="module")
def bpe_tok(tmp_path_factory):
    """A real fast BPE tokenizer trained locally (GPT-2 style byte-level)."""
    tokenizers = pytest.importorskip("tokenizers")
    transformers = pytest.importorskip("transformers")
    td = tmp_path_factory.mktemp("bpe")
    corpus = td / "corpus.txt"
    rng = np.random.default_rng(0)
    words = ("alpha beta gamma delta entropy index corpus signal token "
             "image model robust search weight noise data the quick brown "
             "fox jumps over lazy dog useful surprise").split()
    corpus.write_text("\n".join(
        " ".join(rng.choice(words, size=20)) for _ in range(500)
    ))
    bpe = tokenizers.implementations.ByteLevelBPETokenizer()
    bpe.train([str(corpus)], vocab_size=500, min_frequency=1)
    bpe.save_model(str(td))
    tok = transformers.GPT2TokenizerFast(
        vocab_file=str(td / "vocab.json"), merges_file=str(td / "merges.txt")
    )
    return tok


class TestByteTokenizer:
    def test_encode_lengths_matches_scalar(self):
        t = ByteTokenizer()
        lens = t.encode_lengths(TEXTS, 64)
        for i, s in enumerate(TEXTS):
            assert lens[i] == t.encode_length(s, 64)

    def test_u16_matches_encode_batch(self):
        t = ByteTokenizer()
        ids, mask = t.encode_batch(TEXTS, 32, pad_to=32)
        u16 = t.encode_batch_u16(TEXTS, 32, pad_to=32)
        np.testing.assert_array_equal(ids, u16.astype(np.int32))
        np.testing.assert_array_equal(mask, (u16 != PAD_ID).astype(np.float32))


class TestBPEAdapter:
    def test_adapter_basics(self, bpe_tok):
        a = make_hf_adapter(bpe_tok)
        # len(tok) includes added tokens (here <|endoftext|> at id ==
        # bpe_tok.vocab_size) — the adapter's id extent must cover them.
        assert a.vocab_size == len(bpe_tok) > bpe_tok.vocab_size
        # Small vocab -> exclusive out-of-vocab pad sentinel, u16-capable.
        assert a.pad_is_exclusive and a.pad_id == a.vocab_size

    def test_batch_encode_matches_per_text(self, bpe_tok):
        a = make_hf_adapter(bpe_tok)
        ids, mask = a.encode_batch(TEXTS, 32, pad_to=32)
        for i, s in enumerate(TEXTS):
            e = a.encode(s, 32)
            assert ids[i, : len(e)].tolist() == e
            assert mask[i, : len(e)].sum() == len(e)
            assert mask[i, len(e):].sum() == 0
            # pad fill is a real id (0), not the OOV sentinel
            assert np.all(ids[i, len(e):] == 0)

    def test_u16_pad_sentinel(self, bpe_tok):
        a = make_hf_adapter(bpe_tok)
        u16 = a.encode_batch_u16(TEXTS, 32, pad_to=32)
        ids, mask = a.encode_batch(TEXTS, 32, pad_to=32)
        derived = (u16 != a.pad_id).astype(np.float32)
        np.testing.assert_array_equal(derived, mask)
        # Real tokens identical to the masked encode.
        np.testing.assert_array_equal(
            np.where(derived.astype(bool), u16.astype(np.int32), 0), ids
        )

    def test_added_tokens_never_alias_pad(self, bpe_tok):
        # HF vocab_size excludes added tokens; the pad sentinel must sit
        # beyond len(tok) or the first added token's id == pad and its
        # positions get silently masked (round-3 review finding).
        import copy

        tok = copy.deepcopy(bpe_tok)
        tok.add_tokens(["<domain>", "<chat>"])
        assert len(tok) > tok.vocab_size
        a = make_hf_adapter(tok)
        assert a.pad_id >= len(tok)
        assert a.vocab_size == len(tok)
        u16 = a.encode_batch_u16(["alpha <domain> beta"], 32, pad_to=32)
        ids, mask = a.encode_batch(["alpha <domain> beta"], 32, pad_to=32)
        derived = (u16 != a.pad_id).astype(np.float32)
        np.testing.assert_array_equal(derived, mask)
        # The added token's id survives as a real (unmasked) token.
        added_id = tok.convert_tokens_to_ids("<domain>")
        assert added_id >= bpe_tok.vocab_size  # beyond the base vocab
        assert (u16 == added_id).any()

    def test_interleaved_max_lens_do_not_leak(self, bpe_tok):
        # _encode_all uses the raw Rust encode_batch_fast, whose
        # truncation length lives as state on the shared backend object
        # (also mutated by transformers-level calls).  Interleaving
        # different max_lens must each truncate correctly.
        a = make_hf_adapter(bpe_tok)
        long = ["alpha beta gamma delta " * 40] * 3
        ids16, _ = a.encode_batch(long, 16, pad_to=16)
        ids64, _ = a.encode_batch(long, 64, pad_to=64)
        ids16b, _ = a.encode_batch(long, 16, pad_to=16)
        assert ids64.shape[1] == 64
        # 64-token encode genuinely kept more than 16 tokens
        assert (ids64[:, 16:] != 0).any()
        np.testing.assert_array_equal(ids16, ids16b)
        np.testing.assert_array_equal(ids16, ids64[:, :16])

    def test_encode_lengths_batch(self, bpe_tok):
        a = make_hf_adapter(bpe_tok)
        lens = a.encode_lengths(TEXTS, 32)
        for i, s in enumerate(TEXTS):
            assert lens[i] == a.encode_length(s, 32)

    def test_get_tokenizer_accepts_instances(self, bpe_tok):
        a = make_hf_adapter(bpe_tok)
        assert get_tokenizer(a) is a          # adapter passes through
        b = get_tokenizer(bpe_tok)            # raw HF instance wrapped
        assert b.vocab_size == len(bpe_tok)


class TestBPEEstimator:
    def test_surprisal_with_real_bpe(self, bpe_tok):
        """End-to-end: BPE ids through the packed LM scoring path must
        match the scalar (unpacked int32+mask) path."""
        from dewi.signals.text_entropy import TextEntropyEstimator

        est = TextEntropyEstimator(
            model_name="tiny", batch_size=4, max_length=32,
            tokenizer=make_hf_adapter(bpe_tok),
        )
        assert est.cfg.vocab_size == len(bpe_tok)
        assert est._packed_ok  # exclusive sentinel enables packed transfer
        means, q90s, _ = est.batch_compute_stats(TEXTS)
        for i, s in enumerate(TEXTS):
            r = est.compute_entropy(s)
            assert means[i] == pytest.approx(r.mean_entropy, abs=1e-4)
            assert q90s[i] == pytest.approx(r.q90_entropy, abs=1e-4)

    def test_vocab_mismatch_hard_error(self, bpe_tok, tmp_path):
        """A checkpoint sidecar with a different vocab must refuse."""
        import json

        from dewi.models.registry import init_lm, lm_config, save_params
        from dewi.signals.text_entropy import TextEntropyEstimator

        cfg = lm_config("tiny", vocab_size=258, max_len=32)
        _, params = init_lm(cfg, seed=0)
        ckpt = tmp_path / "lm.msgpack"
        save_params(params, ckpt)
        sidecar = {
            "kind": "lm",
            "config": {
                k: getattr(cfg, k)
                for k in ("vocab_size", "max_len", "d_model", "n_layers",
                          "n_heads", "d_ff")
            },
        }
        (tmp_path / "lm.msgpack.config.json").write_text(json.dumps(sidecar))
        with pytest.raises(ValueError, match="vocab"):
            TextEntropyEstimator(
                tokenizer=make_hf_adapter(bpe_tok),  # vocab 500 != 258
                checkpoint=str(ckpt),
            )


class TestBucketLength:
    def test_powers(self):
        assert bucket_length(2) == 32
        assert bucket_length(33) == 64
        assert bucket_length(1000, max_len=512) == 512
