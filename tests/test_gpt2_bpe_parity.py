"""True GPT-2 BPE parity (VERDICT r3 #5): the vendored fixture exercises the
REFERENCE tokenizer implementation — ``transformers.GPT2Tokenizer`` (the
pure-Python byte-level BPE the reference loads from the hub, reference
text_entropy.py:31-38) — loaded offline from ``tests/fixtures/gpt2_mini/``
(exact gpt2 serialization: vocab.json + merges.txt; regenerate with
``scripts/make_gpt2_fixture.py``).  The encoding algorithm (GPT-2 regex
pretokenizer, bytes<->unicode table, merge resolution, specials) is
vocabulary-independent, so adapter parity here covers the hub-vocab
behavior the offline environment cannot fetch."""

from pathlib import Path

import numpy as np
import pytest

transformers = pytest.importorskip("transformers")

FIXTURE = Path(__file__).parent / "fixtures" / "gpt2_mini"

# The byte-level pretokenizer edge-case battery: contractions ('s 't 're
# 've 'm 'll 'd), leading/multiple/trailing spaces, tabs/newlines/CRLF,
# unicode (accents, CJK, RTL, emoji, combining), digit runs, punctuation
# runs, the empty and whitespace-only strings.
EDGE_CASES = [
    "Don't stop believing; it's what we're here for, isn't it?",
    "I'm sure they'll've finished by 2026-08-19 at 12:30pm.",
    "  leading spaces", "trailing spaces  ", "many   inner    spaces",
    "tabs\tand\nnewlines\r\nand CRLF",
    "déjà vu, São Paulo, naïve café",
    "中文测试 and 日本語 and 한국어",
    "عربى and русский",
    "🙂🚀 emoji 🧪 runs",
    "é combining accent",
    "0 1 22 333 4444 3.14159 1e-8 0xFF",
    "!!! ??? ... --- ***",
    "\"Quoted 'nested' strings\" ([{<>}])",
    "CamelCase snake_case kebab-case",
    "def f(x):\n    return x ** 2  # comment",
    " ", "   ", "\n", "a",
    "<|endoftext|>",  # special token passes through as one id
]


@pytest.fixture(scope="module")
def slow():
    return transformers.GPT2Tokenizer(
        vocab_file=str(FIXTURE / "vocab.json"),
        merges_file=str(FIXTURE / "merges.txt"),
    )


@pytest.fixture(scope="module")
def fast():
    return transformers.GPT2TokenizerFast(
        vocab_file=str(FIXTURE / "vocab.json"),
        merges_file=str(FIXTURE / "merges.txt"),
    )


@pytest.fixture(scope="module")
def adapter(fast):
    from dewi.signals.tokenizer import get_tokenizer

    return get_tokenizer(fast)


class TestReferenceParity:
    def test_adapter_matches_slow_reference(self, adapter, slow):
        """Our adapter's ids == the reference GPT2Tokenizer's ids on every
        pretokenizer edge case (empty string excluded: HF returns [])."""
        for text in EDGE_CASES:
            want = slow.encode(text)
            got = adapter.encode(text, max_len=512)
            assert list(got) == list(want), (text, got, want)

    def test_batch_matches_per_text(self, adapter, slow):
        texts = [t for t in EDGE_CASES if slow.encode(t)]
        ids, mask = adapter.encode_batch(texts, max_len=512)
        for i, t in enumerate(texts):
            want = slow.encode(t)
            n = int(mask[i].sum())
            assert ids[i, :n].tolist() == want[: ids.shape[1]], t

    def test_packed_u16_matches(self, adapter, slow):
        texts = [t for t in EDGE_CASES if slow.encode(t)]
        u16 = adapter.encode_batch_u16(texts, max_len=512)
        assert adapter.pad_is_exclusive
        for i, t in enumerate(texts):
            want = slow.encode(t)
            row = u16[i][u16[i] != adapter.pad_id]
            assert row.tolist() == want[: u16.shape[1]], t

    def test_truncation_matches(self, adapter, slow):
        long = "the quick brown fox jumps over the lazy dog " * 40
        want = slow.encode(long)[:16]
        got = adapter.encode(long, max_len=16)
        assert list(got) == want

    def test_special_token_single_id(self, adapter, slow):
        ids = adapter.encode("<|endoftext|>", max_len=8)
        assert list(ids) == [slow.eos_token_id]

    def test_byte_level_roundtrip(self, slow, fast):
        """The gpt2 bytes<->unicode table: decode(encode(x)) == x for
        arbitrary UTF-8, in both implementations."""
        for text in EDGE_CASES:
            assert slow.decode(slow.encode(text)) == text
            assert fast.decode(fast.encode(text)) == text


class TestEstimatorWithGpt2Fixture:
    def test_text_entropy_runs_with_gpt2_bpe(self, fast):
        """End-to-end: the LM estimator over the gpt2-format tokenizer —
        the configuration the reference runs (text_entropy.py:31-38)."""
        from dewi.signals.text_entropy import TextEntropyEstimator

        est = TextEntropyEstimator(model_name="tiny", batch_size=4,
                                   max_length=128, tokenizer=fast)
        m, q90, q99 = est.batch_compute_stats(EDGE_CASES[:6])
        assert np.all(np.isfinite(m)) and np.all(q90 <= q99 + 1e-6)


@pytest.mark.skipif(__import__("os").cpu_count() < 4,
                    reason="multi-core scaling needs >= 4 host cores "
                           "(dev box has 1; runs on CI)")
class TestBatchEncodeScaling:
    def test_rust_batch_encode_scales(self, fast):
        """encode_batch releases the GIL in the Rust tokenizer; on a
        multi-core host the batched call must beat per-text encoding by
        >= 2x (VERDICT r3 #5)."""
        import time

        texts = ["the quick brown fox jumps over the lazy dog " * 8] * 4096
        bt = fast.backend_tokenizer
        bt.enable_truncation(max_length=512)
        bt.encode_batch_fast(texts[:64])  # warm
        t0 = time.perf_counter()
        bt.encode_batch_fast(texts)
        batch_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for t in texts[:512]:
            fast.encode(t, truncation=True, max_length=512)
        per_text_s = (time.perf_counter() - t0) * (len(texts) / 512)
        assert per_text_s / batch_s >= 2.0, (batch_s, per_text_s)
