#!/usr/bin/env python
"""Host tokenize-rate profile: byte tokenizer vs the first-class BPE path.

VERDICT r2 #5 asked for a measured host tokenize rate for the GPT-2-class
BPE path alongside the hermetic byte tokenizer.  The dev image has no
network (the real `gpt2` vocab/merges can't be fetched), so this trains a
REAL byte-level BPE locally with the bundled Rust `tokenizers` library at
the same vocab size (50,257) on Zipf-distributed synthetic English-like
text — the encode cost structure (byte-level pretokenize + merge loop,
vocab-sized tables) is the same class as the hub checkpoint's; only the
merge table contents differ.  Reference semantics: GPT-2 BPE NLL,
reference src/dewi/signals/text_entropy.py:31-38.

Rows (docs/sec over --n-docs docs of ~--words words):
  byte_u16        ByteTokenizer.encode_batch_u16 (the default hermetic path)
  bpe_fast_batch  HF adapter encode_batch — ONE Rust call per corpus chunk
  bpe_fast_u16    HF adapter encode_batch_u16 (packed transfer, pad sentinel)
  bpe_per_text    the per-text Python encode loop the adapter replaced
                  (measured on a subset; reported at full-corpus rate)

Writes perf_out/tokenize.json.  CPU-only (no accelerator).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def synth_corpus(n_docs: int, words_per_doc: int, seed: int = 0) -> list[str]:
    """Zipf-weighted English-like text (syllable-composed word list)."""
    rng = np.random.default_rng(seed)
    syll = ["al", "an", "ar", "co", "de", "en", "er", "in", "ing", "ion",
            "is", "it", "le", "ment", "nd", "on", "or", "ra", "re", "se",
            "st", "te", "th", "ti", "to", "tro", "ve", "py", "dex", "sig"]
    n_vocab = 120_000
    parts = rng.integers(0, len(syll), size=(n_vocab, 4))
    lens = rng.integers(1, 5, size=n_vocab)
    vocab = np.array(
        ["".join(syll[parts[i, j]] for j in range(lens[i]))
         for i in range(n_vocab)]
    )
    # Zipf ranks: heavy head like natural text (exponent ~1.1).
    ranks = np.arange(1, n_vocab + 1, dtype=np.float64)
    p = ranks ** -1.1
    p /= p.sum()
    idx = rng.choice(n_vocab, size=(n_docs, words_per_doc), p=p)
    return [" ".join(vocab[row]) for row in idx]


def train_bpe(corpus: list[str], vocab_size: int, workdir: Path):
    import tokenizers
    import transformers

    t0 = time.perf_counter()
    workdir.mkdir(parents=True, exist_ok=True)
    train_file = workdir / "train.txt"
    train_file.write_text("\n".join(corpus))
    bpe = tokenizers.implementations.ByteLevelBPETokenizer()
    bpe.train([str(train_file)], vocab_size=vocab_size, min_frequency=1)
    bpe.save_model(str(workdir))
    tok = transformers.GPT2TokenizerFast(
        vocab_file=str(workdir / "vocab.json"),
        merges_file=str(workdir / "merges.txt"),
    )
    return tok, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n-docs", type=int, default=20_000)
    ap.add_argument("--words", type=int, default=100)
    ap.add_argument("--vocab-size", type=int, default=50_257)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--train-docs", type=int, default=4_000)
    ap.add_argument("--output", default="perf_out/tokenize.json")
    args = ap.parse_args()

    from dewi.signals.tokenizer import ByteTokenizer, make_hf_adapter

    print(f"== synthesizing {args.n_docs} docs x ~{args.words} words")
    corpus = synth_corpus(args.n_docs, args.words)
    n_chars = sum(len(t) for t in corpus)

    print(f"== training local byte-level BPE (vocab {args.vocab_size})")
    tok, train_s = train_bpe(
        corpus[: args.train_docs], args.vocab_size,
        Path("/tmp/dewi_bpe_profile"),
    )
    adapter = make_hf_adapter(tok)
    out: dict = {
        "n_docs": args.n_docs,
        "words_per_doc": args.words,
        "chars_total": n_chars,
        "max_len": args.max_len,
        "bpe_vocab_size": adapter.vocab_size,
        "bpe_train_s": round(train_s, 1),
        "bpe_pad_is_exclusive": bool(adapter.pad_is_exclusive),
    }

    def rate(label: str, fn, n: int = args.n_docs, reps: int = 2) -> float:
        fn()  # warm (allocators, Rust thread pool)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        dps = n / best
        out[label + "_docs_per_sec"] = round(dps, 1)
        print(f"   {label}: {dps:,.0f} docs/s")
        return dps

    bt = ByteTokenizer()
    byte_dps = rate("byte_u16",
                    lambda: bt.encode_batch_u16(corpus, args.max_len,
                                                pad_to=args.max_len))
    bpe_dps = rate("bpe_fast_batch",
                   lambda: adapter.encode_batch(corpus, args.max_len,
                                                pad_to=args.max_len))
    # Raw encode A/B (no padding arrays on either side): the Rust
    # encode_batch_fast route the adapter uses vs the transformers
    # __call__ wrapper it bypasses (which builds offsets/attention the
    # estimators never read).  Interleaved reps — sequential best-of on
    # this 1-core shared host confounds the two sides with load drift.
    raw_ts: list[float] = []
    tf_ts: list[float] = []
    adapter._encode_all(corpus, args.max_len)  # warm both routes
    tok(list(corpus), truncation=True, max_length=args.max_len)
    for _ in range(5):
        t0 = time.perf_counter()
        adapter._encode_all(corpus, args.max_len)
        raw_ts.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        tok(list(corpus), truncation=True,
            max_length=args.max_len)["input_ids"]
        tf_ts.append(time.perf_counter() - t0)
    out["bpe_encode_raw_docs_per_sec"] = round(
        args.n_docs / float(np.median(raw_ts)), 1
    )
    out["bpe_transformers_call_docs_per_sec"] = round(
        args.n_docs / float(np.median(tf_ts)), 1
    )
    out["bpe_fast_vs_transformers_speedup"] = round(
        float(np.median(tf_ts)) / float(np.median(raw_ts)), 3
    )
    print(f"   raw-vs-transformers speedup (interleaved median): "
          f"{out['bpe_fast_vs_transformers_speedup']}")
    rate("bpe_fast_u16",
         lambda: adapter.encode_batch_u16(corpus, args.max_len,
                                          pad_to=args.max_len))
    sub = corpus[: max(1, args.n_docs // 10)]
    rate("bpe_per_text",
         lambda: [adapter.encode(t, args.max_len) for t in sub], n=len(sub))

    out["byte_vs_bpe_speedup"] = round(byte_dps / max(bpe_dps, 1e-9), 2)
    out["bpe_mb_per_sec"] = round(bpe_dps * n_chars / args.n_docs / 1e6, 2)
    out["note"] = (
        "Locally trained byte-level BPE (Rust tokenizers; achieved vocab "
        "recorded above — the hub gpt2 vocab is unreachable offline; BPE "
        "encode cost scales with tokens and merge depth, not vocab-table "
        "size). Zipf synthetic text, 1-core dev host. The BPE rate here IS "
        "the reference's tokenize cost (same Rust library underneath its "
        "GPT-2 NLL path, reference text_entropy.py:31-38); the hermetic "
        "byte tokenizer is this framework's faster default. Tokenize is "
        "embarrassingly parallel across docs: provision "
        "ceil(device_docs_per_sec / bpe_fast_batch_docs_per_sec) host "
        "cores to keep the card fed."
    )
    path = ROOT / args.output
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=2) + "\n")
    print(f"== wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
