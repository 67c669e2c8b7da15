#!/usr/bin/env python
"""Columnar (array-native) pipeline at corpus scale, with resume.

The quickstart moves per-``Document`` objects; at 1M docs that Python
overhead can outweigh the device time.  This example runs the production path instead: a columnar :class:`Corpus`
streamed shard-by-shard through signals -> one global fused fit+score ->
a two-array index handoff — no per-doc Python in any hot loop — plus
shard checkpoints that make a second run resume instead of recompute.

Hermetic (tiny models, synthetic text), runs on CPU or GPU:

    python examples/columnar_pipeline.py
"""

import os
import tempfile
import time
from pathlib import Path

import numpy as np

from dewi import DewiConfig, DewiPipeline
from dewi.corpus import COL, Corpus

N_DOCS = int(os.environ.get("DEWI_EXAMPLE_DOCS", 2_000))
WORDS = ("entropy signal index corpus robust weight noise surprise "
         "quantum aurora yeast fermentation qubit atmosphere solar").split()


def synth_texts(n: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    texts = [" ".join(rng.choice(WORDS, size=12)) for _ in range(n)]
    # Seed structure the signals can find: duplicates and low-entropy spam.
    for i in range(0, n, 50):
        texts[i] = texts[0]                        # redundancy
    for i in range(25, n, 100):
        texts[i] = "aaaa " * 12                    # low text entropy
    return texts


def main() -> None:
    cfg = DewiConfig.from_dict({
        "text": {"model": "tiny", "batch_size": 256, "max_length": 64},
        "cross_modal": {"model": "tiny", "batch_size": 256},
        "runtime": {"shard_size": 512},
    })
    pipe = DewiPipeline(cfg)
    corpus = Corpus(ids=[f"doc{i}" for i in range(N_DOCS)],
                    texts=synth_texts(N_DOCS))

    with tempfile.TemporaryDirectory() as td:
        ckpt = Path(td) / "ckpts"

        t0 = time.perf_counter()
        pipe.process_stream_corpus(corpus, checkpoint_dir=ckpt,
                                   progress=True)
        cold = time.perf_counter() - t0
        print(f"\ncold run: {N_DOCS / cold:,.0f} docs/s "
              f"({len(list(ckpt.glob('shard_*.npz')))} shard checkpoints)")

        # Same corpus again: every shard resumes from its checkpoint
        # (content-digest keyed), only the global fit+score re-runs.
        corpus2 = Corpus(ids=list(corpus.ids), texts=list(corpus.texts))
        t0 = time.perf_counter()
        pipe.process_stream_corpus(corpus2, checkpoint_dir=ckpt)
        warm = time.perf_counter() - t0
        print(f"resumed run: {N_DOCS / warm:,.0f} docs/s "
              f"({cold / warm:.1f}x faster)")
        np.testing.assert_allclose(corpus2.dewi, corpus.dewi, atol=1e-6)

    ht = corpus.col("ht_mean")
    red = corpus.col("redundancy")
    print(f"\nsignal columns: ht_mean[{ht.min():.2f}..{ht.max():.2f}] "
          f"redundancy[{red.min():.2f}..{red.max():.2f}] "
          f"(COL order: {list(COL)})")

    index = pipe.build_index_corpus(corpus)
    q = pipe.encode_query("solar particles in the atmosphere")
    print("\nsearch 'solar particles in the atmosphere' (eta=0.4):")
    for doc_id, score, payload in index.search(q, k=3, eta=0.4):
        print(f"  {doc_id}: adjusted={score:6.3f} dewi={payload.dewi:5.3f}")


if __name__ == "__main__":
    main()
