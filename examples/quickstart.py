#!/usr/bin/env python
"""DEWI quickstart: signals -> scores -> index -> entropy-aware search.

Hermetic end-to-end demo on tiny models (no downloads, runs on CPU or GPU):

    python examples/quickstart.py
"""

import numpy as np

from dewi import DewiConfig, DewiPipeline, create_document
from dewi.eval import evaluate_index
from dewi.sampling import sample_by_dewi

CORPUS = [
    "The aurora borealis is caused by charged solar particles striking the "
    "upper atmosphere and exciting oxygen and nitrogen atoms.",
    "The aurora borealis is caused by charged solar particles striking the "
    "upper atmosphere and exciting oxygen and nitrogen atoms.",  # duplicate
    "Buy cheap watches !!! $$$ click here now !!! limited offer $$$",
    "Quantum error correction protects logical qubits by encoding them "
    "redundantly across many physical qubits.",
    "aaaa aaaa aaaa aaaa aaaa aaaa aaaa aaaa aaaa aaaa aaaa aaaa",
    "Fermentation converts sugars to ethanol and carbon dioxide through "
    "anaerobic metabolic pathways in yeast.",
]


def main() -> None:
    cfg = DewiConfig.from_dict(
        {
            "text": {"model": "tiny", "batch_size": 4, "max_length": 128},
            "cross_modal": {"model": "tiny", "batch_size": 4},
            "redundancy": {"block_size": 8},
        }
    )
    pipe = DewiPipeline(cfg)
    docs = [create_document(f"doc{i}", text=t) for i, t in enumerate(CORPUS)]

    docs = pipe.compute_signals(docs, progress=True)
    docs = pipe.compute_dewi_scores(docs)

    print("\nSignals + DEWI scores:")
    for d in docs:
        print(
            f"  {d.doc_id}: ht={d.ht_mean:6.3f} red={d.redundancy:5.2f} "
            f"noise={d.noise:4.2f} dewi={d.dewi_score:5.3f}"
        )

    index = pipe.build_index(docs)
    query = pipe.encode_query("northern lights in the atmosphere")
    print("\nSearch 'northern lights in the atmosphere' (eta=0.4):")
    for doc_id, score, payload in index.search(query, k=3, eta=0.4):
        print(f"  {doc_id}: adjusted={score:6.3f} dewi={payload.dewi:5.3f}")

    report = evaluate_index(
        index,
        np.stack([query]),
        {"q0": ["doc0", "doc1"]},
    )
    print(f"\nEval: recall@5={report['recall@5']:.2f} mrr={report['mrr']:.2f}")

    dewi = np.array([d.dewi_score for d in docs])
    picks = sample_by_dewi(dewi, k=3, tau=2.0, seed=0)
    print(f"DEWI^tau sample (tau=2): {[docs[i].doc_id for i in picks]}")


if __name__ == "__main__":
    main()
