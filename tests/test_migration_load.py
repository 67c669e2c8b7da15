"""Loading index directories written by the reference package.

The reference's ``ExactIndex.save`` (reference backends.py:483-515 +
BaseIndex.save backends.py:104-131) writes ``metadata.json`` (dim/space/
doc_ids/is_trained/type), ``payloads.jsonl`` (``{"id": ..., "payload":
{...}}`` per line) and ``embeddings.npy``.  DEWI's ``BaseIndex.load``
reads exactly that layout, so a reference-built ExactIndex directory loads
here as-is — the migration path documented in docs/MIGRATION.md.

These fixtures are written BY HAND to the reference's on-disk byte format
(no reference code imported), which is the contract being pinned.
"""

import json

import numpy as np
import pytest

from dewi.index import BaseIndex, ExactIndex, IVFIndex
from dewi.types import Payload


def _write_reference_exact_dir(path, n=24, dim=16, seed=0):
    """Emulate reference ExactIndex.save byte-for-byte (backends.py:483-515)."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, dim)).astype(np.float32)
    doc_ids = [f"doc{i}" for i in range(n)]
    payloads = [
        Payload(
            dewi=float(i) / n,
            ht_mean=float(i % 5),
            ht_q90=float(i % 7),
            hi_mean=0.5,
            hi_q90=1.0,
            I_hat=0.1 * (i % 3),
            redundancy=0.2,
            noise=0.05,
        )
        for i in range(n)
    ]
    path.mkdir(parents=True, exist_ok=True)
    np.save(str(path / "embeddings.npy"), emb)
    with open(path / "payloads.jsonl", "w") as f:
        for i, doc_id in enumerate(doc_ids):
            f.write(
                json.dumps({"id": doc_id, "payload": payloads[i].to_dict()})
                + "\n"
            )
    with open(path / "metadata.json", "w") as f:
        json.dump(
            {
                "dim": dim,
                "space": "cosine",
                "doc_ids": doc_ids,
                "is_trained": True,
                "type": "ExactIndex",
            },
            f,
        )
    return doc_ids, emb, payloads


class TestReferenceExactDirLoads:
    def test_loads_and_searches(self, tmp_path):
        doc_ids, emb, payloads = _write_reference_exact_dir(tmp_path / "ix")
        index = ExactIndex.load(tmp_path / "ix")
        assert len(index) == len(doc_ids)
        # Query with doc7's own embedding: cosine argmax at eta=0 must be
        # doc7 itself.
        results = index.search(emb[7], k=3, eta=0.0, entropy_pref=0.0)
        assert results[0][0] == "doc7"
        assert results[0][1] == pytest.approx(1.0, abs=1e-4)

    def test_payload_values_roundtrip(self, tmp_path):
        doc_ids, emb, payloads = _write_reference_exact_dir(tmp_path / "ix")
        index = ExactIndex.load(tmp_path / "ix")
        got = index.get_payload("doc5")
        assert got is not None
        assert got.dewi == pytest.approx(payloads[5].dewi, abs=1e-6)
        assert got.ht_mean == pytest.approx(payloads[5].ht_mean, abs=1e-6)
        assert got.noise == pytest.approx(payloads[5].noise, abs=1e-6)

    def test_baseindex_dispatches_on_type(self, tmp_path):
        _write_reference_exact_dir(tmp_path / "ix")
        index = BaseIndex.load(tmp_path / "ix")
        assert isinstance(index, ExactIndex)

    def test_extra_payload_keys_ignored(self, tmp_path):
        """Reference Payload.from_dict drops unknown keys; so must we."""
        doc_ids, emb, _ = _write_reference_exact_dir(tmp_path / "ix", n=4)
        lines = (tmp_path / "ix" / "payloads.jsonl").read_text().splitlines()
        rows = [json.loads(line) for line in lines]
        for row in rows:
            row["payload"]["someday_field"] = 42.0
        with open(tmp_path / "ix" / "payloads.jsonl", "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
        index = ExactIndex.load(tmp_path / "ix")
        assert len(index) == 4


class TestReferenceGraphDirsDegrade:
    """HNSW/FAISS reference saves carry no raw embeddings (HNSW saves only
    BaseIndex files, backends.py:104-131; FAISS adds an opaque index.faiss,
    backends.py:358-368) — loading must not crash, and must come back empty
    rather than fabricate vectors."""

    def _write_graph_dir(self, path, type_name, with_faiss_blob=False):
        path.mkdir(parents=True, exist_ok=True)
        doc_ids = ["a", "b"]
        with open(path / "payloads.jsonl", "w") as f:
            for d in doc_ids:
                f.write(json.dumps({"id": d, "payload": Payload().to_dict()}) + "\n")
        with open(path / "metadata.json", "w") as f:
            json.dump(
                {
                    "dim": 8,
                    "space": "cosine",
                    "doc_ids": doc_ids,
                    "is_trained": True,
                    "type": type_name,
                },
                f,
            )
        if with_faiss_blob:
            (path / "index.faiss").write_bytes(b"\x00opaque-faiss-bytes")

    def test_hnsw_dir_loads_empty(self, tmp_path):
        self._write_graph_dir(tmp_path / "ix", "HNSWIndex")
        index = BaseIndex.load(tmp_path / "ix")
        assert isinstance(index, ExactIndex)  # HNSW maps to the exact tier
        assert len(index) == 0  # no embeddings to import

    def test_faiss_dir_loads_empty(self, tmp_path):
        self._write_graph_dir(tmp_path / "ix", "FAISSIndex", with_faiss_blob=True)
        index = BaseIndex.load(tmp_path / "ix")
        assert isinstance(index, IVFIndex)
        assert len(index) == 0


@pytest.mark.parametrize("cls_name,legacy", [
    ("ExactIndex", {"use_pallas": True, "blockmax_select": True,
                    "fused_bmax": False}),
    ("QuantizedIndex", {"refine_factor": 8, "approx_select": True,
                        "use_pallas": True, "int8_queries": False,
                        "bf16_scores": False, "blockmax_select": True,
                        "int4_storage": False}),
])
def test_index_saved_with_kernel_flags_still_loads(tmp_path, cls_name,
                                                   legacy):
    """Indexes saved while the tiers carried ``use_pallas`` / ``fused_bmax``
    hyperparameters load and search; the flags are dropped on re-save."""
    from dewi.index import QuantizedIndex

    cls = {"ExactIndex": ExactIndex, "QuantizedIndex": QuantizedIndex}[
        cls_name]
    rng = np.random.default_rng(3)
    src = cls(dim=16)
    ids = [f"d{i}" for i in range(40)]
    src.add_batch(ids, rng.normal(size=(40, 16)).astype(np.float32),
                  np.abs(rng.normal(size=(40, 8))).astype(np.float32))
    src.build()
    src.save(tmp_path / "idx")
    meta_path = tmp_path / "idx" / "metadata.json"
    meta = json.loads(meta_path.read_text())
    meta["hyperparams"] = legacy
    meta_path.write_text(json.dumps(meta))

    loaded = BaseIndex.load(tmp_path / "idx")
    assert type(loaded) is cls and len(loaded) == 40
    q = rng.normal(size=16).astype(np.float32)
    assert [r[0] for r in loaded.search(q, k=5)] == \
        [r[0] for r in src.search(q, k=5)]
    loaded.save(tmp_path / "again")
    again = json.loads((tmp_path / "again" / "metadata.json").read_text())
    assert "use_pallas" not in again["hyperparams"]
    assert "fused_bmax" not in again["hyperparams"]
