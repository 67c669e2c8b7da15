"""Native C++ runtime tests: JSONL codec + minhash, and Python-fallback parity."""

import numpy as np
import pytest

from dewi import native
from dewi.types import PAYLOAD_FIELDS


class TestPayloadCodec:
    def test_roundtrip(self, tmp_path):
        ids = [f"doc-{i}" for i in range(100)]
        mat = np.random.default_rng(0).random((100, 8)).astype(np.float32)
        p = tmp_path / "p.jsonl"
        native.write_payloads_jsonl(p, ids, mat)
        rids, rmat = native.read_payloads_jsonl(p)
        assert rids == ids
        np.testing.assert_allclose(rmat, mat, rtol=1e-6)

    def test_escaped_ids(self, tmp_path):
        ids = ['plain', 'with "quotes"', "back\\slash", "tab\there"]
        mat = np.ones((4, 8), np.float32)
        p = tmp_path / "p.jsonl"
        native.write_payloads_jsonl(p, ids, mat)
        # The file must be line-by-line valid JSON regardless of codec.
        import json

        lines = p.read_text().splitlines()
        parsed = [json.loads(l) for l in lines]
        assert [d["doc_id"] for d in parsed] == ids
        rids, _ = native.read_payloads_jsonl(p)
        assert rids == ids

    def test_read_tolerates_reference_id_key(self, tmp_path):
        # Reference BaseIndex wrote {"id": ...} (backends.py:120-126).
        p = tmp_path / "p.jsonl"
        p.write_text('{"id": "x", "payload": {"dewi": 0.5}}\n')
        ids, mat = native.read_payloads_jsonl(p)
        assert ids == ["x"]
        assert mat[0, 0] == pytest.approx(0.5)
        assert mat[0, 1] == 0.0  # missing keys read 0

    def test_python_fallback_equivalent(self, tmp_path, monkeypatch):
        ids = [f"d{i}" for i in range(20)]
        mat = np.random.default_rng(1).random((20, 8)).astype(np.float32)
        native.write_payloads_jsonl(tmp_path / "n.jsonl", ids, mat)
        monkeypatch.setenv("DEWI_NO_NATIVE", "1")
        monkeypatch.setattr(native, "_tried", False)
        monkeypatch.setattr(native, "_lib", None)
        assert not native.available()
        native.write_payloads_jsonl(tmp_path / "p.jsonl", ids, mat)
        for fname in ("n.jsonl", "p.jsonl"):
            rids, rmat = native.read_payloads_jsonl(tmp_path / fname)
            assert rids == ids
            np.testing.assert_allclose(rmat, mat, rtol=1e-6)

    def test_empty_file(self, tmp_path):
        p = tmp_path / "empty.jsonl"
        p.write_text("")
        ids, mat = native.read_payloads_jsonl(p)
        assert ids == []
        assert mat.shape[0] == 0 or mat.size == 0


class TestNativeMinhash:
    def test_identity_and_difference(self):
        sigs = native.minhash_signatures_native(
            ["aa bb cc dd ee ff", "aa bb cc dd ee ff", "zz yy xx ww vv uu"],
            num_hashes=32,
        )
        if sigs is None:
            pytest.skip("native library unavailable")
        assert np.array_equal(sigs[0], sigs[1])
        assert not np.array_equal(sigs[0], sigs[2])

    def test_jaccard_estimate_reasonable(self):
        # Two docs sharing half their shingles -> signature agreement ~0.5.
        a = "w1 w2 w3 w4 w5 w6 w7 w8 w9 w10 w11 w12"
        b = "w1 w2 w3 w4 w5 w6 x7 x8 x9 x10 x11 x12"
        sigs = native.minhash_signatures_native([a, b], num_hashes=128)
        if sigs is None:
            pytest.skip("native library unavailable")
        agree = float(np.mean(sigs[0] == sigs[1]))
        assert 0.1 < agree < 0.75

    def test_rs_separator_rejected(self):
        out = native.minhash_signatures_native(["has \x1e separator"], 8)
        assert out is None


class TestIndexIntegration:
    def test_save_load_uses_codec(self, tmp_path):
        from dewi import DewiIndex
        from dewi.types import Payload

        rng = np.random.default_rng(0)
        idx = DewiIndex(dim=8)
        ids = [f"n{i}" for i in range(12)]
        emb = rng.normal(size=(12, 8)).astype(np.float32)
        pay = rng.random((12, 8)).astype(np.float32)
        idx.add_batch(ids, emb, pay)
        idx.build()
        idx.save(tmp_path / "idx")
        assert (tmp_path / "idx" / "ann_index" / "payloads.jsonl").exists()
        loaded = DewiIndex.load(tmp_path / "idx")
        assert len(loaded) == 12
        p = loaded.get_payload("n3")
        assert p is not None
        np.testing.assert_allclose(p.to_array(), pay[3], rtol=1e-6)
