"""CLI tests via click.testing.CliRunner (parity: reference tests/test_cli.py)."""

import json
from pathlib import Path

import numpy as np
import pytest
from click.testing import CliRunner

from dewi.cli import cli, create_document


@pytest.fixture
def runner():
    return CliRunner()


class TestConfig:
    def test_config_to_stdout(self, runner):
        res = runner.invoke(cli, ["config"])
        assert res.exit_code == 0
        assert "scoring" in res.output
        assert "alpha_t" in res.output

    def test_config_to_file(self, runner, tmp_path):
        out = tmp_path / "cfg.yaml"
        res = runner.invoke(cli, ["config", "-o", str(out)])
        assert res.exit_code == 0
        assert out.exists()

    def test_overwrite_guard(self, runner, tmp_path):
        out = tmp_path / "cfg.yaml"
        out.write_text("existing")
        res = runner.invoke(cli, ["config", "-o", str(out)])
        assert res.exit_code == 1
        assert "already exists" in res.output
        res = runner.invoke(cli, ["config", "-o", str(out), "--overwrite"])
        assert res.exit_code == 0

    def test_presets_change_weights(self, runner):
        import yaml

        default = runner.invoke(cli, ["config"]).output
        web = runner.invoke(cli, ["config", "--preset", "web"]).output

        def weights(txt):
            body = txt.split("\n\n", 1)[1]
            return yaml.safe_load(body)["scoring"]["weights"]

        assert weights(default)["alpha_t"] == 1.0
        assert weights(web)["alpha_t"] == 0.7
        assert weights(web)["alpha_r"] == 0.3


class TestProcess:
    def test_process_test_mode(self, runner, tmp_path):
        cfg = tmp_path / "cfg.yaml"
        runner.invoke(cli, ["config", "-o", str(cfg)])
        out = tmp_path / "out"
        res = runner.invoke(cli, ["process", str(cfg), str(out)])
        assert res.exit_code == 0, res.output
        assert (out / "documents_batch_0001.jsonl").exists()
        assert (out / "signals_summary.json").exists()
        assert (out / "embeddings.npz").exists()
        assert (out / "metadata.json").exists()
        assert (out / "index").is_dir()  # the dir the reference tests wanted
        meta = json.loads((out / "metadata.json").read_text())
        assert meta["test_mode"] is True
        lines = (out / "documents_batch_0001.jsonl").read_text().splitlines()
        assert len(lines) == 10
        row = json.loads(lines[0])
        assert {"id", "signals", "embedding"} <= set(row)

    def test_process_backup_of_existing(self, runner, tmp_path):
        cfg = tmp_path / "cfg.yaml"
        runner.invoke(cli, ["config", "-o", str(cfg)])
        out = tmp_path / "out"
        runner.invoke(cli, ["process", str(cfg), str(out)])
        res = runner.invoke(cli, ["process", str(cfg), str(out)])
        assert res.exit_code == 0
        backups = list(tmp_path.glob("out_backup_*"))
        assert len(backups) == 1

    def test_process_missing_config_fails(self, runner, tmp_path):
        res = runner.invoke(cli, ["process", str(tmp_path / "nope.yaml"),
                                  str(tmp_path / "o")])
        assert res.exit_code != 0


class TestSearch:
    def test_search_test_mode(self, runner, tmp_path):
        idx = tmp_path / "index"
        idx.mkdir()
        res = runner.invoke(cli, ["search", str(idx), "query text",
                                  "--test-mode", "--k", "3"])
        assert res.exit_code == 0, res.output
        assert "[TEST MODE]" in res.output
        body = res.output.split("[TEST MODE]")[0]
        payload = json.loads(body[body.index("[") : body.rindex("]") + 1])
        assert len(payload) == 3
        assert payload[0]["score"] >= payload[1]["score"]

    def test_search_output_file(self, runner, tmp_path):
        idx = tmp_path / "index"
        idx.mkdir()
        out = tmp_path / "results.json"
        res = runner.invoke(cli, ["search", str(idx), "q", "--test-mode",
                                  "-o", str(out)])
        assert res.exit_code == 0
        data = json.loads(out.read_text())
        assert all({"id", "score", "dewi_score", "entropy"} <= set(r)
                   for r in data)

    def test_search_real_index_with_npy_query(self, runner, tmp_path,
                                              monkeypatch):
        monkeypatch.setenv("DEWI_TEST_MODE", "0")
        from dewi import DewiIndex
        from dewi.types import Payload

        rng = np.random.default_rng(0)
        index = DewiIndex(dim=16)
        for i in range(8):
            index.add(f"d{i}", rng.normal(size=16).astype(np.float32),
                      Payload(dewi=float(i) / 8))
        index.build()
        index.save(tmp_path / "idx")
        q = rng.normal(size=16).astype(np.float32)
        np.save(tmp_path / "q.npy", q)
        res = runner.invoke(
            cli, ["search", str(tmp_path / "idx"), str(tmp_path / "q.npy"),
                  "--k", "3", "--eta", "0.0"],
        )
        assert res.exit_code == 0, res.output
        data = json.loads(
            res.output[res.output.index("[") : res.output.rindex("]") + 1]
        )
        assert len(data) == 3

    def test_help(self, runner):
        for args in ([], ["config", "-h"], ["process", "-h"], ["search", "-h"]):
            res = runner.invoke(cli, args + (["-h"] if not args else []))
            assert res.exit_code == 0


class TestCreateDocument:
    def test_uuid_doc(self):
        d = create_document(text="hello")
        assert len(d.doc_id) == 36  # uuid4
        assert d.text == "hello"
        assert d.metadata == {}


class TestEndToEndRealMode:
    def test_process_real_tiny(self, runner, tmp_path, monkeypatch):
        monkeypatch.setenv("DEWI_TEST_MODE", "0")
        import yaml

        cfg = {
            "text": {"model": "tiny", "batch_size": 2, "max_length": 64},
            "image": {"model": "tiny", "batch_size": 2, "image_size": 32,
                      "patch_size": 8},
            "cross_modal": {"model": "tiny", "batch_size": 2},
            "redundancy": {"block_size": 4},
        }
        cfg_path = tmp_path / "cfg.yaml"
        cfg_path.write_text(yaml.dump(cfg))
        texts = tmp_path / "texts"
        texts.mkdir()
        (texts / "a.txt").write_text("the quick brown fox jumps")
        (texts / "b.txt").write_text("an entirely different document")
        out = tmp_path / "out"
        res = runner.invoke(
            cli, ["process", str(cfg_path), str(out), "--texts", str(texts)]
        )
        assert res.exit_code == 0, res.output
        assert (out / "documents_batch_0001.jsonl").exists()
        assert (out / "index" / "config.json").exists()
        rows = [json.loads(l) for l in
                (out / "documents_batch_0001.jsonl").read_text().splitlines()]
        assert len(rows) == 2
        assert all(0.0 <= r["dewi_score"] <= 1.0 for r in rows)

        # Search the produced index with a text query (tiny CLIP dim=64).
        res = runner.invoke(
            cli, ["search", str(out / "index"), "quick brown fox", "--k", "1"]
        )
        assert res.exit_code == 0, res.output

    def test_process_search_with_trained_checkpoint(self, runner, tmp_path,
                                                    monkeypatch):
        """process -> search round-trip with a non-default (trained) CLIP:
        the index records encoder provenance and search reconstructs the SAME
        encoder (VERDICT round 1 item 2; ADVICE round 1 cli.py finding)."""
        monkeypatch.setenv("DEWI_TEST_MODE", "0")
        import jax
        import yaml

        from dewi.models.registry import (
            clip_config, init_clip, save_params,
        )

        # A "trained" checkpoint: perturbed params, distinct from every
        # seed's default init.
        cfg_clip = clip_config("tiny")
        _, params = init_clip(cfg_clip, seed=7)
        params = jax.tree.map(lambda x: x + 0.05, params)
        ckpt = tmp_path / "clip.msgpack"
        save_params(params, ckpt)

        cfg = {
            "text": {"model": "tiny", "batch_size": 2, "max_length": 64},
            "image": {"model": "tiny", "batch_size": 2, "image_size": 32,
                      "patch_size": 8},
            "cross_modal": {"model": "tiny", "batch_size": 2,
                            "checkpoint": str(ckpt), "seed": 7},
            "redundancy": {"block_size": 4},
        }
        cfg_path = tmp_path / "cfg.yaml"
        cfg_path.write_text(yaml.dump(cfg))
        texts = tmp_path / "texts"
        texts.mkdir()
        (texts / "a.txt").write_text("the quick brown fox jumps")
        (texts / "b.txt").write_text("an entirely different document")
        out = tmp_path / "out"
        res = runner.invoke(
            cli, ["process", str(cfg_path), str(out), "--texts", str(texts)]
        )
        assert res.exit_code == 0, res.output

        prov = json.loads(
            (out / "index" / "config.json").read_text()
        )["encoder"]
        assert prov["model"] == "tiny" and prov["seed"] == 7
        assert prov["checkpoint"] == str(ckpt)
        assert prov["checkpoint_fingerprint"]

        res = runner.invoke(
            cli, ["search", str(out / "index"), "quick brown fox",
                  "--k", "2", "--eta", "0.0", "--entropy-pref", "0.0"],
        )
        assert res.exit_code == 0, res.output
        assert "no encoder provenance" not in res.output

        # CLI ranking must equal encoding the query with the checkpointed
        # pipeline directly (same encoder, same space).
        from dewi.config import DewiConfig
        from dewi.index import DewiIndex
        from dewi.pipelines import DewiPipeline

        pipe = DewiPipeline(DewiConfig.from_dict(cfg))
        index = DewiIndex.load(out / "index")
        expected = index.search(
            pipe.encode_query("quick brown fox"), k=2, eta=0.0,
            entropy_pref=0.0,
        )
        got = json.loads(res.output[res.output.index("["):])
        assert [r["id"] for r in got] == [r[0] for r in expected]

        # A missing checkpoint must fail loudly, not silently mismatch.
        ckpt.unlink()
        res = runner.invoke(
            cli, ["search", str(out / "index"), "quick brown fox"]
        )
        assert res.exit_code != 0
        assert "checkpoint" in res.output


class TestPackImages:
    def test_pack_then_process(self, runner, tmp_path, monkeypatch):
        monkeypatch.setenv("DEWI_TEST_MODE", "0")
        import numpy as np
        import yaml

        PIL = pytest.importorskip("PIL")
        from PIL import Image

        imgs = tmp_path / "imgs"
        imgs.mkdir()
        rng = np.random.default_rng(0)
        for i in range(3):
            arr = rng.integers(0, 256, (48, 48, 3), dtype=np.uint8)
            Image.fromarray(arr).save(imgs / f"{i}.png")
        pack = tmp_path / "corpus.npy"
        res = runner.invoke(
            cli, ["pack-images", str(imgs), str(pack), "--size", "32",
                  "--workers", "0"]
        )
        assert res.exit_code == 0, res.output
        meta = json.loads(next(
            l for l in res.output.strip().splitlines()
            if l.startswith("{")
        ))
        assert meta["n_images"] == 3 and meta["size"] == 32
        assert pack.exists()

        cfg = {
            "text": {"model": "tiny", "batch_size": 2, "max_length": 64},
            "image": {"model": "tiny", "batch_size": 2, "image_size": 32,
                      "patch_size": 8},
            "cross_modal": {"model": "tiny", "batch_size": 2},
            "redundancy": {"block_size": 4},
        }
        cfg_path = tmp_path / "cfg.yaml"
        cfg_path.write_text(yaml.dump(cfg))
        out = tmp_path / "out"
        res = runner.invoke(
            cli, ["process", str(cfg_path), str(out), "--images", str(pack)]
        )
        assert res.exit_code == 0, res.output
        rows = [json.loads(l) for l in
                (out / "documents_batch_0001.jsonl").read_text().splitlines()]
        assert len(rows) == 3
        # Packed rows carried real image signals (hi_mean from the MAE)
        # and real scores.
        assert all(r["signals"]["hi_mean"] != 0.0 for r in rows)
        assert all(0.0 <= r["dewi_score"] <= 1.0 for r in rows)
        # Provenance survives: manifest names each packed row's source.
        assert all("imgs" in r["metadata"]["source"] for r in rows)

    def test_pack_images_empty_dir_fails(self, runner, tmp_path):
        empty = tmp_path / "none"
        empty.mkdir()
        res = runner.invoke(
            cli, ["pack-images", str(empty), str(tmp_path / "o.npy")]
        )
        assert res.exit_code != 0
        assert "No images" in res.output


class TestRuntimeKnobs:
    def test_io_threads_reaches_loader(self, runner, tmp_path, monkeypatch):
        import yaml

        import dewi.cli as climod

        seen = {}
        orig = climod._load_documents

        def spy(*a, **kw):
            seen.update(kw)
            return orig(*a, **kw)

        monkeypatch.setattr(climod, "_load_documents", spy)
        cfg_path = tmp_path / "c.yaml"
        cfg_path.write_text(yaml.dump({"runtime": {"io_threads": 2}}))
        runner.invoke(
            climod.cli,
            ["process", str(cfg_path), str(tmp_path / "o"),
             "--texts", str(cfg_path)],
        )
        assert seen.get("max_workers") == 2

    def test_checkpoint_every_and_profile(self, runner, tmp_path,
                                          monkeypatch):
        """runtime.checkpoint_every forces sharded checkpoints under
        <out>/checkpoints; runtime.profile writes an XLA trace dir."""
        monkeypatch.setenv("DEWI_TEST_MODE", "0")
        import yaml

        cfg = {
            "text": {"model": "tiny", "batch_size": 2, "max_length": 64},
            "image": {"model": "tiny"},
            "cross_modal": {"model": "tiny", "batch_size": 2},
            "redundancy": {"block_size": 4},
            "runtime": {"checkpoint_every": 1, "profile": True},
        }
        cfg_path = tmp_path / "cfg.yaml"
        cfg_path.write_text(yaml.dump(cfg))
        texts = tmp_path / "texts"
        texts.mkdir()
        (texts / "a.txt").write_text("first document text")
        (texts / "b.txt").write_text("second document text")
        out = tmp_path / "out"
        res = runner.invoke(
            cli, ["process", str(cfg_path), str(out), "--texts", str(texts)]
        )
        assert res.exit_code == 0, res.output
        shards = list((out / "checkpoints").glob("shard_*"))
        assert len(shards) == 2  # checkpoint_every=1 -> one shard per doc
        assert (out / "profile").exists()
        assert any((out / "profile").rglob("*"))


class TestEvalCommand:
    def test_eval_real_index(self, runner, tmp_path, monkeypatch):
        monkeypatch.setenv("DEWI_TEST_MODE", "0")
        from dewi import DewiIndex
        from dewi.types import Payload

        rng = np.random.default_rng(0)
        emb = rng.normal(size=(20, 16)).astype(np.float32)
        index = DewiIndex(dim=16)
        for i in range(20):
            index.add(f"d{i}", emb[i], Payload(dewi=float(i) / 20))
        index.build()
        index.save(tmp_path / "idx")

        # Queries = noisy copies of docs 2 and 7.
        q = emb[[2, 7]] + 0.01 * rng.normal(size=(2, 16)).astype(np.float32)
        np.savez(tmp_path / "queries.npz",
                 query_ids=["q0", "q1"], embeddings=q.astype(np.float32))
        (tmp_path / "qrels.json").write_text(
            json.dumps({"q0": ["d2"], "q1": ["d7"]})
        )
        res = runner.invoke(cli, [
            "eval", str(tmp_path / "idx"), str(tmp_path / "queries.npz"),
            str(tmp_path / "qrels.json"), "-o", str(tmp_path / "report.json"),
        ])
        assert res.exit_code == 0, res.output
        report = json.loads((tmp_path / "report.json").read_text())
        assert report["recall@1"] == 1.0
        assert report["mrr"] == 1.0


class TestSampleCommand:
    def test_sample_from_test_mode_output(self, runner, tmp_path):
        cfg = tmp_path / "cfg.yaml"
        runner.invoke(cli, ["config", "-o", str(cfg)])
        out = tmp_path / "out"
        runner.invoke(cli, ["process", str(cfg), str(out)])
        res = runner.invoke(cli, ["sample", str(out), "3",
                                  "--tau", "2.0", "--seed", "1"])
        assert res.exit_code == 0, res.output
        picked = [l for l in res.output.splitlines() if l.startswith("doc_")]
        assert len(picked) == 3
        assert len(set(picked)) == 3

    def test_sample_submodular(self, runner, tmp_path):
        cfg = tmp_path / "cfg.yaml"
        runner.invoke(cli, ["config", "-o", str(cfg)])
        out = tmp_path / "out"
        runner.invoke(cli, ["process", str(cfg), str(out)])
        dst = tmp_path / "picked.txt"
        res = runner.invoke(cli, ["sample", str(out), "2", "--submodular",
                                  "-o", str(dst)])
        assert res.exit_code == 0, res.output
        assert len(dst.read_text().split()) == 2

    def test_sample_missing_summary(self, runner, tmp_path):
        empty = tmp_path / "empty"
        empty.mkdir()
        res = runner.invoke(cli, ["sample", str(empty), "2"])
        assert res.exit_code != 0


class TestImagesEndToEnd:
    def test_process_with_images_dir(self, runner, tmp_path, monkeypatch):
        monkeypatch.setenv("DEWI_TEST_MODE", "0")
        pytest.importorskip("PIL")
        import yaml
        from PIL import Image

        cfg_path = tmp_path / "cfg.yaml"
        cfg_path.write_text(yaml.dump({
            "text": {"model": "tiny", "batch_size": 2, "max_length": 64},
            "image": {"model": "tiny", "batch_size": 2, "image_size": 32,
                      "patch_size": 8},
            "cross_modal": {"model": "tiny", "batch_size": 2},
            "redundancy": {"block_size": 4},
        }))
        imgs = tmp_path / "imgs"
        imgs.mkdir()
        rng = np.random.default_rng(0)
        for i in range(3):
            arr = (rng.random((32, 32, 3)) * 255).astype("uint8")
            Image.fromarray(arr).save(imgs / f"im{i}.png")
        texts = tmp_path / "texts"
        texts.mkdir()
        (texts / "t.txt").write_text("one text document")
        out = tmp_path / "out"
        res = runner.invoke(cli, ["process", str(cfg_path), str(out),
                                  "--texts", str(texts),
                                  "--images", str(imgs)])
        assert res.exit_code == 0, res.output
        rows = [json.loads(l) for l in
                (out / "documents_batch_0001.jsonl").read_text().splitlines()]
        assert len(rows) == 4
        # Image docs got image-entropy signals; the text doc did not.
        img_rows = [r for r in rows
                    if r["metadata"].get("type") == "image"]
        assert len(img_rows) == 3
        assert all(r["signals"]["hi_mean"] > 0 for r in img_rows)
        assert all(0.0 <= r["dewi_score"] <= 1.0 for r in rows)


class TestEmbeddingsLoader:
    def test_process_with_precomputed_embeddings(self, runner, tmp_path,
                                                 monkeypatch):
        monkeypatch.setenv("DEWI_TEST_MODE", "0")
        import yaml

        cfg_path = tmp_path / "cfg.yaml"
        cfg_path.write_text(yaml.dump({
            "text": {"model": "tiny", "batch_size": 2, "max_length": 64},
            "cross_modal": {"model": "tiny", "batch_size": 2},
            "redundancy": {"block_size": 4},
        }))
        rng = np.random.default_rng(0)
        emb = rng.normal(size=(5, 24)).astype(np.float32)
        emb[3] = emb[1]  # planted near-dup pair
        np.savez(tmp_path / "emb.npz",
                 doc_ids=[f"e{i}" for i in range(5)], embeddings=emb)
        out = tmp_path / "out"
        res = runner.invoke(cli, ["process", str(cfg_path), str(out),
                                  "--embeddings", str(tmp_path / "emb.npz")])
        assert res.exit_code == 0, res.output
        rows = [json.loads(l) for l in
                (out / "documents_batch_0001.jsonl").read_text().splitlines()]
        assert len(rows) == 5
        # The duplicate embedding pair must show maximal redundancy.
        by_src = {r["metadata"]["source"]: r for r in rows}
        assert by_src["e1"]["signals"]["redundancy"] == pytest.approx(1.0, abs=1e-3)
        assert by_src["e3"]["signals"]["redundancy"] == pytest.approx(1.0, abs=1e-3)
