"""Runtime helper tests: device summary, batch sharding, default mesh."""

from pathlib import Path

import jax
import numpy as np
import pytest

from dewi.parallel import (
    DATA_AXIS,
    default_mesh,
    device_summary,
    initialize_runtime,
    make_mesh,
    shard_batch,
)


class TestRuntime:
    def test_initialize_noop_single_process(self):
        initialize_runtime()  # must not raise single-process
        initialize_runtime()  # idempotent

    def test_initialize_failure_raises(self, monkeypatch):
        import dewi.parallel.runtime as rt

        def fail(**kwargs):
            raise RuntimeError("no coordinator")

        monkeypatch.setattr(rt, "_initialized", False)
        monkeypatch.setattr(jax.distributed, "initialize", fail)
        with pytest.raises(RuntimeError, match="no coordinator"):
            initialize_runtime("localhost:1", num_processes=2, process_id=0)
        assert rt._initialized is False

    def test_device_summary_fields(self):
        s = device_summary()
        assert s["n_devices"] == 8  # virtual CPU mesh from conftest
        assert s["process_count"] == 1
        assert s["platform"] == "cpu"

    def test_default_mesh_all_devices(self):
        mesh = default_mesh()
        assert mesh.shape[DATA_AXIS] == 8

    def test_shard_batch_pads_and_reports_length(self):
        mesh = make_mesh(n_data=4, n_model=2)
        x = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
        arr, n = shard_batch(x, mesh)
        assert n == 10
        assert arr.shape == (12, 3)  # padded to multiple of 4
        np.testing.assert_array_equal(np.asarray(arr)[:10], x)
        np.testing.assert_array_equal(np.asarray(arr)[10:], 0)

    def test_shard_batch_exact_multiple(self):
        mesh = make_mesh(n_data=8, n_model=1)
        x = np.ones((16, 4), np.float32)
        arr, n = shard_batch(x, mesh)
        assert arr.shape == (16, 4) and n == 16
        # Sharded over the data axis: 8 addressable shards of 2 rows.
        assert len(arr.addressable_shards) == 8
        assert arr.addressable_shards[0].data.shape == (2, 4)

    def test_sharded_compute_matches_host(self):
        mesh = make_mesh(n_data=8, n_model=1)
        x = np.random.default_rng(0).normal(size=(32, 16)).astype(np.float32)
        arr, n = shard_batch(x, mesh)
        out = np.asarray(jax.jit(lambda a: (a * 2).sum(axis=1))(arr))
        np.testing.assert_allclose(out[:n], (x * 2).sum(axis=1),
                                   rtol=1e-4, atol=1e-5)


class TestCompilationCache:
    @staticmethod
    def _record_config(monkeypatch):
        # Record jax.config updates instead of applying them: a real cache
        # directory would outlive this test in the worker process.
        calls = {}
        monkeypatch.setattr(jax.config, "update",
                            lambda k, v: calls.__setitem__(k, v))
        return calls

    def test_enable_idempotent(self, monkeypatch):
        import dewi.utils.compile_cache as cc

        monkeypatch.setattr(cc, "_enabled_dir", None)
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        calls = self._record_config(monkeypatch)
        d1 = cc.enable_compilation_cache()
        # No env: the fixed, git-ignored directory inside the checkout.
        assert d1 == str(cc.CACHE_DIR)
        assert cc.CACHE_DIR.parent == Path(cc.__file__).resolve().parents[2]
        assert calls["jax_compilation_cache_dir"] == d1
        # Second call is a no-op returning the same dir.
        calls.clear()
        assert cc.enable_compilation_cache() == d1
        assert calls == {}

    def test_env_dir_sets_no_directory(self, tmp_path, monkeypatch):
        import dewi.utils.compile_cache as cc

        monkeypatch.setattr(cc, "_enabled_dir", None)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        calls = self._record_config(monkeypatch)
        assert cc.enable_compilation_cache() == str(tmp_path)
        assert "jax_compilation_cache_dir" not in calls

    def test_disable_via_env(self, monkeypatch):
        import dewi.utils.compile_cache as cc

        monkeypatch.setattr(cc, "_enabled_dir", None)
        monkeypatch.setenv("DEWI_COMPILE_CACHE", "0")
        assert cc.enable_compilation_cache() is None
