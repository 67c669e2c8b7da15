"""Config system tests (parity targets: reference config.py:96-155, cli.py:66-89)."""

import pytest

from dewi.config import (
    DewiConfig,
    PRESETS,
    apply_preset,
    get_default_config,
)


def test_defaults():
    cfg = DewiConfig()
    assert cfg.scoring.delta == 3.0
    assert cfg.scoring.mode == "standard"
    assert cfg.scoring.weights.alpha_t == 1.0
    assert cfg.index.metric == "cosine"
    assert cfg.index.rerank_eta == 0.25
    assert cfg.eval.recall_k == [1, 5, 10]
    assert cfg.training_sampling.tau == 1.0
    assert cfg.mesh.model == 1


def test_dict_roundtrip():
    cfg = DewiConfig()
    cfg.scoring.weights.alpha_r = 0.37
    cfg.index.nprobe = 7
    d = cfg.to_dict()
    again = DewiConfig.from_dict(d)
    assert again.scoring.weights.alpha_r == 0.37
    assert again.index.nprobe == 7
    assert again.to_dict() == d


def test_yaml_roundtrip(tmp_path):
    cfg = get_default_config()
    cfg.text.batch_size = 17
    path = tmp_path / "c.yaml"
    cfg.to_yaml(path)
    loaded = DewiConfig.from_yaml(path)
    assert loaded.text.batch_size == 17
    assert loaded.to_dict() == cfg.to_dict()


def test_unknown_keys_filtered():
    cfg = DewiConfig.from_dict(
        {"scoring": {"delta": 1.5, "bogus": 1}, "nonsense_section": {"x": 2}}
    )
    assert cfg.scoring.delta == 1.5


def test_partial_dict_uses_defaults():
    cfg = DewiConfig.from_dict({"index": {"nlist": 99}})
    assert cfg.index.nlist == 99
    assert cfg.index.metric == "cosine"
    assert cfg.scoring.delta == 3.0


def test_ivf_probe_dials_reach_backend():
    """index.probe_dtype flows from config to the IVF backend; a config
    that still names the retired probe_impl switch loads (unknown keys
    are filtered)."""
    from dewi.pipelines import DewiPipeline

    cfg = DewiConfig.from_dict(
        {"index": {"ann": "ivf", "probe_dtype": "bfloat16",
                   "probe_impl": "gather", "nlist": 8, "nprobe": 2}}
    )
    assert cfg.index.probe_dtype == "bfloat16"
    assert not hasattr(cfg.index, "probe_impl")
    ix = DewiPipeline(cfg)._make_index(dim=16)
    assert ix._backend.probe_dtype == "bfloat16"

    # "auto" (the default) passes through; it resolves to the store's
    # embedding dtype at build time (see tests/test_ivf_probe.py).
    cfg = DewiConfig.from_dict({"index": {"ann": "ivf"}})
    assert cfg.index.probe_dtype == "auto"
    assert DewiPipeline(cfg)._make_index(dim=16)._backend.probe_dtype == \
        "auto"

    # Quantized: int8_queries flows through too.
    cfg = DewiConfig.from_dict(
        {"index": {"ann": "quantized", "int8_queries": True}}
    )
    assert DewiPipeline(cfg)._make_index(dim=16)._backend.int8_queries is True


def test_presets():
    expectations = {
        "web": (0.7, 0.3),
        "product": (0.6, 0.4),
        "balanced": (0.5, 0.5),
        "default": (1.0, 1.0),
    }
    for preset, (at, ar) in expectations.items():
        cfg = apply_preset(get_default_config(), preset)
        assert cfg.scoring.weights.alpha_t == at
        assert cfg.scoring.weights.alpha_r == ar
    with pytest.raises(ValueError):
        apply_preset(get_default_config(), "nope")
    assert set(expectations) == set(PRESETS)


def test_default_config_is_deep_copied():
    a = get_default_config()
    a.scoring.delta = 99.0
    assert get_default_config().scoring.delta == 3.0


def test_nested_weights_from_dict():
    cfg = DewiConfig.from_dict({"scoring": {"weights": {"alpha_n": 0.2}}})
    assert cfg.scoring.weights.alpha_n == 0.2
    assert cfg.scoring.weights.alpha_t == 1.0


def test_lazy_package_root():
    """Package root resolves exports lazily (reference README.md:16 lazy
    loading) — importing dewi must not import any submodule."""
    import subprocess
    import sys

    code = (
        "import sys; import dewi; "
        "eager = [m for m in sys.modules if m.startswith('dewi.')]; "
        "assert not eager, eager; "
        "from dewi import Payload; "
        "assert Payload().dewi == 0.0; print('ok')"
    )
    out = subprocess.run([sys.executable, "-c", code],
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert "ok" in out.stdout
