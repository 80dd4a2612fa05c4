"""CPU checks of ``chip_smoke.py``'s own logic and the compile-cache rule.

The smoke run itself needs a GPU; what it decides before and around the
device (refusing the CPU, the parity comparison, the result line) and the
compile-cache directory it shares with ``bench.py`` are checked here.
"""

import json
import os
import types

import jax
import numpy as np
import pytest

import chip_smoke
from fcvm_tpu import config as cfgmod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fake_devices(platform, n, kind="NVIDIA H100 80GB HBM3"):
    return [types.SimpleNamespace(platform=platform, device_kind=kind)
            for _ in range(n)]


def test_main_refuses_cpu_backend(capsys):
    """No GPU: nonzero exit before any phase, and no result line."""
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    out = capsys.readouterr().out
    assert '"ok"' not in out and '"phase"' not in out


def test_require_gpu_counts_devices():
    gpus = _fake_devices("gpu", 1)
    assert chip_smoke.require_gpu(gpus) is gpus
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu(gpus, count=4)
    assert exc.value.code not in (0, None)
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu([])


def test_last_line_has_exactly_ok_and_device():
    line = json.loads(json.dumps(chip_smoke.last_line(_fake_devices("gpu", 4))))
    assert set(line) == {"ok", "device"}
    assert line["ok"] is True
    assert line["device"] == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4,
    }


def test_matched_size_parity_helper_on_tiny_plate():
    """The CG tier in f32 against the scipy direct tier in f64, through the
    same helper and tolerance the smoke run applies on the card."""
    from bench import build_plate

    _, model = build_plate((4, 2, 2))
    prev_x64 = jax.config.read("jax_enable_x64")
    out = chip_smoke.lbd_parity(model, chip_smoke.plate_params(),
                                jax.devices("cpu")[0])
    assert jax.config.read("jax_enable_x64") == prev_x64
    assert out["steps"] == out["steps_ref"] >= 2
    assert out["max_dlbd"] <= chip_smoke.LBD_TOL == out["dlbd_tol"]
    assert out["ok"]
    assert np.all(np.diff(out["lbd_ref"]) > 0.0)


def test_compile_cache_honours_env_var(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: used as is, nothing set in code."""
    monkeypatch.delenv("FCVM_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cfgmod.enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_checkout_dir(monkeypatch):
    """Unset: the fixed, gitignored ``.jax_cache/`` at the checkout root."""
    monkeypatch.delenv("FCVM_NO_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_entry_size_bytes",
             "jax_persistent_cache_min_compile_time_secs")
    prev = {n: getattr(jax.config, n) for n in names}
    try:
        first = cfgmod.enable_compilation_cache()
        assert first == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == first
        assert cfgmod.enable_compilation_cache() == first
    finally:
        for n, v in prev.items():
            jax.config.update(n, v)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
