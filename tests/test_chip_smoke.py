"""chip_smoke.py off the card: its refusal without a GPU, the compile-cache
rule, nvidia-smi parsing, every phase's comparison at tiny sizes on the CPU,
the last-line format, and the four-device phases on virtual CPU devices."""

import json
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest

import chip_smoke as cs
from gogp.utils import compile_cache, device

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _run(args, env_extra=None, timeout=300):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", **(env_extra or {})}
    return subprocess.run(
        [sys.executable, *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=timeout,
    )


@pytest.mark.parametrize("extra", [[], ["--multi"]], ids=["one", "multi"])
def test_refuses_without_gpu(extra):
    out = _run(["chip_smoke.py", *extra])
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_require_gpu_raises_on_cpu():
    with pytest.raises(SystemExit):
        device.require_gpu(1, "test")


@pytest.mark.parametrize(
    "text, want",
    [
        ("NVIDIA H100 80GB HBM3, 700.00 W\n", [("NVIDIA H100 80GB HBM3", "700.00 W")]),
        ("NVIDIA H100 80GB HBM3, 400.00 W\n" * 4, [("NVIDIA H100 80GB HBM3", "400.00 W")] * 4),
        ("\n  A, B, 1 W  \n\n", [("A, B", "1 W")]),
    ],
    ids=["one", "four", "comma-in-name"],
)
def test_parse_smi(text, want):
    assert device.parse_smi(text) == want


def test_parse_smi_rejects_garbage():
    with pytest.raises(ValueError):
        device.parse_smi("no comma here\n")


def test_query_cards_without_nvidia_smi(monkeypatch):
    monkeypatch.setattr(device, "SMI_QUERY", ["/nonexistent/nvidia-smi"])
    cards, why = device.query_cards()
    assert cards == [] and "nvidia-smi" in why


def test_compile_cache_honours_env(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert compile_cache.enable_compile_cache() == "/some/where"
    assert calls == []  # nothing set in code


def test_compile_cache_defaults_to_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == str(ROOT / ".jax_cache")
    assert ("jax_compilation_cache_dir", path) in calls
    # a fixed path: the same on every call
    assert compile_cache.enable_compile_cache() == path


def test_ok_line_format():
    d = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = cs.ok_line(d, 1)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True, "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    }


def test_f64_ops_counts_arrays_not_scalars():
    x = jnp.ones(3, jnp.float32)
    assert cs.f64_ops(lambda v: v.astype(jnp.float64) * 2, x)[0] > 0
    assert cs.f64_ops(lambda v: v * jnp.log(2.0), x)[0] == 0


@pytest.mark.parametrize("n", [64, 200])
def test_phase_lml(n):
    assert cs.phase_lml(n, 0, "cpu", reps=1)["ok"]


def test_phase_train():
    r = cs.phase_train(64, 0, "cpu", steps=5)
    assert r["ok"] and r["steps"] == 5


def test_phase_sampling():
    rows = cs.phase_sampling(0, "cpu", chains=8, warmup=20, samples=4,
                             nuts_warmup=5, nuts_samples=3)
    assert [r["ok"] for r in rows] == [True, True]


def test_phase_serving():
    assert cs.phase_serving(96, 16, 0, "cpu")["ok"]


def test_phase_cli():
    assert cs.phase_cli("cpu", "cpu")["ok"]


def test_phase_fails_outside_tolerance(monkeypatch):
    monkeypatch.setitem(cs.TOL, "serve", (0.0, "forced"))
    assert not cs.phase_serving(32, 8, 0, "cpu")["ok"]


_MULTI = """
import jax
jax.config.update("jax_enable_x64", True)
import chip_smoke as cs
devs = jax.devices()[:4]
rows = cs.phase_sharded_chains(devs, 0, "cpu4", chains=8, warmup=16, samples=4,
                               nuts_chains=8, nuts_warmup=8, nuts_samples=4)
rows += cs.phase_sharded_lml(devs, 128, 0, "cpu4", block=16)
print("ALL_OK" if all(r["ok"] for r in rows) and len(rows) == 5 else "FAILED")
"""


def test_multi_phases_on_four_virtual_devices():
    out = _run(["-c", _MULTI],
               {"XLA_FLAGS": "--xla_force_host_platform_device_count=4"}, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "ALL_OK", out.stdout[-2000:]
