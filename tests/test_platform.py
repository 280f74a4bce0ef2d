"""The tutorial CLIs' ``--platform``: cpu or gpu, float64 on both, and gpu
refused where JAX finds no GPU."""

import jax
import pytest

from gogp.tutorial import barebones, bayes, classify
from gogp.tutorial import io as tio

CLIS = {
    "evaluate": lambda p: barebones.main(["--platform", p, "selfcheck"]),
    "classify": lambda p: classify.main(["--platform", p, "selfcheck"]),
    "bayes": lambda p: bayes.main(["barebones", "--platform", p, "selfcheck"]),
}


def test_platform_choices():
    assert tio.PLATFORMS == ("cpu", "gpu")


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_gpu_refused_without_gpu(cli):
    with pytest.raises(SystemExit) as e:
        CLIS[cli]("gpu")
    assert "no GPU" in str(e.value.code)


@pytest.mark.parametrize("cli", sorted(CLIS))
@pytest.mark.parametrize("platform", ["rocm", "default"])
def test_other_platforms_rejected(cli, platform):
    with pytest.raises(SystemExit) as e:
        CLIS[cli](platform)
    assert e.value.code == 2  # argparse usage error


def test_select_platform_cpu_turns_on_x64(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    tio.select_platform("cpu")
    assert ("jax_enable_x64", True) in calls
    assert ("jax_platforms", "cpu") in calls


def test_select_platform_rejects_unknown():
    with pytest.raises(ValueError):
        tio.select_platform("rocm")
