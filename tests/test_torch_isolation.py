"""The port stands apart from JAX, and chip_smoke.py and chip_profile.py
refuse to run without a card (the card's machine has no JAX; a script must
never report a result it did not measure there)."""
import os
import shutil
import subprocess
import sys

import pytest

import bench
import chip_smoke
from tests.conftest import REPO_ROOT, TINY_CONFIG

_IMPORT_ALL = """
import importlib, pkgutil, sys
import eamm_tpu_torch
for mod in pkgutil.walk_packages(eamm_tpu_torch.__path__, "eamm_tpu_torch."):
    importlib.import_module(mod.name)
import chip_profile, chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "eamm_tpu")
             or m.startswith(("jax.", "flax.", "eamm_tpu.")))
print(bad)
sys.exit(1 if bad else 0)
"""


def _run(args, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    r = _run(["-c", _IMPORT_ALL], REPO_ROOT)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("script", ["chip_smoke.py", "chip_profile.py"])
def test_chip_scripts_fail_without_a_card(script):
    r = _run([script], REPO_ROOT)
    assert r.returncode != 0
    assert r.stdout == ""


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO_ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_configs_are_the_repos():
    assert chip_smoke.TINY_CONFIG == TINY_CONFIG
    assert chip_smoke.FULL_CONFIG == bench.FULL_CONFIG


def test_chip_smoke_cpu_vs_device_on_cpu():
    """Phase 4 at TINY widths with both sides on the CPU: identical."""
    result = chip_smoke.cpu_vs_device("cpu")
    assert result["frames"] == 24
    assert result["l1_max"] == 0.0


def test_chip_smoke_emotional_cpu_vs_device_on_cpu():
    """Phase 4's emotional render with both sides on the CPU: identical."""
    result = chip_smoke.cpu_vs_device("cpu", emotion=True)
    assert result["emotion"] and result["frames"] == 24
    assert result["l1_max"] == 0.0


def test_kernel_sources_are_shipped():
    from eamm_tpu_torch import kernels
    for name in kernels.SOURCES:
        assert (kernels.CSRC / f"{name}.cu").is_file()
    for _, _, source, replaces in chip_smoke.KERNELS.values():
        assert os.path.isfile(os.path.join(REPO_ROOT, source))
        path, line = replaces.split(":")
        with open(os.path.join(REPO_ROOT, path)) as f:
            assert "def " in f.readlines()[int(line) - 1]

