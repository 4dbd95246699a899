"""The port stands apart from JAX, and chip_smoke.py, chip_profile.py and
chip_trials.py refuse to run without a card (the card's machine has no
JAX; a script must never report a result it did not measure there)."""
import os
import shutil
import subprocess
import sys

import pytest
import torch

import bench
import chip_smoke
from tests.conftest import REPO_ROOT, TINY_CONFIG

_IMPORT_ALL = """
import importlib, pkgutil, sys
import eamm_tpu_torch
for mod in pkgutil.walk_packages(eamm_tpu_torch.__path__, "eamm_tpu_torch."):
    importlib.import_module(mod.name)
import chip_profile, chip_smoke, chip_trials
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "eamm_tpu")
             or m.startswith(("jax.", "flax.", "eamm_tpu.")))
missing = sorted(set(sys.argv[1:]) - set(sys.modules))
print(bad, missing)
sys.exit(1 if bad or missing else 0)
"""
# the entry points and what they read: the walk above must import each
ENTRY_MODULES = ["eamm_tpu_torch.serve", "eamm_tpu_torch.serve_http",
                 "eamm_tpu_torch.cli.serve", "eamm_tpu_torch.cli.demo",
                 "eamm_tpu_torch.compat", "eamm_tpu_torch.compat.preflight",
                 "eamm_tpu_torch.config", "eamm_tpu_torch.data.native",
                 "eamm_tpu_torch.data.augmentation",
                 "eamm_tpu_torch.data.landmarks",
                 "eamm_tpu_torch.data.preprocess",
                 "eamm_tpu_torch.ops.subpixel", "eamm_tpu_torch.infer.export",
                 "eamm_tpu_torch.cli.export",
                 # training (part1)
                 "eamm_tpu_torch.cli.run", "eamm_tpu_torch.train.steps",
                 "eamm_tpu_torch.train.loop", "eamm_tpu_torch.train.losses",
                 "eamm_tpu_torch.train.optim",
                 "eamm_tpu_torch.train.checkpoint",
                 "eamm_tpu_torch.train.logging",
                 "eamm_tpu_torch.train.tbevents",
                 "eamm_tpu_torch.models.vgg",
                 "eamm_tpu_torch.models.discriminator",
                 "eamm_tpu_torch.ops.augment",
                 "eamm_tpu_torch.data.datasets",
                 "eamm_tpu_torch.data.packed",
                 # part2 and the evaluation modes
                 "eamm_tpu_torch.ops.tps", "eamm_tpu_torch.ops.warp",
                 "eamm_tpu_torch.train.visualizer",
                 "eamm_tpu_torch.utils.metrics",
                 "eamm_tpu_torch.infer.animate",
                 # the gan A2FD, the image and auxiliary networks, the
                 # preprocessing host side
                 "eamm_tpu_torch.models.stylegan2",
                 "eamm_tpu_torch.models.aux", "eamm_tpu_torch.ops.adain",
                 "eamm_tpu_torch.data.pose",
                 "eamm_tpu_torch.utils.profiling",
                 "eamm_tpu_torch.cli.preprocess",
                 # the mesh
                 "eamm_tpu_torch.parallel", "eamm_tpu_torch.parallel.mesh"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs in several
    workers at once, and a torch per worker spinning a thread per core
    slows every worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cpu_vs_cpu():
    """Phase 4 with both sides on the CPU, neutral and emotional renders
    from one pair of pipelines."""
    return chip_smoke.cpu_vs_device("cpu")


def _run(args, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    r = _run(["-c", _IMPORT_ALL, *ENTRY_MODULES], REPO_ROOT)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("script", ["chip_smoke.py", "chip_profile.py"])
def test_chip_scripts_fail_without_a_card(script):
    r = _run([script], REPO_ROOT)
    assert r.returncode != 0
    assert r.stdout == ""


def test_chip_trials_fail_without_a_card():
    r = _run(["chip_trials.py", "k6", "k2b"], REPO_ROOT)
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


def test_chip_smoke_train_params_are_the_yamls():
    """Phase 8's training parameters are configs/train_part1*.yaml's and
    phase 9's configs/train_part2.yaml's train_params and augmentation
    (the card's machine may lack PyYAML), and its model widths the
    YAMLs'."""
    from eamm_tpu_torch.config import load_config
    for mode, params in {**chip_smoke.TRAIN_PARAMS,
                         "train_part2": chip_smoke.PART2_PARAMS}.items():
        config = load_config(os.path.join(REPO_ROOT, "configs",
                                          f"{mode}.yaml"))
        assert params == config["train_params"], mode
        assert chip_smoke.FULL_CONFIG["model_params"] == \
            config["model_params"], mode
    assert chip_smoke.PART2_AUGMENTATION == config["dataset_params"][
        "augmentation_params"]


def test_chip_smoke_cpu_vs_device_on_cpu(cpu_vs_cpu):
    """Phase 4 at TINY widths with both sides on the CPU: identical."""
    result = cpu_vs_cpu["neutral"]
    assert not result["emotion"] and result["frames"] == 24
    assert result["l1_max"] == 0.0


def test_chip_smoke_emotional_cpu_vs_device_on_cpu(cpu_vs_cpu):
    """Phase 4's emotional render with both sides on the CPU: identical."""
    result = cpu_vs_cpu["emotional"]
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

