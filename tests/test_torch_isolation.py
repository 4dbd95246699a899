"""The port stands apart from JAX, and chip_smoke.py, chip_profile.py and
chip_trials.py refuse to run without a card (the card's machine has no
JAX; a script must never report a result it did not measure there); and
no port test file queues ahead of the suite's longest file."""
import collections
import os
import shutil
import subprocess
import sys

import pytest
import torch

import chip_smoke
from tests.conftest import REPO_ROOT

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


def test_kernel_sources_are_shipped():
    from eamm_tpu_torch import kernels
    for name in kernels.SOURCES:
        assert (kernels.CSRC / f"{name}.cu").is_file()
    for _, _, source, replaces in chip_smoke.KERNELS.values():
        assert os.path.isfile(os.path.join(REPO_ROOT, source))
        path, line = replaces.split(":")
        with open(os.path.join(REPO_ROOT, path)) as f:
            assert "def " in f.readlines()[int(line) - 1]


def test_no_port_file_queues_ahead_of_the_longest(request):
    """xdist's ``--dist loadfile`` hands out the files with the most
    collected tests first, and tests/test_train_loop.py, the suite's
    longest file, must start early: no tests/test_torch_*.py may collect
    as many tests as it does (10 when it is not collected), parametrized
    cases included."""
    counts = collections.Counter(item.path.name
                                 for item in request.session.items)
    limit = counts.get("test_train_loop.py", 10)
    over = {name: n for name, n in counts.items()
            if name.startswith("test_torch_") and n >= limit}
    assert not over, f"{over}: split these files below {limit} tests"
