"""chip_smoke.py's settings and its phase 4 on the CPU: its configs are
the repo's and its training parameters the YAMLs', and its CPU-against-
device render, with both sides on the CPU, is identical."""
import os

import pytest

import bench
import chip_smoke
from tests.conftest import REPO_ROOT, TINY_CONFIG
from tests.test_torch_isolation import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def cpu_vs_cpu():
    """Phase 4 with both sides on the CPU, neutral and emotional renders
    from one pair of pipelines."""
    return chip_smoke.cpu_vs_device("cpu")


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
