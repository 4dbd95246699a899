"""What the port's pipeline starts from, on the CPU: its head-pose
preparation bit for bit the JAX pipeline's, and its random weights drawn
from the seed."""
import numpy as np
import pytest
import torch

from eamm_tpu.infer.pipeline import prepare_pose_np as jax_prepare_pose_np
from eamm_tpu_torch.infer import EammPipeline, PipelineOptions, prepare_pose_np
from tests.conftest import TINY_CONFIG
from tests.test_torch_pipeline import OPTS, one_thread  # noqa: F401


@pytest.mark.parametrize("frames,T,smooth", [(1, 30, True), (5, 30, True),
                                             (40, 30, False), (40, 12, True)])
def test_prepare_pose_matches_jax(frames, T, smooth):
    pose = np.random.RandomState(frames).randn(frames, 7).astype(np.float32)
    np.testing.assert_array_equal(prepare_pose_np(pose, T, smooth),
                                  jax_prepare_pose_np(pose, T, smooth))


def test_from_random_is_seeded():
    a = EammPipeline.from_random(TINY_CONFIG, 3, PipelineOptions(**OPTS))
    b = EammPipeline.from_random(TINY_CONFIG, 3, PipelineOptions(**OPTS))
    c = EammPipeline.from_random(TINY_CONFIG, 4, PipelineOptions(**OPTS))
    for name in a.models:
        sa, sb, sc = (p.models[name].state_dict() for p in (a, b, c))
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
        assert not all(torch.equal(sa[k], sc[k]) for k in sa)
