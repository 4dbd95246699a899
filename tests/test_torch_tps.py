"""The reflection-padded warp, the TPS transform and the equivariance
losses of the port against ``eamm_tpu`` (CPU).

``grid_sample(padding_mode='reflection')`` is held to JAX's within 1e-6
on grids several image spans outside [-1, 1] and on an empty span (a
one-pixel axis), with both ``align_corners``.  TPS parameters cannot come
from the same generator in both packages (a torch Generator against a
PRNG key), so JAX draws them and both packages take the same
``TpsParams``: ``warp_coordinates``, ``transform_frame`` and
``warp_jacobian`` (analytic here, ``jax.jacfwd`` there) within 1e-5, and
the equivariance losses with the same detector within 1e-5.
"""
import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from eamm_tpu import compat
from eamm_tpu import config as jax_cfg
from eamm_tpu.ops import tps as jax_tps
from eamm_tpu.ops import warp as jax_warp
from eamm_tpu.train import steps as JS
from eamm_tpu_torch import config as cfg
from eamm_tpu_torch.ops import tps
from eamm_tpu_torch.ops import warp
from eamm_tpu_torch.train.steps import equivariance_losses
from tests.conftest import TINY_CONFIG

TOL = 1e-5
TRANSFORM = {"sigma_affine": 0.05, "sigma_tps": 0.005, "points_tps": 5}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs in several
    workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _params(batch: int, seed: int = 0, **overrides):
    """JAX's draw and the same numbers as the port's TpsParams."""
    spec = {**TRANSFORM, **overrides}
    p = jax_tps.sample_tps(jax.random.PRNGKey(seed), batch,
                           spec["sigma_affine"], spec["sigma_tps"],
                           spec["points_tps"])
    return p, tps.TpsParams(*(_t(np.array(a)) for a in p))


@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_reflection(align_corners):
    """Coordinates up to seven spans outside the image, and a one-pixel
    axis (an empty span, every coordinate reflected to 0)."""
    rng = np.random.RandomState(3)
    for shape in ((2, 9, 7, 5), (1, 1, 6, 3)):
        img = rng.randn(*shape).astype(np.float32)
        g = rng.uniform(-7.5, 7.5, (shape[0], 11, 13, 2)).astype(np.float32)
        g[:, 0, :4] = [[-1, -1], [1, 1], [-3, 3], [5, -5]]   # on the edges
        ours = warp.grid_sample(_t(img), _t(g), padding_mode="reflection",
                                align_corners=align_corners)
        ref = jax_warp.grid_sample(jnp.asarray(img), jnp.asarray(g),
                                   padding_mode="reflection",
                                   align_corners=align_corners)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6,
                                   rtol=1e-6)


def test_tps_warp_frame_and_jacobian():
    """warp_coordinates and warp_jacobian on JAX's draw at a sigma_tps
    (0.5) large enough that the TPS term is not negligible;
    transform_frame at 0.05, where the warped coordinates stay within
    about two spans (at 0.5 they reach +-20, where the two packages'
    float32 sums of 25 radial terms part by a few spacings, ~1e-4 of a
    pixel)."""
    jp, tp = _params(2, seed=1, sigma_tps=0.5)
    rng = np.random.RandomState(4)
    coords = rng.uniform(-1.1, 1.1, (2, 17, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tps.warp_coordinates(tp, _t(coords)).numpy(),
        np.asarray(jax.jit(jax_tps.warp_coordinates)(jp, coords)),
        atol=TOL, rtol=TOL)
    np.testing.assert_allclose(
        tps.warp_jacobian(tp, _t(coords)).numpy(),
        np.asarray(jax.jit(jax_tps.warp_jacobian)(jp, coords)),
        atol=TOL, rtol=TOL)
    frames = rng.rand(2, 32, 24, 3).astype(np.float32)
    jp, tp = _params(2, seed=2, sigma_tps=0.05)
    np.testing.assert_allclose(
        tps.transform_frame(tp, _t(frames)).numpy(),
        np.asarray(jax.jit(jax_tps.transform_frame)(jp, frames)),
        atol=TOL, rtol=TOL)
    drawn = tps.sample_tps(3, 0.05, 0.005, 5, torch.Generator().manual_seed(0))
    assert drawn.theta.shape == (3, 2, 3)
    assert drawn.control_points.shape == (25, 2)
    assert drawn.control_params.shape == (3, 1, 25)


def test_equivariance_losses_match_jax():
    """Both terms with a TINY detector (Jacobian head randomized), its
    batch statistics, on JAX's draw of the warp."""
    config = copy.deepcopy(TINY_CONFIG)
    torch.manual_seed(0)
    detector = cfg.build_kp_detector(config)
    with torch.no_grad():
        detector.jacobian.weight.normal_(0.0, 0.05)
    variables = compat.convert_kp_detector(
        {k: v.numpy() for k, v in detector.state_dict().items()})
    model = jax_cfg.build_kp_detector(config)
    rng = np.random.RandomState(5)
    frames = rng.rand(2, 64, 64, 3).astype(np.float32)
    kp_driving = {"value": rng.uniform(-0.8, 0.8, (2, 10, 2))
                  .astype(np.float32),
                  "jacobian": (np.eye(2) + 0.1 * rng.randn(2, 10, 2, 2))
                  .astype(np.float32)}
    key = jax.random.PRNGKey(6)
    ref = jax.jit(lambda v, f, kp, k: JS.equivariance_losses(
        {"kp_detector": model}, v["params"], v["batch_stats"], f, kp, k,
        TRANSFORM, 10.0, 10.0))(variables, frames, kp_driving, key)
    # the draw equivariance_losses makes inside from the same key
    jp = jax_tps.sample_tps(key, 2, TRANSFORM["sigma_affine"],
                            TRANSFORM["sigma_tps"], TRANSFORM["points_tps"])
    tp = tps.TpsParams(*(_t(np.array(a)) for a in jp))
    ours = equivariance_losses(detector, _t(frames),
                               {k: _t(v) for k, v in kp_driving.items()}, tp,
                               10.0, 10.0)
    assert set(ours) == {"equivariance_value", "equivariance_jacobian"}
    for k, v in ref.items():
        np.testing.assert_allclose(float(ours[k].detach()), float(v),
                                   rtol=TOL, err_msg=k)
