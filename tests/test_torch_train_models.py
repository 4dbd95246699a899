"""The fine-tune's modules and part1's losses against the JAX package (CPU).

The spectral-norm discriminator's outputs and its power-iteration update,
VGG19's five feature maps, the part1 losses and the device augmentation,
each on the same numpy inputs and weights (``convert.state_dicts_from_jax``
carries the discriminator, its ``u`` and VGG19).  Tolerances: 1e-5 for an
op, 1e-3 (relative) for a module.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from eamm_tpu.models.discriminator import (
    MultiScaleDiscriminator as JaxDiscriminator)
from eamm_tpu.models.vgg import Vgg19 as JaxVgg19
from eamm_tpu.ops import augment as jax_augment
from eamm_tpu.train import losses as jax_losses
from eamm_tpu_torch.convert import state_dicts_from_jax
from eamm_tpu_torch.models.discriminator import MultiScaleDiscriminator
from eamm_tpu_torch.models.vgg import Vgg19
from eamm_tpu_torch.ops import augment
from eamm_tpu_torch.train import losses
from tests.test_torch_models import _jit

OP_TOL = 1e-5
MODULE_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs in several
    workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).detach().numpy()


def _close(ours, ref, tol=OP_TOL):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), atol=tol,
                               rtol=tol)


def _module_close(ours, ref, tol=MODULE_TOL):
    """Max |difference| within ``tol`` of the reference's largest value."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= tol * max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("sn,use_kp", [(True, True), (False, False)])
def test_discriminator_matches_jax(sn, use_kp):
    """Feature maps and prediction map at two scales, and with spectral
    norm the stored u after one update, against JAX's update_stats=True."""
    rng = np.random.RandomState(0)
    kw = dict(scales=(1, 0.5), block_expansion=8, max_features=32,
              num_blocks=3, sn=sn, use_kp=use_kp, num_kp=10)
    pyr = {"prediction_1": rng.rand(2, 64, 64, 3).astype(np.float32),
           "prediction_0.5": rng.rand(2, 32, 32, 3).astype(np.float32)}
    kp = {"value": rng.uniform(-1, 1, (2, 10, 2)).astype(np.float32)}
    jm = JaxDiscriminator(**kw)
    jpyr = {k: jnp.asarray(v) for k, v in pyr.items()}
    jkp = {"value": jnp.asarray(kp["value"])}
    variables = _np(_jit(jm.init)(jax.random.PRNGKey(0), jpyr, jkp))
    ref, upd = _jit(jm.apply, update_stats=True, mutable=["batch_stats"])(
        variables, jpyr, jkp)

    model = MultiScaleDiscriminator(**kw)
    model.load_state_dict(state_dicts_from_jax(
        {"discriminator": variables})["discriminator"])
    out = model({k: _t(v).permute(0, 3, 1, 2) for k, v in pyr.items()},
                {"value": _t(kp["value"])})
    for s in kw["scales"]:
        for ours, want in zip(out[f"feature_maps_{s}"],
                              ref[f"feature_maps_{s}"]):
            _module_close(_nhwc(ours), want)
        _module_close(_nhwc(out[f"prediction_map_{s}"]),
                      ref[f"prediction_map_{s}"])
    if sn:
        model.update_spectral_norms()
        want = state_dicts_from_jax({"discriminator": {
            "params": variables["params"],
            "batch_stats": _np(upd["batch_stats"])}})["discriminator"]
        for name, value in model.state_dict().items():
            if name.endswith("weight_u"):
                _close(value, want[name])


def test_vgg_matches_jax():
    """The five feature maps from the same weights (JAX conv<i> ->
    torchvision features.<i>), and a torchvision-named state_dict with the
    classifier loads as it is."""
    rng = np.random.RandomState(1)
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    jm = JaxVgg19()
    variables = _np(_jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x)))
    ref = _jit(jm.apply)(variables, jnp.asarray(x))
    sd = state_dicts_from_jax({"vgg": variables})["vgg"]
    model = Vgg19()
    model.load_torchvision({**sd, "features.34.weight": torch.zeros(1),
                            "classifier.0.weight": torch.zeros(1)})
    out = model(_t(x).permute(0, 3, 1, 2))
    assert len(out) == len(ref) == 5
    for ours, want in zip(out, ref):
        _module_close(_nhwc(ours), want)


def test_part1_losses_match_jax():
    """Pyramid, keypoint mimic, perceptual (a stand-in feature map),
    LSGAN and feature matching on the same arrays."""
    rng = np.random.RandomState(2)
    img = rng.rand(2, 32, 32, 3).astype(np.float32)
    img2 = rng.rand(2, 32, 32, 3).astype(np.float32)
    scales = (1, 0.5, 0.25)
    pyr_j = jax_losses.image_pyramid(jnp.asarray(img), scales)
    pyr = losses.image_pyramid(_t(img), scales)
    for k in pyr_j:
        _close(pyr[k], pyr_j[k])
    pyr2_j = jax_losses.image_pyramid(jnp.asarray(img2), scales)
    pyr2 = losses.image_pyramid(_t(img2), scales)

    kps = [{k: rng.randn(*shape).astype(np.float32) for k, shape in
            (("value", (4, 10, 2)), ("jacobian", (4, 10, 2, 2)),
             ("heatmap", (4, 10, 5, 5)))} for _ in range(2)]
    mimic_j = jax_losses.kp_mimic_loss(
        *[{k: jnp.asarray(v) for k, v in kp.items()} for kp in kps], 10.0)
    mimic = losses.kp_mimic_loss(
        *[{k: _t(v) for k, v in kp.items()} for kp in kps], 10.0)
    for k in mimic_j:
        _close(mimic[k], mimic_j[k])

    weights = (1.0, 0.5)
    _close(losses.perceptual_loss(lambda x: [x, x * x], pyr, pyr2, scales,
                                  weights),
           jax_losses.perceptual_loss(lambda x: [x, x * x], pyr_j, pyr2_j,
                                      scales, weights))

    def disc_out(seed):
        r = np.random.RandomState(seed)
        return {"prediction_map_1": r.randn(2, 5, 5, 1).astype(np.float32),
                "feature_maps_1": [r.randn(2, 6, 6, 4).astype(np.float32)
                                   for _ in range(3)]}
    real, fake = disc_out(3), disc_out(4)
    tj = {"prediction_map_1": jnp.asarray(real["prediction_map_1"]),
          "feature_maps_1": [jnp.asarray(a) for a in real["feature_maps_1"]]}
    fj = {"prediction_map_1": jnp.asarray(fake["prediction_map_1"]),
          "feature_maps_1": [jnp.asarray(a) for a in fake["feature_maps_1"]]}
    tt = {"prediction_map_1": _t(real["prediction_map_1"]),
          "feature_maps_1": [_t(a) for a in real["feature_maps_1"]]}
    ft = {"prediction_map_1": _t(fake["prediction_map_1"]),
          "feature_maps_1": [_t(a) for a in fake["feature_maps_1"]]}
    _close(losses.lsgan_generator_loss(ft, (1,), 2.0),
           jax_losses.lsgan_generator_loss(fj, (1,), 2.0))
    _close(losses.lsgan_discriminator_loss(tt, ft, (1,), 2.0),
           jax_losses.lsgan_discriminator_loss(tj, fj, (1,), 2.0))
    _close(losses.feature_matching_loss(tt, ft, (1,), (10, 0, 3)),
           jax_losses.feature_matching_loss(tj, fj, (1,), (10, 0, 3)))


def test_augment_matches_jax():
    """uint8 decode, the time and horizontal flips and per-sample jitter of
    ``decode_and_augment`` on a [B, T, H, W, 3] batch."""
    rng = np.random.RandomState(5)
    batch = {
        "example_image": rng.randint(0, 256, (3, 8, 8, 3), np.uint8),
        "driving": rng.randint(0, 256, (3, 4, 8, 8, 3), np.uint8),
        "driving_audio": rng.randn(3, 4, 28, 12).astype(np.float32),
        "flip_time": np.array([1, 0, 0], np.uint8),
        "flip_h": np.array([0, 1, 0], np.uint8),
        "jitter_factors": np.array([[1.1, 0.9, 1.2, 0.03],
                                    [0.8, 1.1, 0.9, -0.06],
                                    [1.0, 1.0, 1.0, 0.0]], np.float32),
    }
    ref = jax_augment.decode_and_augment(
        {k: jnp.asarray(v) for k, v in batch.items()})
    out = augment.decode_and_augment({k: _t(v) for k, v in batch.items()})
    assert sorted(out) == sorted(ref)
    for k in ref:
        _close(out[k], ref[k])
