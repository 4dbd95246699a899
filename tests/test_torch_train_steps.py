"""Part1 training steps of the port against ``eamm_tpu.train.steps`` (CPU).

Both packages start from the same parameters (the port's, seeded, which
``eamm_tpu.compat`` converts for JAX) and take the same batch.  Adam turns any gradient into an update of
about +-lr, so parameters after a step say little; the port is held to
JAX on what the step computes:

- the losses, within rtol 1e-4;
- every gradient leaf, within 1e-3 relative L2 (a leaf whose true gradient
  is 0, such as a conv bias that a training-mode BatchNorm follows, is
  held to 1e-3 of 1e-3 of its model's gradient norm instead);
- the BatchNorm running statistics written, within 1e-5;
- the frozen detector's statistics, unchanged bit for bit;
- separately, the optimizer's update of one given gradient.

TINY_CONFIG widths, B = 2, 256x256 frames; the fine-tune's perceptual
pyramid and its discriminator run at scale 0.125 (32x32), so that VGG19
costs little here.  Both packages compute in float64 from the same
float32 weights and inputs (JAX under ``enable_x64``): in float32 each
package's gradients of the early layers that a training-mode BatchNorm
follows differ from its own float64 ones by up to 1% at this batch
(ATNet's first audio conv: JAX 0.87%; ATNet's first image conv, torch on
one thread: 0.75%), while the two packages' float64 gradients agree to
1e-13.  The card runs the port in float32 against its CPU run
(``chip_smoke.py``).
"""
import copy
import functools
import json
from typing import NamedTuple

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

from eamm_tpu import compat
from eamm_tpu import config as jax_cfg
from eamm_tpu.models.vgg import Vgg19 as JaxVgg19, convert_vgg19
from eamm_tpu.ops.augment import decode_and_augment as jax_decode
from eamm_tpu.train import steps as JS
from eamm_tpu.train.optim import make_optimizer as jax_make_optimizer
from eamm_tpu_torch import config as cfg
from eamm_tpu_torch.convert import state_dicts_from_jax
from eamm_tpu_torch.models.vgg import Vgg19
from eamm_tpu_torch.train import steps as S
from eamm_tpu_torch.train.loop import build_discriminator
from eamm_tpu_torch.train.optim import make_optimizer
from tests.conftest import TINY_CONFIG

LOSS_RTOL = 1e-4
GRAD_REL = 1e-3
STATS_TOL = 1e-5
B = 2

PART1 = {"loss_weights": {"audio": 10}, "generator": "not"}
FINE_TUNE = {"loss_weights": {"audio": 10, "perceptual": [0.1] * 5,
                              "generator_gan": 1.0, "discriminator_gan": 1.0,
                              "feature_matching": [10, 10, 10]},
             "generator": "audio", "scales": [0.125]}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs in several
    workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config():
    config = copy.deepcopy(TINY_CONFIG)
    config["model_params"]["discriminator_params"]["scales"] = [0.125]
    return config


def _batch(T: int, seed: int, uint8: bool = False) -> dict:
    """A host batch; with ``uint8`` the device-augmentation form (raw
    frames, flips and jitter factors)."""
    rng = np.random.RandomState(seed)
    out = {"example_image": rng.rand(B, 256, 256, 3).astype(np.float32),
           "driving": rng.rand(B, T, 256, 256, 3).astype(np.float32),
           "driving_audio": rng.randn(B, T, 28, 12).astype(np.float32),
           "driving_pose": rng.randn(B, T, 6).astype(np.float32)}
    if uint8:
        for k in ("example_image", "driving"):
            out[k] = (out[k] * 255).astype(np.uint8)
        out.update(flip_time=np.array([1, 0], np.uint8),
                   flip_h=np.array([0, 1], np.uint8),
                   jitter_factors=np.array([[1.1, 0.9, 1.05, 0.03],
                                            [0.95, 1.1, 0.9, -0.05]],
                                           np.float32))
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_models(gan: bool) -> dict:
    models = jax_cfg.build_all(_config())
    if gan:
        models["vgg"] = JaxVgg19()
    return models


class _JaxState(NamedTuple):
    """JAX's side of a state: what ``_make_part1_loss`` and the
    discriminator step read."""
    trainable: dict
    frozen: dict
    batch_stats: dict
    disc_params: dict | None


def _states(gan: bool):
    """(the port's state, JAX's) over the same weights: the port's models
    drawn from seed 0 (both detectors' Jacobian heads given small random
    weights, else the Jacobian is the identity everywhere and its loss
    rounding noise), converted for JAX by ``eamm_tpu.compat`` (the port
    keeps the reference checkpoints' names); the port's then in float64."""
    config = _config()
    torch.manual_seed(0)
    models = {"generator": cfg.build_generator(config),
              "kp_detector": cfg.build_kp_detector(config),
              "kp_detector_a": cfg.build_kp_detector_a(config),
              "audio_feature": cfg.build_atnet(config)}
    noise = np.random.RandomState(7)
    with torch.no_grad():
        for name in ("kp_detector", "kp_detector_a"):
            w = models[name].jacobian.weight
            w.copy_(torch.from_numpy(
                0.05 * noise.randn(*w.shape).astype(np.float32)))
    if gan:
        models["vgg"] = Vgg19()
        models["discriminator"] = build_discriminator(config)
    sd = {name: {k: v.numpy() for k, v in m.state_dict().items()}
          for name, m in models.items()}
    converted = {
        "kp_detector": compat.convert_kp_detector(sd["kp_detector"]),
        "kp_detector_a": compat.convert_kp_detector_a(sd["kp_detector_a"]),
        "generator": compat.convert_generator(sd["generator"]),
        "audio_feature": compat.convert_atnet(sd["audio_feature"])}
    if gan:
        converted["vgg"] = convert_vgg19(sd["vgg"])
        converted["discriminator"] = compat.convert_discriminator(
            sd["discriminator"])
    trainable = ("audio_feature", "kp_detector_a") + (
        ("generator",) if gan else ())
    jax_state = _JaxState(
        {n: converted[n]["params"] for n in trainable},
        {n: v["params"] for n, v in converted.items()
         if n not in trainable and n != "discriminator"},
        {n: v.get("batch_stats", {}) for n, v in converted.items()
         if n != "vgg"},
        converted["discriminator"]["params"] if gan else None)
    for m in models.values():
        m.double()
    port = S.init_part1_state(
        models, make_optimizer, train_generator=gan,
        make_disc_optimizer=make_optimizer if gan else None)
    return port, jax_state


def _f64(tree):
    """Float leaves as float64 (call under ``jax.enable_x64``)."""
    return jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float64)
        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
        else jnp.asarray(a), tree)


def _decoded(batch: dict) -> dict:
    """JAX's device decode of a host batch, then float64."""
    return _f64(jax_decode({k: jnp.asarray(v) for k, v in batch.items()}))


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(gan: bool, tp_json: str):
    """(JAX's models, its jitted part1 gradient) for the config and these
    train_params, made once: tests with the same shapes reuse the
    compiled program."""
    models = _jax_models(gan)
    loss = JS._make_part1_loss(models, json.loads(tp_json))
    return models, jax.jit(jax.grad(loss, has_aux=True))


def _jax_grads(state, tp, batch, gan: bool):
    """(grads, metrics, new batch_stats, gen_out) of JAX's part1 loss, in
    float64."""
    _, fn = _jax_grad_fn(gan, json.dumps(tp, sort_keys=True))
    frozen = dict(state.frozen)
    if gan:
        frozen["discriminator"] = state.disc_params
    with jax.enable_x64(True):
        grads, (metrics, stats, gen_out) = fn(
            _f64(state.trainable), _f64(frozen), _f64(state.batch_stats),
            _decoded(batch))
        return _np(grads), _np(metrics), _np(stats), _np(gen_out)


def _check_losses(ours: dict, ref: dict):
    assert set(ref) <= set(ours)
    for k, v in ref.items():
        np.testing.assert_allclose(float(ours[k]), float(v), rtol=LOSS_RTOL)


def _check_grads(name: str, module, jax_grads, jax_stats):
    """Each parameter's .grad against JAX's gradient of the same leaf."""
    ref = state_dicts_from_jax({name: {"params": jax_grads,
                                       "batch_stats": jax_stats}})[name]
    ours = {k: p.grad for k, p in module.named_parameters()}
    total = np.sqrt(sum(float((r.double() ** 2).sum())
                        for k, r in ref.items() if k in ours))
    for k, g in ours.items():
        r = ref[k].double()
        assert g is not None, f"{name}.{k}: no gradient"
        err = float((g.double() - r).norm())
        floor = max(float(r.norm()), GRAD_REL * total)
        assert err <= GRAD_REL * floor, \
            f"{name}.{k}: |diff| {err} against |grad| {float(r.norm())}"


def _check_stats(name: str, module, jax_params, jax_stats):
    """The module's BatchNorm running statistics against JAX's new ones."""
    ref = state_dicts_from_jax({name: {"params": _np(jax_params),
                                       "batch_stats": jax_stats}})[name]
    n = 0
    for k, v in module.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(),
                                       rtol=STATS_TOL, atol=STATS_TOL)
            n += 1
    assert n > 0


def _buffers(module) -> dict:
    return {k: v.clone() for k, v in module.state_dict().items()
            if "running" in k or "num_batches" in k}


def _run(tp: dict, T: int, gan: bool, uint8: bool = False, seed: int = 0):
    """One gradient of the part1 loss in both packages from the same state
    and batch -> dict of the port's state, metrics and gen_out, its frozen
    detector's statistics from before, JAX's state and results."""
    batch = _batch(T, seed, uint8)
    port, state = _states(gan)
    before = _buffers(port.models["kp_detector"])
    metrics, gen_out = S.part1_grads(port, tp, S.to_device(batch, "cpu"))
    grads, jmetrics, jstats, jgen = _jax_grads(state, tp, batch, gan)
    models = _jax_grad_fn(gan, json.dumps(tp, sort_keys=True))[0]
    return dict(port=port, metrics=metrics, gen_out=gen_out, before=before,
                batch=batch, models=models, state=state, grads=grads,
                jax_metrics=jmetrics, jax_stats=jstats, jax_gen_out=jgen)


def _check_step(r: dict, stats_of=("audio_feature",)):
    port, state = r["port"], r["state"]
    _check_losses(r["metrics"], r["jax_metrics"])
    params = {**state.frozen, **state.trainable}
    for name in port.trainable:
        _check_grads(name, port.models[name], r["grads"][name],
                     r["jax_stats"].get(name, {}))
    for name in stats_of:
        _check_stats(name, port.models[name], params[name],
                     r["jax_stats"][name])


@pytest.fixture(scope="module")
def part1():
    return _run(PART1, T=2, gan=False)


@pytest.fixture(scope="module")
def fine_tune():
    return _run(FINE_TUNE, T=5, gan=True, uint8=True, seed=1)


def test_part1_step_matches_jax(part1):
    """Losses, every gradient of audio_feature and kp_detector_a, and
    audio_feature's new BatchNorm statistics."""
    _check_step(part1)


def test_frozen_detector_statistics_unchanged(part1, fine_tune):
    """The frozen detector ran in training mode (batch statistics) and
    took no gradient; its running statistics are bit for bit the same."""
    for r in (part1, fine_tune):
        detector = r["port"].models["kp_detector"]
        after = _buffers(detector)
        for k, v in r["before"].items():
            assert torch.equal(after[k], v), k
        assert all(p.grad is None for p in detector.parameters())


def test_fine_tune_gan_step_matches_jax(fine_tune):
    """The fine-tune with perceptual and GAN terms on a device-augmented
    uint8 batch: losses, the gradients of audio_feature, kp_detector_a
    and the generator, the generator's statistics after encode_source
    then decode; then the discriminator step on the generated frames:
    its loss, gradients and the stored power-iteration vectors, against
    JAX's discriminator step (with SGD at rate 1, whose update is minus
    the gradient)."""
    r = fine_tune
    _check_step(r, stats_of=("audio_feature", "generator"))
    np.testing.assert_allclose(r["gen_out"]["prediction"].detach().numpy(),
                               np.asarray(r["jax_gen_out"]["prediction"]),
                               atol=1e-4)
    state, models = r["state"], r["models"]
    disc_step = JS.make_discriminator_step(models, FINE_TUNE,
                                           optax.sgd(1.0))
    with jax.enable_x64(True):
        params = _f64(state.disc_params)
        new_params, new_stats, _, dmetrics = jax.jit(disc_step)(
            params, _f64(state.batch_stats["discriminator"]),
            optax.sgd(1.0).init(params), _decoded(r["batch"]),
            _f64(r["jax_gen_out"]))
        grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                             params, new_params)

    port = r["port"]
    decoded = S.decode_and_augment(S.to_device(r["batch"], "cpu"))
    ours = S.discriminator_grads(port, FINE_TUNE, decoded, r["gen_out"])
    _check_losses(ours, _np(dmetrics))
    disc = port.models["discriminator"]
    _check_grads("discriminator", disc, grads, _np(new_stats))
    ref = state_dicts_from_jax({"discriminator": {
        "params": _np(new_params), "batch_stats": _np(new_stats)}})
    for k, v in disc.state_dict().items():
        if k.endswith("weight_u"):
            np.testing.assert_allclose(v.numpy(),
                                       ref["discriminator"][k].numpy(),
                                       atol=STATS_TOL, rtol=STATS_TOL)


def test_grad_accum_is_the_mean_gradient():
    """grad_accum 2 on a stacked batch: the mean of the two micro-batches'
    gradients and metrics, the second micro-batch starting from the
    statistics the first left (what JAX's ``_accum_grads`` computes),
    against JAX's gradients of the two micro-batches taken so."""
    micro = [_batch(T=2, seed=s) for s in (2, 3)]
    port, state = _states(gan=False)
    metrics, _ = S.part1_grads(port, dict(PART1, grad_accum=2),
                               S.to_device(JS.stack_host_batches(micro),
                                           "cpu"))
    runs = []
    for batch in micro:
        runs.append(_jax_grads(state, PART1, batch, False))
        state = state._replace(batch_stats=runs[-1][2])
    mean = jax.tree.map(lambda a, b: (a + b) / 2, runs[0][:2], runs[1][:2])
    _check_step(dict(port=port, state=state, metrics=metrics,
                     jax_metrics=mean[1], grads=mean[0],
                     jax_stats=runs[-1][2]))


def test_adam_update_matches_optax():
    """One given gradient through the port's Adam (b1 0.5, b2 0.999) with
    the MultiStep schedule, against optax.adam over the same schedule:
    three updates across a milestone at update 2 (steps_per_epoch 1,
    milestones_epochs 1 and 2)."""
    rng = np.random.RandomState(4)
    w0 = rng.randn(5, 3).astype(np.float32)
    gs = [rng.randn(5, 3).astype(np.float32) for _ in range(3)]
    sched = dict(lr=1e-2, milestones_epochs=(1, 2), steps_per_epoch=1)
    tx = jax_make_optimizer(**sched)
    w, opt_state = jnp.asarray(w0), None
    opt_state = tx.init(w)
    module = torch.nn.Linear(3, 5, bias=False)
    with torch.no_grad():
        module.weight.copy_(torch.from_numpy(w0))
    opt = make_optimizer({"m": module}, **sched)
    for g in gs:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, w)
        w = optax.apply_updates(w, updates)
        module.weight.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(module.weight.detach().numpy(),
                                   np.asarray(w), rtol=1e-6, atol=1e-7)
