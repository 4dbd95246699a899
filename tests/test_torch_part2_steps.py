"""The part2 step of the port against ``eamm_tpu.train.steps`` (CPU).

Both packages start from the same weights (the port's, seeded, which
``eamm_tpu.compat`` converts for JAX) and take the same batch, in float64
(JAX under ``enable_x64``).  JAX's own part2 loss is the function its
``make_part2_step`` closes over; its gradient is taken here without the
step's float32 cast of the metrics.  Held, per emotion head type
(``linear_4``; ``map_4`` and ``linear_10``, both with ``smooth``):

- the losses, within 1e-9 relative;
- every ``emo_detector`` gradient leaf and the Adam update (optax's over
  JAX's gradient), within 1e-6 relative L2.  A leaf whose true gradient
  is 0, such as a conv bias that a training-mode BatchNorm follows,
  carries rounding noise (below 1e-9 of the model's gradient norm): its
  gradient is held to 1e-6 of that norm, and its update, which Adam makes
  of the noise over eps, to 1e-6 of the model's update norm;
- emo_detector's new BatchNorm running statistics, within 2.5e-7
  relative: JAX's BatchNorm rounds the batch mean and variance to float32
  and takes their momentum share in float32
  (``eamm_tpu/models/blocks.py:48-51``), two roundings of 2^-24 each (the
  largest difference seen is 1.25 float32 spacings of the statistic), so
  1e-9 is below what it keeps;
- the frozen modules' running statistics unchanged (bit for bit in the
  port, equal in JAX's returned tree).

TINY_CONFIG widths with a narrow emotion hourglass, one clip of three
frames (the smoothness term's second difference needs three), 64x64 for
the detectors and emo_detector, 256x256 for ATNet's example image.
"""
import copy
import functools
import json

import numpy as np
import optax
import pytest
import torch
import jax

from eamm_tpu import compat
from eamm_tpu import config as jax_cfg
from eamm_tpu.train import steps as JS
from eamm_tpu.train.optim import make_optimizer as jax_make_optimizer
from eamm_tpu_torch.convert import state_dicts_from_jax
from eamm_tpu_torch.train import steps as S
from eamm_tpu_torch.train.loop import build_models
from eamm_tpu_torch.train.optim import make_optimizer
from tests.conftest import TINY_CONFIG
from tests.test_torch_train_steps import _np

LOSS_RTOL = 1e-9
GRAD_REL = 1e-6
STATS_RTOL = 2.5e-7
B, T = 1, 3
HW = 64             # the frames the detectors read; ATNet reads 256x256
TYPES = {"linear_4": False, "map_4": True, "linear_10": True}   # smooth


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs in several
    workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _train_params(etype: str, **extra) -> dict:
    return {"type": etype, "classify": True, "smooth": TYPES[etype],
            "loss_weights": {"emo": 10}, **extra}


def _config(etype: str) -> dict:
    config = copy.deepcopy(TINY_CONFIG)
    config["model_params"]["emotion_params"] = {
        "block_expansion": 8, "max_features": 32, "num_blocks": 3}
    config["train_params"] = _train_params(etype)
    return config


def _batch(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    return {"example_image": rng.rand(B, 256, 256, 3).astype(np.float32),
            "driving": rng.rand(B, T, HW, HW, 3).astype(np.float32),
            "transformed_driving": rng.rand(B, T, HW, HW, 3)
            .astype(np.float32),
            "driving_audio": rng.randn(B, T, 28, 12).astype(np.float32),
            "driving_pose": rng.randn(B, T, 6).astype(np.float32),
            "emotion": rng.randint(0, 8, B).astype(np.int32)}


def _states(etype: str):
    """(the port's Part2State in float64, JAX's (trainable, frozen,
    batch_stats)) over the port's part2 models drawn from seed 0, every
    Jacobian head given small random weights (else its Jacobian is the
    identity everywhere and the Jacobian loss rounding noise)."""
    models = copy.deepcopy(_drawn(etype.split("_")[0]))
    noise = np.random.RandomState(7)
    with torch.no_grad():
        for m in models.values():
            for name, p in m.named_parameters():
                if "jacobian" in name and name.endswith("weight"):
                    p.copy_(torch.from_numpy(
                        0.05 * noise.randn(*p.shape).astype(np.float32)))
    sd = {name: {k: v.numpy() for k, v in m.state_dict().items()}
          for name, m in models.items()}
    emo = (compat.convert_emotion_map if etype.startswith("map")
           else compat.convert_emotion_k)
    v = {"kp_detector": compat.convert_kp_detector(sd["kp_detector"]),
         "kp_detector_a": compat.convert_kp_detector_a(sd["kp_detector_a"]),
         "audio_feature": compat.convert_atnet(sd["audio_feature"]),
         "emo_detector": emo(sd["emo_detector"])}
    jax_state = ({"emo_detector": v["emo_detector"]["params"]},
                 {n: v[n]["params"] for n in S.PART2_FROZEN},
                 {n: v[n].get("batch_stats", {}) for n in v
                  if n != "kp_detector_a"})
    for m in models.values():
        m.double()
    return S.init_part2_state(models, make_optimizer), jax_state


def _f64(tree):
    """Float leaves as float64 numpy arrays (a jitted function takes them
    as they are under ``enable_x64``; converting on the device would
    compile one conversion per leaf shape)."""
    return jax.tree.map(
        lambda a: np.asarray(a, np.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else np.asarray(a),
        tree)


@functools.lru_cache(maxsize=None)
def _drawn(kind: str) -> dict:
    """The part2 models of an emotion kind ('linear' or 'map'), drawn
    once; ``_states`` copies them."""
    return build_models(_config(f"{kind}_4"), "train_part2", device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(tp_json: str):
    """JAX's jitted gradient of its part2 loss for these train_params (the
    loss ``make_part2_step`` closes over), made once per head type."""
    tp = json.loads(tp_json)
    models = jax_cfg.build_all(_config(tp["type"]),
                               emotion_kind=tp["type"].split("_")[0])
    step = JS.make_part2_step(models, tp, optax.sgd(1.0))
    loss_fn = step.__closure__[step.__code__.co_freevars.index(
        "loss_fn")].cell_contents
    return jax.jit(jax.grad(loss_fn, has_aux=True))


def _jax_grads(tp: dict, jax_state, batch: dict):
    """(grads, metrics, new batch_stats) of JAX's part2 loss in float64."""
    fn = _jax_grad_fn(json.dumps(tp, sort_keys=True))
    trainable, frozen, stats = jax_state
    with jax.enable_x64(True):
        grads, (metrics, new_stats) = fn(
            _f64(trainable), _f64(frozen), _f64(stats), _f64(batch))
        return _np(grads), _np(metrics), _np(new_stats)


@functools.lru_cache(maxsize=None)
def _jax_adam_fn():
    """optax's first Adam update (the port's schedule and betas) of a
    gradient, jitted: eager optax compiles each operation per leaf."""
    tx = jax_make_optimizer()
    return jax.jit(lambda g, p: tx.update(g, tx.init(p), p)[0])


def _jax_adam_update(jax_state, grads) -> dict:
    """optax's first Adam update of JAX's gradient, in float64."""
    with jax.enable_x64(True):
        return _np(_jax_adam_fn()(_f64(grads), _f64(jax_state[0])))


def _port_names(tree: dict, stats: dict, etype: str) -> dict:
    return state_dicts_from_jax({"emo_detector": {
        "params": tree["emo_detector"], "batch_stats": stats}},
        etype)["emo_detector"]


def _grads(module) -> dict:
    """Each parameter's gradient; zeros for the heads the type does not
    run, which JAX differentiates to zeros."""
    return {k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for k, p in module.named_parameters()}


def _buffers(module) -> dict:
    return {k: v.clone() for k, v in module.state_dict().items()
            if "running" in k or "num_batches" in k}


def _norm(tree: dict) -> float:
    return float(np.sqrt(sum(float((r.double() ** 2).sum())
                             for r in tree.values())))


def _check_leaves(ours: dict, ref: dict, what: str,
                  noise: frozenset = frozenset()):
    """Each leaf within GRAD_REL relative L2 of ``ref``'s; a leaf in
    ``noise`` (or, for gradients, a zero one) within GRAD_REL of the
    model's norm."""
    total = _norm(ref)
    for k, g in ours.items():
        r = ref[k].double()
        err = float((g.double() - r).norm())
        scale = total if k in noise else max(float(r.norm()),
                                             GRAD_REL * total)
        assert err <= GRAD_REL * scale, \
            f"{what} {k}: |diff| {err} against |ref| {float(r.norm())}"


def _zero_leaves(grads: dict) -> frozenset:
    """The leaves whose gradient is rounding noise."""
    total = _norm(grads)
    return frozenset(k for k, g in grads.items()
                     if float(g.double().norm()) <= 1e-9 * total)


def _run(etype: str) -> dict:
    """One part2 gradient and Adam update in both packages."""
    tp = _train_params(etype)
    batch = _batch(0)
    port, jax_state = _states(etype)
    frozen = {n: _buffers(port.models[n]) for n in S.PART2_FROZEN}
    emo = port.models["emo_detector"]
    metrics = S.part2_grads(port, tp, S.to_device(batch, "cpu"))
    grads = _grads(emo)
    before = {k: p.detach().clone() for k, p in emo.named_parameters()}
    port.optimizer.step()
    update = {k: p.detach() - before[k] for k, p in emo.named_parameters()}
    jgrads, jmetrics, jstats = _jax_grads(tp, jax_state, batch)
    return dict(port=port, frozen=frozen, metrics=metrics, grads=grads,
                update=update, jax_state=jax_state, jax_grads=jgrads,
                jax_metrics=jmetrics, jax_stats=jstats, tp=tp)


@pytest.fixture(scope="module")
def runs():
    return {}


def _get(runs: dict, etype: str) -> dict:
    if etype not in runs:
        runs[etype] = _run(etype)
    return runs[etype]


def _check_run(r: dict, etype: str):
    assert set(r["jax_metrics"]) == set(r["metrics"])
    for k, v in r["jax_metrics"].items():
        np.testing.assert_allclose(float(r["metrics"][k]), float(v),
                                   rtol=LOSS_RTOL, err_msg=k)
    stats = r["jax_stats"]["emo_detector"]
    grads = _port_names(r["jax_grads"], stats, etype)
    _check_leaves(r["grads"], grads, "gradient")
    jupdate = _jax_adam_update(r["jax_state"], r["jax_grads"])
    _check_leaves(r["update"], _port_names(jupdate, stats, etype), "update",
                  _zero_leaves(grads))
    ref = _port_names(_np(r["jax_state"][0]), stats, etype)
    n = 0
    for k, v in r["port"].models["emo_detector"].state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(),
                                       rtol=STATS_RTOL, atol=1e-12,
                                       err_msg=k)
            n += 1
    assert n > 0


@pytest.mark.parametrize("etype", list(TYPES))
def test_part2_step_matches_jax(runs, etype):
    """Losses, every emo_detector gradient, the Adam update and
    emo_detector's new BatchNorm statistics, per head type."""
    _check_run(_get(runs, etype), etype)


def test_frozen_modules_unchanged(runs):
    """kp_detector, ATNet and kp_detector_a ran with batch statistics
    under no_grad: no gradient, running statistics bit for bit as they
    were; JAX returns its frozen statistics as given."""
    r = _get(runs, "linear_4")
    for name in S.PART2_FROZEN:
        module = r["port"].models[name]
        after = _buffers(module)
        for k, v in r["frozen"][name].items():
            assert torch.equal(after[k], v), f"{name}.{k}"
        assert all(p.grad is None for p in module.parameters()), name
    given = _np(r["jax_state"][2])
    for name in ("kp_detector", "audio_feature"):
        for a, b in zip(jax.tree.leaves(given[name]),
                        jax.tree.leaves(r["jax_stats"][name])):
            np.testing.assert_array_equal(np.asarray(a, np.float64), b)


def test_grad_accum_is_the_mean_gradient(runs):
    """grad_accum 2 on a stacked batch of two clips: the mean of the two
    micro-batches' gradients and metrics, the second starting from the
    BatchNorm statistics the first left, against JAX's gradients of the
    two micro-batches taken so."""
    tp = _train_params("linear_4")
    micro = [_batch(s) for s in (2, 3)]
    port, jax_state = _states("linear_4")
    metrics = S.part2_grads(port, dict(tp, grad_accum=2), S.to_device(
        S.stack_host_batches(micro), "cpu"))
    results = []
    for batch in micro:
        results.append(_jax_grads(tp, jax_state, batch))
        jax_state = (jax_state[0], jax_state[1], results[-1][2])
    grads, jmetrics = jax.tree.map(lambda a, b: (a + b) / 2,
                                   results[0][:2], results[1][:2])
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v),
                                   rtol=LOSS_RTOL, err_msg=k)
    emo = port.models["emo_detector"]
    stats = results[-1][2]["emo_detector"]
    _check_leaves(_grads(emo), _port_names(grads, stats, "linear_4"),
                  "gradient")
