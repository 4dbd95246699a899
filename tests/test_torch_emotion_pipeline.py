"""The port's emotional render against the JAX pipeline on the CPU.

One set of random weights at TINY widths with a narrow emotion hourglass
(``chip_smoke.EMOTION_TINY_CONFIG``) drives both packages.  The emotion
model's BN statistics are calibrated on a seeded batch
(``tests.test_torch_emotion.calibrate``), so that its feature depends on
the frame and the displacements move the keypoints by a few hundredths
(at the JAX initialization they move them by 0.003, or not at all for the
map head).  Four routes of ``render_uint8(add_emo=True)``, each chosen the way
the JAX pipeline chooses it:

- linear_3 with fewer emotion frames than timesteps (U < Tp): trunk per
  unique frame, heads per timestep;
- linear_3 with U >= Tp: the whole model per timestep;
- a ``prepare_emotion`` handle: the precomputed feature table;
- the map head: the whole model per timestep, keypoints through the
  keypoint-expectation op at K = 10.

Each is held to the JAX frames at per-frame mean |difference| max < 1e-2
and mean < 3e-3 (tests/test_e2e_parity.py's bound) and, since the TINY
generator barely shows the displacement in the frames, at the keypoint
level to the JAX keypoint stage within 1e-4 (measured: 4e-6)."""
import jax
import numpy as np
import pytest
import torch

from chip_smoke import EMOTION_TINY_CONFIG
from eamm_tpu.infer import EammPipeline as JaxPipeline
from eamm_tpu.infer import PipelineOptions as JaxOptions
from eamm_tpu_torch.infer import EammPipeline, PipelineOptions
from eamm_tpu_torch.ops.mfcc import audio_to_mfcc_windows
from tests.conftest import TINY_CONFIG
from tests.test_infer_pipeline import _inputs
from tests.test_torch_emotion import calibrate

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs in several
    workers at once, and a torch per worker spinning a thread per core
    slows every worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


OPTS = dict(frame_chunk=8, time_bucket=8)
KP_TOL = 1e-4


def _pair(emo_type: str):
    jp = JaxPipeline.from_random(EMOTION_TINY_CONFIG,
                                 options=JaxOptions(emo_type=emo_type, **OPTS))
    v = jax.tree.map(np.asarray, jp.vars)
    port = EammPipeline.from_jax_variables(
        EMOTION_TINY_CONFIG, v,
        PipelineOptions(emo_type=emo_type, device="cpu", **OPTS))
    v["emo_detector"] = calibrate(port.models["emo_detector"], 4, 256)
    jp = JaxPipeline(EMOTION_TINY_CONFIG, v,
                     JaxOptions(emo_type=emo_type, **OPTS))
    port = EammPipeline.from_jax_variables(
        EMOTION_TINY_CONFIG, v,
        PipelineOptions(emo_type=emo_type, device="cpu", **OPTS))
    return jp, port


@pytest.fixture(scope="module")
def linear_pair():
    return _pair("linear_3")


@pytest.fixture(scope="module")
def map_pair():
    return _pair("map")


def _clip(route):
    """(source, waveform, pose, emotion frames) of a route."""
    src, wav, pose, emo = _inputs(seed=1)
    if route == "frames_u_ge_tp":       # 12 frames, Tp 16, 20 emotion frames
        emo = np.random.RandomState(2).rand(20, 256, 256, 3).astype(np.float32)
        wav = wav[:8000]
    return src, wav, pose, emo


def _jax_keypoints(jp, src, wav, pose, video):
    T, args, emo_kw = jp._prepare_full_render_args(src, wav, pose, video, True)
    fn = jax.jit(jp._clip_kp_impl,
                 static_argnames=("add_emo", "emo_from_feats"))
    kp_norm, _ = fn(jp.vars, *args, add_emo=True, **emo_kw)
    return {k: np.asarray(v)[:T] for k, v in kp_norm.items()}


def _port_keypoints(port, src, wav, pose, video):
    T, source, w, p = port._prepare(src, wav, pose)
    Tp = p.shape[0]
    emotion = port._emotion_input(video, Tp)
    kp_norm, _ = port.clip_keypoints(source, audio_to_mfcc_windows(w)[:Tp], p,
                                     emotion)
    neutral, _ = port.clip_keypoints(source, audio_to_mfcc_windows(w)[:Tp], p)
    return ({k: v[:T].numpy() for k, v in kp_norm.items()},
            {k: v[:T].numpy() for k, v in neutral.items()})


@pytest.mark.parametrize("route", ["frames_u_lt_tp", "frames_u_ge_tp",
                                   "handle", "map"])
def test_emotional_render_matches_jax(route, request):
    jp, port = request.getfixturevalue(
        "map_pair" if route == "map" else "linear_pair")
    src, wav, pose, emo = _clip(route)
    jax_video = port_video = emo
    if route == "handle":
        jax_video, port_video = jp.prepare_emotion(emo), port.prepare_emotion(emo)
        assert port_video.feats.shape == (32, 512)
        assert port_video.n_frames == 5
    ref_kp = _jax_keypoints(jp, src, wav, pose, jax_video)
    ours_kp, neutral_kp = _port_keypoints(port, src, wav, pose, port_video)
    for key in ("value", "jacobian"):
        np.testing.assert_allclose(ours_kp[key], ref_kp[key], atol=KP_TOL)
        # the displacement is real: keypoints 1 (by 0.2 of it), 4 and 6
        # move by ten times the tolerance or more
        moved = np.abs(ours_kp[key] - neutral_kp[key]).max(axis=0)
        assert moved.reshape(10, -1).max(axis=1)[[1, 4, 6]].min() > 10 * KP_TOL
    ref = jp.render(src, wav, pose, jax_video, add_emo=True)
    ours = port.render(src, wav, pose, port_video)       # add_emo default
    assert ours.shape == ref.shape
    l1 = np.abs(ours - ref).mean(axis=(1, 2, 3))
    assert l1.max() < 1e-2, l1
    assert l1.mean() < 3e-3, l1.mean()


def test_handle_matches_frames(linear_pair):
    """The handle moves the trunk to prepare time and changes no math
    (tests/test_infer_pipeline.py's bound: at most one uint8 count)."""
    _, port = linear_pair
    src, wav, pose, emo = _clip("frames_u_lt_tp")
    ref = port.render_uint8(src, wav, pose, emo)
    out = port.render_uint8(src, wav, pose, port.prepare_emotion(emo))
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


def test_uint8_frames_are_scaled(linear_pair):
    """uint8 RGB emotion frames are uploaded as uint8 and read as value *
    float32(1/255): within one float32 rounding of value / 255."""
    _, port = linear_pair
    u8 = np.random.RandomState(6).randint(0, 256, (3, 8, 8, 3)).astype(np.uint8)
    ours = port._emotion_frames(u8)
    assert ours.dtype == torch.float32 and ours.shape == (3, 3, 8, 8)
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(),
                               u8.astype(np.float32) / 255.0, rtol=1.2e-7,
                               atol=0)


def test_default_render_needs_frames(tiny_pipeline, linear_pair):
    """Both packages render emotionally by default and refuse to without
    emotion frames."""
    jp, port = linear_pair
    src, wav, pose, _ = _inputs()
    assert jp.options.add_emo and port.options.add_emo
    for pipe in (tiny_pipeline, port):
        with pytest.raises(ValueError, match="transformed_video"):
            pipe.render_uint8(src, wav, pose)


def test_check_add_matches_jax(linear_pair):
    """check_add freezes the audio keypoints at the unsmoothed frame 0, so
    only the emotion displacement animates."""
    jp, port = linear_pair
    src, wav, pose, emo = _clip("frames_u_lt_tp")
    jp.options.check_add = port.options.check_add = True
    try:
        ref = _jax_keypoints(jp, src, wav, pose, emo)
        ours, still = _port_keypoints(port, src, wav, pose, emo)
    finally:
        jp.options.check_add = port.options.check_add = False
    for key in ("value", "jacobian"):
        np.testing.assert_allclose(ours[key], ref[key], atol=KP_TOL)
        assert np.ptp(still[key], axis=0).max() == 0.0


def test_emotion_tiny_config_is_tiny_plus_emotion_params():
    cfg = dict(EMOTION_TINY_CONFIG)
    params = dict(cfg.pop("model_params"))
    assert params.pop("emotion_params") == {
        "block_expansion": 8, "max_features": 32, "num_blocks": 3}
    assert {**cfg, "model_params": params} == TINY_CONFIG
