"""The port's neutral render against the JAX pipeline, end to end on the CPU.

A JAX pipeline (TINY_CONFIG, frame_chunk 8, time_bucket 8) renders the 1 s
clip of tests/test_infer_pipeline.py; the port, built from the same
variables through convert.state_dicts_from_jax, renders it with the
kernels' plain versions.  The variables are the port's seeded random
weights taken to JAX by ``eamm_tpu.compat``'s converters of the reference
checkpoints (``jax_variables``): JAX's own random init compiles five
init programs, which made up most of these files' time on the CPU.
Bound: per-frame mean |difference| max < 1e-2 and mean < 3e-3, the bound
tests/test_e2e_parity.py holds the JAX pipeline to against the torch
reference.  (The pose preparation and the seeded weights are in
tests/test_torch_pipeline_setup.py.)"""
import jax
import numpy as np
import pytest
import torch

from eamm_tpu import compat
from eamm_tpu.infer import EammPipeline as JaxPipeline
from eamm_tpu.infer import PipelineOptions as JaxOptions
from eamm_tpu_torch.infer import EammPipeline, PipelineOptions
from tests.conftest import TINY_CONFIG
from tests.test_infer_pipeline import _inputs

OPTS = dict(frame_chunk=8, time_bucket=8, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs in several
    workers at once, and a torch per worker spinning a thread per core
    slows every worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_variables(models: dict) -> dict:
    """The five port models' weights as a JAX pipeline's variables, by
    ``eamm_tpu.compat``'s converters of the reference checkpoints (the
    port keeps the reference's state_dict names); EmotionMap for a map
    head, EmotionK otherwise."""
    sd = {n: {k: v.detach().numpy() for k, v in m.state_dict().items()}
          for n, m in models.items()}
    emo = (compat.convert_emotion_map
           if type(models["emo_detector"]).__name__ == "EmotionMap"
           else compat.convert_emotion_k)
    return {"generator": compat.convert_generator(sd["generator"]),
            "kp_detector": compat.convert_kp_detector(sd["kp_detector"]),
            "kp_detector_a": compat.convert_kp_detector_a(
                sd["kp_detector_a"]),
            "audio_feature": compat.convert_atnet(sd["audio_feature"]),
            "emo_detector": emo(sd["emo_detector"])}


@pytest.fixture(scope="module")
def jax_pipe():
    """A JAX pipeline over the port's weights drawn from seed 0."""
    drawn = EammPipeline.from_random(TINY_CONFIG, 0, PipelineOptions(**OPTS))
    return JaxPipeline(TINY_CONFIG, jax_variables(drawn.models),
                       JaxOptions(frame_chunk=8, time_bucket=8))


@pytest.fixture(scope="module")
def port(jax_pipe):
    variables = jax.tree.map(np.asarray, jax_pipe.vars)
    return EammPipeline.from_jax_variables(TINY_CONFIG, variables,
                                           PipelineOptions(**OPTS))


def test_neutral_render_matches_jax(jax_pipe, port):
    src, wav, pose, _ = _inputs()
    ref = jax_pipe.render(src, wav, pose, add_emo=False)
    ours = port.render(src, wav, pose, add_emo=False)
    assert ours.shape == ref.shape and ours.dtype == np.float32
    l1 = np.abs(ours - ref).mean(axis=(1, 2, 3))
    assert l1.max() < 1e-2, l1
    assert l1.mean() < 3e-3, l1.mean()


def test_bf16_render_tracks_f32(port):
    """compute_dtype bfloat16 casts the generator only.  At TINY widths the
    frames sit near 0.5, where one bfloat16 rounding of the output is half a
    uint8 count, so most pixels move by one count: the JAX pipeline's own
    bfloat16 render of this clip differs from its float32 one by mean 0.99,
    99th percentile 1 and max 1 counts.  Bound: at most 2 counts anywhere."""
    src, wav, pose, _ = _inputs(seed=7)
    bf16 = EammPipeline(TINY_CONFIG, models=port.models, options=PipelineOptions(
        compute_dtype=torch.bfloat16, **OPTS))
    assert bf16.models["generator"] is port.models["generator"]
    assert next(bf16.generator.parameters()).dtype == torch.bfloat16
    d = np.abs(port.render_uint8(src, wav, pose, add_emo=False)
               .astype(np.float32)
               - bf16.render_uint8(src, wav, pose, add_emo=False)
               .astype(np.float32))
    assert d.max() <= 2.0, (d.mean(), d.max())


def test_unported_options_raise(port):
    """What the port does not build raises: a ``jaco_net`` other than
    'cnn' and 'gan' (the gan decoder is tests/test_torch_atnet_gan.py's),
    as the JAX package's ATNet does.  render_stream refuses adapt_scale,
    as the JAX package's does; the whole-clip render takes it (the staged
    route)."""
    src, wav, pose, _ = _inputs()
    config = {**TINY_CONFIG, "train_params": {"jaco_net": "vae"}}
    with pytest.raises(ValueError, match="jaco_net"):
        EammPipeline.from_random(config, options=PipelineOptions(**OPTS))
    staged = EammPipeline(TINY_CONFIG, models=port.models,
                          options=PipelineOptions(adapt_scale=True, **OPTS))
    with pytest.raises(ValueError, match="adapt_scale"):
        next(staged.render_stream(src, wav, pose, add_emo=False))


@pytest.fixture(scope="module")
def yuv_pair(jax_pipe, port):
    """A JAX pipeline and the port on the same weights, both delivering
    yuv420 planes, with relative keypoint movement, and streaming in
    chunks of 16 frames."""
    options = dict(segment_frames=16, transfer_format="yuv420", relative=True)
    jp = JaxPipeline(TINY_CONFIG, jax_pipe.vars,
                     JaxOptions(frame_chunk=8, time_bucket=8, **options))
    ours = EammPipeline(TINY_CONFIG, models=port.models,
                        options=PipelineOptions(**OPTS, **options))
    return jp, ours


def _assert_e2e(a, b, what):
    """Per frame (the leading axes but the last two), mean |a - b| / 255
    has max < 1e-2 and mean < 3e-3."""
    assert a.shape == b.shape, (what, a.shape, b.shape)
    d = np.abs(a.astype(np.float32) - b.astype(np.float32)) / 255.0
    l1 = d.reshape(*a.shape[:-2], -1).mean(-1)
    assert l1.max() < 1e-2, (what, l1)
    assert l1.mean() < 3e-3, (what, l1.mean())


def test_stream_yuv420_matches_jax(yuv_pair):
    """The slice as a whole: a 1 s neutral clip (24 frames) streamed in
    chunks of 16 frames (the unbounded route, the recurrent state and the
    first audio keypoints carried across the boundary) and delivered as
    yuv420 planes, by both packages on the same weights, within the bound
    above per frame and plane."""
    jp, ours = yuv_pair
    src, wav, pose, _ = _inputs(seconds=1.0, seed=11)
    ref = list(jp.render_stream(src, wav, pose, add_emo=False))
    got = list(ours.render_stream(src, wav, pose, add_emo=False))
    assert [s for s, _ in got] == [s for s, _ in ref] == [0, 16]
    for plane in range(3):
        a = np.concatenate([p[plane] for _, p in got])
        assert a.shape[0] == 24
        _assert_e2e(a, np.concatenate([p[plane] for _, p in ref]),
                    f"plane {plane}")


def test_batch_keypoints_match_jax(yuv_pair):
    """The batched render's keypoints for two identities of 0.3 s and 0.2 s
    (7 and 4 frames, the second with a pose track; Tp 8 with the padded
    tail) against the JAX package's batch keypoint stage, within 1e-5,
    with relative=True, which both batches leave out: each clip's windows
    by themselves, zero-padded, one-euro smoothed per identity, not
    normalized, identities in order.  The keypoints, not the frames: at
    random weights relative movement shifts the driving keypoints by ~1e-2
    and the frames by one count at most, inside the bound above.  The
    batch's frames are held to each identity's own render by
    tests/test_torch_delivery_stream.py::test_batch_matches_single, and
    those renders to the JAX package's by the tests above."""
    jp, ours = yuv_pair
    clips = [_inputs(seconds=0.3, seed=12), _inputs(seconds=0.2, seed=13)]
    sources = np.stack([c[0] for c in clips])
    wavs = [c[1] for c in clips]
    poses = [clips[0][2],
             np.random.RandomState(14).randn(4, 7).astype(np.float32)]
    ref = jp._batch_kp_stage(jp.vars,
                             *jp._prepare_batch_args(sources, wavs, poses)[1])
    driving, _ = ours.batch_keypoints(
        *ours._prepare_batch(sources, wavs, poses)[1:])
    assert driving["value"].shape == (2, 8, 10, 2)
    for key, ref_v in zip(("value", "jacobian"), ref[:2]):
        np.testing.assert_allclose(driving[key].numpy(), np.asarray(ref_v),
                                   rtol=0, atol=1e-5, err_msg=key)
