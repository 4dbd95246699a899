"""The port's neutral render against the JAX pipeline, end to end on the CPU.

The conftest ``tiny_pipeline`` (TINY_CONFIG, frame_chunk 8, time_bucket 8)
renders the 1 s clip of tests/test_infer_pipeline.py; the port, built from
the same variables through convert.state_dicts_from_jax, renders it with
the kernels' plain versions.  Bound: per-frame mean |difference| max < 1e-2
and mean < 3e-3, the bound tests/test_e2e_parity.py holds the JAX pipeline
to against the torch reference."""
import jax
import numpy as np
import pytest
import torch

from eamm_tpu.infer import EammPipeline as JaxPipeline
from eamm_tpu.infer import PipelineOptions as JaxOptions
from eamm_tpu.infer.pipeline import prepare_pose_np as jax_prepare_pose_np
from eamm_tpu_torch.infer import EammPipeline, PipelineOptions, prepare_pose_np
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


@pytest.fixture(scope="module")
def port(tiny_pipeline):
    variables = jax.tree.map(np.asarray, tiny_pipeline.vars)
    return EammPipeline.from_jax_variables(TINY_CONFIG, variables,
                                           PipelineOptions(**OPTS))


def test_neutral_render_matches_jax(tiny_pipeline, port):
    src, wav, pose, _ = _inputs()
    ref = tiny_pipeline.render(src, wav, pose, add_emo=False)
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
    """What is still to port raises, naming its ROADMAP item: ATNet's 'gan'
    Jacobian decoder.  render_stream refuses adapt_scale, as the JAX
    package's does; the whole-clip render takes it (the staged route)."""
    src, wav, pose, _ = _inputs()
    config = {**TINY_CONFIG, "train_params": {"jaco_net": "gan"}}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EammPipeline.from_random(config, options=PipelineOptions(**OPTS))
    staged = EammPipeline(TINY_CONFIG, models=port.models,
                          options=PipelineOptions(adapt_scale=True, **OPTS))
    with pytest.raises(ValueError, match="adapt_scale"):
        next(staged.render_stream(src, wav, pose, add_emo=False))


@pytest.fixture(scope="module")
def yuv_pair(tiny_pipeline, port):
    """A JAX pipeline and the port on the same weights, both delivering
    yuv420 planes, with relative keypoint movement, and streaming in
    chunks of 16 frames."""
    options = dict(segment_frames=16, transfer_format="yuv420", relative=True)
    jp = JaxPipeline(TINY_CONFIG, tiny_pipeline.vars,
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
