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

from eamm_tpu.infer.pipeline import prepare_pose_np as jax_prepare_pose_np
from eamm_tpu_torch.infer import EammPipeline, PipelineOptions, prepare_pose_np
from tests.conftest import TINY_CONFIG
from tests.test_infer_pipeline import _inputs

OPTS = dict(frame_chunk=8, time_bucket=8, device="cpu")


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
    """What is still to port raises, naming its ROADMAP item: the packed
    yuv420 emotion upload (uint8 planes [U, 384, 256]), yuv420 transfer and
    adapt_scale."""
    src, wav, pose, _ = _inputs()
    packed = np.zeros((2, 384, 256), np.uint8)
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        port.render_uint8(src, wav, pose, packed)
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        port.prepare_emotion(packed)
    yuv = EammPipeline(TINY_CONFIG, models=port.models, options=PipelineOptions(
        transfer_format="yuv420", **OPTS))
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        yuv.render_uint8(src, wav, pose, add_emo=False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.render_uint8(src, wav, pose, add_emo=False, adapt_scale=True)


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
