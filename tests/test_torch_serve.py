"""The port's RenderServer and HTTP front over the port's pipeline on the
CPU (EMOTION_TINY_CONFIG widths, random weights), following
tests/test_serve.py without its device-mesh test: coalescing, padding by
replication, results equal to the pipeline called directly (bit for bit
where the served call is the same call), a failing request that leaves the
worker alive, stop, emotional and streamed requests beside neutral ones,
and the length policy's long route (the HTTP front, stop and the wire
format are in tests/test_torch_serve_http.py)."""

import numpy as np
import pytest
import torch

from chip_smoke import EMOTION_TINY_CONFIG
from eamm_tpu_torch.infer import EammPipeline, PipelineOptions
from eamm_tpu_torch.ops.mfcc import num_windows_for_samples
from eamm_tpu_torch.serve import RenderServer

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
def pipe():
    return EammPipeline.from_random(EMOTION_TINY_CONFIG, 0,
                                    PipelineOptions(**OPTS))


def _variant(pipe, **options):
    """``pipe``'s models under other options."""
    return EammPipeline(EMOTION_TINY_CONFIG, models=pipe.models,
                        options=PipelineOptions(**{**OPTS, **options}))


def _req(seed, seconds=0.3):
    rng = np.random.RandomState(seed)
    return (rng.rand(256, 256, 3).astype(np.float32),
            (0.1 * rng.randn(int(16000 * seconds))).astype(np.float32),
            rng.randn(1, 7).astype(np.float32))


def _emotion(seed, n=3):
    return np.random.RandomState(seed).rand(n, 256, 256, 3).astype(np.float32)


@pytest.fixture()
def server(pipe, request):
    """A server over ``pipe`` (``request.param``: its max_batch and
    max_delay_ms), stopped after the test."""
    max_batch, delay = getattr(request, "param", (2, 300))
    s = RenderServer(pipe, max_batch=max_batch, max_delay_ms=delay)
    yield s
    s.stop()


@pytest.mark.parametrize("server", [(3, 300)], indirect=True)
def test_concurrent_requests_are_coalesced(server):
    futures = [server.submit(*_req(i)) for i in range(3)]
    results = [f.result(timeout=600) for f in futures]
    for r in results:
        assert r.shape == (num_windows_for_samples(4800), 256, 256, 3)
    s = server.stats()
    assert s["requests"] == 3 and s["dispatches"] == 1
    assert s["mean_batch_occupancy"] == 3.0
    assert s["mean_latency_ms"] > 0


def test_result_matches_direct_batch_render(server, pipe):
    """Each request's frames are bitwise its row of the batched render of
    the same group, cut to its own length."""
    a, b = _req(10), _req(11, seconds=0.2)
    fa, fb = server.submit(*a), server.submit(*b)
    ra, rb = fa.result(600), fb.result(600)
    direct = pipe.render_batch_uint8([a[0], b[0]], [a[1], b[1]],
                                     [a[2], b[2]])
    ta, tb = (num_windows_for_samples(len(r[1])) for r in (a, b))
    assert ta != tb                               # trimmed per request
    np.testing.assert_array_equal(ra, direct[0, :ta])
    np.testing.assert_array_equal(rb, direct[1, :tb])


@pytest.mark.parametrize("server", [(2, 1)], indirect=True)
def test_single_request_pads_to_fixed_batch(server, pipe):
    """A lone request renders in a group padded by replicating it: bitwise
    row 0 of the batched render of [it, it]."""
    req = _req(20)
    r = server.render(*req, timeout=600)
    assert server.stats()["mean_batch_occupancy"] == 1.0
    direct = pipe.render_batch_uint8(*([x, x] for x in req))
    np.testing.assert_array_equal(r, direct[0, :len(r)])


@pytest.mark.parametrize("server", [(1, 1)], indirect=True)
def test_worker_survives_bad_request(server):
    bad_src = np.zeros((13, 13, 3), np.float32)   # wrong resolution
    f = server.submit(bad_src, _req(30)[1], _req(30)[2])
    with pytest.raises(Exception):
        f.result(600)
    r = server.render(*_req(31), timeout=600)     # the worker lives on
    assert r.shape[1:] == (256, 256, 3)


def test_emotional_requests_interleave_with_neutral(server, pipe):
    """An emotional request dispatches alone, bitwise the pipeline's own
    emotional render; the neutral requests around it still coalesce."""
    emo = _emotion(60)
    f1 = server.submit(*_req(61))
    fe = server.submit(*_req(62), transformed_video=emo)
    f2 = server.submit(*_req(63))
    r1, re, r2 = (f.result(900) for f in (f1, fe, f2))
    np.testing.assert_array_equal(
        re, pipe.render_uint8(*_req(62), emo, add_emo=True))
    s = server.stats()
    assert s["requests"] == 3 and s["batched_requests"] == 3
    assert 2 <= s["dispatches"] <= 3              # the emotional one alone
    assert r1.shape == r2.shape == re.shape


def test_emotion_handle_requests(server, pipe):
    """prepare_emotion runs on the worker; a request given the handle
    renders what the pipeline renders with the same handle."""
    emo = _emotion(70)
    handle = server.prepare_emotion(emo, timeout=600)
    assert handle.n_frames == 3
    served = server.render(*_req(71), transformed_video=handle, timeout=900)
    np.testing.assert_array_equal(
        served, pipe.render_uint8(*_req(71), handle, add_emo=True))
    assert server.stats()["requests"] == 1        # the prepare is no request


def test_uint8_clip_is_served_unscaled(server, pipe):
    """The server casts raw emotion frames to float32 unscaled, as the JAX
    server does: a uint8 clip renders as its 0..255 values in float32,
    not as the pipeline's own uint8 route (value / 255) renders it."""
    u8 = (_emotion(80) * 255).astype(np.uint8)
    served = server.render(*_req(81), transformed_video=u8, timeout=900)
    unscaled = pipe.render_uint8(*_req(81), u8.astype(np.float32),
                                 add_emo=True)
    np.testing.assert_array_equal(served, unscaled)
    scaled = pipe.render_uint8(*_req(81), u8, add_emo=True)
    assert not np.array_equal(served, scaled)


def test_streaming_request(pipe):
    """submit_stream delivers the segments of render_stream in order, bit
    for bit the whole render; a neutral request alongside still serves."""
    ov = _variant(pipe, overlap_segments=2, time_bucket=16)
    server = RenderServer(ov, max_batch=2, max_delay_ms=30)
    try:
        src, wav, pose = _req(0, seconds=0.5)           # 12 frames
        whole = ov.render_uint8(src, wav, pose, add_emo=False)
        stream = server.submit_stream(src, wav, pose)
        fut = server.submit(*_req(1, seconds=0.5))
        segs = list(stream)
        assert [s for s, _ in segs] == [0, 8]
        np.testing.assert_array_equal(
            np.concatenate([p for _, p in segs], axis=0), whole)
        assert fut.result(timeout=300).shape == whole.shape
    finally:
        server.stop()


def test_long_request_takes_the_unbounded_route(pipe):
    """Past the length policy a request dispatches alone through the
    unbounded chunks: bitwise the pipeline's render_uint8 of it (which
    takes the chunks too) and not coalesced with a short request."""
    long_pipe = _variant(pipe, segment_frames=8, stream_policy_frames=4)
    server = RenderServer(long_pipe, max_batch=2, max_delay_ms=300)
    try:
        short, long_ = _req(90, seconds=0.05), _req(91)
        assert not long_pipe.use_unbounded(
            num_windows_for_samples(len(short[1])))
        assert long_pipe.use_unbounded(num_windows_for_samples(len(long_[1])))
        fs, fl = server.submit(*short), server.submit(*long_)
        np.testing.assert_array_equal(
            fl.result(600), long_pipe.render_uint8(*long_, add_emo=False))
        fs.result(600)
        assert server.stats()["dispatches"] == 2
    finally:
        server.stop()
