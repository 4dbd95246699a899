"""The port's HTTP front over its RenderServer on the CPU
(EMOTION_TINY_CONFIG widths, random weights), following tests/test_serve.py:
the endpoints against the pipeline called directly, bit for bit, the
emotion registry, a stream that fails midway, and stop.  The wire format is
held to the JAX package's byte for byte and each package decodes the
other's; the stats keep the JAX server's keys."""
import http.client
import json
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from eamm_tpu import serve as jax_serve
from eamm_tpu import serve_http as jax_http
from eamm_tpu_torch import serve_http
from eamm_tpu_torch.infer import PipelineOptions
from eamm_tpu_torch.ops.mfcc import num_windows_for_samples
from eamm_tpu_torch.serve import RenderServer
from tests.test_torch_serve import (_emotion, _req, _variant, one_thread,  # noqa: F401
                                    pipe, server)


def test_stats_keys_are_the_jax_servers(server):
    """stats() gives the JAX server's keys (its worker never dispatches
    here: nothing is submitted to it)."""
    other = jax_serve.RenderServer(pipeline=None, max_batch=2)
    try:
        assert set(server.stats()) == set(other.stats())
    finally:
        other.stop()


class _EchoPipeline:
    """Renders nothing: each clip's frames carry its source's first value,
    so a result shows whose it is."""
    options = PipelineOptions(device="cpu")

    def use_unbounded(self, frames):
        return False

    def render_batch_uint8(self, sources, waveforms, poses):
        T = max(num_windows_for_samples(len(w)) for w in waveforms)
        return np.stack([np.full((T, 1, 1, 3), s.flat[0], np.uint8)
                         for s in sources])


def test_concurrent_submitters_stress():
    """16 threads submit 64 requests of different lengths with a tiny
    switch interval: each future gets its own clip cut to its own length,
    and the stats count every request once."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    server = RenderServer(_EchoPipeline(), max_batch=4, max_delay_ms=2)
    futures, n, workers = {}, 64, 16

    def client(first):
        for i in range(first, n, workers):
            futures[i] = server.submit(np.full((2, 2, 3), i, np.float32),
                                       np.zeros(400 + 160 * i, np.float32),
                                       np.zeros((1, 7), np.float32))
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        for i in range(n):
            out = futures[i].result(30)
            assert out.shape[0] == num_windows_for_samples(400 + 160 * i)
            assert (out == i).all()
        s = server.stats()
        assert s["requests"] == s["batched_requests"] == n
        assert n / 4 <= s["dispatches"] <= n
    finally:
        sys.setswitchinterval(old)
        server.stop()


def test_stop_resolves_queued_and_rejects_new(pipe):
    """stop() fails what is still queued (a stream too) while the worker
    is busy, and refuses later submissions."""
    server = RenderServer(pipe, max_batch=1, max_delay_ms=1)
    gate, busy = threading.Event(), threading.Event()

    def held(group):
        busy.set()
        gate.wait(30)
        raise RuntimeError("held")

    server._dispatch = held
    first = server.submit(*_req(40))
    assert busy.wait(30)
    queued = server.submit(*_req(41))
    stream = server.submit_stream(*_req(42))
    server.stop(timeout=0.1)
    gate.set()
    with pytest.raises(RuntimeError, match="stopped"):
        queued.result(30)
    with pytest.raises(RuntimeError, match="stopped"):
        list(stream)
    with pytest.raises(RuntimeError, match="held"):
        first.result(30)
    with pytest.raises(RuntimeError, match="stopped"):
        server.submit(*_req(43))


def _post(url, body, method="POST", timeout=600):
    return urllib.request.urlopen(urllib.request.Request(
        url, data=body, method=method), timeout=timeout)


def test_http_front(pipe):
    """/render and /render_stream round-trip the npz wire format and equal
    the pipeline's own render; /healthz, /stats, and 400 on a bad body."""
    ov = _variant(pipe, overlap_segments=2, time_bucket=16)
    server = RenderServer(ov, max_batch=2, max_delay_ms=20)
    front = serve_http.HttpRenderFront(server)
    try:
        src, wav, pose = _req(3, seconds=0.5)
        want = ov.render_uint8(src, wav, pose, add_emo=False)
        body = serve_http.encode_request(src, wav, pose)
        with _post(front.url + "/render", body) as resp:
            out = serve_http.decode_response(resp.read())
        np.testing.assert_array_equal(out["frames"], want)
        with _post(front.url + "/render_stream", body) as resp:
            segs = list(serve_http.iter_stream(resp))
        assert [s["start"] for s in segs] == [0, 8]
        np.testing.assert_array_equal(
            np.concatenate([s["frames"] for s in segs], axis=0), want)
        with urllib.request.urlopen(front.url + "/healthz", timeout=60) as r:
            assert r.read() == b"ok"
        with urllib.request.urlopen(front.url + "/stats", timeout=60) as r:
            assert json.loads(r.read())["requests"] == 2
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(front.url + "/render", b"junk", timeout=60)
        assert e.value.code == 400
    finally:
        front.close()
        server.stop()


def test_http_emotion_registry(pipe):
    """PUT /emotion registers a clip once; a render naming its id carries
    no frames and equals the pipeline's render with a handle of the clip;
    an unknown id is a 400."""
    emo = _emotion(82)
    server = RenderServer(pipe, max_batch=2, max_delay_ms=20)
    front = serve_http.HttpRenderFront(server)
    try:
        req = _req(83)
        with _post(front.url + "/emotion",
                   serve_http.encode_emotion_registration("style-a", emo),
                   method="PUT") as r:
            assert json.loads(r.read())["frames"] == 3
        id_body = serve_http.encode_request(*req, emotion_id="style-a")
        raw_body = serve_http.encode_request(*req, transformed=emo)
        assert len(id_body) < len(raw_body) - 0.9 * emo.nbytes
        with _post(front.url + "/render", id_body) as r:
            cached = serve_http.decode_response(r.read())["frames"]
        np.testing.assert_array_equal(cached, pipe.render_uint8(
            *req, pipe.prepare_emotion(emo), add_emo=True))
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(front.url + "/render",
                  serve_http.encode_request(*req, emotion_id="nope"))
        assert e.value.code == 400 and b"unknown emotion_id" in e.value.read()
    finally:
        front.close()
        server.stop()


def test_http_stream_failure_closes_connection(pipe, monkeypatch):
    """A render that fails mid-stream drops the connection, so the client
    gets an error at once instead of waiting on an unterminated body."""
    ov = _variant(pipe)

    def broken_stream(*a, **kw):
        yield 0, np.zeros((8, 256, 256, 3), np.uint8)
        raise RuntimeError("the card fell over")

    monkeypatch.setattr(ov, "render_stream", broken_stream)
    server = RenderServer(ov, max_batch=1, max_delay_ms=10)
    front = serve_http.HttpRenderFront(server)
    try:
        with _post(front.url + "/render_stream",
                   serve_http.encode_request(*_req(5)), timeout=120) as resp:
            segs = []
            with pytest.raises((IOError, http.client.HTTPException)):
                for s in serve_http.iter_stream(resp):
                    segs.append(s)
        assert len(segs) <= 1
    finally:
        front.close()
        server.stop()


def _wire_cases():
    src, wav, pose = _req(7, seconds=0.01)
    emo = _emotion(8, n=1)[:, :4, :4]
    return {
        "request": lambda m: m.encode_request(src, wav, pose),
        "request_frames": lambda m: m.encode_request(src, wav, pose,
                                                     transformed=emo),
        "request_id": lambda m: m.encode_request(src, wav, pose,
                                                 emotion_id="style-a"),
        "registration": lambda m: m.encode_emotion_registration("s", emo),
        "payload_rgb": lambda m: m._encode_arrays(**m._payload_arrays(
            (emo * 255).astype(np.uint8))),
        "segment_yuv": lambda m: m._encode_arrays(
            start=np.int64(8), **m._payload_arrays(tuple(
                np.full((2, 4, 4), i, np.uint8) for i in range(3)))),
    }


def test_wire_format_matches_jax():
    """Each encoder gives the JAX package's bytes for the same arrays, and
    each package decodes the other's: requests (neutral, with frames, with
    an emotion id), the emotion registration, an rgb payload and a yuv420
    stream segment."""
    for case, make in _wire_cases().items():
        ours, ref = make(serve_http), make(jax_http)
        assert ours == ref, case
        a, b = serve_http.decode_response(ref), jax_http.decode_response(ours)
        assert a.keys() == b.keys(), case
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_iter_stream_reads_the_jax_framing():
    """A stream framed as the JAX front frames it parses into its
    segments, then ends at the zero length."""
    import io
    import struct
    segs = [jax_http._encode_arrays(start=np.int64(s), frames=np.full(
        (1, 2, 2, 3), s, np.uint8)) for s in (0, 4)]
    body = b"".join(struct.pack(">Q", len(x)) + x for x in segs)
    out = list(serve_http.iter_stream(io.BytesIO(body + struct.pack(">Q", 0))))
    assert [s["start"] for s in out] == [0, 4]
    assert out[1]["frames"].max() == 4
    with pytest.raises(IOError):
        list(serve_http.iter_stream(io.BytesIO(body)))
