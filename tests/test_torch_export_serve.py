"""``eamm-torch-export`` then ``eamm-torch-serve --artifact`` on the CPU,
following tests/test_export.py's serving tests: the artifact written by the
export CLI from the reference's three checkpoints (EMOTION_TINY_CONFIG
widths, batch 2, buckets of 16 and 32 frames: the CLI's frame chunk is 16)
is served by the serve CLI, whose ``RenderServer`` runs the
``ArtifactPipeline``; its results over HTTP are bitwise the artifact's own
calls, a stream without streamed programs is one whole-clip segment, and an
emotional request or an emotion registration fails as it does for a JAX
artifact (no emotional programs, no ``prepare_emotion``)."""
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import yaml

from chip_smoke import EMOTION_TINY_CONFIG, save_checkpoints
from eamm_tpu_torch.cli import export as export_cli
from eamm_tpu_torch.cli import serve as serve_cli
from eamm_tpu_torch.infer import EammPipeline, PipelineOptions
from eamm_tpu_torch.infer.export import ArtifactPipeline
from eamm_tpu_torch.ops.mfcc import num_windows_for_samples
from eamm_tpu_torch.serve_http import (decode_response,
                                       encode_emotion_registration,
                                       encode_request, iter_stream)


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
def exported(tmp_path_factory):
    """The export CLI's artifact of a seeded pipeline's checkpoints, and
    its meta."""
    d = tmp_path_factory.mktemp("artifact")
    pipe = EammPipeline.from_random(EMOTION_TINY_CONFIG, 0,
                                    PipelineOptions(device="cpu"))
    paths = save_checkpoints(pipe.models, str(d))
    with open(d / "config.yaml", "w") as f:
        yaml.safe_dump(EMOTION_TINY_CONFIG, f)
    out = str(d / "model.eammx")
    meta = export_cli.main([
        "--config", str(d / "config.yaml"), "--checkpoint", paths["fomm"],
        "--audio_checkpoint", paths["audio"], "--emo_checkpoint",
        paths["emo"], "--out", out, "--batch", "2", "--frames", "16", "32",
        "--cpu"])
    return out, meta


@pytest.fixture(scope="module")
def front(exported):
    """``eamm-torch-serve --artifact`` on the CPU (its own flags for batch
    and format are overridden by the artifact's), stopped at the end."""
    stop, fronts = threading.Event(), []
    argv = ["--artifact", exported[0], "--cpu", "--host", "127.0.0.1",
            "--port", "0", "--max_batch", "7", "--transfer_format", "yuv420",
            "--max_delay_ms", "300"]
    t = threading.Thread(target=serve_cli.main, args=(argv,),
                         kwargs=dict(stop_event=stop, ready=fronts.append))
    t.start()
    for _ in range(1200):
        if fronts or not t.is_alive():
            break
        t.join(0.1)
    assert fronts, "the server did not start"
    yield fronts[0]
    stop.set()
    t.join(60)
    assert not t.is_alive()


def _req(seed, samples=5000):
    rng = np.random.RandomState(seed)
    return (rng.rand(256, 256, 3).astype(np.float32),
            (0.1 * rng.randn(samples)).astype(np.float32),
            rng.randn(1, 7).astype(np.float32))


def _post(url, body, method="POST"):
    with urllib.request.urlopen(urllib.request.Request(
            url, data=body, method=method), timeout=600) as r:
        return r.read()


def test_export_cli_meta(exported):
    path, meta = exported
    assert meta["batch"] == 2 and meta["frame_buckets"] == [16, 32]
    assert meta["device"] == "cpu" and meta["transfer_format"] == "rgb"
    assert sorted(meta["export_seconds"]) == ["2x16", "2x32"]
    assert meta["emotional"] is meta["streaming"] is meta["unbounded"] is None


def test_served_by_the_artifact(front):
    """The server's pipeline is the artifact's, at the artifact's batch
    and format (the flags said 7 and yuv420)."""
    server = front.server
    assert isinstance(server.pipeline, ArtifactPipeline)
    assert server.max_batch == 2
    assert server.pipeline.options.transfer_format == "rgb"
    assert not server.pipeline.use_unbounded(10 ** 6)
    assert server.stats()["requests"] == 0          # nothing served yet


def test_concurrent_http_requests_bitwise(front):
    """Two concurrent requests (7 and 12 frames) coalesce into one batched
    dispatch; each client's frames are bitwise its row of the artifact's
    own batched call of both clips."""
    reqs = [_req(1), _req(2, samples=8000)]
    bodies = [encode_request(*r) for r in reqs]
    out = [None, None]

    def client(i):
        out[i] = decode_response(_post(front.url + "/render",
                                       bodies[i]))["frames"]

    front.server.reset_stats()
    threads = [threading.Thread(target=client, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert front.server.stats()["dispatches"] == 1
    want = front.server.pipeline.render_batch_uint8(*zip(*reqs))
    for i, (_, wav, _) in enumerate(reqs):
        T = num_windows_for_samples(len(wav))
        assert out[i].shape == (T, 256, 256, 3)
        np.testing.assert_array_equal(out[i], want[i, :T])


def test_stream_is_one_whole_clip_segment(front):
    """Without streamed programs /render_stream delivers the whole clip in
    one segment, bitwise /render of the same request."""
    body = encode_request(*_req(3))
    with urllib.request.urlopen(urllib.request.Request(
            front.url + "/render_stream", data=body, method="POST"),
            timeout=600) as r:
        segs = list(iter_stream(r))
    whole = decode_response(_post(front.url + "/render", body))["frames"]
    assert [int(s["start"]) for s in segs] == [0]
    np.testing.assert_array_equal(segs[0]["frames"], whole)


def test_emotional_requests_fail_without_emotional_programs(front):
    src, wav, pose = _req(4)
    emo = np.random.RandomState(4).rand(3, 256, 256, 3).astype(np.float32)
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(front.url + "/render",
              encode_request(src, wav, pose, transformed=emo))
    assert err.value.code == 500 and b"emotional" in err.value.read()
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(front.url + "/emotion",
              encode_emotion_registration("style", emo), "PUT")
    assert err.value.code == 400 and b"prepare_emotion" in err.value.read()
