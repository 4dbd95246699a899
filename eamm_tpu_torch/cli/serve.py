"""``eamm-torch-serve``: the render server over HTTP, on the card.

Counterpart of ``eamm_tpu/cli/serve.py`` with the same flags.  It loads
the reference's three torch checkpoints (the demo's flags), builds an
``EammPipeline`` with the delivery options, wraps it in the
dynamic-batching ``RenderServer`` and serves the stdlib HTTP front
(``eamm_tpu_torch.serve_http``: POST /render, POST /render_stream,
PUT /emotion, GET /stats, GET /healthz).

    python -m eamm_tpu_torch.cli.serve --config configs/demo.yaml \\
        --checkpoint fomm.pth.tar --audio_checkpoint audio.pth.tar \\
        --emo_checkpoint emo.pth.tar --port 8080 --warmup_seconds 4

The server runs on the CUDA device unless ``--cpu`` is given.  With
``--artifact`` it serves a frozen render artifact
(``eamm-torch-export``; ``infer/export.py`` ``ArtifactPipeline``) instead
of the checkpoints: the batch size, transfer format and segments are the
artifact's, and the artifact's device is used.

    python -m eamm_tpu_torch.cli.serve --artifact model.eammx --port 8080
"""
from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--artifact", default=None,
                   help="serve a frozen render artifact (eamm-torch-export) "
                        "instead of --config and the checkpoints; its batch, "
                        "transfer format and segments override the flags")
    p.add_argument("--config", help="path to config yaml")
    p.add_argument("--checkpoint",
                   help="FOMM .pth.tar (generator + kp_detector)")
    p.add_argument("--audio_checkpoint",
                   help="A2FD .pth.tar (audio_feature + kp_detector_a)")
    p.add_argument("--emo_checkpoint",
                   help="emotion .pth.tar (emo_detector)")
    p.add_argument("--type", default="linear_3", dest="emo_type")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max_batch", type=int, default=4,
                   help="clips per coalesced dispatch")
    p.add_argument("--max_delay_ms", type=float, default=50.0,
                   help="batching window after the first queued request")
    p.add_argument("--transfer_format", default="yuv420",
                   choices=["rgb", "yuv420"])
    p.add_argument("--overlap_segments", type=int, default=8)
    p.add_argument("--frame_chunk", type=int, default=32)
    p.add_argument("--time_bucket", type=int, default=32)
    p.add_argument("--segment_frames", type=int, default=128,
                   help="unbounded streaming chunk size (frames): long "
                        "clips render in chunks of this many frames with "
                        "the recurrent state carried, in O(chunk) device "
                        "memory.  0 disables.  A multiple of --frame_chunk")
    p.add_argument("--stream_policy_frames", type=int, default=384,
                   help="length policy: clips of at most this many frames "
                        "(~15 s) take the whole-clip route; longer ones "
                        "the unbounded chunks, dispatched alone.  0: every "
                        "clip chunks")
    p.add_argument("--f32", action="store_true",
                   help="float32 decode instead of the default bfloat16")
    p.add_argument("--warmup_seconds", type=float, default=0.0,
                   help="before accepting traffic, render a silent clip "
                        "of this length through each route family")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    return p


def build_pipeline(opt, config: dict):
    """The parsed flags and the config dict -> the ``EammPipeline`` built
    from the three checkpoints."""
    import torch

    from eamm_tpu_torch.infer import EammPipeline, PipelineOptions
    options = PipelineOptions(
        emo_type=opt.emo_type,
        transfer_format=opt.transfer_format,
        overlap_segments=max(1, opt.overlap_segments),
        frame_chunk=opt.frame_chunk, time_bucket=opt.time_bucket,
        segment_frames=opt.segment_frames or None,
        stream_policy_frames=opt.stream_policy_frames or None,
        compute_dtype=torch.float32 if opt.f32 else torch.bfloat16,
        device="cpu" if opt.cpu else "cuda")
    return EammPipeline.from_torch_checkpoints(
        config, opt.checkpoint, opt.audio_checkpoint, opt.emo_checkpoint,
        options)


def warmup(server, seconds: float) -> None:
    """Render a silent ``seconds`` clip through the three route families
    before going live: a coalesced batch (``max_batch`` clips), a stream,
    and, with ``segment_frames``, the unbounded chunks (a clip just past
    the length policy); then zero the stats."""
    import numpy as np
    wav = np.zeros(int(16000 * seconds), np.float32)
    src = np.zeros((256, 256, 3), np.float32)
    pose = np.zeros((1, 7), np.float32)
    server.render(src, wav, pose)
    for _ in server.submit_stream(src, wav, pose):
        pass
    sf = server.pipeline.options.segment_frames
    if sf:
        pol = server.pipeline.options.stream_policy_frames or 0
        long_wav = np.zeros(int(16000 * (pol + sf) * 0.040) + 16000,
                            np.float32)
        for _ in server.submit_stream(src, long_wav, pose):
            pass
    server.reset_stats()


def main(argv=None, stop_event=None, ready=None):
    """``stop_event`` / ``ready``: a threading.Event that ends the serve
    loop, and a callback given the live ``HttpRenderFront``."""
    opt = build_parser().parse_args(argv)
    if opt.artifact:
        serve(opt, None, stop_event, ready)
        return
    for flag in ("config", "checkpoint", "audio_checkpoint",
                 "emo_checkpoint"):
        if getattr(opt, flag) is None:
            raise SystemExit(f"--{flag} is required without --artifact")
    from eamm_tpu_torch.config import load_config
    serve(opt, load_config(opt.config), stop_event, ready)


def artifact_pipeline(opt):
    """``--artifact``: the loaded artifact's ``ArtifactPipeline``; the
    server's batch size, transfer format and segments become the
    artifact's."""
    from eamm_tpu_torch.infer.export import ArtifactPipeline, RenderArtifact
    art = RenderArtifact.load(opt.artifact, "cpu" if opt.cpu else "cuda")
    pipe = ArtifactPipeline(art)
    opt.max_batch = art.batch               # the batched programs' size
    opt.transfer_format = pipe.options.transfer_format
    stream = art.meta.get("streaming")
    opt.overlap_segments = int(stream["segments"]) if stream else 1
    return pipe


def serve(opt, config: dict, stop_event=None, ready=None) -> None:
    """What ``main`` runs once the flags are parsed and the config read
    (None with ``--artifact``): build the pipeline, warm it, serve until
    ``stop_event`` (or SIGINT / SIGTERM), then close the front and stop the
    server."""
    import threading

    from eamm_tpu_torch.serve import RenderServer
    from eamm_tpu_torch.serve_http import HttpRenderFront

    pipe = (artifact_pipeline(opt) if opt.artifact
            else build_pipeline(opt, config))
    server = RenderServer(pipe, max_batch=opt.max_batch,
                          max_delay_ms=opt.max_delay_ms)
    front = None
    try:
        if opt.warmup_seconds > 0:
            warmup(server, opt.warmup_seconds)
        front = HttpRenderFront(server, host=opt.host, port=opt.port)
        print(f"eamm-torch-serve listening on {front.url} "
              f"(max_batch={opt.max_batch}, {opt.transfer_format}, "
              f"S={opt.overlap_segments}, {pipe.options.device})",
              flush=True)
        stop = stop_event or threading.Event()
        try:
            import signal
            for sig in (signal.SIGINT, signal.SIGTERM):
                signal.signal(sig, lambda *_: stop.set())
        except ValueError:
            pass                    # not the main thread
        if ready is not None:
            ready(front)
        stop.wait()
    finally:
        if front is not None:
            front.close()
        server.stop()


if __name__ == "__main__":
    main()
