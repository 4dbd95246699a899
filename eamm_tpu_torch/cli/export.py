"""``eamm-torch-export``: a render pipeline frozen into one artifact file.

Counterpart of ``eamm_tpu/cli/export.py`` with the same flags.  It loads
the reference's three torch checkpoints, builds an ``EammPipeline`` and
writes the programs and weights that ``RenderArtifact.load`` (and
``eamm-torch-serve --artifact``) read back without the models, the
checkpoints or the config (``eamm_tpu_torch/infer/export.py``).

    python -m eamm_tpu_torch.cli.export --config configs/demo.yaml \\
        --checkpoint fomm.pth.tar --audio_checkpoint audio.pth.tar \\
        --emo_checkpoint emo.pth.tar --out model.eammx --batch 4 \\
        --frames 128 256 --emotional --stream_segments 4 \\
        --unbounded_frames 128 --compute_dtype bfloat16

The programs are exported on the CUDA device, where they launch the
kernels, unless ``--cpu`` is given; an artifact runs only on the kind of
device it was exported on.
"""
from __future__ import annotations

import json
from argparse import ArgumentParser


def build_parser() -> ArgumentParser:
    p = ArgumentParser("eamm-torch-export", description=__doc__)
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True,
                   help="FOMM checkpoint (generator + kp_detector)")
    p.add_argument("--audio_checkpoint", required=True)
    p.add_argument("--emo_checkpoint", required=True)
    p.add_argument("--out", required=True, help="artifact path (.eammx)")
    p.add_argument("--batch", type=int, default=1,
                   help="identity-batch size of the batched programs")
    p.add_argument("--frames", type=int, nargs="+", default=[128, 256],
                   help="padded clip-length buckets to export")
    p.add_argument("--emotional", action="store_true",
                   help="also export one-clip emotional programs, one per "
                        "--frames x --emo_frames bucket")
    p.add_argument("--emo_frames", type=int, nargs="+", default=[32],
                   help="padded unique-emotion-frame buckets (--emotional)")
    p.add_argument("--stream_segments", type=int, default=0,
                   help="also export one-clip streaming programs that "
                        "deliver the clip in N in-order segments; each "
                        "--frames bucket must divide into N render chunks")
    p.add_argument("--unbounded_frames", type=int, default=0,
                   help="also export the unbounded chunk programs at this "
                        "chunk size (frames): one program set serves any "
                        "clip length in O(chunk) device memory; clips past "
                        "--stream_policy_frames (or the largest --frames "
                        "bucket) take them")
    p.add_argument("--stream_policy_frames", type=int, default=None,
                   help="length policy recorded in the artifact (see "
                        "--unbounded_frames); default: the largest "
                        "--frames bucket")
    p.add_argument("--emo_type", default="linear_3",
                   help="emotion head of the emotional programs (demo "
                        "--type)")
    p.add_argument("--transfer_format", choices=["rgb", "yuv420"],
                   default="rgb")
    p.add_argument("--compute_dtype", choices=["float32", "bfloat16"],
                   default="float32")
    p.add_argument("--pallas_warp", choices=["auto", "on", "off"],
                   default="auto",
                   help="accepted for the JAX CLI's flags and ignored: the "
                        "warps are CUDA kernels kept as eamm:: operators, "
                        "which a --cpu export runs as their plain versions")
    p.add_argument("--cpu", action="store_true",
                   help="export on the CPU (the kernels' plain versions); "
                        "the artifact then runs on the CPU only")
    return p


def main(argv=None) -> dict:
    import torch

    from eamm_tpu_torch.config import load_config
    from eamm_tpu_torch.infer import EammPipeline, PipelineOptions
    from eamm_tpu_torch.infer.export import export_render_artifact

    opt = build_parser().parse_args(argv)
    options = PipelineOptions(
        add_emo=opt.emotional, emo_type=opt.emo_type,
        transfer_format=opt.transfer_format,
        compute_dtype=getattr(torch, opt.compute_dtype),
        stream_policy_frames=opt.stream_policy_frames,
        device="cpu" if opt.cpu else "cuda")
    pipe = EammPipeline.from_torch_checkpoints(
        load_config(opt.config), opt.checkpoint, opt.audio_checkpoint,
        opt.emo_checkpoint, options)
    meta = export_render_artifact(
        pipe, opt.out, batch=opt.batch, frame_buckets=tuple(opt.frames),
        emotional=opt.emotional, emo_frame_buckets=tuple(opt.emo_frames),
        stream_segments=opt.stream_segments,
        unbounded_frames=opt.unbounded_frames)
    print(json.dumps(meta))
    return meta


if __name__ == "__main__":
    main()
