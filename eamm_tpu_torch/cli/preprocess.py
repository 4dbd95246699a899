"""``eamm-torch-preprocess``: dataset preprocessing (crop, align, MFCC
windows, pose, packs).

Counterpart of ``eamm_tpu/cli/preprocess.py`` with the same subcommands,
flags and outputs:

    # align one portrait to the template
    python -m eamm_tpu_torch.cli.preprocess crop --image face.png --out crop.png

    # align every frame of a clip with frame 0's landmarks as the template
    python -m eamm_tpu_torch.cli.preprocess align --frames clip.npy \\
        --out-dir frames/

    # audio -> the clip's MFCC windows ([N, 28, 13] .npy)
    python -m eamm_tpu_torch.cli.preprocess mfcc --audio a.wav \\
        --out-dir MFCC/ --name clip0

    # 3DMM camera parameters, or a clip's frames, -> [N, 7] pose .npy
    python -m eamm_tpu_torch.cli.preprocess pose --params params.npy --out pose.npy
    python -m eamm_tpu_torch.cli.preprocess pose --frames clip.npy --out pose.npy

    # per-frame PNGs -> one frames.eammpack per clip directory
    python -m eamm_tpu_torch.cli.preprocess pack --root dataset/

``mfcc`` computes on the CUDA device unless ``--cpu`` is given; the other
subcommands are host code.
"""
from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np


def build_parser() -> ArgumentParser:
    parser = ArgumentParser("eamm-torch-preprocess", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    crop = sub.add_parser("crop", help="align one portrait to the template")
    crop.add_argument("--image", required=True)
    crop.add_argument("--out", required=True)
    crop.add_argument("--landmarks", default=None,
                      help="optional [68,2] npy (else dlib, else the coarse "
                           "landmark fallback)")

    align = sub.add_parser("align",
                           help="align clip frames (frame-0 transform)")
    align.add_argument("--frames", required=True,
                       help="[T,H,W,3] npy of frames (uint8 or float)")
    align.add_argument("--out-dir", required=True)
    align.add_argument("--landmarks", default=None,
                       help="optional [68,2] npy for frame 0")

    mfcc = sub.add_parser("mfcc", help="audio -> MFCC window npy")
    mfcc.add_argument("--audio", required=True)
    mfcc.add_argument("--out-dir", required=True)
    mfcc.add_argument("--name", required=True)
    mfcc.add_argument("--cpu", action="store_true",
                      help="compute on the CPU instead of the CUDA device")

    pose = sub.add_parser(
        "pose", help="7-vector pose npy from 3DMM camera params or from a "
                     "clip's frames (landmark weak-perspective fit)")
    pose.add_argument("--params", default=None,
                      help="[N,>=12] npy of 3DMM camera params")
    pose.add_argument("--frames", default=None,
                      help="[T,H,W,3] npy of frames (uint8 or float)")
    pose.add_argument("--out", required=True)

    pack = sub.add_parser(
        "pack", help="pack per-frame PNGs into decode-free frames.eammpack "
                     "files (one per clip directory, written atomically)")
    pack.add_argument("--root", required=True,
                      help="dataset tree to walk (every directory holding "
                           "<N>.png frames gets a pack)")
    pack.add_argument("--quiet", action="store_true")
    return parser


def main(argv=None):
    opt = build_parser().parse_args(argv)
    from eamm_tpu_torch.data import preprocess as P

    if opt.cmd == "crop":
        import imageio.v2 as imageio
        img = np.asarray(imageio.imread(opt.image))
        lm = np.load(opt.landmarks) if opt.landmarks else None
        out = P.crop_image(img, landmarks=lm)
        imageio.imwrite(opt.out, (out * 255).astype(np.uint8))
        print(opt.out)
        return opt.out

    if opt.cmd == "align":
        import imageio.v2 as imageio
        frames = np.load(opt.frames)
        if frames.dtype == np.uint8:
            frames = frames.astype(np.float32) / 255.0
        lm = np.load(opt.landmarks) if opt.landmarks else None
        aligned = P.align_clip(frames, landmarks0=lm)
        os.makedirs(opt.out_dir, exist_ok=True)
        for i, frame in enumerate(aligned):
            imageio.imwrite(os.path.join(opt.out_dir, f"{i}.png"),
                            (frame * 255).astype(np.uint8))
        print(f"{len(aligned)} frames -> {opt.out_dir}")
        return opt.out_dir

    if opt.cmd == "mfcc":
        out = P.export_mfcc_windows(opt.audio, opt.out_dir, opt.name,
                                    device="cpu" if opt.cpu else "cuda")
        print(out)
        return out

    if opt.cmd == "pose":
        if (opt.params is None) == (opt.frames is None):
            raise SystemExit("pose: pass exactly one of --params / --frames")
        if opt.params is not None:
            from eamm_tpu_torch.data.pose import pose_from_param
            poses = np.stack([pose_from_param(p) for p in np.load(opt.params)])
        else:
            poses = P.estimate_pose_clip(np.load(opt.frames))
        np.save(opt.out, poses)
        print(f"{poses.shape} -> {opt.out}")
        return opt.out

    from eamm_tpu_torch.data.packed import pack_tree
    count = pack_tree(opt.root, verbose=not opt.quiet)
    print(f"{count} clip packs under {opt.root}")
    return count


if __name__ == "__main__":
    main()
