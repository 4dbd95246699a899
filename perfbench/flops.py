"""Floating-point operations of the work a cell asks for, counted once by
``torch.utils.flop_counter.FlopCounterMode`` (convolutions and matrix
products, two operations a multiply-add) over the reference networks on
the meta device at the cell's shapes, so the count is the same whatever
implements the work and costs no device time.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import nets as R
from perfbench.reference.train import part1_loss


def _meta_nets(config: dict, with_vgg: bool = False) -> dict:
    with torch.device("meta"):
        nets = R.build(config)
        if with_vgg:
            nets["vgg"] = R.Vgg19()
    return nets


def render(config: dict, frames: int) -> int:
    """Operations to render one clip of ``frames`` frames: the source's
    keypoints and features once, ATNet and the audio keypoints over every
    frame, the generator's decode of every frame."""
    nets = _meta_nets(config)
    for n in nets.values():
        n.eval()
    m = dict(device="meta")
    src = torch.zeros(1, 3, 256, 256, **m)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        kp_s = nets["kp_detector"](src)
        maps = nets["audio_feature"](src, torch.zeros(1, frames, 28, 12, **m),
                                     torch.zeros(1, frames, 6, **m))[0]
        kp_d = nets["kp_detector_a"](maps)
        gen = nets["generator"]
        feats = gen.encode_source(src)
        gen.decode(src, feats, {k: kp_d[k] for k in ("value", "jacobian")},
                   {k: kp_s[k].expand(frames, *kp_s[k].shape[1:])
                    for k in ("value", "jacobian")})
    return counter.get_total_flops()


def render_line(config: dict, a: int = 32, b: int = 64) -> tuple:
    """(per clip, per frame): the render's count is linear in the frames,
    fixed costs plus a cost a frame; read at ``a`` and ``b`` frames."""
    fa, fb = render(config, a), render(config, b)
    per_frame = (fb - fa) / (b - a)
    return fa - a * per_frame, per_frame


def train_step(config: dict, train_params: dict, batch: int,
               frames: int) -> int:
    """Operations of one part1 or fine-tune step (forward and backward)
    at ``batch`` clips of ``frames`` frames."""
    vgg = train_params.get("generator", "not") == "audio"
    nets = _meta_nets(config, vgg)
    trainable = ("audio_feature", "kp_detector_a") + (
        ("generator",) if vgg else ())
    for name, net in nets.items():
        net.requires_grad_(name in trainable).train(name in trainable)
    m = dict(device="meta")
    data = {"example_image": torch.zeros(batch, 256, 256, 3, **m),
            "driving": torch.zeros(batch, frames, 256, 256, 3, **m),
            "driving_audio": torch.zeros(batch, frames, 28, 12, **m),
            "driving_pose": torch.zeros(batch, frames, 6, **m)}
    with FlopCounterMode(display=False) as counter:
        part1_loss(nets, data, train_params)["total"].backward()
    return counter.get_total_flops()

