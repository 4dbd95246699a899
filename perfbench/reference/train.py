"""The reference part1 and fine-tune training steps and Adam.

Part1 (EAMM's ``train_part1.yaml``): ATNet (``audio_feature``) and the
audio keypoint detector train against the frozen FOMM detector's
keypoints on the driving frames (value target detached, heatmap term
x100, Jacobians), the 16-frame window folded into the batch.  The
fine-tune (``train_part1_fine_tune.yaml``, generator ``audio``) adds the
generator: every 4th frame is rendered from the source with the audio
keypoints and held to the real frame by VGG19's L1 over a four-scale
pyramid.  Frozen networks normalize with the batch's statistics and keep
their running statistics; the trained ones are in train mode.  Adam is
written out: b1 0.5, b2 0.999, eps 1e-8, bias-corrected.
"""
from __future__ import annotations

import torch

from perfbench.reference import ops
from perfbench.reference.nets import batch_statistics


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def part1_loss(nets: dict, batch: dict, train_params: dict) -> dict:
    """The step's loss terms (``total`` their sum) on one batch:
    ``example_image`` [B, H, W, 3], ``driving`` [B, T, H, W, 3],
    ``driving_audio`` [B, T, 28, 12], ``driving_pose`` [B, T, 6]."""
    w = train_params["loss_weights"]
    B, T = batch["driving"].shape[:2]
    driving = batch["driving"].reshape(B * T, *batch["driving"].shape[2:])
    example = _nchw(batch["example_image"])
    with batch_statistics(nets["kp_detector"]) as detector:
        kp_vis = detector(_nchw(driving))
    maps = nets["audio_feature"](example, batch["driving_audio"],
                                 batch["driving_pose"])
    kp_aud = nets["kp_detector_a"](maps.reshape(B * T, *maps.shape[2:]))
    a = w["audio"]
    terms = {
        "loss_value": a * (kp_vis["value"].detach()
                           - kp_aud["value"]).abs().mean(),
        "loss_heatmap": a * 100 * (kp_vis["heatmap"]
                                   - kp_aud["heatmap"]).abs().mean(),
        "loss_jacobian": a * (kp_vis["jacobian"]
                              - kp_aud["jacobian"]).abs().mean()}
    layer_w = w.get("perceptual", ())
    if train_params.get("generator", "not") == "audio" and sum(layer_w):
        frames = torch.arange(0, T, 4, device=driving.device)
        F_ = len(frames)
        rows = (frames[:, None] + torch.arange(B, device=driving.device)
                [None] * T).reshape(-1)                  # frame-major
        with batch_statistics(nets["kp_detector"]) as detector:
            kp_src = detector(example)
        kp_d = {k: kp_aud[k][rows] for k in ("value", "jacobian")}
        kp_s = {k: kp_src[k].repeat(F_, 1, 1) if k == "value"
                else kp_src[k].repeat(F_, 1, 1, 1)
                for k in ("value", "jacobian")}
        gen = nets["generator"]
        feats = gen.encode_source(example)
        fake = gen.decode(example.repeat(F_, 1, 1, 1),
                          feats.repeat(F_, 1, 1, 1), kp_d, kp_s)
        real = _nchw(driving[rows])
        vgg = nets["vgg"]
        total = 0.0
        for scale in train_params["scales"]:
            xf = vgg(ops.blur_downsample(fake, scale))
            yf = vgg(ops.blur_downsample(real, scale))
            for lw, x, y in zip(layer_w, xf, yf):
                total = total + lw * (x - y.detach()).abs().mean()
        terms["perceptual"] = total
    terms["total"] = sum(terms.values())
    return terms


class Adam:
    """Adam over named leaves: m, v, the bias-corrected update."""

    def __init__(self, params: dict, lr: float, b1: float = 0.5,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = \
            params, lr, b1, b2, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = p.grad
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p -= self.lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt()
                                               + self.eps)


def follow(nets: dict, trainable: tuple, batches: list, train_params: dict,
           lr: float) -> dict:
    """Run ``len(batches)`` reference steps from the networks' weights ->
    {'losses': [each step's terms as floats], 'first_grad': {leaf: norm of
    its first gradient}, 'change': {leaf: norm of its change over the
    steps}}."""
    params = {f"{n}.{k}": p for n in trainable
              for k, p in nets[n].named_parameters()}
    start = {k: p.detach().clone() for k, p in params.items()}
    for name, net in nets.items():
        net.requires_grad_(name in trainable)
        net.train(name in trainable)
    opt = Adam(params, lr)
    out = {"losses": []}
    for i, batch in enumerate(batches):
        for p in params.values():
            p.grad = None
        terms = part1_loss(nets, batch, train_params)
        terms["total"].backward()
        out["losses"].append({k: float(v.detach()) for k, v in terms.items()})
        if i == 0:
            out["first_grad"] = {k: float(p.grad.norm())
                                 for k, p in params.items()}
        opt.step()
    out["change"] = {k: float((p.detach() - start[k]).norm())
                     for k, p in params.items()}
    return out
