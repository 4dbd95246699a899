"""Random weights for a cell, drawn on the device from the seed.

Every float tensor of every network's state dict comes out of two large
draws from one ``torch.Generator`` on the device (uniform, then normal),
sliced and scaled per tensor by the rule of the layer it belongs to:

- convolutions, transposed convolutions and linear layers: U(+-1/sqrt(fan
  in)), weights and biases (PyTorch's defaults);
- LSTMs: U(+-1/sqrt(hidden));
- BatchNorm: weight 1, bias 0, running mean U(-0.5, 0.5), running variance
  U(0.5, 2), so that eval-mode normalization does real work;
- the keypoint detectors' Jacobian heads: identity bias and zero weights
  (the reference's initialization, from which part1 trains the audio
  detector);
- StyleGAN2: equalized weights N(0, 1) (over lr_mul for the dense
  layers), biases as constructed.

A network named in ``trained`` stands for trained weights, in three
places where the defaults leave a random network degenerate.  Its
BatchNorm statistics are those of its own activations (one train-mode
pass over seeded smooth images, MFCCs of an enveloped noise and keypoints
near the source's, ``calibrate``): with the random statistics above,
each channel's shift swamps its spatial signal and the frames come out
all but the same grey whatever the portrait.  Its keypoint
heads' logits x10 (peaked heatmaps at temperature 0.1, keypoints spread
over the face instead of all at the centre), its Jacobian head's weights
U(+-0.1/sqrt(fan in)) (Jacobians off the identity; with both detectors at
the identity, part1's Jacobian loss is a difference of roundings and its
gradient's signs are noise).

The tensors are float32, the type the program receives them in (the
program casts what it serves in bfloat16 itself).  The layouts come from
the reference networks built on the meta device.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from perfbench.reference import nets as R

UNIFORM, NORMAL, FILL = "uniform", "normal", "fill"
GAIN = 10.0          # of a trained detector's keypoint logits


def _rules(model: nn.Module, trained: bool = False) -> dict:
    """{state key: (kind, a, b)}: uniform in [a, b), normal times a, or
    filled with a (b the per-kp pattern for a Jacobian bias)."""
    rules, heads = {}, {}
    for prefix, m in model.named_modules():
        p = f"{prefix}." if prefix else ""
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            rules[p + "weight"] = (UNIFORM, -bound, bound)
            if m.bias is not None:
                rules[p + "bias"] = (UNIFORM, -bound, bound)
        elif isinstance(m, nn.LSTM):
            bound = 1.0 / math.sqrt(m.hidden_size)
            for name, _ in m.named_parameters():
                rules[p + name] = (UNIFORM, -bound, bound)
        elif isinstance(m, nn.BatchNorm2d):
            rules.update({p + "weight": (FILL, 1.0, None),
                          p + "bias": (FILL, 0.0, None),
                          p + "running_mean": (UNIFORM, -0.5, 0.5),
                          p + "running_var": (UNIFORM, 0.5, 2.0)})
        elif isinstance(m, R.EqualLinear):
            rules[p + "weight"] = (NORMAL, 1.0 / m.lr_mul, None)
            rules[p + "bias"] = (FILL, float(m.bias_init), None)
        elif isinstance(m, R.ModulatedConv):
            rules[p + "weight"] = (NORMAL, 1.0, None)
        elif isinstance(m, (R.FusedLeakyReLU, R.ToRGB)):
            rules[p + "bias"] = (FILL, 0.0, None)
        if isinstance(m, (R.KPDetector, R.KPDetectorA)):
            bound = 0.1 / math.sqrt(m.jacobian.weight[0].numel())
            heads[p + "jacobian.weight"] = ((UNIFORM, -bound, bound)
                                            if trained else (FILL, 0.0, None))
            heads[p + "jacobian.bias"] = (FILL, None, "identity")
            if trained:
                bound = GAIN / math.sqrt(m.kp.weight[0].numel())
                heads[p + "kp.weight"] = heads[p + "kp.bias"] = (
                    UNIFORM, -bound, bound)
    rules.update(heads)             # over the heads' convolution rule
    return rules


def draw(config: dict, seed: int, device, trained: tuple = (),
         with_vgg: bool = False) -> dict:
    """{network: state dict} of the reference networks of ``config`` (and
    VGG19 with ``with_vgg``), every tensor on ``device``; the networks
    named in ``trained`` as trained ones (above)."""
    with torch.device("meta"):
        nets = R.build(config)
        if with_vgg:
            nets["vgg"] = R.Vgg19()
    plan = []                                   # (net, key, shape, rule)
    for name in sorted(nets):
        rules = _rules(nets[name], name in trained)
        for key, t in nets[name].state_dict().items():
            if not t.is_floating_point():
                continue
            if key not in rules:
                raise KeyError(f"no draw rule for {name}.{key}")
            plan.append((name, key, t.shape, rules[key]))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = {kind: sum(math.prod(s) for _, _, s, r in plan if r[0] == kind)
             for kind in (UNIFORM, NORMAL)}
    pools = {UNIFORM: torch.rand(sizes[UNIFORM], generator=gen,
                                 device=device),
             NORMAL: torch.randn(sizes[NORMAL], generator=gen,
                                 device=device)}
    offset = {UNIFORM: 0, NORMAL: 0}
    out = {name: {} for name in nets}
    for name, key, shape, (kind, a, b) in plan:
        n = math.prod(shape)
        if kind == FILL:
            if b == "identity":
                t = torch.tensor([1.0, 0.0, 0.0, 1.0], device=device).repeat(
                    n // 4)
            else:
                t = torch.full((n,), a, device=device)
        else:
            t = pools[kind][offset[kind]:offset[kind] + n]
            offset[kind] += n
            t = a + (b - a) * t if kind == UNIFORM else t * a
        out[name][key] = t.reshape(shape)
    for name, net in nets.items():
        for key, t in net.state_dict().items():
            if not t.is_floating_point():
                out[name][key] = torch.zeros(t.shape, dtype=t.dtype,
                                             device=device)
    calibrate(config, out, trained, seed, device)
    return out


@torch.no_grad()
def calibrate(config: dict, sds: dict, trained: tuple, seed: int,
              device) -> None:
    """Set the BatchNorm statistics of the ``trained`` networks in
    ``sds`` to those of one train-mode pass: the detector and ATNet over 4
    smooth images (and 16 MFCC windows each of an enveloped noise), the
    generator encoding them and decoding them at keypoints 0.05 from the
    source's."""
    from perfbench.reference import ops
    from perfbench.traffic import smooth_images, waveforms
    names = [name for name in ("kp_detector", "audio_feature", "generator")
             if name in trained]
    if not names:
        return
    nets = R.loaded(config, sds, names)
    gen = torch.Generator(device=device).manual_seed(int(seed) + 2)
    images = smooth_images(4, gen, device).permute(0, 3, 1, 2)

    def measure(net, forward):
        norms = [m for m in net.modules() if isinstance(m, nn.BatchNorm2d)]
        for m in norms:
            m.reset_running_stats()
            m.momentum = None                # the pass's own statistics
        net.train()
        forward(net)
        net.eval()
        for key, t in net.state_dict().items():
            if key.endswith(("running_mean", "running_var")):
                sds_key[key] = t.detach().clone()

    if "kp_detector" in nets:
        sds_key = sds["kp_detector"]
        measure(nets["kp_detector"], lambda n: n(images))
    if "audio_feature" in nets:
        sds_key = sds["audio_feature"]
        import numpy as np
        wav = waveforms(4, ops.samples_for_frames(16),
                        np.random.default_rng(int(seed) + 2))
        windows = torch.stack([ops.mfcc_windows(torch.as_tensor(
            w, device=device))[:16] for w in wav])
        pose = 0.1 * torch.randn(4, 16, 6, generator=gen, device=device)
        measure(nets["audio_feature"],
                lambda n: n(images, windows, pose))
    if "generator" in nets:
        sds_key = sds["generator"]
        detector = nets.get("kp_detector") or R.loaded(
            config, sds, ["kp_detector"])["kp_detector"]
        kp_s = detector.eval()(images)
        kp_d = {"value": kp_s["value"] + 0.05 * torch.randn(
            kp_s["value"].shape, generator=gen, device=device),
            "jacobian": kp_s["jacobian"]}
        kp_s = {k: kp_s[k] for k in ("value", "jacobian")}
        measure(nets["generator"], lambda n: n.decode(
            images, n.encode_source(images), kp_d, kp_s))
