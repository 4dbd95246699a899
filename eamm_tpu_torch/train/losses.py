"""Training losses: keypoint mimic (part1), the emotion residual (part2),
the perceptual pyramid, LSGAN and feature matching.

Counterpart of ``eamm_tpu/train/losses.py``.  Images are NHWC, as in JAX;
the VGG and discriminator outputs may be in any layout, since every term
is a mean.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from eamm_tpu_torch.ops.antialias import antialias_downsample


def image_pyramid(x: torch.Tensor, scales) -> dict:
    """Anti-aliased pyramid {'prediction_<scale>': [B, h, w, C]}."""
    return {f"prediction_{scale}": antialias_downsample(x, scale)
            for scale in scales}


def mean_abs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def kp_mimic_loss(kp_vis: dict, kp_audio: dict, weight: float) -> dict:
    """Part1's losses between the visual and the audio keypoints over all
    frames (leading [B*T]): the value target detached, the heatmap term
    times 100."""
    return {
        "loss_value": weight * mean_abs(kp_vis["value"].detach(),
                                        kp_audio["value"]),
        "loss_heatmap": weight * 100.0 * mean_abs(kp_vis["heatmap"],
                                                  kp_audio["heatmap"]),
        "loss_jacobian": weight * mean_abs(kp_vis["jacobian"],
                                           kp_audio["jacobian"]),
    }


# keypoints that take part2's emotion displacement, in the order of the
# four-keypoint heads' output (inference's linear_3 moves 1, 4 and 6)
EMO_KP_INDICES = (1, 4, 6, 8)


def emotion_residual_loss(kp_vis: dict, kp_audio: dict, kp_emo: dict,
                          logits: torch.Tensor, labels: torch.Tensor,
                          weight: float, ten_kp: bool,
                          classify: bool = True) -> dict:
    """Part2's residual |kp_vis - (kp_audio + kp_emo)| (value target
    detached) on all ten keypoints (``ten_kp``) or on EMO_KP_INDICES, each
    of those a mean of its own; and the cross-entropy of the emotion
    ``logits`` [B*T, 8] against integer ``labels`` [B*T], its mean over
    B*T (0 unless ``classify``)."""
    if ten_kp:
        loss_value = mean_abs(kp_vis["value"].detach(),
                              kp_audio["value"] + kp_emo["value"]) * weight
        loss_jac = mean_abs(kp_vis["jacobian"],
                            kp_audio["jacobian"] + kp_emo["jacobian"]) * weight
    else:
        loss_value = loss_jac = 0.0
        for j, i in enumerate(EMO_KP_INDICES):
            loss_value = loss_value + mean_abs(
                kp_vis["value"][:, i].detach(),
                kp_audio["value"][:, i] + kp_emo["value"][:, j]) * weight
            loss_jac = loss_jac + mean_abs(
                kp_vis["jacobian"][:, i],
                kp_audio["jacobian"][:, i] + kp_emo["jacobian"][:, j]) * weight
    out = {"loss_value": loss_value, "loss_jacobian": loss_jac}
    out["loss_classify"] = (F.cross_entropy(logits, labels.long())
                            if classify else logits.new_zeros(()))
    return out


def perceptual_loss(vgg_apply, pyramid_real: dict, pyramid_generated: dict,
                    scales, layer_weights) -> torch.Tensor:
    """Multi-scale VGG19 L1, the real features detached."""
    total = 0.0
    for scale in scales:
        x_feats = vgg_apply(pyramid_generated[f"prediction_{scale}"])
        y_feats = vgg_apply(pyramid_real[f"prediction_{scale}"])
        for w, xf, yf in zip(layer_weights, x_feats, y_feats):
            total = total + w * mean_abs(xf, yf.detach())
    return total


def lsgan_generator_loss(disc_out: dict, scales, weight: float):
    """(1 - D(G))^2."""
    total = 0.0
    for scale in scales:
        total = total + weight * torch.mean(
            (1.0 - disc_out[f"prediction_map_{scale}"]) ** 2)
    return total


def lsgan_discriminator_loss(disc_real: dict, disc_fake: dict, scales,
                             weight: float):
    """(1 - D(x))^2 + D(G)^2."""
    total = 0.0
    for scale in scales:
        total = total + weight * torch.mean(
            (1.0 - disc_real[f"prediction_map_{scale}"]) ** 2
            + disc_fake[f"prediction_map_{scale}"] ** 2)
    return total


def feature_matching_loss(disc_real: dict, disc_fake: dict, scales,
                          layer_weights):
    """L1 between the discriminator's feature maps of real and generated
    images; a zero weight skips its layer."""
    total = 0.0
    for scale in scales:
        reals = disc_real[f"feature_maps_{scale}"]
        fakes = disc_fake[f"feature_maps_{scale}"]
        for w, a, b in zip(layer_weights, reals, fakes):
            if w == 0:
                continue
            total = total + w * mean_abs(a, b)
    return total
