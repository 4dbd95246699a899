"""The FOMM evaluation protocols: reconstruction and animation.

Counterpart of ``eamm_tpu/infer/animate.py``:

- ``reconstruction`` drives each clip's first frame with the clip's own
  per-frame keypoints and reports L1, PSNR, SSIM and AKD (keypoints
  detected again on the reconstruction) against the clip, and AED (the
  mean L2 distance of two emotion-trunk embeddings) when given the
  embedding;
- ``animate`` drives one clip's example image with another clip's
  keypoints (``PairedDataset``), moved relative to the first driving
  frame, scaled by the convex hulls' area ratio with ``adapt_scale``.

Both run the models in eval mode (running statistics, the eval conv forms)
on the device their parameters are on, through the generator's
``encode_source`` once and ``decode`` of the clip's frames as one batch.
"""
from __future__ import annotations

import numpy as np
import torch

from eamm_tpu_torch.ops.motion import convex_hull_area, normalize_kp
from eamm_tpu_torch.utils.metrics import clip_metrics


def _device(models: dict) -> torch.device:
    return next(models["generator"].parameters()).device


def _frames(x, device) -> torch.Tensor:
    """Host [T, H, W, 3] float frames -> NCHW float32 on ``device``."""
    return torch.as_tensor(np.asarray(x, np.float32)).to(device) \
        .permute(0, 3, 1, 2)


def _keypoints(models: dict, frames: torch.Tensor) -> dict:
    kp = models["kp_detector"](frames)
    return {k: v for k, v in kp.items() if k != "heatmap"}


def _render(models: dict, source: torch.Tensor, kp_driving: dict,
            kp_source: dict) -> torch.Tensor:
    """The [1, 3, H, W] source driven by T keypoints -> [T, H, W, 3]."""
    gen = models["generator"]
    T = kp_driving["value"].shape[0]
    kp_s = {k: v.expand(T, *v.shape[1:]) for k, v in kp_source.items()}
    return gen.decode(source, gen.encode_source(source), kp_driving,
                      kp_s).permute(0, 2, 3, 1)


@torch.no_grad()
def reconstruction(models: dict, dataset, num_videos: int = 10,
                   emotion_feature_fn=None) -> dict:
    """Self-reconstruction of the first ``num_videos`` clips of
    ``dataset``: {'reconstruction_l1', '_psnr', '_ssim', '_akd', ['_aed'],
    'videos'}, each metric the mean over clips.  ``emotion_feature_fn``
    takes NCHW frames on the device to [T, D] embeddings."""
    for m in models.values():
        m.eval()
    device = _device(models)
    per_clip = []
    for i in range(min(num_videos, len(dataset))):
        driving = _frames(dataset[i]["driving"], device)       # [T,3,H,W]
        kp_d = _keypoints(models, driving)
        pred = _render(models, driving[:1], kp_d,
                       _keypoints(models, driving[:1]))
        kp_pred = _keypoints(models, pred.permute(0, 3, 1, 2))
        m = clip_metrics(pred, driving.permute(0, 2, 3, 1),
                         kp_pred=kp_pred["value"], kp_target=kp_d["value"])
        if emotion_feature_fn is not None:
            m["aed"] = float(torch.linalg.vector_norm(
                emotion_feature_fn(pred.permute(0, 3, 1, 2))
                - emotion_feature_fn(driving), dim=-1).mean())
        per_clip.append(m)
    out = {"reconstruction_" + k: float(np.mean([m[k] for m in per_clip]))
           for k in (per_clip[0] if per_clip else {})}
    out["videos"] = len(per_clip)
    out.setdefault("reconstruction_l1", float("nan"))
    return out


@torch.no_grad()
def animate(models: dict, paired_dataset, relative: bool = True,
            adapt_scale: bool = False) -> list[np.ndarray]:
    """Cross-identity animation of each pair -> [T, H, W, 3] float32 numpy
    clips in [0, 1]."""
    for m in models.values():
        m.eval()
    device = _device(models)
    outputs = []
    for i in range(len(paired_dataset)):
        pair = paired_dataset[i]
        driving = _frames(pair["driving_driving"], device)
        source = _frames(np.asarray(pair["source_example_image"])[None],
                         device)
        kp_d = _keypoints(models, driving)
        kp_s = _keypoints(models, source)
        kp_initial = {k: v[:1] for k, v in kp_d.items()}
        scale = 1.0
        if adapt_scale:
            scale = float(np.sqrt(convex_hull_area(
                kp_s["value"][0].cpu().numpy())) / np.sqrt(convex_hull_area(
                    kp_initial["value"][0].cpu().numpy())))
        kp_norm = normalize_kp(
            {k: v[0] for k, v in kp_s.items()}, kp_d,
            {k: v[0] for k, v in kp_initial.items()},
            use_relative_movement=relative, use_relative_jacobian=relative,
            adapt_movement_scale=scale)
        outputs.append(_render(models, source, kp_norm, kp_s)
                       .float().cpu().numpy())
    return outputs
