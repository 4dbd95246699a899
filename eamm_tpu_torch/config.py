"""Model factories from the JAX package's config dict schema
(``model_params.{common,audio,kp_detector,generator}_params``,
``train_params.jaco_net``); see ``eamm_tpu/config.py``.  The dict is
passed in: this module reads no files."""
from __future__ import annotations

from eamm_tpu_torch.models import (ATNet, KPDetector, KPDetectorA,
                                   OcclusionAwareGenerator)


def _check_jacobian(params: dict) -> None:
    if not params.get("estimate_jacobian", True):
        raise NotImplementedError("the port's keypoint heads always estimate "
                                  "Jacobians (estimate_jacobian=True)")


def build_kp_detector(config: dict) -> KPDetector:
    mp = config["model_params"]
    kp, common = mp["kp_detector_params"], mp["common_params"]
    _check_jacobian(common)
    return KPDetector(num_kp=common["num_kp"],
                      num_channels=common.get("num_channels", 3),
                      temperature=kp["temperature"],
                      block_expansion=kp["block_expansion"],
                      max_features=kp["max_features"],
                      num_blocks=kp["num_blocks"],
                      scale_factor=kp.get("scale_factor", 1))


def build_kp_detector_a(config: dict) -> KPDetectorA:
    mp = config["model_params"]
    audio = mp["audio_params"]
    _check_jacobian(audio)
    return KPDetectorA(num_kp=audio["num_kp"],
                       temperature=mp["kp_detector_params"]["temperature"])


def build_generator(config: dict) -> OcclusionAwareGenerator:
    mp = config["model_params"]
    g, common = mp["generator_params"], mp["common_params"]
    _check_jacobian(common)
    return OcclusionAwareGenerator(
        num_channels=common.get("num_channels", 3),
        num_kp=common["num_kp"],
        block_expansion=g["block_expansion"],
        max_features=g["max_features"],
        num_down_blocks=g["num_down_blocks"],
        num_bottleneck_blocks=g["num_bottleneck_blocks"],
        estimate_occlusion_map=g.get("estimate_occlusion_map", False),
        dense_motion_params=g.get("dense_motion_params"))


def build_atnet(config: dict) -> ATNet:
    jaco_net = (config.get("train_params") or {}).get("jaco_net") or "cnn"
    if jaco_net != "cnn":
        raise NotImplementedError(f"jaco_net={jaco_net!r}: the port has the "
                                  "'cnn' decoder only (ROADMAP Queue 1)")
    return ATNet()


def build_all(config: dict) -> dict:
    """The four models of the neutral render, by their variable names."""
    return {"generator": build_generator(config),
            "kp_detector": build_kp_detector(config),
            "kp_detector_a": build_kp_detector_a(config),
            "audio_feature": build_atnet(config)}
