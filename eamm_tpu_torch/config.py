"""Config loading and model factories over the JAX package's config dict
schema (``model_params.{common,audio,kp_detector,generator,emotion}_params``,
``train_params.jaco_net``); see ``eamm_tpu/config.py``.  ``load_config``
reads a YAML file into that dict; the factories take the dict and read no
files."""
from __future__ import annotations

from eamm_tpu_torch.models import (ATNet, EmotionK, EmotionMap, KPDetector,
                                   KPDetectorA, OcclusionAwareGenerator)


def load_config(path: str) -> dict:
    """A YAML config file (the reference's schema, ``configs/*.yaml``) ->
    its dict.  PyYAML is imported here, so the package imports without it."""
    import yaml
    with open(path) as f:
        return yaml.safe_load(f)


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


def build_emotion_detector(config: dict | None = None,
                           kind: str = "linear") -> EmotionK | EmotionMap:
    """kind 'linear*' -> EmotionK, 'map*' -> EmotionMap.  The reference
    hard-codes block_expansion 32, max_features 1024, num_blocks 5 and
    scale 0.25; ``model_params.emotion_params`` overrides them."""
    kwargs = dict(block_expansion=32, num_channels=3, max_features=1024,
                  num_blocks=5, scale_factor=0.25, num_classes=8)
    kwargs.update(((config or {}).get("model_params") or {})
                  .get("emotion_params") or {})
    return EmotionMap(**kwargs) if kind.startswith("map") else EmotionK(**kwargs)


def build_all(config: dict, emotion_kind: str = "linear") -> dict:
    """The five models of the render, by their variable names."""
    return {"generator": build_generator(config),
            "kp_detector": build_kp_detector(config),
            "kp_detector_a": build_kp_detector_a(config),
            "audio_feature": build_atnet(config),
            "emo_detector": build_emotion_detector(config, emotion_kind)}
