from eamm_tpu_torch.models.audio import ATNet
from eamm_tpu_torch.models.dense_motion import DenseMotionNetwork
from eamm_tpu_torch.models.emotion import EmotionK, EmotionMap
from eamm_tpu_torch.models.generator import OcclusionAwareGenerator
from eamm_tpu_torch.models.kp_detector import KPDetector, KPDetectorA

__all__ = ["ATNet", "DenseMotionNetwork", "EmotionK", "EmotionMap",
           "KPDetector", "KPDetectorA", "OcclusionAwareGenerator"]
