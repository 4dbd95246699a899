from eamm_tpu_torch.infer.pipeline import (EammPipeline, PipelineOptions,
                                           prepare_pose_np)

__all__ = ["EammPipeline", "PipelineOptions", "prepare_pose_np"]
