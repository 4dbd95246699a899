"""Device meshes and data parallelism: ``mesh``."""
from eamm_tpu_torch.parallel.mesh import *  # noqa: F401,F403
from eamm_tpu_torch.parallel.mesh import __all__  # noqa: F401
