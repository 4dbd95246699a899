"""The benchmark of ``eamm_tpu_torch`` on NVIDIA H100 cards; see
``harness.py``.  It imports neither JAX nor the JAX package."""
