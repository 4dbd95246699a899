"""PyTorch and CUDA port of eamm_tpu for NVIDIA Hopper.

The JAX package ``eamm_tpu`` stays the reference; this package imports
nothing of it and no JAX.  Layout mirrors it: ``ops/``, ``models/``,
``infer/``, ``config.py``, ``compat/`` (the reference's checkpoints),
``data/`` (the demo's host side), ``serve.py``, ``serve_http.py`` and
``cli/`` (``eamm-torch-serve``, ``eamm-torch-demo``), plus ``csrc/``
(CUDA sources) and ``kernels/`` (their build and ctypes binding).  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; a kernel wrapper takes its plain PyTorch
version only for a CPU tensor.
"""
