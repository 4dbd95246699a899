"""Command-line entry points: ``eamm-torch-serve`` (``cli/serve.py``) and
``eamm-torch-demo`` (``cli/demo.py``)."""
