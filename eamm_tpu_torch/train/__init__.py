"""Part1 training (``train_part1`` and ``train_part1_fine_tune``): steps,
losses, the optimizer, checkpoints, metrics and the loop behind
``eamm-torch-run`` (``cli/run.py``)."""
