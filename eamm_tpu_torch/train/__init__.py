"""Training (``train_part1``, ``train_part1_fine_tune`` and ``train_part2``):
steps, losses, the optimizer, checkpoints, metrics, the checkpoint
visualizer and the loop behind ``eamm-torch-run`` (``cli/run.py``)."""
