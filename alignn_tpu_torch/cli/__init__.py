"""Command-line entry points of the port (``python -m
alignn_tpu_torch.cli.ff``)."""
