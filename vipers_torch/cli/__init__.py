"""Command-line entry points: ``python -m vipers_torch.cli.main``."""
