"""Runnable examples of the port (python -m agdiff_torch.examples.<name>)."""
