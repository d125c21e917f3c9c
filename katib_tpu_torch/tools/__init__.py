"""Measurement scripts of the port, each run as ``python -m katib_tpu_torch.tools.<name>``."""
