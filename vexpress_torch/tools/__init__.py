"""Measurement tools of the port, run as modules (`python -m
vexpress_torch.tools.<name>`): counterparts of the JAX package's tools/."""
