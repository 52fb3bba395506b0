"""vexpress_torch: the PyTorch / CUDA (NVIDIA H100) port of vexpress_tpu.

The sub-packages mirror vexpress_tpu's (`ops`, `models`, `diffusion`,
`pipelines`, `io`, `train`) with the same class and function names. Nothing here
imports JAX or vexpress_tpu. Entry points run on the CUDA device unless the
caller passes `device="cpu"`.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
