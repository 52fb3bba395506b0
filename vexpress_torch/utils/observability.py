"""Device traces. Counterpart of vexpress_tpu/utils/observability.py's
`device_trace`, which wraps jax.profiler."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[Optional[str]]:
    """torch.profiler trace of the enclosed work: host operations and, where a
    CUDA device is present, its kernels, written on exit as one Chrome trace
    file (`*.pt.trace.json`, for Perfetto or chrome://tracing) into `log_dir`.
    Yields that file's path; with an empty `log_dir` it traces nothing and
    yields None."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"vexpress_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}"
                                 ".pt.trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
