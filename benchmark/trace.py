"""A torch.profiler session over part of a run, reduced in memory to what
the per-layer readers take: the device operations as (name, start, end)
intervals, the host's calls into the CUDA runtime, the traced span, the
device's busy time (the union of its operations' intervals) and a
breakdown. The profiler records the device's activity alone (CUPTI: the
kernels, copies and the runtime calls that issue them), not the host's
PyTorch operators, whose recording slows the host's issue and so would
make idle time of its own. Nothing is written to disk."""

from __future__ import annotations

import bisect
import collections
import re
from typing import Dict, List, Tuple

import torch

# device-time families of kernel names, first match wins (a copy of
# vexpress_torch/tools/common.py FAMILIES, frozen with the benchmark)
FAMILIES = [
    ("flash_fwd (K1, K2)", r"flash_fwd"),
    ("flash_bwd (K1 backward)", r"flash_bwd"),
    ("layout nchw<->nhwc (cuDNN)", r"nchwToNhwc|nhwcToNchw"),
    ("conv (cuDNN)", r"fprop|dgrad|wgrad|conv|cudnn|implicit_gemm"),
    ("gemm bf16 (cuBLAS)", r"nvjet|bf16.*gemm|gemm.*bf16|cutlass"),
    ("gemm fp32 (cuBLAS)", r"gemm"),
    ("group_norm", r"group_norm|GroupNorm|RowwiseMoments|ComputeFusedParams"),
    ("layer_norm", r"layer_norm|LayerNorm"),
    ("softmax", r"softmax"),
    ("median filter", r"[Mm]edian"),
    ("index/scatter/gather", r"index|scatter|gather"),
    ("reduce", r"reduce"),
    ("copy/cat/transpose", r"copy|Cat|transpose|Memcpy|Memset"),
    ("elementwise", r"elementwise|vectorized|unrolled|upsample"),
]


def family(name: str) -> str:
    for fam, pat in FAMILIES:
        if re.search(pat, name):
            return fam
    return "other"


Interval = Tuple[str, int, int]  # name, start ns, end ns


def _annotation(event) -> bool:
    """A `record_function` span, which the profiler also draws on the
    device's row (the optimizer's step, say): no work of the device."""
    flag = getattr(event, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


class Trace:
    """The reduced trace of one profiler session."""

    def __init__(self, device_ops: List[Interval], host_ops: List[Interval]):
        """`host_ops`: the host's calls into the CUDA runtime or driver."""
        self.device_ops = sorted(device_ops, key=lambda e: e[1])
        self.host_ops = sorted(host_ops, key=lambda e: e[1])
        every = self.device_ops + self.host_ops
        self.start = min(e[1] for e in every)
        self.end = max(e[2] for e in every)

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        device, host = [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.profiler.kineto_results.events():
            start, dur = e.start_ns(), e.duration_ns()
            if dur <= 0 or _annotation(e):
                continue
            if e.device_type() == cuda:
                device.append((e.name(), start, start + dur))
            elif e.name().startswith("cu"):  # cudaLaunchKernel, cudaMemcpyAsync, ...
                host.append((e.name(), start, start + dur))
        if not device:
            raise RuntimeError("the profiler saw no device operation")
        return cls(device, host)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        """The intervals of the traced span in which no device operation ran."""
        out, at = [], self.start
        for _, s, e in self.device_ops:
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if self.end > at:
            out.append((at, self.end))
        return out

    @property
    def busy_s(self) -> float:
        return self.window_s - sum(b - a for a, b in self.gaps()) / 1e9

    def device_seconds(self, pattern: str) -> float:
        """Summed device time of the operations whose name matches `pattern`."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.device_ops if rx.search(n)) / 1e9

    def by_family(self) -> Dict[str, float]:
        fams: "collections.Counter[str]" = collections.Counter()
        for n, s, e in self.device_ops:
            fams[family(n)] += (e - s) / 1e9
        return dict(fams.most_common())

    def top_operations(self, n: int = 25) -> List[Tuple[str, float]]:
        """The device operations with the most time, by name (seconds)."""
        ops: "collections.Counter[str]" = collections.Counter()
        for name, s, e in self.device_ops:
            ops[name] += (e - s) / 1e9
        return ops.most_common(n)

    def idle_by_host(self) -> Dict[str, float]:
        """Idle seconds by what the host was doing: each gap is put on the
        last runtime call that had started by the gap's end (a launch: the
        host issues too slowly; a copy or a synchronize: it waits)."""
        starts = [s for _, s, _ in self.host_ops]
        out: "collections.Counter[str]" = collections.Counter()
        for a, b in self.gaps():
            i = bisect.bisect_right(starts, b) - 1
            out[self.host_ops[i][0] if i >= 0 else "(before the first host op)"] += (b - a) / 1e9
        return dict(out.most_common())

    def breakdown(self, n: int = 10) -> Dict[str, list]:
        return {"device_ops": [[k, v] for k, v in list(self.by_family().items())[:n]],
                "idle_gaps": [[k, v] for k, v in list(self.idle_by_host().items())[:n]]}


def profile():
    """A profiler of the device's activity, kept in memory."""
    from torch.profiler import ProfilerActivity, profile as _profile

    return _profile(activities=[ProfilerActivity.CUDA])

