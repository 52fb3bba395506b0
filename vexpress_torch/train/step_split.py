"""The split of a training step into conditioning, UNet forward, backward
and optimizer, read from marks that hooks set as the step runs: CUDA events
on the card (no synchronize inside the step), the host clock on the CPU,
where every op has ended when it returns."""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

PARTS = ("conditioning", "unet_forward", "backward", "optimizer")
MARKS = ("start", "unet_start", "unet_end", "opt_start", "opt_end")  # PARTS lie between these


class StepSplit:
    """`begin()` marks a step's start; hooks on the denoising UNet and a
    wrapper around the optimizer's `step` mark the rest; `remove()` takes
    them off again. `on_mark(name)`, where given, runs at each mark before
    it is taken (a profiler switching segments, say)."""

    def __init__(self, unet: torch.nn.Module, optimizer, device=None,
                 on_mark: Optional[Callable[[str], None]] = None):
        self.cuda = torch.device(device or "cuda").type == "cuda"
        self.steps, self.optimizer, self.on_mark = [], optimizer, on_mark
        self.hooks = [unet.register_forward_pre_hook(lambda *_: self.mark("unet_start")),
                      unet.register_forward_hook(lambda *_: self.mark("unet_end"))]
        self.inner_step = optimizer.step

        def timed_step():
            self.mark("opt_start")
            updated = self.inner_step()
            self.mark("opt_end")
            return updated

        optimizer.step = timed_step

    def begin(self):
        self.steps.append({})
        self.mark("start")

    def mark(self, name):
        if self.on_mark is not None:
            self.on_mark(name)
        if self.cuda:
            self.steps[-1][name] = torch.cuda.Event(enable_timing=True)
            self.steps[-1][name].record()
        else:
            self.steps[-1][name] = time.perf_counter()

    def _seconds(self, a, b) -> float:
        return a.elapsed_time(b) / 1e3 if self.cuda else b - a

    def splits(self) -> list:
        """Seconds of each part of each step (call after a synchronize)."""
        return [{part: self._seconds(e[a], e[b]) for part, a, b in zip(PARTS, MARKS, MARKS[1:])}
                for e in self.steps]

    def remove(self):
        for h in self.hooks:
            h.remove()
        self.optimizer.step = self.inner_step
