"""Clip cells: V-Express inference through the port's entry,
`VExpressPipeline.__call__`, from the seeded inputs to the YUV420 planes on
the host, one caller back to back (a closed loop).

Set-up builds the pipeline on the device, loads the benchmark's seeded
weights and the run's clip inputs, and warms up with one call at the
cell's shapes (`warmup_steps`; a fused cell captures its graph there). The
window starts clips until `seconds` have passed and ends when the last one
ends. The check runs one clip of the window, drawn from the seed, through
the plain fp32 reference on the same inputs and weights, once the
program's state is freed, and compares the planes."""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import program
from .. import traffic as gen
from ..reference.pipeline import generate_clip
from ..trace import Trace, profile

WARMUP_INDEX = 1 << 30  # the warm-up clip's inputs, apart from every window clip's


def frame_rms(a, b) -> np.ndarray:
    """RMS difference of each frame over its Y, U and V samples, in levels."""
    sq = sum(((x.astype(np.float64) - y.astype(np.float64)) ** 2).reshape(x.shape[0], -1).sum(1)
             for x, y in zip(a, b))
    n = sum(int(np.prod(x.shape[1:])) for x in a)
    return np.sqrt(sq / n)


@dataclasses.dataclass
class Clip:
    index: int  # into the run's inputs
    seconds: float  # host clock, call to return
    timings: Dict[str, float]  # the pipeline's phases
    traced: bool
    planes: tuple  # the (Y, U, V) planes it returned


class ClipRun:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg, self.traffic = cell.config, cell.traffic
        self.clips: List[Clip] = []
        self.attempted = self.failed = 0
        self.trace: Optional[Trace] = None
        self.error: Optional[str] = None

    def _kwargs(self, inputs: Dict, steps: int) -> Dict:
        c, t = self.cfg, self.traffic
        return dict(inputs, width=c["width"], height=c["height"], video_length=t["frames"],
                    num_inference_steps=steps, guidance_scale=c["guidance_scale"],
                    sampler=t["sampler"], context_frames=c["context_frames"],
                    context_overlap=c["context_overlap"],
                    reference_attention_weight=c["reference_attention_weight"],
                    audio_attention_weight=c["audio_attention_weight"],
                    num_pad_audio_frames=c["num_pad_audio_frames"], seed=self.seed % (1 << 63),
                    mode=self.cell.cell["mode"], median_filter=c["median_filter"],
                    output_yuv420=True)

    def setup(self) -> None:
        self.pipe = program.pipeline(self.cfg, self.seed, self.device)
        self.inputs = [gen.clip_inputs(self.traffic, self.cfg, self.seed, i)
                       for i in range(self.traffic["pool"])]
        warm = self.cell.cell.get("warmup_steps") or self.traffic["steps"]
        self.pipe(**self._kwargs(gen.clip_inputs(self.traffic, self.cfg, self.seed, WARMUP_INDEX),
                                 warm))
        program.sync(self.device)

    def _one(self, i: int, traced: bool) -> None:
        idx = i % len(self.inputs)
        kwargs = self._kwargs(self.inputs[idx], self.traffic["steps"])
        self.attempted += 1
        t0 = time.perf_counter()
        if traced:
            with profile() as prof:
                planes = self.pipe(**kwargs)
                program.sync(self.device)
        else:
            planes = self.pipe(**kwargs)
        seconds = time.perf_counter() - t0
        self.clips.append(Clip(idx, seconds, dict(self.pipe.timings), traced, tuple(planes)))
        if traced:
            t1 = time.perf_counter()
            self.trace = Trace.from_profiler(prof)
            print(f"trace: the profiled clip {seconds!r} s, read in "
                  f"{time.perf_counter() - t1!r} s, {len(self.trace.device_ops)} device "
                  f"operations, {len(self.trace.host_ops)} runtime calls", file=sys.stderr)

    def window(self, seconds: float, trace: bool) -> float:
        """Clips back to back until `seconds` have passed; returns the
        window's length, from its start to the last clip's end. With
        `trace` one clip runs under the profiler first, and the window of
        unprofiled clips starts once its trace is read."""
        i = 0
        try:
            if trace:
                self._one(i, traced=True)
                i += 1
            t0 = time.perf_counter()
            n = 0
            while n == 0 or time.perf_counter() - t0 < seconds:
                self._one(i, traced=False)
                i, n = i + 1, n + 1
        except Exception as exc:  # the run goes on to report it
            self.failed += 1
            self.error = f"clip {i}: {type(exc).__name__}: {exc}"
            return 0.0
        return time.perf_counter() - t0

    def end_to_end(self, window_s: float) -> Dict[str, float]:
        frames = self.traffic["frames"] * sum(not c.traced for c in self.clips)
        return {"gen_frames_per_s": frames / window_s if window_s else 0.0}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.pipe = None
        program.free(self.device)

    def check(self) -> Dict[str, Dict[str, float]]:
        """The sampled clip's worst frame against the reference's."""
        rng = np.random.default_rng([self.seed, 7])
        clip = self.clips[int(rng.integers(len(self.clips)))]
        inputs = gen.clip_inputs(self.traffic, self.cfg, self.seed, clip.index)
        ref = self.reference_planes(inputs)
        limits = self.cell.cell["limits"]
        rms = float(frame_rms(clip.planes, ref).max())
        return {"yuv_worst_frame_rms": {"value": rms, "limit": limits["yuv_worst_frame_rms"]}}

    def reference_planes(self, inputs: Dict, control: bool = False):
        from ..reference.lowp import fp8_operands, plain_fp32

        mods = program.reference(self.cfg, self.seed, self.device)
        settings = gen.clip_settings(self.traffic, self.cfg)
        try:
            with plain_fp32(), (fp8_operands() if control else contextlib.nullcontext()):
                return generate_clip(mods, self.cfg, settings, inputs)
        finally:
            del mods
            program.free(self.device)

    def facts(self) -> Dict:
        """What the per-layer readers read."""
        return {"cell": self.cell, "clips": self.clips, "trace": self.trace}


Run = ClipRun



def calibrate(cell, seeds, device: torch.device, control: int):
    """Each seed's readings, the program and the reference built once and
    given each seed's weights in place: the program's first window clip
    against the reference (the lower reading), and for the first `control`
    seeds the fp8 reference against it (the upper reading)."""
    from .. import weights
    from ..reference.lowp import fp8_operands, plain_fp32
    from ..reference.pipeline import build_models

    run = ClipRun(cell, seeds[0], device)
    run.setup()
    ref = program.reference(run.cfg, seeds[0], device)
    table = weights.table(build_models(run.cfg, "meta"))
    settings = gen.clip_settings(run.traffic, run.cfg)
    for i, seed in enumerate(seeds):
        weights.fill(run.pipe.components(), table, seed)
        weights.fill(ref, table, seed, dtype=program.DTYPES[run.cfg["dtype"]])
        run.seed, run.clips = seed, []
        run.inputs = [gen.clip_inputs(run.traffic, run.cfg, seed, 0)]
        run.window(0.0, False)
        if run.failed:
            raise RuntimeError(run.error)
        clip = run.clips[0]
        t0 = time.perf_counter()
        with plain_fp32():
            planes = generate_clip(ref, run.cfg, settings, run.inputs[0])
        row = {"seed": seed, "clip_s": clip.seconds, "reference_s": time.perf_counter() - t0,
               "program": {"yuv_worst_frame_rms": float(frame_rms(clip.planes, planes).max())},
               "reference_y_std": float(planes[0].std())}
        if i < control:
            with plain_fp32(), fp8_operands():
                ctl = generate_clip(ref, run.cfg, settings, run.inputs[0])
            row["control"] = {"yuv_worst_frame_rms": float(frame_rms(ctl, planes).max())}
        yield row
