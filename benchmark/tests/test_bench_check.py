"""A tiny clip cell driven through `benchmark.run.main` on the CPU (the look
for a card skipped), with the cell's committed limit: the program reads
correct, the fp8 control does not, and every fault that a clip cell can
have, planted in the timed path, turns `correct` false."""

import contextlib

import numpy as np
import pytest
import torch

from benchmark import run, traffic
from benchmark.kinds.clip import ClipRun, frame_rms
from benchmark.tests.tiny import tiny_cell

CELLS = ["infer.ddim25.f44", "infer.dpm12.f44.fused"]
SEED = 2**31 + 11  # past 32 signed bits, as the check's seeds are


def run_tiny(name, seed=SEED):
    cell = tiny_cell(name, dtype="bfloat16", frames=6, steps=3)
    argv = ["--workload", name, "--seed", str(seed), "--seconds", "0", "--trace", "0"]
    return run.main(argv, device=torch.device("cpu"), cell=cell)


@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct(name):
    result = run_tiny(name)
    assert result["correct"] and result["attempted"] == 1 and not result["failed"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = tiny_cell(name, dtype="bfloat16", frames=6, steps=3)
    r = ClipRun(cell, SEED, torch.device("cpu"))
    inputs = traffic.clip_inputs(r.traffic, r.cfg, SEED, 0)
    ref, ctl = r.reference_planes(inputs), r.reference_planes(inputs, control=True)
    limit = cell.cell["limits"]["yuv_worst_frame_rms"]
    assert float(frame_rms(ctl, ref).max()) > limit


@contextlib.contextmanager
def patched(obj, attr, make):
    saved = getattr(obj, attr)
    setattr(obj, attr, make(saved))
    try:
        yield
    finally:
        setattr(obj, attr, saved)


def altered_answer(call):
    def wrapped(self, *a, **k):
        y, u, v = call(self, *a, **k)
        y = y.copy()
        y[-1] = np.clip(y[-1].astype(np.int16) + 24, 16, 235).astype(np.uint8)
        return y, u, v
    return wrapped


def unchanged_state(update):
    def wrapped(self, model_output, sample, *a, **k):
        return sample
    return wrapped


def half_the_windows(tables):
    def wrapped(windows, inv_counts, window_group):
        idx, w = tables(windows, inv_counts, window_group)
        w = w.copy()
        w[len(w) // 2:] = 0.0
        return idx, w
    return wrapped


def faults():
    from vexpress_torch.diffusion import ddim, dpm_solver
    from vexpress_torch.pipelines import pipeline

    return {
        "answer altered": (pipeline.VExpressPipeline, "__call__", altered_answer),
        "ddim step returns its state": (ddim.DDIMScheduler, "_update", unchanged_state),
        "dpm step returns its state": (dpm_solver.DPMSolverMultistepScheduler, "build_step",
                                       lambda build: lambda self, n, device="cpu":
                                       (lambda acc, idx, s, p, h: (s, p, h))),
        "half the windows left out": (pipeline, "_window_tables", half_the_windows),
    }


@pytest.mark.parametrize("fault", ["answer altered", "ddim step returns its state",
                                   "dpm step returns its state", "half the windows left out"])
def test_a_fault_is_not_correct(fault):
    name = CELLS[1] if fault.startswith("dpm") else CELLS[0]
    obj, attr, make = faults()[fault]
    with patched(obj, attr, make):
        result = run_tiny(name)
    assert not result["correct"]
