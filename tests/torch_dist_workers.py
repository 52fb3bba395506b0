"""Multi-process jobs of the port's data-parallel tests (tests/test_torch_parallel.py,
tests/test_torch_train.py): `run_ranks` spawns one process a rank, joins them
in a gloo group on a free localhost port and returns what each rank's job
returned. This module imports only torch, numpy and vexpress_torch, so that a
spawned process does not import JAX.

Nothing here can hang a test run: the group's collectives time out after 60 s,
and `run_ranks` kills every rank and raises when one fails or when the job
outlives its timeout.
"""

from __future__ import annotations

import datetime
import os
import pathlib
import socket
import tempfile
import time
from typing import Any, Callable, List

import numpy as np
import torch

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, port: int, out_dir: str, job: Callable, args: tuple) -> None:
    import torch.distributed as dist

    from vexpress_torch.parallel import mesh

    torch.set_num_threads(1)
    mesh.TIMEOUT = COLLECTIVE_TIMEOUT
    mesh.initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo")
    try:
        result = job(mesh.create_mesh(), *args)
        torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(job: Callable, world: int, *args, timeout: float = 120.0) -> List[Any]:
    """`job(mesh, *args)` on `world` spawned ranks of one gloo group; the
    list of their return values, by rank."""
    with tempfile.TemporaryDirectory(prefix="vx_ranks_") as out_dir:
        ctx = torch.multiprocessing.start_processes(
            _entry, args=(world, free_port(), out_dir, job, args), nprocs=world, join=False,
            start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{job.__name__} on {world} ranks outlived {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(pathlib.Path(out_dir) / f"{r}.pt", weights_only=False)
                for r in range(world)]


# ------------------------------------------------------------------ jobs


def toy_predict(lat, t, w_idx, cond):
    """tests/test_parallel.py's toy prediction."""
    mixed = torch.mean(lat, dim=1, keepdim=True) + 0.1 * lat
    return torch.tanh(mixed + 0.001 * t)


def window_step_job(mesh, latents: np.ndarray, length: int, size: int, overlap: int,
                    n_steps: int, window_group: int, named_shapes: dict):
    """The port's window_parallel_step on the toy prediction for DDIM's
    `n_steps` steps; and the ZeRO-2 owner map of tensors of `named_shapes`
    as every rank computes it."""
    import torch.distributed as dist

    from vexpress_torch.diffusion.ddim import DDIMScheduler
    from vexpress_torch.parallel import shard_opt_state_zero2, window_parallel_step
    from vexpress_torch.pipelines.context import compute_context_windows

    windows, inv = compute_context_windows(length, size, overlap)
    sched = DDIMScheduler()
    step = window_parallel_step(toy_predict, sched, windows, inv, n_steps, mesh,
                                window_group=window_group)
    lat = torch.from_numpy(latents)
    for t in sched.timesteps(n_steps):
        lat = step(lat, int(t), None)
    owners = shard_opt_state_zero2({n: torch.empty(s) for n, s in named_shapes.items()}, mesh)
    every = [None] * mesh.size
    dist.all_gather_object(every, owners)
    return dict(latents=lat.numpy(), owners=every)


def pipeline_job(mesh, models, state_path: str, calls: list):
    """The port's pipeline on the CPU with the weights at `state_path`, one
    sharded call of each keyword set in `calls` (return_latents)."""
    from vexpress_torch.pipelines.pipeline import VExpressPipeline

    pipe = VExpressPipeline(models, device="cpu")
    state = torch.load(state_path, weights_only=True)
    for name, mod in pipe.components().items():
        mod.load_state_dict(state[name])
    return [pipe(mode="sharded", mesh=mesh, return_latents=True, **kw) for kw in calls]


def dp_step_job(mesh, models, state_path: str, cfg, batch: dict, draws: dict):
    """One data-parallel train_step on this rank's row of `batch`, with the
    global batch's `draws` in place of sample_draws: the step's loss, the
    averaged gradients the optimizer saw (by parameter name) and the
    parameters after the update."""
    from vexpress_torch.pipelines.pipeline import VExpressPipeline
    from vexpress_torch.train import train_step as tts

    pipe = VExpressPipeline(models, device="cpu")
    state = torch.load(state_path, weights_only=True)
    for name, mod in pipe.components().items():
        mod.load_state_dict(state[name])
    comps = pipe.components()
    optimizer, mask = tts.make_optimizer(comps, cfg, mesh)
    step_fn, _ = tts.build_train_step(pipe, cfg, optimizer)
    tts.sample_draws = lambda *a, **k: draws
    b = batch["target_images"].shape[0] // mesh.size
    mine = {k: torch.from_numpy(v[mesh.rank * b:(mesh.rank + 1) * b]) for k, v in batch.items()}
    names = {id(p): f"{m}.{n}" for m, mod in comps.items() for n, p in mod.named_parameters()}
    seen = {}
    inner_step = optimizer.inner.step

    def spy():
        seen.update({names[id(p)]: p.grad.clone() for p in optimizer.params})
        return inner_step()

    optimizer.inner.step = spy
    _, metrics = step_fn(tts.TrainState(comps, optimizer), mine, torch.Generator())
    params = {names[id(p)]: p.detach().clone() for p in optimizer.params}
    return dict(loss=float(metrics["loss"]), grads=seen, params=params,
                state_tensors=sum(len(optimizer.inner.state[p]) > 0 for p in optimizer.params))


# ckpt_job's two plans: (the optimizer's settings, mini-steps before the
# checkpoint, mini-steps in all). The 8-bit Adam saves at an update; AdamW
# accumulates 2 mini-steps and saves halfway through an accumulation.
CKPT_PLANS = {"adam8bit": (dict(reduce_optimizer_memory=True), 2, 3),
              "accumulate": (dict(gradient_accumulation_steps=2), 3, 4)}


def ckpt_setup(models, plan: str, mesh=None):
    """A tiny stage-3 run of `plan` from seeded weights: (TrainState, step_fn)."""
    from vexpress_torch.io import init_pipeline_random_
    from vexpress_torch.pipelines.pipeline import VExpressPipeline
    from vexpress_torch.train import train_step as tts

    pipe = init_pipeline_random_(VExpressPipeline(models, device="cpu"), seed=0)
    cfg = tts.TrainConfig.stage("stage_3", num_frames=2, learning_rate=1e-3,
                                lip_loss_weight=2.0, **CKPT_PLANS[plan][0])
    optimizer, _ = tts.make_optimizer(pipe.components(), cfg, mesh)
    step_fn, _ = tts.build_train_step(pipe, cfg, optimizer)
    return tts.TrainState(pipe.components(), optimizer), step_fn


def ckpt_steps(state, step_fn, batch: dict, until: int, rank: int = 0, world: int = 1):
    """Mini-steps up to `until` on this rank's rows of `batch`; mini-step i
    draws from a generator seeded 100 + i, so a resumed run draws what an
    uninterrupted one does."""
    b = batch["target_images"].shape[0] // world
    mine = {k: torch.from_numpy(v[rank * b:(rank + 1) * b]) for k, v in batch.items()}
    while state.step < until:
        state, _ = step_fn(state, mine, torch.Generator().manual_seed(100 + state.step))
    return state


def ckpt_job(mesh, models, batch: dict, ckpt_root: str, resume: bool):
    """Each plan on this rank: uninterrupted, saving its checkpoint on the
    way (resume=False), or restored from that checkpoint (resume=True);
    returns the trainable tensors at the end, by plan."""
    from vexpress_torch.io.checkpoints import restore_train_state, save_train_state

    out = {}
    for plan, (_, at, until) in CKPT_PLANS.items():
        state, step_fn = ckpt_setup(models, plan, mesh)
        path = os.path.join(ckpt_root, plan)
        if resume:
            restore_train_state(os.path.join(path, f"checkpoint-{at}"), state)
        else:
            state = ckpt_steps(state, step_fn, batch, at, mesh.rank, mesh.size)
            save_train_state(path, at, state)
        state = ckpt_steps(state, step_fn, batch, until, mesh.rank, mesh.size)
        out[plan] = [p.detach().clone() for p in state.optimizer.params]
    return out
