"""Data-parallel processes over torch.distributed. Counterpart of
vexpress_tpu/parallel/mesh.py.

One process per device, joined in one process group: NCCL between CUDA
devices (with gloo beside it for CPU tensors), gloo on the CPU. Three parts:

  * `initialize_distributed` and `create_mesh`: the group and a small `Mesh`
    record of it (rank, size, the axis name "dp");
  * `shard_opt_state_zero2`: the ZeRO-2 counterpart. Each trainable tensor is
    owned whole by one rank, which alone keeps its optimizer state and
    updates it; gradients are all-reduced (`all_reduce_mean`), and the owner
    broadcasts the updated tensor (`broadcast_owned`). JAX shards the state's
    layout and never its math; whole-tensor ownership keeps the math too
    (the 8-bit Adam quantizes each tensor in blocks);
  * `window_parallel_step`: window-parallel inference. Rank r blends rows
    [r * per_dev, (r + 1) * per_dev) of the padded window table into an fp32
    accumulator, the accumulators are summed over the group, and the sampler
    update runs on every rank on replicated latents. JAX's
    `window_parallel_step_dynamic` exists for compiled-program reuse; PyTorch
    runs eagerly, so the two are one function here.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..pipelines.pipeline import blend_windows

AXIS = "dp"
# the longest any collective (the rendezvous included) waits for its peers
TIMEOUT = datetime.timedelta(minutes=10)
# all_reduce_mean and broadcast_owned move tensors in flat buckets of this size
BUCKET_BYTES = 256 << 20


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Join this process to the group, once (a later call does nothing).

    With `coordinator_address` ("host:port" of process 0) the group forms
    over tcp:// from `num_processes` and `process_id`. Without it, from
    torchrun's environment (env://: MASTER_ADDR, MASTER_PORT, RANK,
    WORLD_SIZE); where no WORLD_SIZE is set and no more than one process is
    asked for, the group is this process alone. A group that cannot form
    raises after `TIMEOUT`.

    `backend` defaults to NCCL for CUDA tensors (gloo for CPU tensors) when a
    CUDA device is present, else gloo; backend="gloo" puts several ranks on
    one card. The CUDA device is set to LOCAL_RANK (else the rank) modulo
    the device count before any module is built, since `resolve_device`
    reads it."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    kw: Dict[str, Any] = dict(backend=backend, timeout=TIMEOUT)
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        rank = process_id
        kw.update(init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                  rank=process_id)
    elif "WORLD_SIZE" in os.environ:
        rank = int(os.environ["RANK"])
        kw.update(init_method="env://")
    elif (num_processes or 1) > 1:
        raise ValueError(f"num_processes={num_processes} needs coordinator_address or "
                         "torchrun's environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE)")
    else:
        rank = 0
        kw.update(store=dist.HashStore(), world_size=1, rank=0)
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(**kw)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data-parallel group: this process's rank among `size`, on the one
    axis "dp" (`shape` as a JAX mesh's)."""

    group: Any
    rank: int
    size: int

    @property
    def shape(self) -> Dict[str, int]:
        return {AXIS: self.size}


def create_mesh() -> Mesh:
    """The mesh of the initialised group (`initialize_distributed` first)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed() first")
    return Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size())


# ------------------------------------------------------------ ZeRO-2 ownership


def shard_opt_state_zero2(params: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, int]:
    """{name: owning rank} of every tensor in `params`: greedily by bytes,
    largest first (ties by name), each to the rank that owns the fewest
    bytes so far (ties to the lowest rank). Every rank computes the same
    map from the same names and shapes."""
    loads = [0] * mesh.size
    owners = {}
    for name, p in sorted(params.items(), key=lambda kv: (-kv[1].numel() * kv[1].element_size(),
                                                           kv[0])):
        rank = min(range(mesh.size), key=lambda r: (loads[r], r))
        owners[name] = rank
        loads[rank] += p.numel() * p.element_size()
    return owners


def _buckets(tensors: Sequence[torch.Tensor], itemsize: Callable[[torch.Tensor], int]):
    """Consecutive runs of `tensors` of up to BUCKET_BYTES each (a larger
    tensor alone)."""
    run, size = [], 0
    for i, x in enumerate(tensors):
        nbytes = x.numel() * itemsize(x)
        if run and size + nbytes > BUCKET_BYTES:
            yield run
            run, size = [], 0
        run.append(i)
        size += nbytes
    if run:
        yield run


@torch.no_grad()
def all_reduce_mean(tensors: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """The mean over the group of each tensor, summed in fp32 flat buckets
    and cast back to each tensor's dtype."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for run in _buckets(tensors, lambda _x: 4):
        flat = torch.cat([tensors[i].reshape(-1).float() for i in run])
        dist.all_reduce(flat, group=mesh.group)
        flat /= mesh.size
        offset = 0
        for i in run:
            x = tensors[i]
            out[i] = flat[offset: offset + x.numel()].view(x.shape).to(x.dtype)
            offset += x.numel()
    return out


@torch.no_grad()
def broadcast_owned(tensors: Sequence[torch.Tensor], owners: Sequence[int], mesh: Mesh) -> None:
    """Copy each tensor from its owner to every other rank, in place: each
    owner's tensors of one dtype in flat buckets, sent as their bytes."""
    for src in range(mesh.size):
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for x, r in zip(tensors, owners):
            if r == src:
                by_dtype.setdefault(x.dtype, []).append(x)
        for group in by_dtype.values():
            for run in _buckets(group, lambda x: x.element_size()):
                flat = torch.cat([group[i].detach().reshape(-1) for i in run])
                dist.broadcast(flat.view(torch.uint8), src=src, group=mesh.group)
                if mesh.rank == src:
                    continue
                offset = 0
                for i in run:
                    x = group[i]
                    x.copy_(flat[offset: offset + x.numel()].view(x.shape))
                    offset += x.numel()


@torch.no_grad()
def sync_params(modules: Dict[str, torch.nn.Module], mesh: Mesh) -> None:
    """Broadcast every parameter and buffer of `modules` from rank 0, so that
    the ranks agree whatever each one loaded or initialised."""
    tensors = [t for _, m in sorted(modules.items())
               for t in (*m.parameters(), *m.buffers())]
    broadcast_owned(tensors, [0] * len(tensors), mesh)


# --------------------------------------------------- window-parallel inference


def pad_window_set(windows: np.ndarray, inv_counts: np.ndarray, n_dev: int,
                   window_group: int = 1, pad_to: int = 0) -> tuple:
    """Pad a context-window schedule to a multiple of n_dev * window_group
    rows (and at least `pad_to`). Pad rows index frame 0 with blend weight 0:
    they run dead compute and contribute nothing.

    Returns (win_idx [total, win] int32, win_w [total, win] float32)."""
    n_windows, win_size = windows.shape
    quantum = n_dev * window_group
    total = -(-max(n_windows, pad_to) // quantum) * quantum
    pad = total - n_windows
    win_idx = np.concatenate([windows, np.zeros((pad, win_size), np.int32)]) if pad else windows
    win_mask = np.concatenate([np.ones(n_windows, np.float32), np.zeros(pad, np.float32)])
    win_w = inv_counts[win_idx] * win_mask[:, None]  # (total, win)
    return win_idx.astype(np.int32), win_w.astype(np.float32)


def local_window_tables(windows: np.ndarray, inv_counts: np.ndarray, mesh: Mesh,
                        window_group: int = 1) -> tuple:
    """This rank's rows of the padded window table, as `blend_windows` takes
    them: (groups, window_group, win) int64 frame indices and float32
    weights."""
    win_idx, win_w = pad_window_set(windows, inv_counts, mesh.size, window_group)
    per_dev = win_idx.shape[0] // mesh.size
    rows = slice(mesh.rank * per_dev, (mesh.rank + 1) * per_dev)
    shape = (per_dev // window_group, window_group, win_idx.shape[1])
    return win_idx[rows].reshape(shape).astype(np.int64), win_w[rows].reshape(shape)


def blend_sharded(predict_fn, latents: torch.Tensor, t: int, cond_of_group,
                  win_idx: np.ndarray, win_w: np.ndarray, mesh: Mesh) -> torch.Tensor:
    """`blend_windows` over this rank's window groups, summed over the group
    in fp32: every rank gets the blend of the whole table."""
    acc = blend_windows(predict_fn, latents, t, cond_of_group, win_idx, win_w)
    dist.all_reduce(acc, group=mesh.group)
    return acc


def window_parallel_step(predict_fn, scheduler, windows: np.ndarray, inv_counts: np.ndarray,
                         num_inference_steps: int, mesh: Mesh, window_group: int = 1,
                         eta: float = 0.0, sampler_step=None):
    """A denoise step whose windows are spread over the group.

    DDIM: `step_fn(latents, t, cond, noise=None)`; with eta > 0 every rank
    passes the same noise. With `sampler_step` (DPM-Solver++'s `build_step`):
    `step_fn(latents, step_idx, t, cond, prev_x0, has_prev)` returning
    (latents, prev_x0, has_prev). `predict_fn(lat, t, w_idx, cond)` as
    `build_blended_denoise_step` takes it."""
    win_idx, win_w = local_window_tables(windows, inv_counts, mesh, window_group)

    def blend(latents, t, cond):
        return blend_sharded(predict_fn, latents, t, lambda _gi: cond, win_idx, win_w, mesh)

    if sampler_step is not None:
        def step_dpm(latents, step_idx, t, cond, prev_x0, has_prev):
            return sampler_step(blend(latents, t, cond), step_idx, latents, prev_x0, has_prev)

        return step_dpm

    def step_fn(latents, t, cond, noise=None):
        return scheduler.step(blend(latents, t, cond), t, latents, num_inference_steps, eta=eta,
                              noise=noise)

    return step_fn
