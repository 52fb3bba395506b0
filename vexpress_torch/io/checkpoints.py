"""Train-state checkpoints and per-module torch exports. Counterpart of
vexpress_tpu/io/checkpoints.py.

Mirrors the reference's two mechanisms (SURVEY.md §5.4): (a) the full
trainer state, saved and resumed (accelerator.save_state/load_state; orbax
in the JAX package, `torch.save` here), and (b) per-module weight dumps every
checkpointing_steps (train.py:672-698, 734-753).

The train state of `checkpoint-<step>/train_state.pt` holds what a resume
needs and nothing else: the trainable tensors by name (`<module>.<parameter
name>`: the trained modules' parameters, or the LoRA factors under their
parametrization names), the optimizer state (the clip's accumulation, the
update count, each tensor's momenta: fp32, or the 8-bit Adam's int8 codes
and fp32 scales) and the step. Frozen weights are not saved: a resume
rebuilds them from the same configuration. Data-parallel runs write the
same file from rank 0 (the owners' moments gathered to it, the accumulation
averaged over the group) and restore it at any world size.
"""

from __future__ import annotations

import os
import pathlib
import shutil
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..parallel.mesh import all_reduce_mean
from ..train.adam8bit import QTensor
from .torch_export import filter_motion_module, save_torch_checkpoint

MODULE_FILES = (
    "denoising_unet",
    "reference_net",
    "v_kps_guider",
    "audio_projection",
)
STATE_FILE = "train_state.pt"


def trainable_tensors(models: Dict[str, nn.Module]) -> Dict[str, torch.Tensor]:
    """{"<module>.<name>": parameter} of every parameter that requires a
    gradient."""
    return {f"{mod}.{n}": p for mod, m in models.items() for n, p in m.named_parameters()
            if p.requires_grad}


def _pack(x):
    if isinstance(x, QTensor):
        return {"codes": x.codes.detach().cpu(), "scales": x.scales.detach().cpu()}
    return x.detach().cpu()


def _unpack(x, device):
    if isinstance(x, dict):
        return QTensor(x["codes"].to(device), x["scales"].to(device))
    return x.to(device)


def _optimizer_state(optimizer, names: Dict[int, str]) -> dict:
    """The optimizer's state; under a mesh, collective: the accumulation is
    the group's mean and rank 0 gathers every owner's moments (None
    elsewhere)."""
    inner, mesh = optimizer.inner, optimizer.mesh
    acc = optimizer.acc
    if acc is not None and mesh is not None:
        acc = all_reduce_mean(acc, mesh)
    moments = {names[id(p)]: {k: _pack(v) for k, v in inner.state[p].items()}
               for p in optimizer.owned() if inner.state[p]}
    if mesh is not None:
        parts = [None] * mesh.size if mesh.rank == 0 else None
        dist.gather_object(moments, parts, dst=0, group=mesh.group)
        if mesh.rank != 0:
            return None
        moments = {n: m for part in parts for n, m in part.items()}
    return {
        "count": inner.count,
        "mini_step": optimizer.mini_step,
        "acc": None if acc is None else
        {names[id(p)]: a.detach().cpu() for p, a in zip(optimizer.params, acc)},
        "state": {names[id(p)]: moments[names[id(p)]] for p in optimizer.params
                  if names[id(p)] in moments},
    }


def save_train_state(ckpt_dir: str, step: int, state) -> str:
    """Write `state` (a TrainState) into `<ckpt_dir>/checkpoint-<step>`,
    replacing a directory left at the same step by an earlier run. Under a
    mesh (the optimizer's) every rank calls it, rank 0 writes the file one
    process would write, and it returns on every rank once that is done."""
    path = pathlib.Path(ckpt_dir).resolve() / f"checkpoint-{step}"
    tensors = trainable_tensors(state.models)
    names = {id(p): n for n, p in tensors.items()}
    missing = [i for i, p in enumerate(state.optimizer.params) if id(p) not in names]
    if missing:
        raise ValueError(f"optimizer parameters {missing[:5]} are not trainable tensors of "
                         "the models")
    opt_state = _optimizer_state(state.optimizer, names)
    mesh = state.optimizer.mesh
    if mesh is None or mesh.rank == 0:
        payload = {"params": {n: p.detach().cpu() for n, p in tensors.items()},
                   "opt_state": opt_state, "step": int(state.step)}
        if path.exists():
            shutil.rmtree(path)
        path.mkdir(parents=True)
        torch.save(payload, path / STATE_FILE)
    if mesh is not None:
        dist.barrier(group=mesh.group)
    return str(path)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    p = pathlib.Path(ckpt_dir)
    if not p.exists():
        return None
    ckpts = sorted(
        (d for d in p.iterdir() if d.name.startswith("checkpoint-")),
        key=lambda d: int(d.name.split("-")[1]),
    )
    return str(ckpts[-1]) if ckpts else None


@torch.no_grad()
def restore_train_state(path: str, state):
    """Load `checkpoint-<step>` into `state` (a TrainState built as the saved
    one was: the same models, trainable tensors and optimizer), in place:
    the tensors' values, the optimizer state on each tensor's device and the
    step. Under a mesh each rank keeps the state of the tensors it owns, so a
    checkpoint restores at any world size. Returns `state`."""
    saved = torch.load(pathlib.Path(path) / STATE_FILE, map_location="cpu", weights_only=True)
    tensors = trainable_tensors(state.models)
    if set(saved["params"]) != set(tensors):
        diff = sorted(set(saved["params"]) ^ set(tensors))
        raise ValueError(f"checkpoint {path} does not hold this run's trainable tensors "
                         f"({len(diff)} differ, first {diff[:3]})")
    for n, p in tensors.items():
        p.copy_(saved["params"][n])
    opt, inner, names = state.optimizer, state.optimizer.inner, {id(p): n for n, p in
                                                                 tensors.items()}
    ost = saved["opt_state"]
    inner.count = ost["count"]
    opt.mini_step = ost["mini_step"]
    opt.acc = None if ost["acc"] is None else [ost["acc"][names[id(p)]].to(p.device)
                                               for p in opt.params]
    for p in opt.owned():
        inner.state[p] = {k: _unpack(v, p.device)
                          for k, v in ost["state"].get(names[id(p)], {}).items()}
    state.step = int(saved["step"])
    return state


def export_modules(models: Dict[str, nn.Module], out_dir: str, step: int) -> None:
    """Per-module torch dumps `<module>-<step>.pth` (and
    `motion_module-<step>.pth`, filtered from the denoising UNet): each
    module's parameters as the JAX package exports them, fp32 CPU tensors
    under their torch keys."""
    os.makedirs(out_dir, exist_ok=True)
    for name in MODULE_FILES:
        if name not in models:
            continue
        sd = {n: p.detach().to("cpu", torch.float32).contiguous()
              for n, p in models[name].named_parameters()}
        save_torch_checkpoint(sd, os.path.join(out_dir, f"{name}-{step}.pth"))
        if name == "denoising_unet":
            save_torch_checkpoint(filter_motion_module(sd),
                                  os.path.join(out_dir, f"motion_module-{step}.pth"))
