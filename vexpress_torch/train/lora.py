"""LoRA fine-tuning (Hu et al. 2021, arXiv:2106.09685). Counterpart of
vexpress_tpu/train/lora.py.

Low-rank factors per adapted attention projection, kept in the peft layout:
`lora_A.weight` (r, in) and `lora_B.weight` (out, r), fp32 parameters, with
the effective weight W + (alpha / r) * B @ A, which is the JAX package's
kernel + scale * A @ B transposed.

PyTorch mapping: the factors of one projection form a `LoraFactors` module,
registered on the projection's `nn.Linear` as a parametrization of its weight
(`torch.nn.utils.parametrize`), whose forward is the JAX merge itself,
`(W.float() + s * B @ A).to(W.dtype)` (vexpress_tpu/train/lora.py:135-138), so
autograd through it gives what `jax.value_and_grad` through `merge_lora`
gives. Base weights do not require a gradient. `merge_lora` is the same
arithmetic on plain state dicts (inference, `load_and_merge_lora`), where
every tensor that is not an adapted weight is passed through as the same
object. The merge's product runs with TF32 off.

Placement follows the JAX param paths: each `nn.Linear` of an adapted module
is given the flax path whose torch key is its name (`flax_path`), and
`LoraConfig.targets` and `include` are read against that path exactly as the
JAX package reads them (the wav2vec2's names are the transformers
checkpoint's, not the flax tree's, so it is not adaptable). `init_lora` walks the adapted projections in the
order of those paths sorted (the order of a param tree that went through
jax.tree_util) and draws from `numpy.random.default_rng(seed)` as the JAX
package does, so both start from the same factors. `LoraPiecewiseTrainer` is
not ported (the piecewise trainer is TPU-only).
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

from ..io.torch_export import _flax_path_to_torch_key

# the four projections of every attention flavor (spatial attn1, reference
# attn1_5, audio attn2, temporal/motion), by their flax names
DEFAULT_TARGETS = ("to_q", "to_k", "to_v", "to_out_0")

# {top-level module: {torch name of the adapted Linear: its factors}}
LoraTree = Dict[str, Dict[str, "LoraFactors"]]


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 8.0  # effective scale = alpha / rank (peft convention)
    targets: Tuple[str, ...] = DEFAULT_TARGETS
    # top-level pipeline modules to adapt (reference_net also works; the
    # frozen encoders make no sense to adapt)
    modules: Tuple[str, ...] = ("denoising_unet",)
    # optional regex over the slash-joined flax param path to narrow
    # placement, e.g. r"motion_modules" (temporal only) or r"attn2" (audio only)
    include: str = ""

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


# ------------------------------------------------------------ placement

# torch name -> flax path: the inverses of _flax_path_to_torch_key's renames
_FLAX_RENAMES = (
    (r"\blayers\.(\d+)\.0\.", r"layers_\1_attn/"),
    (r"\blayers\.(\d+)\.1\.0\.", r"layers_\1_ff/norm/"),
    (r"\blayers\.(\d+)\.1\.1\.", r"layers_\1_ff/fc1/"),
    (r"\blayers\.(\d+)\.1\.3\.", r"layers_\1_ff/fc2/"),
    (r"\bnet\.0\.proj\b", "net_0_proj"),
    (r"\.(\d+)\b", r"_\1"),  # list indices: down_blocks.0 -> down_blocks_0, to_out.0 -> to_out_0
)


def flax_path(name: str) -> Tuple[str, ...]:
    """The JAX param path ("params", ..., "kernel") of the `nn.Linear` named
    `name` in its top-level module: the path whose torch key is `name`."""
    path = name + "."
    for pat, rep in _FLAX_RENAMES:
        path = re.sub(pat, rep, path)
    parts = ("params",) + tuple(re.split(r"[./]", path[:-1])) + ("kernel",)
    if _flax_path_to_torch_key(parts[1:-1] + ("weight",)) != name + ".weight":
        raise ValueError(f"no flax path maps to the torch name {name!r} (got {parts})")
    return parts


def _adapted(cfg: LoraConfig, path: Tuple[str, ...]) -> bool:
    """vexpress_tpu/train/lora.py:_adapted on a Linear's flax path."""
    if path[-2] not in cfg.targets:
        return False
    return not cfg.include or bool(re.search(cfg.include, "/".join(path)))


def adapted_linears(models: Dict[str, nn.Module], cfg: LoraConfig
                    ) -> List[Tuple[str, str, nn.Linear]]:
    """(module, name, Linear) of every projection `cfg` adapts, module by
    module in `cfg.modules`' order, each in its sorted flax-path order."""
    out = []
    for mod in cfg.modules:
        if mod not in models:
            raise ValueError(f"lora module {mod!r} not in params (have {sorted(models)})")
        found = []
        for name, sub in models[mod].named_modules():
            if isinstance(sub, nn.Linear):
                path = flax_path(name)
                if _adapted(cfg, path):
                    found.append((path, name, sub))
        out += [(mod, name, sub) for _, name, sub in sorted(found, key=lambda x: x[0])]
    return out


# ------------------------------------------------------------ the factors


@contextlib.contextmanager
def _fp32_matmul():
    """TF32 off for the merge's product (a no-op on the CPU)."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def _merged(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor, scale: float) -> torch.Tensor:
    """(W.float() + (B @ A) * s).to(W.dtype): the JAX merge, transposed."""
    with _fp32_matmul():
        delta = (b.to(w.device, torch.float32) @ a.to(w.device, torch.float32)) * scale
    return (w.float() + delta).to(w.dtype)


class _Factor(nn.Module):
    def __init__(self, value: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(value)


class LoraFactors(nn.Module):
    """One adapter: `lora_A.weight` (r, in) and `lora_B.weight` (out, r),
    fp32. As a parametrization of a Linear's weight W its forward is the
    merged weight (W.float() + scale * B @ A).to(W.dtype)."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor, scale: float):
        super().__init__()
        self.lora_A = _Factor(a.float())
        self.lora_B = _Factor(b.float())
        self.scale = float(scale)

    @property
    def rank(self) -> int:
        return self.lora_A.weight.shape[0]

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        return _merged(w, self.lora_A.weight, self.lora_B.weight, self.scale)


def init_lora(models: Dict[str, nn.Module], cfg: LoraConfig, seed: int = 0) -> LoraTree:
    """The factors of every adapted projection, on its device: A small-normal
    (the JAX draws, in the JAX order), B zero, so the adapter starts as an
    exact no-op. Nothing is attached yet (`attach_lora`)."""
    rng = np.random.default_rng(seed)
    tree: LoraTree = {}
    for mod, name, lin in adapted_linears(models, cfg):
        d_out, d_in = lin.weight.shape
        a = (rng.standard_normal((d_in, cfg.rank)) / cfg.rank).astype(np.float32)
        dev = lin.weight.device
        tree.setdefault(mod, {})[name] = LoraFactors(
            torch.from_numpy(np.ascontiguousarray(a.T)).to(dev),
            torch.zeros((d_out, cfg.rank), dtype=torch.float32, device=dev), cfg.scale)
    if not tree:
        raise ValueError(
            f"LoRA placement matched no kernels (targets={cfg.targets}, "
            f"include={cfg.include!r}, modules={cfg.modules})")
    return tree


def lora_parameters(lora: LoraTree) -> List[nn.Parameter]:
    """The factors in the tree's order: A then B of each adapter."""
    return [p for sub in lora.values() for f in sub.values()
            for p in (f.lora_A.weight, f.lora_B.weight)]


def attach_lora(models: Dict[str, nn.Module], lora: LoraTree) -> Dict[str, nn.Module]:
    """Register each adapter as the parametrization of its Linear's weight,
    freeze every base parameter of `models` and make the factors trainable.
    Returns `models`."""
    for m in models.values():
        m.requires_grad_(False)
    for mod, sub in lora.items():
        for name, factors in sub.items():
            lin = models[mod].get_submodule(name)
            if parametrize.is_parametrized(lin, "weight"):
                raise ValueError(f"{mod}.{name} already carries a parametrization")
            parametrize.register_parametrization(lin, "weight", factors)
    for p in lora_parameters(lora):
        p.requires_grad_(True)
    return models


def detach_lora(models: Dict[str, nn.Module], lora: LoraTree) -> Dict[str, nn.Module]:
    """Undo `attach_lora`: each Linear gets its base weight back, unmerged."""
    for mod, sub in lora.items():
        for name in sub:
            parametrize.remove_parametrizations(models[mod].get_submodule(name), "weight",
                                                leave_parametrized=False)
    return models


def base_named_parameters(module: nn.Module):
    """named_parameters under the names they have without adapters: an
    adapted weight as `<linear>.weight`, the factors left out."""
    for name, p in module.named_parameters():
        if ".parametrizations.weight." in "." + name:
            if not name.endswith("parametrizations.weight.original"):
                continue
            name = name[: -len("parametrizations.weight.original")] + "weight"
        yield name, p


# ------------------------------------------------------------ merge, mask, grads


def merge_lora(params: Dict[str, Dict[str, torch.Tensor]], lora: LoraTree,
               cfg: Union[LoraConfig, float]) -> Dict[str, Dict[str, torch.Tensor]]:
    """`params` ({module: {name: tensor}}) with W + scale * (B @ A) at the
    adapted weights, each on W's device; every other tensor, and every
    module the adapter does not touch, is passed through as the same
    object. `cfg`: a LoraConfig or a bare scale."""
    s = cfg.scale if isinstance(cfg, LoraConfig) else float(cfg)
    out = {}
    with torch.no_grad():
        for mod, sd in params.items():
            if mod not in lora:
                out[mod] = sd
                continue
            new = dict(sd)
            for name, f in lora[mod].items():
                key = name + ".weight"
                new[key] = _merged(sd[key], f.lora_A.weight, f.lora_B.weight, s)
            out[mod] = new
    return out


def lora_mask(models: Dict[str, nn.Module], lora: LoraTree) -> Dict[str, Dict[str, bool]]:
    """{module: {parameter name: bool}} over every module (the shape of
    `trainable_mask`): True only at the adapted weights."""
    adapted = {(mod, name + ".weight") for mod, sub in lora.items() for name in sub}
    return {mod: {n: (mod, n) in adapted for n, _ in base_named_parameters(m)}
            for mod, m in models.items()}


def project_grads(dense_grads: Dict[str, Dict[str, torch.Tensor]], lora: LoraTree,
                  cfg: LoraConfig) -> Dict[str, Dict[str, Dict[str, torch.Tensor]]]:
    """Exact factor gradients from the gradients G of the merged weights
    ({module: {name: G (out, in)}}): dL/dA = s * B^T @ G, dL/dB = s * G @ A^T,
    as {module: {linear: {"lora_A": ..., "lora_B": ...}}}."""
    s = cfg.scale
    out: Dict[str, Dict[str, Dict[str, torch.Tensor]]] = {}
    with torch.no_grad(), _fp32_matmul():
        for mod, sub in lora.items():
            for name, f in sub.items():
                g = dense_grads[mod][name + ".weight"].float()
                a, b = f.lora_A.weight.float(), f.lora_B.weight.float()
                out.setdefault(mod, {})[name] = {"lora_A": (b.T @ g) * s,
                                                 "lora_B": (g @ a.T) * s}
    return out


# ------------------------------------------------------------ torch interop


def lora_to_torch_state_dict(lora: LoraTree,
                             cfg: Optional[LoraConfig] = None) -> Dict[str, torch.Tensor]:
    """peft-layout export, fp32 CPU tensors: `<module>.<linear>.lora_A.weight`
    (r, in), `.lora_B.weight` (out, r); with `cfg`, a scalar `lora_alpha` so a
    reload needs no side-channel config."""
    out: Dict[str, torch.Tensor] = {}
    for mod, sub in lora.items():
        for name, f in sub.items():
            for part in ("lora_A", "lora_B"):
                out[f"{mod}.{name}.{part}.weight"] = (
                    getattr(f, part).weight.detach().to("cpu", torch.float32).clone())
    if cfg is not None:
        out["lora_alpha"] = torch.tensor(cfg.alpha, dtype=torch.float32)
    return out


def lora_from_torch_state_dict(sd: Dict[str, Any], models: Dict[str, nn.Module]
                               ) -> Tuple[LoraTree, Optional[float]]:
    """Inverse of lora_to_torch_state_dict: the factors, validated against
    the Linears of `models` (an adapter key that matches none, a missing half
    or a shape that does not fit raises) and put on their devices, each with
    the scale alpha / rank (1 without alpha). Returns (lora, alpha_or_None)."""
    linears: Dict[str, Tuple[str, str, nn.Linear]] = {}
    for mod, m in models.items():
        for name, sub in m.named_modules():
            if isinstance(sub, nn.Linear):
                linears[f"{mod}.{name}"] = (mod, name, sub)
    alpha = None
    pending: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, v in sd.items():
        if k == "lora_alpha":
            alpha = float(torch.as_tensor(v))
            continue
        m = re.match(r"^(.*)\.lora_([AB])\.weight$", k)
        if not m:
            raise ValueError(f"not a LoRA adapter key: {k!r}")
        pending.setdefault(m.group(1), {})[m.group(2)] = torch.as_tensor(v).float()

    tree: LoraTree = {}
    for prefix, ab in sorted(pending.items()):
        if prefix not in linears:
            raise ValueError(f"adapter {prefix!r} matches no kernel in params")
        if set(ab) != {"A", "B"}:
            raise ValueError(f"adapter {prefix!r} missing lora_{'B' if 'A' in ab else 'A'}")
        mod, name, lin = linears[prefix]
        d_out, d_in = lin.weight.shape
        a, b = ab["A"], ab["B"]
        if a.shape[1] != d_in or b.shape[0] != d_out or a.shape[0] != b.shape[1]:
            raise ValueError(f"adapter {prefix!r} shapes A{tuple(a.shape)} B{tuple(b.shape)} "
                             f"do not fit kernel ({d_in}, {d_out})")
        scale = 1.0 if alpha is None else alpha / a.shape[0]
        dev = lin.weight.device
        tree.setdefault(mod, {})[name] = LoraFactors(a.to(dev), b.to(dev), scale)
    if not tree:
        raise ValueError("state dict contains no LoRA adapter keys")
    return tree, alpha


def load_and_merge_lora(params: Dict[str, Dict[str, torch.Tensor]], path: str,
                        models: Dict[str, nn.Module], scale: Optional[float] = None,
                        host_params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None):
    """Inference-time adapter loading (cli/infer.py --lora_path): read a
    peft-layout checkpoint, validate it against `models`, and return
    `params` ({module: {name: tensor}}, `models`' tensors) merged on their
    devices; modules the adapter does not touch come back as the same
    objects. `scale` overrides the checkpoint's alpha / rank.

    `host_params`: host copies of some modules (the save_memory stash,
    `VExpressPipeline._host_cond`). When given, returns (merged,
    merged_host), the adapter-touched entries of `host_params` merged on
    the host, so that releasing an adapted module later never copies it
    back from the card."""
    from ..io.torch_import import load_torch_checkpoint

    lora, alpha = lora_from_torch_state_dict(load_torch_checkpoint(path), models)
    if scale is None:
        first = next(f for sub in lora.values() for f in sub.values())
        scale = 1.0 if alpha is None else alpha / first.rank
    out = merge_lora(params, lora, float(scale))
    if host_params is None:
        return out
    return out, merge_lora(host_params, lora, float(scale))


# ------------------------------------------------------------ trainer


def make_lora_optimizer(lora: LoraTree, tcfg, mesh=None):
    """What cli/train.py builds for LoRA runs: global-norm clipping, then
    AdamW over the factors with the config's solver values and learning-rate
    schedule (8-bit state would save nothing on this little state). With a
    `mesh`, the factors' gradients are averaged over the group and their
    AdamW state is ZeRO-2-sharded (`TrainOptimizer`)."""
    from .train_step import AdamW, make_lr_schedule, sharded_optimizer

    named = {f"{mod}.{name}.{ab}": getattr(f, ab).weight for mod, sub in lora.items()
             for name, f in sub.items() for ab in ("lora_A", "lora_B")}
    lr, betas = make_lr_schedule(tcfg), (tcfg.adam_beta1, tcfg.adam_beta2)
    return sharded_optimizer(
        named, lambda groups: AdamW(groups, lr, betas=betas, eps=tcfg.adam_epsilon,
                                    weight_decay=tcfg.adam_weight_decay),
        tcfg.max_grad_norm, mesh=mesh)


def build_lora_train_step(pipeline, tcfg, optimizer, lora_cfg: LoraConfig, lora: LoraTree,
                          scheduler=None):
    """The LoRA train step: `lora` attached to the pipeline's modules (base
    weights frozen), then the train step of `build_train_step`, whose
    backward reaches the factors through the merge. `optimizer` updates the
    factors (`make_lora_optimizer`). Returns (step_fn, lora_loss) with
    step_fn(state, batch, generator) and lora_loss(models, batch, draws)."""
    from .train_step import build_train_step

    if {p for p in optimizer.params} != set(lora_parameters(lora)):
        raise ValueError("the optimizer must update exactly the adapter's factors")
    scales = {f.scale for sub in lora.values() for f in sub.values()}
    if scales != {lora_cfg.scale}:
        raise ValueError(f"adapter scales {sorted(scales)} differ from the config's "
                         f"{lora_cfg.scale}")
    attach_lora(pipeline.components(), lora)
    return build_train_step(pipeline, tcfg, optimizer, scheduler=scheduler)
