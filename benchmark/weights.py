"""Seeded weights, made by the benchmark and loaded into both sides.

The rule is the port's seeded random init (vexpress_torch/io/loaders.py
`init_random_`, as the JAX package fills its tree): Gaussian values of
standard deviation 0.02 for every parameter of rank >= 2, output projections
that a checkpoint would zero included, so that no branch is inert; ones for
rank-1 weights (norm scales); zeros for the rest (biases). The values are
drawn on the device from one generator seeded by `--seed`, in the dtype
they are served in, a few large calls a component (each at most `CHUNK`
values, so that no draw leaves a block of gigabytes in the allocator's
cache), and cut into the parameters in the order of the reference modules'
table. The cache is emptied after the fill."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

STD = 0.02
CHUNK = 1 << 26  # values of one draw: 128 MiB in bf16

Table = List[Tuple[str, Tuple[int, ...]]]


def table(components: Dict[str, torch.nn.Module]) -> Table:
    """(component.parameter, shape) of every parameter, in a fixed order."""
    return [(f"{c}.{n}", tuple(p.shape)) for c in sorted(components)
            for n, p in components[c].named_parameters()]


@torch.no_grad()
def fill(components: Dict[str, torch.nn.Module], entries: Table, seed: int,
         dtype: Optional[torch.dtype] = None) -> None:
    """Put the seeded values of `entries` into the components' parameters
    (names and shapes must match the table exactly, or it raises); the
    draws are made in `dtype` (by default the component's parameters'), each
    freed before the next."""
    params = {f"{c}.{n}": p for c, m in components.items() for n, p in m.named_parameters()}
    if [(k, tuple(p.shape)) for k, p in sorted(params.items())] != sorted(entries):
        missing = sorted({k for k, _ in entries} - params.keys())[:5]
        extra = sorted(params.keys() - {k for k, _ in entries})[:5]
        raise KeyError(f"parameters differ from the table: missing {missing}, unexpected "
                       f"{extra}, or a shape differs")
    first = params[entries[0][0]]
    gen = torch.Generator(device=first.device).manual_seed(seed)
    for comp in sorted({k.split(".", 1)[0] for k, _ in entries}):
        rows = [(k, s) for k, s in entries if k.split(".", 1)[0] == comp]
        big = [(k, s) for k, s in rows if len(s) >= 2]
        for group in chunks(big):
            flat = torch.randn(sum(torch.Size(s).numel() for _, s in group), generator=gen,
                               device=first.device,
                               dtype=dtype or params[rows[0][0]].dtype).mul_(STD)
            at = 0
            for k, s in group:
                n = torch.Size(s).numel()
                params[k].copy_(flat[at : at + n].view(s))
                at += n
            del flat
        for k, s in rows:
            if len(s) < 2:
                params[k].fill_(1.0 if k.endswith("weight") else 0.0)
    if first.device.type == "cuda":
        torch.cuda.empty_cache()


def chunks(entries: Table) -> List[Table]:
    """`entries` cut, in order, into runs of at most `CHUNK` values (an
    entry larger than that is a run of its own)."""
    out: List[Table] = []
    size = CHUNK
    for k, s in entries:
        n = torch.Size(s).numel()
        if size + n > CHUNK:
            out.append([])
            size = 0
        out[-1].append((k, s))
        size += n
    return out
