"""Per-block marginal cost, MFU and HBM share at the window step's shapes
(CFG 2 x 24 frames = batch 48): the port of tools/bench_perf_table.py.

At each latent resolution of `--res` (64, 32, 16, 8 for 512x512; the channels
of that UNet level, 8 heads, bf16, seeded random weights): ResnetBlock, the
up path's ResnetBlock on a concatenated skip, the motion module, the
SpatialTransformer (attn1, attn1_5 under the CFG shortcut, attn2, GEGLU, the
projections; K1 where the shapes take it), GroupNorm, GEGLU FeedForward, and
(above 8x8) Downsample and Upsample. Each is timed by the chained marginal
timer (tools.common.chain_ms: N = 6 applications a call with a data
dependency, CUDA events, `--reps` calls); its FLOPs are count_flops of one
application, its bytes the JAX tool's nominal tensor traffic. Prints a
markdown table of ms, GFLOP, MFU % (of 989 TFLOP/s) and HBM % (of 3.35 TB/s).

    python -m vexpress_torch.tools.bench_perf_table [--res 64,32,16,8] [--reps 5]   # on the card
    python -m vexpress_torch.tools.bench_perf_table --device cpu --tiny --height 64 --frames 4 --res 8,4
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, List, Tuple

import numpy as np
import torch
from torch import nn

from ..io.loaders import init_random_
from ..models.blocks import Downsample, ResnetBlock, SpatialTransformer, Upsample
from ..models.motion_module import TemporalMotionModule
from ..ops.layers import FeedForward
from .common import (HBM_BPS, PEAK_BF16, add_device_args, card_line, chain_ms, pipeline_models,
                     tool_device)
from .unet_step_flops import count_flops

Block = Tuple[str, Callable[[torch.Tensor], torch.Tensor], torch.Tensor, int]  # name, op, x0, bytes


def level_channels(cfg, latent: int) -> dict:
    """Latent side -> that UNet level's channels (64 -> 320, ..., 8 -> 1280)."""
    return {latent >> i: c for i, c in enumerate(cfg.block_out_channels)}


def block_ops(cfg, latent: int, hw: int, frames: int, device, dtype) -> List[Block]:
    """(name, op, x0, nominal bytes) of each block at side `hw` of a `latent`²
    UNet, with that level's channels."""
    c = level_channels(cfg, latent)[hw]
    bf, n_tok = 2 * frames, hw * hw
    heads, cross, groups = cfg.attention_head_dim, cfg.cross_attention_dim, cfg.norm_num_groups
    g = torch.Generator().manual_seed(hw)

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(device=device, dtype=dtype)

    def mod(m: nn.Module, seed: int) -> nn.Module:
        return init_random_(m.to(device=device, dtype=dtype), seed).eval().requires_grad_(False)

    def nbytes(*shapes):
        return sum(int(np.prod(s)) * torch.finfo(dtype).bits // 8 for s in shapes)

    x, x2 = rnd(bf, c, hw, hw), rnd(bf, 2 * c, hw, hw)
    temb, ctx, bank = rnd(bf, 4 * cfg.block_out_channels[0]), rnd(bf, 5, cross), rnd(2, n_tok, c)
    xs = x.permute(0, 2, 3, 1).reshape(bf, n_tok, c)
    rn = mod(ResnetBlock(c, c, groups=groups, temb_channels=temb.shape[1]), 1)
    rn2 = mod(ResnetBlock(2 * c, c, groups=groups, temb_channels=temb.shape[1]), 2)
    mm = mod(TemporalMotionModule(c, cfg.motion_num_attention_heads, 1, cfg.motion_max_len,
                                  groups), 3)
    st = mod(SpatialTransformer(c, heads, cross, temporal=True, groups=groups), 4)
    gn = mod(nn.GroupNorm(groups, c), 5)
    ff = mod(FeedForward(c), 6)
    one = torch.tensor(1.0, dtype=dtype, device=device)
    blocks = [
        (f"Resnet {c}->{c} @{hw}", lambda y: rn(y, temb), x, nbytes(*(x.shape,) * 6)),
        (f"Resnet concat {2 * c}->{c} @{hw}",
         lambda y: torch.cat([rn2(y, temb), y[:, c:]], dim=1), x2, nbytes(x2.shape, x2.shape)),
        (f"MotionModule f={frames} @{hw}", lambda y: mm(y, frames), x, nbytes(*(x.shape,) * 12)),
        (f"SpatialTransformer(attn1+1_5+2+ff) @{hw}",
         lambda y: st(y, ctx, (bank,), one, one, True, frames), x, nbytes(*(x.shape,) * 10)),
        (f"GroupNorm @{hw}", gn, x, nbytes(x.shape, x.shape)),
        (f"FeedForward(GEGLU) @{hw}", ff, xs, nbytes(xs.shape, xs.shape)),
    ]
    if hw > latent >> 3:  # the levels that down- and upsample
        dsp, usp = mod(Downsample(c, c), 7), mod(Upsample(c, c), 8)
        blocks += [
            (f"Downsample @{hw}",
             lambda y: dsp(y).repeat_interleave(2, dim=2).repeat_interleave(2, dim=3), x,
             nbytes(x.shape, x.shape)),
            (f"Upsample @{hw}", lambda y: usp(y)[:, :, ::2, ::2], x, nbytes(x.shape, x.shape)),
        ]
    return blocks


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_args(p)
    p.add_argument("--res", type=str, default="64,32,16,8", help="latent sides, comma-separated")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--height", type=int, default=512, help="the frames' side (sets the levels)")
    return p.parse_args(argv)


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    device = tool_device("bench_perf_table", args.device)
    print(card_line(device), flush=True)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    cfg = pipeline_models(args.tiny, dtype).unet_config
    latent, cuda = args.height // 8, device.type == "cuda"
    rows = []
    with torch.inference_mode():
        for hw in (int(r) for r in args.res.split(",")):
            c = level_channels(cfg, latent)[hw]
            print(f"--- {hw}x{hw}, C={c}, batch {2 * args.frames} (CFG x {args.frames} frames) ---",
                  flush=True)
            for name, op, x0, nbytes in block_ops(cfg, latent, hw, args.frames, device, dtype):
                with count_flops(cfg.attention_head_dim) as flops:
                    op(x0)
                ms = chain_ms(op, x0, device, args.reps)
                row = {"name": name, "ms": ms, "gflop": flops["total"] / 1e9, "bytes": nbytes,
                       "mfu": flops["total"] / (ms * 1e-3) / PEAK_BF16 if cuda else None,
                       "hbm": nbytes / (ms * 1e-3) / HBM_BPS if cuda else None}
                rates = (f"MFU {row['mfu']:6.1%}  HBM {row['hbm']:6.1%}" if cuda
                         else "(host clock)")
                print(f"{name:<44} {ms:8.3f} ms  {row['gflop']:8.1f} GF  {rates}", flush=True)
                rows.append(row)
    print("\n| block | ms | GFLOP | MFU % | HBM % |")
    print("|---|---|---|---|---|")
    for r in rows:
        rates = (f"{100 * r['mfu']:.1f} | {100 * r['hbm']:.1f}" if cuda else "— | —")
        print(f"| {r['name']} | {r['ms']:.3f} | {r['gflop']:.1f} | {rates} |")
    print(json.dumps({"rows": rows, "device": device.type}), flush=True)
    return rows


if __name__ == "__main__":
    main()
