"""The UNet's hot sub-ops at the window step's shapes (64x64 latents, CFG
batch 2 x 24 frames = 48, level 0: 320 channels, 8 heads), bf16, against the
H100's bf16 peak: the port of tools/microbench_ops.py.

Rows: conv3x3 320->320, ResnetBlock, GroupNorm+SiLU, attn1 (self, K1),
attn1_5 (the reference bank under the CFG shortcut: the cond half's 24
frames' queries grouped against one bank, K1), the sdpa core at attn1's
shape, GEGLU FeedForward, the motion module (24 frames) and attn2 (5 audio
tokens). Each row's time is the CUDA-event mean of `--reps` calls after a
warm-up; its FLOPs are unet_step_flops.count_flops of one call (K1's
launches included), its MFU their rate over 989 TFLOP/s. Seeded random
weights (std 0.02) and inputs.

    python -m vexpress_torch.tools.microbench_ops                 # on the card
    python -m vexpress_torch.tools.microbench_ops --device cpu --tiny --height 64 --frames 4
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..io.loaders import init_random_
from ..models.blocks import ResnetBlock
from ..models.motion_module import TemporalMotionModule
from ..ops.attention import Attention, sdpa
from ..ops.layers import FeedForward
from .common import PEAK_BF16, add_device_args, card_line, pipeline_models, time_ms, tool_device
from .unet_step_flops import count_flops


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_args(p)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--reps", type=int, default=10)
    return p.parse_args(argv)


def op_rows(cfg, frames: int, hw: int, device, dtype) -> List[Tuple[str, Callable]]:
    """(name, fn) of each row at level 0 of `cfg`, CFG batch 2 x frames."""
    c, heads, cross = cfg.block_out_channels[0], cfg.attention_head_dim, cfg.cross_attention_dim
    groups, bf, n_tok = cfg.norm_num_groups, 2 * frames, hw * hw
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(device=device, dtype=dtype)

    def mod(m: nn.Module, seed: int) -> nn.Module:
        return init_random_(m.to(device=device, dtype=dtype), seed).eval().requires_grad_(False)

    x_img, x_seq, temb = rnd(bf, c, hw, hw), rnd(bf, n_tok, c), rnd(bf, 4 * c)
    bank, audio = rnd(2, n_tok, c), rnd(bf, 5, cross)
    conv = mod(nn.Conv2d(c, c, 3, padding=1), 1)
    rn = mod(ResnetBlock(c, c, groups=groups, temb_channels=4 * c), 2)
    gn = mod(nn.GroupNorm(groups, c), 3)
    attn1, attn1_5 = mod(Attention(c, heads, c // heads), 4), mod(Attention(c, heads, c // heads), 5)
    ff = mod(FeedForward(c), 6)
    mm = mod(TemporalMotionModule(c, cfg.motion_num_attention_heads, 1, cfg.motion_max_len,
                                  groups), 7)
    attn2 = mod(Attention(c, heads, c // heads, cross), 8)
    return [
        (f"conv3x3 {c}->{c} ({bf},{hw},{hw})", lambda: conv(x_img)),
        (f"ResnetBlock {c} ({bf},{hw},{hw})", lambda: rn(x_img, temb)),
        (f"GroupNorm+silu ({bf},{hw},{hw},{c})", lambda: F.silu(gn(x_img))),
        (f"attn1 self ({bf}, {n_tok}, {c})", lambda: attn1(x_seq)),
        (f"attn1_5 grouped (q {frames * n_tok}, kv {n_tok})",
         lambda: attn1_5(x_seq, bank, zero_kv_first_half=True)),
        (f"sdpa core ({bf}, {n_tok}x{n_tok}, d{c // heads}x{heads})",
         lambda: sdpa(x_seq, x_seq, x_seq, heads)),
        (f"FeedForward GEGLU ({bf},{n_tok},{c})", lambda: ff(x_seq)),
        (f"MotionModule f={frames} ({bf},{hw},{hw},{c})", lambda: mm(x_img, frames)),
        (f"attn2 audio ({bf},{n_tok} q, 5 kv)", lambda: attn2(x_seq, audio)),
    ]


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    device = tool_device("microbench_ops", args.device)
    print(card_line(device), flush=True)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    cfg = pipeline_models(args.tiny, dtype).unet_config
    rows = []
    with torch.inference_mode():
        for name, fn in op_rows(cfg, args.frames, args.height // 8, device, dtype):
            with count_flops(cfg.attention_head_dim) as flops:
                fn()
            ms = time_ms(fn, device, args.reps)
            row = {"name": name, "ms": ms, "gflop": flops["total"] / 1e9}
            if device.type == "cuda":
                row["tflops"] = flops["total"] / (ms * 1e-3) / 1e12
                row["mfu"] = row["tflops"] * 1e12 / PEAK_BF16
                print(f"{name:<42} {ms:8.3f} ms  {row['tflops']:7.1f} TF/s  {row['mfu']:6.1%} MFU",
                      flush=True)
            else:
                print(f"{name:<42} {ms:8.3f} ms (host clock)", flush=True)
            rows.append(row)
    print(json.dumps({"rows": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
