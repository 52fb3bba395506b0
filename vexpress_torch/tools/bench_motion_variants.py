"""Temporal (motion) attention formulation sweep at the 64x64-latent production
shape: the port of tools/bench_motion_variants.py.

The motion module attends across the 24 frames of a window at each of the
4096 latent tokens: 2*4096*8 tiny (24 x 40) x (40 x 24) products per call
under CFG (b = 2), 6 GFLOP in all. The rows, all in the module's folded
layout (b*f, tokens, heads*40) in and out, bf16 inputs, fp32 softmax, are
plain torch on purpose (no kernel is written for the motion attention yet;
these numbers say whether one is wanted):
  prod_folded     ops.attention.temporal_attention, the port's Attention
                  temporal branch: per-head einsums, frames inside the batch
  einsum_auto     one 5-D einsum, heads as an axis (no Python loop)
  unroll_kf       the 24 key frames unrolled into elementwise multiply-reduce,
                  fp32 products (as ops.attention's tiny-KV path does for the
                  5 audio tokens)
  unroll_kf_bf16  the same with bf16 products (fp32 softmax statistics)

Each row prints its time, its rate on the attention's 4*b*tokens*h*f^2*40
operations and its max difference from prod_folded on the first 256 tokens
of the first frame. The first line names the card and its power limit.

    python -m vexpress_torch.tools.bench_motion_variants          # on the card
    python -m vexpress_torch.tools.bench_motion_variants --device cpu --shape 1 4 64 2 8

On the card the times are CUDA-event means over REPS calls; on the CPU
they are host-clock times.
"""

from __future__ import annotations

import argparse
from typing import Callable, List, Tuple

import torch

from ..ops.attention import temporal_attention
from .bench_attn_variants import SEED
from .common import card_line, time_ms

REPS = 8  # timed calls per row


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    p.add_argument("--shape", type=int, nargs=5, default=(2, 24, 4096, 8, 40),
                   metavar=("B", "F", "TOKENS", "H", "D"))
    return p.parse_args(argv)


def motion_rows(shape) -> List[Tuple[str, Callable]]:
    """(name, fn(q, k, v)) of each row; q, k, v and the result are (b*f,
    tokens, h*dd)."""
    b, f, d_tok, h, dd = shape
    scale = dd**-0.5

    def prod_folded(q, k, v):
        return temporal_attention(q, k, v, f, h)

    def einsum_auto(q, k, v):
        q5, k5, v5 = (t.reshape(b, f, d_tok, h, dd) for t in (q, k, v))
        logits = torch.einsum("bqdhe,bkdhe->bdhqk", q5.float(), k5.float())
        w = torch.softmax(logits * scale, dim=-1).to(v.dtype)
        return torch.einsum("bdhqk,bkdhe->bqdhe", w, v5).reshape(b * f, d_tok, h * dd)

    def unroll_kf(q, k, v, prod_dtype=torch.float32):
        q5 = q.reshape(b, f, d_tok, h, dd).to(prod_dtype)
        k5 = k.reshape(b, f, d_tok, h, dd).to(prod_dtype)
        v5 = v.reshape(b, f, d_tok, h, dd)
        # logits[j] = sum_e q k_j: (b, f, tokens, h), one per key frame
        logits = [(q5 * k5[:, j][:, None]).sum(-1).float() * scale for j in range(f)]
        m = logits[0]
        for j in range(1, f):
            m = torch.maximum(m, logits[j])
        exps = [torch.exp(lg - m) for lg in logits]
        denom = exps[0]
        for j in range(1, f):
            denom = denom + exps[j]
        out = torch.zeros((b, f, d_tok, h, dd), dtype=torch.float32, device=q.device)
        for j in range(f):
            out = out + (exps[j] / denom)[..., None] * v5[:, j].float()[:, None]
        return out.to(v.dtype).reshape(b * f, d_tok, h * dd)

    return [("prod_folded", prod_folded), ("einsum_auto", einsum_auto), ("unroll_kf", unroll_kf),
            ("unroll_kf_bf16", lambda q, k, v: unroll_kf(q, k, v, torch.bfloat16))]


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_motion_variants: no CUDA device (--device cpu runs on the CPU)")
    b, f, d_tok, h, dd = args.shape
    gen = torch.Generator(device=device).manual_seed(SEED)
    # post-projection q, k, v in the folded layout the module uses
    q, k, v = (torch.randn(b * f, d_tok, h * dd, generator=gen, device=device)
               .to(torch.bfloat16) for _ in range(3))
    ops = 4.0 * b * d_tok * h * f * f * dd  # q k^T and w v
    print(card_line(device), flush=True)
    results, ref = [], None
    for name, fn in motion_rows(args.shape):
        first = fn(q, k, v)[:1, :256].float()
        ref = first if ref is None else ref
        err = float((first - ref).abs().max())
        ms = time_ms(lambda: fn(q, k, v), device, REPS)
        row = dict(name=name, ms=ms, max_abs_err=err, device=device.type)
        if device.type == "cuda":
            row["tflops"] = ops / (ms * 1e-3) / 1e12
            print(f"{name:<16} {ms:9.3f} ms  {row['tflops']:6.3f} TFLOP/s  maxdiff {err:.2e}",
                  flush=True)
        else:
            print(f"{name:<16} {ms:9.3f} ms (host clock)  maxdiff {err:.2e}", flush=True)
        results.append(row)
    return results


if __name__ == "__main__":
    main()
