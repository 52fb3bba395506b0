"""Attention-variant sweep at the production attn1 shape (B, H, L, D) =
(48, 8, 4096, 40), bf16: the port of tools/bench_attn_variants.py.

Rows, in the JAX tool's order:
  t1_pad128, t1_native, t1_pad64   T1 (ops/flash_variants.py): K1's kernel with
                                   the head dim padded to 128, 48 (its natural
                                   padding) and 64 in shared memory
  t2_native, t2_pad64, t2_bigtile  T2 (ops/splash.py): full-mask splash MHA on q
                                   pre-scaled in bf16; padded to 48 and 64, and
                                   one larger tile (128 queries x 128 keys)
  sdpa_dispatch                    ops.attention.sdpa on the packed (B, L, H*D)
                                   layout, which takes K1 (the JAX tool's
                                   xla_chunked row)
  t1_hb{2,4}_q{BQ}k{BK}            T1 with 2 or 4 (batch, head) pairs per block
                                   (the TPU kernel's block_b) at three (query
                                   rows, keys) tiles: equal, q-larger, k-larger

Each row prints its time, its rate on the nominal 4*B*H*L^2*D operations, that
rate's share of the H100's 989 TFLOP/s dense bf16, and its max error on the
(1, 1) batch-head slice against exact fp32 attention of the unscaled q. The
first line names the card and its power limit. VEXPRESS_BENCH_ONLY_BB=1 runs
only t1_native and the t1_hb rows, as in the JAX tool.

    python -m vexpress_torch.tools.bench_attn_variants          # on the card
    python -m vexpress_torch.tools.bench_attn_variants --device cpu --shape 2 2 256 40

On the card the times are CUDA-event means over REPS calls. On the CPU the
rows run the plain versions and the times are host-clock times of those, with
no device rate.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, List, Tuple

import torch

from ..ops.attention import sdpa
from ..ops.flash_variants import flash_fwd_variant
from ..ops.splash import splash_mha_fwd
from .common import PEAK_BF16, card_line, time_ms

# (query rows, keys) per block of the t1_hb rows, for the JAX tool's
# (block_q, block_k) = (1024, 1024), (2048, 1024), (512, 2048)
HB_TILES = ((64, 64), (128, 64), (64, 128))
SEED = 0
REPS = 10  # timed calls per row


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    p.add_argument("--shape", type=int, nargs=4, default=(48, 8, 4096, 40),
                   metavar=("B", "H", "L", "D"))
    return p.parse_args(argv)


def prescale(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q times the scale in q's dtype, as the JAX tool scales q for splash:
    its `q * scale` casts the weakly typed scale to bf16 before the product."""
    return q * torch.tensor(scale, dtype=q.dtype, device=q.device)


def variant_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                 only_bb: bool = False) -> List[Tuple[str, Callable[[], torch.Tensor]]]:
    """(name, fn) of each row in order; fn returns (B, H, L, D)."""
    b, h, l, d = q.shape
    qs = prescale(q, scale)

    def t1(d_target, bq=64, bk=64, hb=1):
        return lambda: flash_fwd_variant(q, k, v, scale, block_q=bq, block_k=bk,
                                         heads_per_block=hb, d_target=d_target)

    def t2(d_target, bq=64, bkv=64):
        return lambda: splash_mha_fwd(qs, k, v, block_q=bq, block_kv=bkv, d_target=d_target)

    packed = [t.transpose(1, 2).reshape(b, l, h * d) for t in (q, k, v)]

    def dispatch():
        return sdpa(*packed, h, scale).reshape(b, l, h, d).transpose(1, 2)

    rows = [] if only_bb else [("t1_pad128", t1(128))]
    rows.append(("t1_native", t1(d)))
    if not only_bb:
        rows += [("t1_pad64", t1(64)), ("t2_native", t2(d)), ("t2_pad64", t2(64)),
                 ("t2_bigtile", t2(d, 128, 128)), ("sdpa_dispatch", dispatch)]
    rows += [(f"t1_hb{hb}_q{bq}k{bk}", t1(d, bq, bk, hb))
             for hb in (2, 4) for bq, bk in HB_TILES]
    return rows


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_attn_variants: no CUDA device (--device cpu runs the plain "
                         "versions)")
    b, h, l, d = args.shape
    scale = d**-0.5
    gen = torch.Generator(device=device).manual_seed(SEED)
    q, k, v = (torch.randn(b, h, l, d, generator=gen, device=device).to(torch.bfloat16)
               for _ in range(3))
    nominal = 4.0 * b * h * l * l * d  # q k^T and p v
    print(card_line(device), flush=True)

    # the reference on the (1, 1) batch-head slice only: the full fp32 logits
    # would take B*H*L*L*4 bytes (26 GB at the production shape)
    qs, ks, vs = (t[:1, :1].float() for t in (q, k, v))
    ref = torch.softmax(qs @ ks.transpose(-1, -2) * scale, dim=-1) @ vs

    results = []
    only_bb = os.environ.get("VEXPRESS_BENCH_ONLY_BB") == "1"
    for name, fn in variant_rows(q, k, v, scale, only_bb):
        err = float((fn()[:1, :1].float() - ref).abs().max())
        ms = time_ms(fn, device, REPS)
        row = dict(name=name, ms=ms, max_abs_err=err, device=device.type)
        if device.type == "cuda":
            row["tflops"] = nominal / (ms * 1e-3) / 1e12
            row["peak_share"] = row["tflops"] * 1e12 / PEAK_BF16
            print(f"{name:<18} {ms:9.3f} ms  {row['tflops']:7.1f} TFLOP/s  "
                  f"{row['peak_share']:6.1%} of 989  maxerr {err:.2e}", flush=True)
        else:
            print(f"{name:<18} {ms:9.3f} ms (host clock, plain version)  maxerr {err:.2e}",
                  flush=True)
        results.append(row)
    return results


if __name__ == "__main__":
    main()
