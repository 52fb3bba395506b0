"""Times K1's backward on the card at chip_smoke.py's training shapes (stage
2, then stage 3, then the D=160 rows: 1024x1024's and the bf16 row at batch
2) by chip_smoke.py's own `bwd_kernel_times`: the dk/dv
kernel, the dq kernel, the plain di reduction (`flash.bwd_di`) and, as a
yardstick, SDPA's backward alone from one saved forward, each beside its
bound. CUDA events, bf16, seeded inputs. With `--fp32`, the fp32 rows
instead (chip_smoke.py's TRAIN_K1_FP32 and "fp32 D=40"), beside the 3xTF32
bound, with TF32 off for SDPA, and the fp32 split pass where the kernels
have one.

    python -m vexpress_torch.tools.bench_flash_bwd [--fp32]

To time another checkout's kernels (a parent commit unpacked with `git
archive`) at the same shapes in the same call, run this file with that
checkout first on the path:

    PYTHONPATH=/path/to/other python vexpress_torch/tools/bench_flash_bwd.py

The shapes and the timing come from the chip_smoke.py of the checkout this
file is in, the kernels from whichever `vexpress_torch` the path finds
first. Prints one line per shape and a JSON line of all rows.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib


def _chip_smoke():
    """chip_smoke.py beside this file's package, loaded by path."""
    path = pathlib.Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_bench_chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> list:
    import torch
    from vexpress_torch.ops import flash

    if not torch.cuda.is_available():
        raise SystemExit("bench_flash_bwd times the card's kernels: no CUDA device")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fp32", action="store_true", help="the fp32 rows instead of the bf16 ones")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False  # SDPA's fp32 backward in fp32
    torch.backends.cudnn.allow_tf32 = False
    cs = _chip_smoke()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(cs.card_line(), f"kernels from {pathlib.Path(flash.__file__).resolve().parents[2]}",
          flush=True)
    rows = []
    if args.fp32:
        dtype, peak = torch.float32, cs.PEAK_3XTF32
        groups = (("fp32", [row[:6] for row in cs.TRAIN_K1_FP32 + cs.TRAIN_K1_EXTRA
                            if row[6] == "float32"]),)
    else:
        dtype, peak = torch.bfloat16, cs.PEAK_BF16
        d160 = cs.HIRES_K1_SHAPES + [row[:6] for row in cs.TRAIN_K1_EXTRA if row[6] == "bfloat16"]
        groups = (("stage 2", cs.TRAIN_K1_SHAPES), ("stage 3", cs.STAGE3_K1_SHAPES),
                  ("D=160", d160))
    for group, shapes in groups:
        for name, b, lq, lk, inner, heads in shapes:
            d = inner // heads
            q, k, v, do = (torch.randn(b, n, inner, generator=gen, device=dev).to(dtype)
                           for n in (lq, lk, lk, lq))
            out, lse = flash.flash_sdpa_fwd(q, k, v, heads, d**-0.5)
            times = cs.bwd_kernel_times(torch, q, k, v, do, out, lse, heads)
            bounds = cs.k1_grad_bounds(b, lq, lk, inner, heads, q.element_size(), peak)
            row = dict(group=group, shape=name, B=b, Lq=lq, Lk=lk, H=heads, D=d, **times,
                       dkv_bound_ms=bounds["dkv"][0], dq_bound_ms=bounds["dq"][0])
            rows.append(row)
            print(f"{name} B={b} Lq={lq} Lk={lk} D={d}: dk/dv {row['dkv_ms']:.3f} ms (bound "
                  f"{row['dkv_bound_ms']:.3f}), dq {row['dq_ms']:.3f} ms (bound "
                  f"{row['dq_bound_ms']:.3f}), di {row['di_ms']:.3f} ms, sdpa bwd alone "
                  f"{row['sdpa_bwd_ms']:.3f} ms"
                  + (f", split pass {row['split_ms']:.3f} ms" if "split_ms" in row else ""),
                  flush=True)
            del q, k, v, do, out, lse
            torch.cuda.empty_cache()
    print(json.dumps({"bench_flash_bwd": rows}))
    return rows


if __name__ == "__main__":
    main()
