"""Times K1's backward on the card at chip_smoke.py's training shapes (stage
2, then stage 3, then the D=160 rows: 1024x1024's and the bf16 row at batch
2) by chip_smoke.py's own `bwd_kernel_times`: the dk/dv
kernel, the dq kernel, the plain di reduction (`flash.bwd_di`) and, as a
yardstick, SDPA's backward alone from one saved forward, each beside its
bound. CUDA events, bf16, seeded inputs.

    python -m vexpress_torch.tools.bench_flash_bwd

To time another checkout's kernels (a parent commit unpacked with `git
archive`) at the same shapes in the same call, run this file with that
checkout first on the path:

    PYTHONPATH=/path/to/other python vexpress_torch/tools/bench_flash_bwd.py

The shapes and the timing come from the chip_smoke.py of the checkout this
file is in, the kernels from whichever `vexpress_torch` the path finds
first. Prints one line per shape and a JSON line of all rows.
"""

from __future__ import annotations

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


def main() -> list:
    import torch
    from vexpress_torch.ops import flash

    if not torch.cuda.is_available():
        raise SystemExit("bench_flash_bwd times the card's kernels: no CUDA device")
    cs = _chip_smoke()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(cs.card_line(), f"kernels from {pathlib.Path(flash.__file__).resolve().parents[2]}",
          flush=True)
    rows = []
    d160 = cs.HIRES_K1_SHAPES + [row[:6] for row in cs.TRAIN_K1_EXTRA if row[6] == "bfloat16"]
    for group, shapes in (("stage 2", cs.TRAIN_K1_SHAPES), ("stage 3", cs.STAGE3_K1_SHAPES),
                          ("D=160", d160)):
        for name, b, lq, lk, inner, heads in shapes:
            d = inner // heads
            q, k, v, do = (torch.randn(b, n, inner, generator=gen, device=dev).to(torch.bfloat16)
                           for n in (lq, lk, lk, lq))
            out, lse = flash.flash_sdpa_fwd(q, k, v, heads, d**-0.5)
            times = cs.bwd_kernel_times(torch, q, k, v, do, out, lse, heads)
            bounds = cs.k1_grad_bounds(b, lq, lk, inner, heads, 2, cs.PEAK_BF16)
            row = dict(group=group, shape=name, B=b, Lq=lq, Lk=lk, H=heads, D=d, **times,
                       dkv_bound_ms=bounds["dkv"][0], dq_bound_ms=bounds["dq"][0])
            rows.append(row)
            print(f"{name} B={b} Lq={lq} Lk={lk} D={d}: dk/dv {row['dkv_ms']:.3f} ms (bound "
                  f"{row['dkv_bound_ms']:.3f}), dq {row['dq_ms']:.3f} ms (bound "
                  f"{row['dq_bound_ms']:.3f}), di {row['di_ms']:.3f} ms, sdpa bwd alone "
                  f"{row['sdpa_bwd_ms']:.3f} ms", flush=True)
            del q, k, v, do, out, lse
            torch.cuda.empty_cache()
    print(json.dumps({"bench_flash_bwd": rows}))
    return rows


if __name__ == "__main__":
    main()
