"""One run of one benchmark cell:

  python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (imports, the kernel library, the
models and their seeded weights, the inputs, the warm-up) counts as
`setup_s`; then the window runs for `--seconds`; then the check against the
plain reference. With `--trace 0` the result carries the cell's end-to-end
metrics, with `--trace 1` its per-layer metrics, read from a profiled part
of the window. The last line of standard output is the result, a JSON
object; the numbers compared with their limits are also the last lines of
standard error. Without a CUDA device, or with fewer than the cell asks
for, the run exits with code 2 and prints no result."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional  # noqa: E402

from . import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "vexpress_tpu")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def set_environment(cell: spec.Cell) -> None:
    """Before the program is imported: its kernel switches, caches inside
    the checkout, and no JAX through a library that would load it."""
    os.environ["VEXPRESS_FLASH_LITE"] = "1" if cell.cell.get("flash_lite") else "0"
    os.environ["TRITON_CACHE_DIR"] = str(spec.ROOT / ".cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(spec.ROOT / ".cache" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def fail(msg: str, code: int = 2) -> None:
    print(f"benchmark: {msg}", file=sys.stderr)
    raise SystemExit(code)


def main(argv=None, device=None, cell: Optional[spec.Cell] = None) -> Dict:
    """Run one cell; `device` and `cell` are given only by the tests, which
    run a tiny cell on the CPU."""
    args = parse_args(argv)
    cell = cell or spec.load(args.workload)
    set_environment(cell)
    import torch

    if device is None:
        chips = cell.entry["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            fail(f"the cell needs {chips} CUDA device(s); found "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
        import vexpress_torch  # noqa: F401  (the program, before the clock of set-up stops)
    kind = importlib.import_module(f"benchmark.kinds.{cell.traffic['kind']}")
    run = kind.Run(cell, args.seed, device)
    run.setup()
    setup_s = time.perf_counter() - T_START
    window_s = run.window(args.seconds, bool(args.trace))
    e2e = run.end_to_end(window_s)
    peak = (torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0)
    run.release()
    found = loaded_forbidden()
    if found:
        fail(f"modules of JAX or of the JAX package are loaded: {found}")
    checks = run.check() if not run.failed else {}
    correct = not run.failed and all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if args.trace:
        facts = run.facts()
        for m in cell.per_layer:
            value = spec.reader(m["name"])(facts)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(e2e, setup_s=setup_s, peak_reserved_gib=peak / 2**30)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.entry["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": dev}
    if args.trace and run.trace is not None:
        dev["busy_s"], dev["window_s"] = run.trace.busy_s, run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
        for name, seconds in run.trace.top_operations():
            print(f"device op {seconds!r} s {name}", file=sys.stderr)
    if run.error:
        print(f"benchmark: {run.error}", file=sys.stderr)
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
