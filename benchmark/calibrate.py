"""The readings that a cell's limits are set from, on the card, in one
process: for each seed the program's first window clip (or first steps)
against the plain reference (the lower reading), and for the first
`--control` seeds the control, the reference in fp8 in the program's
place, against the reference (the upper reading).

  python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 ... --control 3 \
      --out chiprun_out/calibrate.<cell>.json

Not part of a benchmark run; its results go into PERF.md."""

from __future__ import annotations

import argparse
import json
import sys

from . import spec
from .run import set_environment


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    cell = spec.load(args.workload)
    set_environment(cell)
    import importlib

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("calibrate: no CUDA device")
    kind = importlib.import_module(f"benchmark.kinds.{cell.traffic['kind']}")
    rows = []
    for row in kind.calibrate(cell, args.seeds, torch.device("cuda", 0), args.control):
        rows.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(0), "rows": rows}
    for key in rows[0]["program"]:
        prog = [r["program"][key] for r in rows]
        ctl = [r["control"][key] for r in rows if "control" in r]
        out[key] = {"lower": max(prog), "upper": min(ctl) if ctl else None}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "rows"}))


if __name__ == "__main__":
    main()
