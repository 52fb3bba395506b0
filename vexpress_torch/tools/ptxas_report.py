"""Registers, shared memory and spills of every kernel in vexpress_torch/csrc,
as ptxas reports them for sm_90a with the flags of the library build
(ops/flash.py: NVCC_FLAGS), one nvcc per source, all at once. Needs nvcc.

    python -m vexpress_torch.tools.ptxas_report

Prints one line per kernel: source, registers, shared memory bytes, spill
stores and loads, and the demangled name; then every warning nvcc or ptxas
gave (a `setmaxnreg` that ptxas ignored, wgmma it had to serialise).

`sass_ops` reads the built library's SASS (cuobjdump, from the toolkit) and
counts the lines of some opcodes in each kernel: chip_smoke.py and the card
tests check that the bf16 forward and backward kernels hold HGMMA (wgmma)
and UTMALDG (TMA loads), and chip_smoke.py that they hold no more
WARPGROUP.DEPBAR (a wait on the warpgroup's wgmma) than the fixed waits
their code issues: ptxas adds one after every wgmma it serialises.
"""

from __future__ import annotations

import pathlib
import re
import shutil
import subprocess
import tempfile
from collections import Counter
from typing import Dict, List

from ..ops import flash


def _demangle(names: List[str], nvcc: str) -> Dict[str, str]:
    tool = pathlib.Path(nvcc).with_name("cu++filt")
    tool = str(tool) if tool.exists() else shutil.which("c++filt")
    if not tool or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return dict(zip(names, out))


def parse(source: str, log: str) -> List[dict]:
    """Kernels of one ptxas -v log: name, registers, smem, spill bytes."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = dict(source=source, mangled=m.group(1), registers=None, smem=0,
                       spill_stores=0, spill_loads=0)
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(s.group(1)) if s else 0
    return rows


def sass_ops(library: pathlib.Path, name_part: str,
             opcodes=("HGMMA", "UTMALDG", "MUFU.EX2", "HMMA", "WARPGROUP.DEPBAR")
             ) -> Dict[str, Counter]:
    """Kernels of the built `library` whose mangled name holds `name_part`,
    each with the count of SASS lines that hold each of the `opcodes` it
    holds."""
    tool = pathlib.Path(flash.nvcc_path()).with_name("cuobjdump")
    out = subprocess.run([str(tool) if tool.exists() else "cuobjdump", "-sass", str(library)],
                         capture_output=True, text=True, check=True, timeout=600).stdout
    found: Dict[str, Counter] = {}
    cur = None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1) if name_part in m.group(1) else None
            if cur:
                found[cur] = Counter()
        elif cur:
            found[cur].update(op for op in opcodes if op in line)
    return found


def main(argv=None) -> List[dict]:
    nvcc = flash.nvcc_path()
    sources = sorted(flash._CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([nvcc, *flash.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                                   str(pathlib.Path(tmp) / (src.stem + ".o")), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src in sources]
        rows, warnings = [], []
        for src, proc in zip(sources, procs):
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc {src.name} failed ({proc.returncode}):\n{log}")
            rows += parse(src.name, log)
            warnings += [f"{src.name}: {line.strip()}" for line in log.splitlines()
                         if "warning" in line.lower()]
    names = _demangle([r["mangled"] for r in rows], nvcc)
    for r in rows:
        r["name"] = names[r["mangled"]]
        print(f"{r['source']:<20} {r['registers']:>4} regs {r['smem']:>6} B smem "
              f"spill {r['spill_stores']}/{r['spill_loads']} B  {r['name']}", flush=True)
    for w in warnings:
        print(w, flush=True)
    return rows


if __name__ == "__main__":
    main()
