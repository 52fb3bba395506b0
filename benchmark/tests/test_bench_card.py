"""On the card, at each cell's own size, one seed: the program reads within
the cell's limits and the control (the reference one precision below the
configuration's) does not. The benchmark's runs do not run the control.

  python -m pytest benchmark/tests/test_bench_card.py -m cuda -q"""

import importlib

import pytest

from benchmark import spec

CELLS = ["infer.ddim25.f44", "infer.dpm12.f44.fused"]
SEED = 3_000_000_777


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits_at_the_cells_size(card, name):
    cell = spec.load(name)
    kind = importlib.import_module(f"benchmark.kinds.{cell.traffic['kind']}")
    row = next(kind.calibrate(cell, [SEED], card, control=1))
    limits = cell.cell["limits"]
    assert all(row["program"][k] <= v for k, v in limits.items()), row
    assert any(row["control"][k] > v for k, v in limits.items()), row
