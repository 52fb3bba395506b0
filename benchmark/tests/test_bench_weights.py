"""The seeded weights: drawn in runs of at most CHUNK values, in the
table's order, the same on every fill with one seed."""

import torch

from benchmark import weights


def test_chunks_keep_the_order_and_the_size():
    n = weights.CHUNK
    entries = [("a.w", (n // 2, 1)), ("a.x", (n // 2, 1)), ("a.y", (2, n)), ("a.z", (3, 4))]
    groups = weights.chunks(entries)
    assert [k for g in groups for k, _ in g] == [k for k, _ in entries]
    assert [[k for k, _ in g] for g in groups] == [["a.w", "a.x"], ["a.y"], ["a.z"]]


def test_one_seed_fills_alike():
    def mods():
        torch.manual_seed(0)
        return {"m": torch.nn.Sequential(torch.nn.Linear(5, 7), torch.nn.LayerNorm(7))}

    a, b = mods(), mods()
    table = weights.table(a)
    weights.fill(a, table, 2**31 + 5)
    weights.fill(b, table, 2**31 + 5)
    for (_, p), (_, q) in zip(a["m"].named_parameters(), b["m"].named_parameters()):
        assert torch.equal(p, q)
    assert float(a["m"][0].weight.std()) > 0.005 and torch.all(a["m"][1].weight == 1)
    assert torch.all(a["m"][0].bias == 0)
