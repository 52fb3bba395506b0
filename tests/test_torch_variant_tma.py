"""The host side of T1 and T2 on the card (csrc/flash_variants.cu and
csrc/splash_fwd.cu, both the bf16 forward of csrc/flash_fwd_wgmma.cuh) on the
CPU: the TMA geometry that ops/flash_tma.py computes for each of their 12
tilings over (B, H, L, D) tensors and over head-major views of packed (B, L,
H*D) ones, a numpy model of the boxes the kernel asks for under both layouts,
the shared memory an SM holds, the refusals, and the check of the library's
tiles against flash_tma's.
"""

import numpy as np
import pytest
import torch

from vexpress_torch.ops import flash_tma, flash_variants, splash

# (kind, tiling) of every instantiation
TILINGS = ([("t1", t) for t in sorted(flash_variants.TILINGS)]
           + [("t2", t) for t in sorted(splash.TILINGS)])
IDS = [f"{kind}-{'x'.join(map(str, t))}" for kind, t in TILINGS]
BENCH = (48, 8, 4096, 40)  # (B, H, L, D) of the attention-variant bench
CARD = (2, 4, 512, 40)  # tests/test_torch_attn_variants_cuda.py's shape


def contiguous_strides(b, h, length, d):
    """(batch, head, row) element strides of a contiguous (B, H, L, D) tensor."""
    return (h * length * d, length * d, d)


def packed_view_strides(b, h, length, d):
    """... of a head-major view of a contiguous packed (B, L, H*D) tensor."""
    return (length * h * d, d, h * d)


LAYOUTS = {"contiguous": contiguous_strides, "packed_view": packed_view_strides}


def geometry(kind, tiling, shape, layout):
    b, h, length, d = shape
    st = LAYOUTS[layout](b, h, length, d)
    return flash_tma.variant_geometry(kind, tiling, b, h, length, length, d, st, st)


def test_the_tables_are_the_bench_rows():
    assert len(flash_variants.TILINGS) == 9 and len(splash.TILINGS) == 3
    assert flash_variants.TILINGS == set(flash_tma.T1_TILES)
    assert splash.TILINGS == set(flash_tma.T2_TILES)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("shape", [BENCH, CARD], ids=["bench", "card"])
@pytest.mark.parametrize("kind,tiling", TILINGS, ids=IDS)
def test_variant_geometry_meets_tma_rules(kind, tiling, shape, layout):
    b, h, length, d = shape
    geom = geometry(kind, tiling, shape, layout)
    assert flash_tma.tma_violations(geom) == []
    t = flash_tma.variant_tile(kind, tiling)
    bq, bk, nv, hb = geom["tiling"]
    assert (bq, bk, nv) == tuple(tiling[:3]) and hb == (tiling[3] if kind == "t1" else 1)
    row_dim = 1 if layout == "contiguous" else 2
    for name, rows in (("q", bq), ("kv", bk)):
        m = geom[name]
        assert m["row_dim"] == row_dim
        assert m["dims"][0] == d and m["dims"][row_dim] == length and m["dims"][3] == b
        assert m["dims"][3 - row_dim] == h
        assert list(m["strides"]) == sorted(m["strides"])  # the tensor's memory order
        assert m["box"][0] == 64 and m["box"][row_dim] == rows and m["box"][3 - row_dim] == 1
    assert geom["padded_head_dim"] == nv and geom["chunks"] * 64 >= nv
    assert geom["grid"] == (length // bq, b * h // hb)
    assert geom["smem"] == t["smem"] and geom["threads"] == t["threads"] == 128 * (bq // 64 + 1)
    arg = list(flash_tma.variant_geometry_arg(geom))
    assert len(arg) == 22 and arg[:7] == [128, 64, bq, bk, *geom["grid"], geom["smem"]]
    assert arg[21] == (3 if layout == "contiguous" else 0)


@pytest.mark.parametrize("kind,tiling", TILINGS, ids=IDS)
def test_blocks_of_an_sm_fit_its_shared_memory(kind, tiling):
    """Shared memory a block times the blocks an SM stays within an H100's
    232448 bytes; Q takes a second buffer where a block walks several pairs."""
    t = flash_tma.variant_tile(kind, tiling)
    assert t["smem"] * t["blocks_per_sm"] <= flash_tma.SMEM_LIMIT
    bq, bk, nv, hb = flash_tma._tiling4(kind, tiling)
    chunks = -(-nv // 64)
    tiles = (2 if hb > 1 else 1) * chunks * bq * 128 + 2 * t["stages"] * chunks * bk * 128
    assert t["smem"] == tiles + 8 * (2 * t["stages"] + (2 if hb > 1 else 1)) + 1024
    assert tuple(t) == flash_tma.VARIANT_TILE_FIELDS


def _box(flat: np.ndarray, m: dict, col: int, h: int, row: int, b: int) -> np.ndarray:
    """The (rows, cols) box the kernel asks of map `m` for pair (b, h) from
    `row` and column `col`, read from the flat buffer by the map's dims and
    byte strides, zeros past the tensor's bounds (TMA's fill)."""
    coord = (col, row, h, b) if m["row_dim"] == 1 else (col, h, row, b)
    elem = (1,) + tuple(s // 2 for s in m["strides"])
    idx = np.meshgrid(*(c + np.arange(n) for c, n in zip(coord, m["box"])), indexing="ij")
    inside = np.ones(idx[0].shape, bool)
    off = np.zeros(idx[0].shape, np.int64)
    for i, dim, st in zip(idx, m["dims"], elem):
        inside &= i < dim
        off += np.where(i < dim, i, 0) * st
    out = np.where(inside, flat[off], 0)
    rows = m["box"][m["row_dim"]]
    return out.reshape(m["box"][0], rows).T  # (rows, cols)


@pytest.mark.parametrize("kind,tiling", [TILINGS[0], TILINGS[4], TILINGS[-1]],
                         ids=[IDS[0], IDS[4], IDS[-1]])
def test_both_layouts_address_the_same_elements(kind, tiling):
    """A map over a head-major view of a packed (B, L, H*D) tensor and one over
    the same values as a contiguous (B, H, L, D) tensor give the same boxes at
    every (pair, row tile, chunk) the kernel asks for; both are the tensor's
    rows with zeros past D."""
    b, h, length, d = 2, 3, 256, 40
    packed = np.arange(b * length * h * d, dtype=np.int64) + 1  # (B, L, H*D), no zero
    bhld = packed.reshape(b, length, h, d).transpose(0, 2, 1, 3)
    contiguous = np.ascontiguousarray(bhld).reshape(-1)
    views = {layout: geometry(kind, tiling, (b, h, length, d), layout)
             for layout in ("packed_view", "contiguous")}
    assert views["packed_view"]["q"]["dims"] == flash_tma._tensor_map(b, length, h, d, 1, 128)[
        "dims"]
    bq, bk, nv, _ = views["contiguous"]["tiling"]
    for name, rows in (("q", bq), ("kv", bk)):
        for bb in range(b):
            for hh in range(h):
                for row in range(0, length, rows):
                    for col in range(0, -(-nv // 64) * 64, 64):
                        a = _box(packed, views["packed_view"][name], col, hh, row, bb)
                        c = _box(contiguous, views["contiguous"][name], col, hh, row, bb)
                        want = np.zeros((rows, 64), np.int64)
                        part = bhld[bb, hh, row:row + rows, col:d]
                        want[:part.shape[0], :part.shape[1]] = part
                        np.testing.assert_array_equal(a, want)
                        np.testing.assert_array_equal(c, want)


@pytest.mark.parametrize("shape,message", [
    ((2, 4, 512 + 64, 40), "not whole tiles"),
    ((3, 1, 512, 40), "not whole blocks"),
])
@pytest.mark.parametrize("kind,tiling", [("t1", (128, 64, 48, 4)), ("t2", (128, 128, 48))],
                         ids=["t1", "t2"])
def test_tiles_and_pairs_must_divide(kind, tiling, shape, message):
    geom = geometry(kind, tiling, shape, "contiguous")
    bad = flash_tma.tma_violations(geom)
    if kind == "t2" and message == "not whole blocks":  # one pair a block divides any B*H
        assert bad == []
    else:
        assert any(message in m for m in bad), bad


def test_strides_that_do_not_rise_are_refused():
    """A batch stride below the head stride is no memory order the kernel maps."""
    geom = flash_tma.variant_geometry("t1", (64, 64, 48, 1), 2, 4, 512, 512, 40,
                                      (40, 2 * 512 * 40, 2 * 40), (40, 2 * 512 * 40, 2 * 40))
    assert any("rise with the dimension" in m for m in flash_tma.tma_violations(geom))


def test_unbuilt_tiling_gets_a_geometry_for_the_launch_to_refuse():
    geom = geometry("t1", (128, 128, 48, 1), CARD, "contiguous")
    assert flash_tma.tma_violations(geom) == []
    assert geom["blocks_per_sm"] == 1 and flash_tma.variant_tile("t1", (128, 128, 48, 1))[
        "stages"] == 3


@pytest.mark.parametrize("case,message", [
    ("misaligned", "16-byte aligned"),
    ("strided_head_dim", "contiguous head dim"),
    ("kv_layouts", "one layout"),
    ("dtype", "bfloat16"),
    ("head_dim", "head dim 40"),
])
def test_kernel_tensor_check_refuses(case, message):
    q = k = v = torch.zeros(1, 2, 128, 40, dtype=torch.bfloat16)
    if case == "misaligned":
        q = torch.zeros(2 * 128 * 40 + 1, dtype=torch.bfloat16)[1:].view(1, 2, 128, 40)
    elif case == "strided_head_dim":
        q = torch.zeros(1, 2, 40, 128, dtype=torch.bfloat16).transpose(2, 3)
    elif case == "kv_layouts":
        v = torch.zeros(1, 128, 2 * 40, dtype=torch.bfloat16).view(1, 128, 2, 40).transpose(1, 2)
    elif case == "dtype":
        q = k = v = torch.zeros(1, 2, 128, 40)
    elif case == "head_dim":
        q = k = v = torch.zeros(1, 2, 128, 48, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=message):
        flash_variants.check_kernel_tensors("flash_fwd_variant", q, k, v)


def test_kernel_tensor_check_takes_both_layouts():
    packed = torch.zeros(2, 128, 4 * 40, dtype=torch.bfloat16).view(2, 128, 4, 40).transpose(1, 2)
    flash_variants.check_kernel_tensors("t", packed, packed, packed)
    bhld = torch.zeros(2, 4, 128, 40, dtype=torch.bfloat16)
    flash_variants.check_kernel_tensors("t", bhld, bhld, bhld)


def test_launch_geometry_is_cached_and_checked():
    flash_variants._variant_geometry.cache_clear()
    q = torch.zeros(2, 4, 512, 40, dtype=torch.bfloat16)
    first = flash_variants.launch_geometry("flash_fwd_variant", "t1", (64, 64, 48, 2), q, q)
    assert flash_variants.launch_geometry("flash_fwd_variant", "t1", (64, 64, 48, 2), q, q) is first
    with pytest.raises(ValueError, match="flash_fwd_variant kernel cannot take this launch"):
        flash_variants.launch_geometry("flash_fwd_variant", "t1", (64, 128, 48, 2),
                                       torch.zeros(2, 4, 512, 40), torch.zeros(2, 4, 576, 40))


class _FakeVariantLibrary:
    """Stands in for the built library's vx_flash_fwd_variant_tile and
    vx_splash_mha_tile."""

    def __init__(self, tiles):
        self.tiles, self.calls = tiles, 0

    def _tile(self, key, out):
        self.calls += 1
        if key not in self.tiles:
            return 1  # cudaErrorInvalidValue: no instantiation
        for i, name in enumerate(flash_tma.VARIANT_TILE_FIELDS):
            out[i] = self.tiles[key][name]
        return 0

    def vx_flash_fwd_variant_tile(self, bq, bk, dp, hb, out):
        return self._tile(("t1", bq, bk, dp, hb), out)

    def vx_splash_mha_tile(self, bq, bkv, dp, out):
        return self._tile(("t2", bq, bkv, dp), out)


def _built(kind, tiling, **change):
    return {(kind,) + tuple(tiling): dict(flash_tma.variant_tile(kind, tiling), **change)}


@pytest.fixture
def fresh_variant_checks(monkeypatch):
    monkeypatch.setattr(flash_variants, "_tiles_checked", {"t1": set(), "t2": set()})


@pytest.mark.parametrize("kind,tiling", TILINGS, ids=IDS)
def test_library_tile_check_passes_once(fresh_variant_checks, kind, tiling):
    lib = _FakeVariantLibrary(_built(kind, tiling))
    for _ in range(2):
        flash_variants.check_library_tile(lib, kind, tiling)
    assert lib.calls == 1 and flash_variants._tiles_checked[kind] == {tiling}


@pytest.mark.parametrize("field", ["tile_k", "blocks_per_sm", "stages", "smem", "threads"])
@pytest.mark.parametrize("kind,tiling", [("t1", (64, 128, 48, 4)), ("t2", (64, 64, 64))],
                         ids=["t1", "t2"])
def test_library_tile_check_names_a_mismatch(fresh_variant_checks, kind, tiling, field):
    """A library built to another tiling than flash_tma's (say, TILINGS
    edited on one side only) raises before any launch."""
    built = _built(kind, tiling)
    built[(kind,) + tiling][field] += 1
    with pytest.raises(RuntimeError, match="the library's tiling"):
        flash_variants.check_library_tile(_FakeVariantLibrary(built), kind, tiling)
    assert not flash_variants._tiles_checked[kind]


def test_library_tile_check_leaves_unbuilt_tilings_to_the_launch(fresh_variant_checks):
    flash_variants.check_library_tile(_FakeVariantLibrary({}), "t1", (128, 128, 48, 1))
    assert not flash_variants._tiles_checked["t1"]
