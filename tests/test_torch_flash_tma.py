"""The host side of the bf16 forward kernel (vexpress_torch/csrc/
flash_fwd_wgmma.cuh) and of the fp32 one (csrc/flash_fwd_tf32.cuh) on the
CPU: the TMA geometry that ops/flash_tma.py computes for every shape the main
paths and the kernel phase's fp32 rows launch, the wrapper's refusals, and
K2's packed-exp rounding (ops/flash_lite.py::lite_packed_exp) against the JAX
package's Pallas K2 in interpret mode.

K2's bar: tests/test_flash_lite.py's 0.03 absolute against exact fp32
attention, and the same 0.03 against the Pallas kernel. At (B, H, L, D) =
(1, 2, 256, 40), bf16, key blocks of 128, the emulation reads max |d| 1.95e-3
against the Pallas kernel and 1.98e-3 against exact fp32 (the Pallas kernel
itself 1.82e-3 against exact fp32; the plain version without the packed exp
1.95e-3 against the Pallas kernel).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import K1_EXTRA, K1_G2_SHAPES, K1_SHAPES, TRAIN_K1_EXTRA, TRAIN_K1_SHAPES
from vexpress_tpu.ops.flash_lite import flash_lite_fwd
from vexpress_torch.ops import flash, flash_tma, launches
from vexpress_torch.ops.flash_lite import flash_lite_reference, lite_packed_exp

# (name, B, Lq, Lk, H, D) of every bf16 shape the kernel phase checks
SHAPES = sorted({(n, b, lq, lk, h, i // h)
                 for n, b, lq, lk, i, h, *dt in K1_SHAPES + K1_G2_SHAPES + TRAIN_K1_SHAPES
                 + K1_EXTRA + TRAIN_K1_EXTRA if not dt or dt[0] == "bfloat16"})
LAUNCHES = [(s, flash_tma.SWIZZLE[s[5]]) for s in SHAPES]
# (name, B, Lq, Lk, H, D) of every fp32 shape the kernel phase checks
F32_SHAPES = sorted({(n, b, lq, lk, h, i // h)
                     for n, b, lq, lk, i, h, *dt in K1_EXTRA + TRAIN_K1_EXTRA
                     if dt[0] == "float32"})


def test_shapes_cover_the_paths():
    assert {s[5] for s in SHAPES} == {40, 80, 160}
    assert len(SHAPES) == 15  # 6 inference, 4 at window_group 2, 4 training, D=160


@pytest.mark.parametrize("shape,swizzle", LAUNCHES, ids=lambda x: str(x))
def test_geometry_meets_tma_rules(shape, swizzle):
    _, b, lq, lk, h, d = shape
    geom = flash_tma.fwd_geometry(b, lq, lk, h, d)
    assert geom["swizzle"] == swizzle
    assert flash_tma.tma_violations(geom) == []
    for name, length, rows in (("q", lq, 128), ("kv", lk, 128 if d == 80 else 64)):
        m = geom[name]
        assert m["dims"] == (d, h, length, b)
        assert m["strides"] == (2 * d, 2 * h * d, 2 * length * h * d)
        assert all(s % 16 == 0 and s < 2**40 for s in m["strides"])
        assert m["box"] == (swizzle // 2, 1, rows, 1)
        assert all(0 < n <= 256 for n in m["box"])
        assert m["box"][0] * 2 <= swizzle  # a box row within the swizzle span
    nv = geom["padded_head_dim"]
    assert nv % 16 == 0 and d <= nv < d + 16  # whole wgmma k-steps, no more
    assert geom["smem_head_dim"] >= nv and geom["chunks"] * swizzle // 2 == geom["smem_head_dim"]
    assert geom["grid"] == (-(-lq // 128), b * h) and geom["grid"][1] <= 65535
    assert geom["smem"] * flash_tma.blocks_per_sm(d) <= flash_tma.SMEM_LIMIT
    arg = list(flash_tma.geometry_arg(geom))
    assert len(arg) == 21 and arg[0] == swizzle and arg[6] == geom["smem"]


def test_default_layout_is_instantiated():
    """One layout per head dim is built; any other swizzle is refused."""
    for d, sw in flash_tma.SWIZZLE.items():
        geom = flash_tma.fwd_geometry(1, 128, 128, 8, d)
        assert geom["swizzle"] == sw and not flash_tma.tma_violations(geom)
        for other in {32, 64, 128} - {sw}:
            assert any("no instantiation" in m
                       for m in flash_tma.tma_violations(dict(geom, swizzle=other)))


@pytest.mark.parametrize("d", sorted(flash_tma.SWIZZLE))
def test_tile_is_the_launch_geometry(d):
    """`tile` (what the library's vx_flash_fwd_tile must report) is what
    fwd_geometry hands the kernel: box columns and rows, shared memory."""
    t = flash_tma.tile(d)
    assert tuple(t) == flash_tma.TILE_FIELDS
    geom = flash_tma.fwd_geometry(2, 256, 256, 8, d)
    assert t["swizzle"] == geom["swizzle"] and t["box_cols"] * 2 == t["swizzle"]
    assert geom["q"]["box"] == (t["box_cols"], 1, t["tile_q"], 1)
    assert geom["kv"]["box"] == (t["box_cols"], 1, t["tile_k"], 1)
    assert geom["smem"] == t["smem"] and geom["threads"] == t["threads"]
    arg = list(flash_tma.geometry_arg(geom))
    assert arg[:4] == [t["swizzle"], t["box_cols"], t["tile_q"], t["tile_k"]]


def test_f32_shapes_cover_the_head_dims():
    assert {s[5] for s in F32_SHAPES} == set(flash_tma.F32_TILES) == {40, 80, 160}


@pytest.mark.parametrize("shape", F32_SHAPES, ids=lambda x: str(x))
def test_f32_geometry_meets_tma_rules(shape):
    """The fp32 kernel's maps: Q's and K's parts in q's and k's layout with
    4-byte elements, V^T's parts (Lk, D, H, B); boxes within TMA's limits and
    their swizzle spans; whole key tiles; the shared memory within the SM's."""
    _, b, lq, lk, h, d = shape
    geom = flash_tma.f32_geometry(b, lq, lk, h, d)
    t = flash_tma.f32_tile(d)
    assert flash_tma.tma_violations(geom) == []
    for name, length, rows in (("q", lq, t["tile_q"]), ("kv", lk, t["tile_k"])):
        m = geom[name]
        assert m["dims"] == (d, h, length, b)
        assert m["strides"] == (4 * d, 4 * h * d, 4 * length * h * d)
        assert m["box"] == (t["box_cols"], 1, rows, 1) and t["box_cols"] * 4 == t["swizzle"]
    vt = geom["vt"]
    assert vt["dims"] == (lk, d, h, b) and vt["strides"] == (4 * lk, 4 * d * lk, 4 * h * d * lk)
    assert vt["box"] == (t["v_box_cols"], d, 1, 1) and t["v_box_cols"] * 4 == vt["swizzle"]
    for m in (geom["q"], geom["kv"], vt):
        assert all(s % 16 == 0 and s < 2**40 for s in m["strides"])
        assert all(0 < n <= 256 for n in m["box"])
    assert d % 8 == 0 and lk % t["tile_k"] == 0 and t["tile_k"] % t["v_box_cols"] == 0
    assert geom["grid"] == (-(-lq // t["tile_q"]), b * h) and geom["grid"][1] <= 65535
    assert geom["smem"] == t["smem"] <= flash_tma.SMEM_LIMIT
    assert geom["scratch_floats"] == 2 * b * lq * h * d + 4 * b * lk * h * d
    arg = list(flash_tma.f32_geometry_arg(geom))
    assert len(arg) == 30
    assert arg[:9] == [t["swizzle"], t["box_cols"], t["v_swizzle"], t["v_box_cols"],
                       t["tile_q"], t["tile_k"], *geom["grid"], t["smem"]]


@pytest.mark.parametrize("d", sorted(flash_tma.F32_TILES))
def test_f32_tile_is_the_shared_memory_layout(d):
    """f32_tile (what vx_flash_fwd_f32_tile must report): Q's two parts,
    3 stages of K's and V^T's two parts, the barriers and the slack, every
    part a whole number of swizzle periods (8 rows of its span)."""
    t = flash_tma.f32_tile(d)
    assert tuple(t) == flash_tma.F32_TILE_FIELDS
    sw, bq, bk = flash_tma.F32_TILES[d]
    chunks = -(-d // (sw // 4))
    q_part, k_part = chunks * bq * sw, chunks * bk * sw
    v_part = bk // t["v_box_cols"] * d * t["v_swizzle"]
    assert t["smem"] == 2 * q_part + 3 * (2 * k_part + 2 * v_part) + 8 * 7 + 1024
    for part, span in ((q_part, sw), (k_part, sw), (v_part, t["v_swizzle"])):
        assert part % (8 * span) == 0
    assert t["threads"] == 128 * (bq // 64 + 1) and t["blocks_per_sm"] == 1
    assert chunks * sw // 4 - d < sw // 4  # no chunk wholly past D


def test_f32_violations_are_named():
    geom = flash_tma.f32_geometry(2, 1024, 1024, 8, 40)
    assert any("no instantiation" in m
               for m in flash_tma.tma_violations(dict(geom, swizzle=128)))
    vt = dict(geom["vt"], box=(64, 40, 1, 1))
    assert any("swizzle span" in m for m in flash_tma.tma_violations(dict(geom, vt=vt)))
    kv = dict(geom["kv"], dims=(40, 8, 1000, 2))
    assert any("whole tiles" in m for m in flash_tma.tma_violations(dict(geom, kv=kv)))
    with pytest.raises(ValueError, match="no instantiation for D=64"):
        flash._f32_geometry(1, 128, 128, 2, 64)


class _FakeF32TileLibrary:
    """Stands in for the built library's vx_flash_fwd_f32_tile."""

    def __init__(self, tiles):
        self.tiles = tiles

    def vx_flash_fwd_f32_tile(self, d, out):
        if d not in self.tiles:
            return 1
        for i, name in enumerate(flash_tma.F32_TILE_FIELDS):
            out[i] = self.tiles[d][name]
        return 0


@pytest.mark.parametrize("field", flash_tma.F32_TILE_FIELDS)
def test_f32_tile_check_names_a_mismatch(monkeypatch, field):
    monkeypatch.setattr(flash, "_f32_tiles_checked", set())
    flash._check_f32_tile(_FakeF32TileLibrary({d: flash_tma.f32_tile(d)
                                               for d in flash_tma.F32_TILES}), 160)
    assert flash._f32_tiles_checked == {160}
    built = dict(flash_tma.f32_tile(80))
    built[field] += 16
    with pytest.raises(RuntimeError, match="fp32 forward at D=80: the library's tiling"):
        flash._check_f32_tile(_FakeF32TileLibrary({80: built}), 80)


class _FakeTileLibrary:
    """Stands in for the built library's vx_flash_fwd_tile."""

    def __init__(self, tiles):
        self.tiles, self.calls = tiles, 0

    def vx_flash_fwd_tile(self, d, out):
        self.calls += 1
        if d not in self.tiles:
            return 1  # cudaErrorInvalidValue: no instantiation
        for i, name in enumerate(flash_tma.TILE_FIELDS):
            out[i] = self.tiles[d][name]
        return 0


@pytest.fixture
def fresh_tile_checks(monkeypatch):
    monkeypatch.setattr(flash, "_tiles_checked", set())


def test_tile_check_passes_once_per_head_dim(fresh_tile_checks):
    lib = _FakeTileLibrary({d: flash_tma.tile(d) for d in flash_tma.SWIZZLE})
    for d in (40, 40, 80):
        flash._check_tile(lib, d)
    assert lib.calls == 2 and flash._tiles_checked == {40, 80}


def test_tile_check_leaves_unbuilt_head_dims_to_the_launch(fresh_tile_checks):
    flash._check_tile(_FakeTileLibrary({}), 64)
    assert not flash._tiles_checked


@pytest.mark.parametrize("field", flash_tma.TILE_FIELDS)
def test_tile_check_names_a_mismatch(fresh_tile_checks, field):
    """A library built to another tiling than flash_tma's raises before any
    launch, for each field of the tile."""
    built = dict(flash_tma.tile(80))
    built[field] += 16
    with pytest.raises(RuntimeError, match="the library's tiling"):
        flash._check_tile(_FakeTileLibrary({80: built}), 80)
    assert not flash._tiles_checked


def test_launch_geometry_is_cached_and_checked():
    flash._tma_geometry.cache_clear()
    first = flash._tma_geometry(48, 4096, 4096, 8, 40)
    assert flash._tma_geometry(48, 4096, 4096, 8, 40) is first
    assert list(first) == list(flash_tma.geometry_arg(flash_tma.fwd_geometry(48, 4096, 4096, 8,
                                                                               40)))
    with pytest.raises(ValueError, match="no instantiation for D=64"):
        flash._tma_geometry(1, 128, 128, 2, 64)


@pytest.mark.parametrize("change,message", [
    (dict(swizzle=64), "no instantiation"),
    (dict(kv=dict(dims=(40, 8, 4096, 48), strides=(72, 640, 2621440), box=(64, 1, 128, 1))),
     "byte strides"),
    (dict(q=dict(dims=(40, 8, 4096, 48), strides=(80, 640, 2621440), box=(64, 1, 512, 1))),
     "box"),
    (dict(q=dict(dims=(40, 8, 4096, 48), strides=(80, 640, 2621440), box=(128, 1, 128, 1))),
     "swizzle span"),
    (dict(smem=300000), "shared memory"),
    (dict(grid=(32, 70000)), "grid y"),
])
def test_violations_are_named(change, message):
    geom = dict(flash_tma.fwd_geometry(48, 4096, 4096, 8, 40), **change)
    bad = flash_tma.tma_violations(geom)
    assert bad and any(message in m for m in bad), bad


def _packed(b, l, inner, dtype=torch.bfloat16):
    return torch.zeros(b, l, inner, dtype=dtype)


@pytest.mark.parametrize("case,message", [
    ("misaligned", "16-byte aligned"),
    ("strided", "contiguous"),
    ("head_dim", "head dims"),
    ("rows", "multiples of 64"),
    ("dtype", "take"),
])
def test_layout_check_refuses(case, message):
    q = k = v = _packed(1, 128, 80)
    if case == "misaligned":  # one element in: the pointer is 2 bytes off
        q = torch.zeros(1 * 128 * 80 + 1, dtype=torch.bfloat16)[1:].view(1, 128, 80)
    elif case == "strided":
        q = _packed(1, 80, 128).transpose(1, 2)
    elif case == "head_dim":
        q = k = v = _packed(1, 128, 128)
    elif case == "rows":
        q = _packed(1, 96, 80)
    elif case == "dtype":
        q = k = v = _packed(1, 128, 80, torch.float16)
    with pytest.raises(ValueError, match=message):
        flash.check_kernel_layout(2, q=q, k=k, v=v)


def test_layout_check_takes_the_main_path_layout():
    flash.check_kernel_layout(8, q=_packed(2, 128, 320), k=_packed(2, 256, 320),
                              v=_packed(2, 256, 320))


def test_kernel_wrapper_refuses_cpu_tensors():
    """The launch path never runs a plain version in the kernel's place."""
    q = _packed(1, 128, 80)
    launches.reset()
    for call in (lambda: flash._launch_fwd(q, q, q, 2, 0.1),
                 lambda: flash.launch_lite(q, q, q, 2, 0.1)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    assert not launches.counts


def test_packed_exp_rounding():
    """bf16(2^bf16(bf16(x) log2 e)) against bf16(exp(bf16(x))), the TPU
    kernel's p, over the range p takes: within 2^-8 (one bf16 ulp of p in
    [0.5, 1)) everywhere, within two bf16 ulps of p where p >= 0.5. The
    rounding of x log2(e) to bf16 costs more of p's own ulps as x falls
    (measured: 3.4 at x in [-4, -1], 23 at x < -12), where p is small."""
    x = -torch.linspace(0, 30, 30001)
    packed = lite_packed_exp(x)
    tpu = torch.exp(x.to(torch.bfloat16).float()).to(torch.bfloat16).float()
    assert packed.dtype == torch.float32
    assert torch.equal(packed, packed.to(torch.bfloat16).float())  # bf16 values
    assert float((packed - tpu).abs().max()) <= 2.0**-8
    top = tpu >= 0.5
    assert float(((packed - tpu).abs() / tpu)[top].max()) <= 2 * 2.0**-8
    assert float(lite_packed_exp(torch.tensor([0.0]))) == 1.0


def test_packed_exp_emulation_against_pallas_k2():
    b, h, l, d = 1, 2, 256, 40
    q, k, v = (np.asarray(jax.random.normal(jax.random.PRNGKey(i), (b, h, l, d), jnp.bfloat16)
                          .astype(jnp.float32)) for i in range(3))
    scale = d**-0.5
    pallas = np.asarray(flash_lite_fwd(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), scale,
                                       block_q=128, block_k=128, interpret=True), np.float32)
    packed = [torch.from_numpy(x.transpose(0, 2, 1, 3).reshape(b, l, h * d).copy())
              .to(torch.bfloat16) for x in (q, k, v)]
    emul = (flash_lite_reference(*packed, h, scale, block_k=128, packed_exp=True).float()
            .reshape(b, l, h, d).permute(0, 2, 1, 3).numpy())
    logits = np.einsum("bhqd,bhkd->bhqk", q, k) * scale
    w = np.exp(logits - logits.max(-1, keepdims=True))
    exact = np.einsum("bhqk,bhkd->bhqd", w / w.sum(-1, keepdims=True), v)
    assert np.abs(emul - pallas).max() < 0.03
    assert np.abs(emul - exact).max() < 0.03
