"""The arithmetic and host side of K1's fp32 backward (vexpress_torch/csrc/
flash_bwd_tf32.cuh, "3xTF32") on the CPU: the plain version of its split
pass (ops/flash.py::tf32_bwd_parts: the row-major parts, and q, do and k
transposed with each 8 rows in TF32_KEY_ORDER), the emulation of both
kernels (flash_sdpa_bwd_tf32_emulated: the same parts and permutation, P
and dS split as the registers hold them, each ring tile's products added in
the kernels' order) under chip_smoke.py's unchanged fp32 gradient bars
against flash_sdpa_bwd_reference and against jax.grad of
vexpress_tpu.ops.attention.sdpa, and a single TF32 product as the control
that must fail the mean bar; then the tiling and TMA geometry of
ops/flash_tma.py (F32_BWD_TILES) and the wrapper's check of the library's
tiling. Inputs from a numpy seed.

The bars (chip_smoke.within_k1_grad_bar, fp32): max |d| <= 1e-4 std(ref),
mean |d| <= 3e-6 std(ref); the LSE is the forward's and not checked here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TRAIN_K1_EXTRA, TRAIN_K1_SHAPES, HIRES_K1_SHAPES, within_k1_grad_bar
from vexpress_tpu.ops import attention as jattn
from vexpress_torch.ops import flash, flash_tma

HEAD_DIMS = (40, 80, 160)
# (Lq, Lk) per head dim: whole 64-row blocks, several ring tiles on each axis
LENGTHS = {40: (256, 512), 80: (512, 128), 160: (128, 256)}
HEADS = 2


def _inputs(b, lq, lk, d, seed=0):
    rng = np.random.default_rng(seed + d)
    return [rng.standard_normal((b, n, HEADS * d), dtype=np.float32) for n in (lq, lk, lk, lq)]


def _emulated(q, k, v, do, products=3):
    """(dq, dk, dv) of the emulation from the plain forward's output and LSE."""
    out, lse = flash.flash_sdpa_reference(q, k, v, HEADS, return_lse=True)
    di = flash.bwd_di(do, out, HEADS)
    return flash.flash_sdpa_bwd_tf32_emulated(q, k, v, do, lse, di, HEADS, products=products)


def _bar(got, ref):
    err = (got - ref).abs()
    return within_k1_grad_bar(False, float(err.max()), float(err.mean()), float(ref.std()),
                              float(ref.abs().max()))


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_emulated_backward_within_fp32_bars_of_plain(d):
    """The 3xTF32 backward's arithmetic against flash_sdpa_bwd_reference in
    fp32 (the oracle the card's rows are held to)."""
    lq, lk = LENGTHS[d]
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, lq, lk, d))
    out, lse = flash.flash_sdpa_reference(q, k, v, HEADS, return_lse=True)
    refs = flash.flash_sdpa_bwd_reference(q, k, v, out, lse, do, HEADS)
    for name, got, ref in zip(("dq", "dk", "dv"), _emulated(q, k, v, do), refs):
        assert got.shape == ref.shape and got.dtype == torch.float32
        ok, tol = _bar(got, ref)
        assert ok, (name, tol)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_emulated_backward_within_fp32_bars_of_jax_grad(d):
    """The same against jax.grad of the JAX package's attention on the CPU."""
    lq, lk = LENGTHS[d]
    q, k, v, do = _inputs(1, lq, lk, d, seed=4)

    def f(qq, kk, vv):
        return jnp.sum(jattn.sdpa(qq, kk, vv, HEADS) * jnp.asarray(do))

    refs = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = _emulated(*(torch.from_numpy(x) for x in (q, k, v, do)))
    for name, g, ref in zip(("dq", "dk", "dv"), got, refs):
        ok, tol = _bar(g, torch.from_numpy(np.array(ref)))
        assert ok, (name, tol)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_single_tf32_product_fails_the_mean_bar(d):
    """The control: each product as one TF32 product (hi hi, 10 mantissa
    bits) misses the fp32 mean bar by more than 10x on every gradient, so
    the bar tells 3xTF32 from TF32."""
    lq, lk = LENGTHS[d]
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, lq, lk, d))
    out, lse = flash.flash_sdpa_reference(q, k, v, HEADS, return_lse=True)
    refs = flash.flash_sdpa_bwd_reference(q, k, v, out, lse, do, HEADS)
    for name, got, ref in zip(("dq", "dk", "dv"), _emulated(q, k, v, do, products=1), refs):
        ok, tol = _bar(got, ref)
        assert not ok, name
        assert float((got - ref).abs().mean()) > 10 * 3e-6 * float(ref.std()), (name, tol)


def test_split_pass_layout():
    """tf32_bwd_parts: q, do, k, v split in their own layout; q, do and k
    transposed to (B, H, D, L) with column 8j + i holding row
    8j + TF32_KEY_ORDER[i]; each pair of parts rebuilds its tensor."""
    b, lq, lk, d = 2, 64, 128, 40
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(b, lq, lk, d, seed=2))
    parts = flash.tf32_bwd_parts(q, k, v, do, HEADS)
    assert tuple(parts) == flash.TF32_BWD_PARTS
    for name, x in (("q", q), ("do", do), ("k", k), ("v", v)):
        hi, lo = flash.split_tf32(x)
        assert torch.equal(parts[name + "h"], hi) and torch.equal(parts[name + "l"], lo)
    for name, x, n in (("qt", q, lq), ("dot", do, lq), ("kt", k, lk)):
        assert parts[name + "h"].shape == (b, HEADS, d, n)
        xt = x.reshape(b, n, HEADS, d).permute(0, 2, 3, 1)  # (B, H, D, L), rows in order
        for j in range(n // 8):
            for i, row in enumerate(flash.TF32_KEY_ORDER):
                hi, lo = flash.split_tf32(xt[..., 8 * j + row])
                assert torch.equal(parts[name + "h"][..., 8 * j + i], hi)
                assert torch.equal(parts[name + "l"][..., 8 * j + i], lo)
        rebuilt = (parts[name + "h"].double() + parts[name + "l"].double())
        assert float((rebuilt.reshape(-1) - flash._transposed(x, HEADS).double().reshape(-1))
                     .abs().max()) <= 2.0**-21 * float(x.abs().max())


def test_accumulator_columns_meet_the_transposed_parts():
    """The A fragments' order (_tf32_a: each 8 columns in TF32_KEY_ORDER, as
    split_a pairs a thread's columns 2t, 2t+1 with k-indices t, t+4) against
    the transposed parts' (rows in the same order): their product is the
    product in natural order (small integers, so every sum is exact)."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(-8, 9, (1, HEADS, 64, 32)).astype(np.float32))
    x = torch.from_numpy(rng.integers(-8, 9, (1, 32, HEADS * 40)).astype(np.float32))
    ah, al = flash._tf32_a(a)
    assert not al.any()
    got = ah @ flash._transposed(x, HEADS).transpose(-1, -2)
    assert torch.equal(got, a @ x.reshape(1, 32, HEADS, 40).transpose(1, 2))


# (B, Lq, Lk, H, D) of chip_smoke.py's fp32 gradient rows (the stage-2
# training shapes, 1024x1024's stage-2 D=160 pair, "fp32 D=40") and of the
# card tests
TRAIN = sorted({(b, lq, lk, h, i // h) for _, b, lq, lk, i, h in TRAIN_K1_SHAPES
                + HIRES_K1_SHAPES[:2]}
               | {(b, lq, lk, h, i // h) for _, b, lq, lk, i, h, dt in TRAIN_K1_EXTRA
                  if dt == "float32"})
CARD = [(2, lq, lk, 2, d) for d in HEAD_DIMS
        for lq, lk in ((192, 320), (320, 192), (64, 64), (512, 1024))] + [
    (1, 1024, 512, 2, 40), (1, 2048, 256, 2, 80), (1, 1024, 512, 2, 160), (4, 1024, 1024, 2, 40),
    (2, 1024, 1024, 8, 160), (2, 192, 320, 3, 40), (1, 1024, 256, 2, 40)]


@pytest.mark.parametrize("kernel", ("dkv", "dq"))
@pytest.mark.parametrize("shape", TRAIN + CARD, ids=lambda s: "x".join(map(str, s)))
def test_f32_bwd_geometry_meets_tma_rules(shape, kernel):
    b, lq, lk, h, d = shape
    geom = flash_tma.f32_bwd_geometry(b, lq, lk, h, d, kernel)
    t = flash_tma.f32_bwd_tile(d)
    assert flash_tma.tma_violations(geom) == []
    rows, cl = t[f"{kernel}_rows"], t["cluster"]
    q_rows, kv_rows = (rows, 64) if kernel == "dkv" else (64, rows)
    for name, length, box_rows in (("q", lq, q_rows), ("kv", lk, kv_rows)):
        m = geom[name]
        assert m["dims"] == (d, h, length, b) and m["strides"] == (4 * d, 4 * h * d,
                                                                 4 * length * h * d)
        assert m["box"] == (16, 1, box_rows, 1)
    tname, length = ("qt", lq) if kernel == "dkv" else ("kt", lk)
    m = geom[tname]
    assert m["dims"] == (length, d, h, b) and m["box"] == (rows, d // cl, 1, 1)
    assert m["swizzle"] == 4 * rows and length % rows == 0
    along = lk if kernel == "dkv" else lq
    parts = flash_tma.f32_dkv_splits(b, h, lq, lk, d) if kernel == "dkv" else 1
    assert geom["grid"] == (along // 64 * cl, b * h, parts)
    arg = list(flash_tma.f32_bwd_geometry_arg(geom))
    assert len(arg) == 36 and arg[:8] == [d, cl, rows, t[f"{kernel}_stages"], *geom["grid"],
                                          geom["smem"]]


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_f32_bwd_tile_fits_shared_memory(d):
    """Each head dim's tiling fits one CTA an SM: the fixed 64 rows' four
    parts, the stages, lse/di, at D=160 the exchange buffers; and the
    registers' budget sets 32-row ring tiles at D=40, 16-row above."""
    t = flash_tma.f32_bwd_tile(d)
    assert tuple(t) == flash_tma.F32_BWD_TILE_FIELDS
    for kernel, transposed in (("dkv", 2), ("dq", 1)):
        rows, stages = t[f"{kernel}_rows"], t[f"{kernel}_stages"]
        assert t[f"{kernel}_smem"] <= flash_tma.SMEM_LIMIT
        assert t[f"{kernel}_smem"] == flash_tma.f32_bwd_smem(d, t["cluster"], rows, stages,
                                                             transposed)
        assert stages >= 3 and 64 % rows == 0 and rows == (32 if d == 40 else 16)
    dh = d // t["cluster"]
    assert dh in (40, 80) and t["cluster"] == (2 if d == 160 else 1)
    # D=80: the 64 fixed rows' four parts (80 KiB) and 3 stages of 40 KiB
    assert flash_tma.f32_bwd_smem(80, 1, 16, 3, 2) == 4 * 64 * 320 + 3 * 40960 + 384 + 72 + 1024


def test_f32_dkv_splits_only_where_the_card_is_not_filled():
    assert flash_tma.f32_dkv_splits(20, 8, 4096, 4096, 40) == 1
    assert flash_tma.f32_dkv_splits(1, 8, 20480, 1024, 80) == 1  # 128 CTAs: one wave
    assert flash_tma.f32_dkv_splits(4, 2, 1024, 1024, 40) == 1  # 128 CTAs
    assert flash_tma.f32_dkv_splits(1, 2, 1024, 512, 40) == 8  # 16 CTAs
    assert flash_tma.f32_dkv_splits(1, 2, 1024, 512, 160) == 4  # 32 CTAs in clusters of 2
    assert flash_tma.f32_dkv_splits(1, 1, 64, 64, 80) == 4  # no more parts than query tiles


class _FakeTileLibrary:
    """Stands in for the built library's vx_flash_bwd_f32_tile."""

    def __init__(self, tiles):
        self.tiles, self.calls = tiles, 0

    def vx_flash_bwd_f32_tile(self, d, out):
        self.calls += 1
        if d not in self.tiles:
            return 1  # cudaErrorInvalidValue: no instantiation
        for i, name in enumerate(flash_tma.F32_BWD_TILE_FIELDS):
            out[i] = self.tiles[d][name]
        return 0


@pytest.fixture
def fresh_tile_checks(monkeypatch):
    monkeypatch.setattr(flash, "_f32_bwd_tiles_checked", set())


def test_f32_bwd_tile_check_passes_once_per_head_dim(fresh_tile_checks):
    lib = _FakeTileLibrary({d: flash_tma.f32_bwd_tile(d) for d in HEAD_DIMS})
    for d in HEAD_DIMS + HEAD_DIMS:
        flash._check_f32_bwd_tile(lib, d)
    assert lib.calls == 3 and flash._f32_bwd_tiles_checked == set(HEAD_DIMS)


@pytest.mark.parametrize("field", flash_tma.F32_BWD_TILE_FIELDS)
def test_f32_bwd_tile_check_names_a_mismatch(fresh_tile_checks, field):
    """A library built to another fp32 backward tiling than flash_tma's
    raises before any launch, for each field of the tile."""
    built = dict(flash_tma.f32_bwd_tile(80))
    built[field] += 16
    with pytest.raises(RuntimeError, match="flash fp32 backward at D=80: the library's tiling"):
        flash._check_f32_bwd_tile(_FakeTileLibrary({80: built}), 80)
    assert not flash._f32_bwd_tiles_checked


def test_f32_bwd_launch_geometry_is_cached_and_checked():
    flash._f32_bwd_geometry.cache_clear()
    first = flash._f32_bwd_geometry(1, 1024, 512, 2, 40, "dkv")
    assert flash._f32_bwd_geometry(1, 1024, 512, 2, 40, "dkv") is first
    geom = flash_tma.f32_bwd_geometry(1, 1024, 512, 2, 40, "dkv")
    assert list(first[0]) == list(flash_tma.f32_bwd_geometry_arg(geom)) and first[1] == 8
    with pytest.raises(ValueError, match="no instantiation for D=64"):
        flash._f32_bwd_geometry(1, 128, 128, 2, 64, "dq")
    with pytest.raises(ValueError, match="'dkv' or 'dq'"):
        flash_tma.f32_bwd_geometry(1, 128, 128, 2, 40, "fwd")


@pytest.mark.parametrize("kernel,change,message", [
    ("dkv", dict(grid=(128, 160, 129)), "parts of 128 query tiles"),
    ("dq", dict(grid=(64, 160, 2)), "parts of 1 query tiles"),
    ("dkv", dict(smem=240000), "shared memory"),
    ("dq", dict(cluster=2), "not whole clusters"),
])
def test_f32_bwd_violations_are_named(kernel, change, message):
    geom = dict(flash_tma.f32_bwd_geometry(20, 4096, 4096, 8, 40, kernel), **change)
    if "cluster" in change:
        geom["grid"] = (63, 160, 1)
    bad = flash_tma.tma_violations(geom)
    assert bad and any(message in m for m in bad), bad


def test_fp32_backward_wrapper_refuses_cpu_tensors():
    """launch_bwd never runs a plain version or the emulation in the
    kernels' place."""
    from vexpress_torch.ops import launches

    q = torch.zeros(1, 128, 80)
    stats = torch.zeros(1, 2, 128)
    launches.reset()
    with pytest.raises(ValueError, match="unsupported device"):
        flash.launch_bwd(q, q, q, q, stats, stats, 2, 0.1)
    assert not launches.counts
