"""The host side of the bf16 forward kernel (vexpress_torch/csrc/
flash_fwd_wgmma.cuh) on the CPU: the TMA geometry that ops/flash_tma.py
computes for every shape the main paths launch, the wrapper's refusals, and
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
