"""The host side of the bf16 backward kernels (vexpress_torch/csrc/
flash_bwd_wgmma.cuh) on the CPU: the TMA geometry that ops/flash_tma.py
computes for every stage-2 and stage-3 training shape and every shape the
card tests launch, the tile check against the library's `vx_flash_bwd_tile`,
the split of the dk/dv kernel's query axis, and the wrapper's refusals.
"""

import pytest
import torch

from chip_smoke import HIRES_K1_SHAPES, STAGE3_K1_SHAPES, TRAIN_K1_EXTRA, TRAIN_K1_SHAPES
from vexpress_torch.ops import flash, flash_tma, launches

# (B, Lq, Lk, H, D) of the training rows (512x512, and 1024x1024's D=160
# level), then of tests/test_torch_flash_grad_cuda.py
TRAIN = sorted({(b, lq, lk, h, i // h)
                for _, b, lq, lk, i, h in TRAIN_K1_SHAPES + STAGE3_K1_SHAPES + HIRES_K1_SHAPES})
CARD = [(2, lq, lk, 2, d) for d in (40, 80, 160)
        for lq, lk in ((512, 1024), (2048, 512), (192, 320), (320, 192), (64, 64))] + [
    (1, 8192, 1024, 8, 80), (1, 1024, 1024, 8, 80), (1, 1024, 1024, 8, 40), (2, 1024, 1024, 8, 40),
    (1, 8192, 1024, 8, 160), (1, 1024, 1024, 8, 160), (2, 1024, 1024, 8, 160)]
SHAPES = TRAIN + CARD
KERNELS = ("dkv", "dq")


def test_training_shapes_are_the_wgmma_kernels():
    """Every training row is bf16 at D=40, 80 or 160, which the wgmma kernels
    take, and so is the bf16 D=160 row off the path."""
    assert len(TRAIN) == 15
    assert {s[4] for s in TRAIN} == set(flash_tma.BWD_SWIZZLE) == {40, 80, 160}
    extra = [(b, lq, lk, h, i // h) for _, b, lq, lk, i, h, dt in TRAIN_K1_EXTRA
             if dt == "bfloat16"]
    assert extra == [(2, 1024, 1024, 8, 160)]


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bwd_geometry_meets_tma_rules(shape, kernel):
    b, lq, lk, h, d = shape
    geom = flash_tma.bwd_geometry(b, lq, lk, h, d, kernel)
    sw = flash_tma.BWD_SWIZZLE[d]
    rows = 32 if (d, kernel) == (160, "dkv") else 64  # a ring tile's rows
    assert geom["kernel"] == kernel and geom["swizzle"] == sw
    assert flash_tma.tma_violations(geom) == []
    for name, length in (("q", lq), ("kv", lk)):
        m = geom[name]
        assert m["dims"] == (d, h, length, b)
        assert m["strides"] == (2 * d, 2 * h * d, 2 * length * h * d)
        assert m["box"] == (sw // 2, 1, rows, 1)  # one box of a ring tile's rows on both axes
        assert length % 64 == 0  # whole ring tiles and warpgroups: nothing masked
    nv = geom["padded_head_dim"]
    assert nv % 16 == 0 and d <= nv < d + 16 and geom["chunks"] * sw // 2 >= nv
    along = lk if kernel == "dkv" else lq
    assert geom["grid"][:2] == (-(-along // 128), b * h) and geom["grid"][1] <= 65535
    parts = geom["grid"][2]
    assert parts == (flash_tma.dkv_splits(b, h, lq, lk) if kernel == "dkv" else 1)
    assert geom["smem"] == flash_tma.bwd_tile(d)[f"{kernel}_smem"] <= flash_tma.SMEM_LIMIT
    arg = list(flash_tma.bwd_geometry_arg(geom))
    assert len(arg) == 21 and arg[:7] == [sw, sw // 2, rows, *geom["grid"], geom["smem"]]


@pytest.mark.parametrize("d", sorted(flash_tma.BWD_SWIZZLE))
def test_bwd_tile_is_the_launch_geometry(d):
    """`bwd_tile` (what the library's vx_flash_bwd_tile must report) is what
    bwd_geometry hands both kernels, and fits one block an SM."""
    t = flash_tma.bwd_tile(d)
    assert tuple(t) == flash_tma.BWD_TILE_FIELDS
    for kernel in KERNELS:
        geom = flash_tma.bwd_geometry(2, 256, 256, 8, d, kernel)
        rows = t[f"{kernel}_rows"]
        assert geom["q"]["box"] == geom["kv"]["box"] == (t["box_cols"], 1, rows, 1)
        assert geom["smem"] == t[f"{kernel}_smem"] and geom["threads"] == t["threads"]
        assert geom["blocks_per_sm"] == 1
        # two 128-row fixed tiles, `stages` stages of two ring tiles of `rows`
        # rows, at `swizzle` bytes a row and one chunk (D=40), two (D=80) or
        # five (D=160); lse/di (dk/dv: `rows` of each a stage, dq: 128 of each
        # once), barriers, alignment slack
        ns, chunks, sw = t[f"{kernel}_stages"], {40: 1, 80: 2, 160: 5}[d], t["swizzle"]
        assert t[f"{kernel}_smem"] == (chunks * sw * (2 * 128 + 2 * ns * rows)
                                       + max(ns * rows * 8, 1024) + 8 * (2 * ns + 1) + 1024)
        assert t[f"{kernel}_smem"] <= flash_tma.SMEM_LIMIT
        assert 64 % rows == 0  # a consumer warpgroup's 64 rows are whole boxes
    assert t["block_rows"] == 128  # two consumer warpgroups of 64 rows each
    assert (t["dkv_rows"], t["dq_rows"], t["dkv_stages"], t["dq_stages"]) == (
        (32, 64, 4, 3) if d == 160 else (64, 64, 3, 4))


@pytest.mark.parametrize("b,lq,lk,heads", [(20, 4096, 4096, 8), (1, 81920, 4096, 8),
                                           (1, 20480, 1024, 8), (1, 1024, 1024, 8),
                                           (1, 64, 128, 1), (1, 4096, 128, 1),
                                           (2, 512, 1024, 2), (1, 8192, 1024, 8)])
def test_dkv_splits_cover_every_query_once(b, lq, lk, heads):
    """At least one part; each part walks whole 64-row query tiles, at least
    one; together the parts walk every query tile exactly once, in order; and
    the blocks of all parts fit one wave of the card when there is more than
    one part."""
    parts = flash_tma.dkv_splits(b, heads, lq, lk)
    assert parts >= 1
    for rows in (64, 32):  # the ring tiles at D=40 and 80, and at D=160
        ranges = flash_tma.dkv_parts(lq, parts, rows)
        assert len(ranges) == parts
        walked = [t for start, end in ranges for t in range(start, end)]
        assert walked == list(range(lq // rows))
        assert all(end > start for start, end in ranges)
    blocks = b * heads * -(-lk // 128)
    if parts > 1:
        assert blocks * parts <= flash_tma.N_SMS
    else:
        assert blocks * 2 > flash_tma.N_SMS or lq // 64 == 1


def test_dkv_splits_only_where_the_card_is_not_filled():
    # stage 2's attn1 rows fill the card; attn1_5 and the B=1 rows at 32x32 do not
    assert flash_tma.dkv_splits(20, 8, 4096, 4096) == 1
    assert flash_tma.dkv_splits(20, 8, 1024, 1024) == 1
    assert flash_tma.dkv_splits(1, 8, 32768, 4096) == 1  # 256 blocks
    assert flash_tma.dkv_splits(1, 8, 8192, 1024) == 2  # 64 blocks
    assert flash_tma.dkv_splits(1, 8, 1024, 1024) == 2
    assert flash_tma.dkv_splits(1, 1, 16384, 128) == flash_tma.N_SMS
    assert flash_tma.dkv_splits(1, 1, 256, 128) == 4  # no more parts than query tiles


class _FakeBwdTileLibrary:
    """Stands in for the built library's vx_flash_bwd_tile."""

    def __init__(self, tiles):
        self.tiles, self.calls = tiles, 0

    def vx_flash_bwd_tile(self, d, out):
        self.calls += 1
        if d not in self.tiles:
            return 1  # cudaErrorInvalidValue: no instantiation
        for i, name in enumerate(flash_tma.BWD_TILE_FIELDS):
            out[i] = self.tiles[d][name]
        return 0


@pytest.fixture
def fresh_bwd_tile_checks(monkeypatch):
    monkeypatch.setattr(flash, "_bwd_tiles_checked", set())


def test_bwd_tile_check_passes_once_per_head_dim(fresh_bwd_tile_checks):
    lib = _FakeBwdTileLibrary({d: flash_tma.bwd_tile(d) for d in flash_tma.BWD_SWIZZLE})
    for d in (40, 80, 160, 40, 80, 160):
        flash._check_bwd_tile(lib, d)
    assert lib.calls == 3 and flash._bwd_tiles_checked == {40, 80, 160}


def test_bwd_tile_check_leaves_unbuilt_head_dims_to_the_launch(fresh_bwd_tile_checks):
    flash._check_bwd_tile(_FakeBwdTileLibrary({}), 64)
    assert not flash._bwd_tiles_checked


@pytest.mark.parametrize("field", flash_tma.BWD_TILE_FIELDS)
def test_bwd_tile_check_names_a_mismatch(fresh_bwd_tile_checks, field):
    """A library built to another backward tiling than flash_tma's raises
    before any launch, for each field of the tile."""
    built = dict(flash_tma.bwd_tile(40))
    built[field] += 16
    with pytest.raises(RuntimeError, match="flash backward at D=40: the library's tiling"):
        flash._check_bwd_tile(_FakeBwdTileLibrary({40: built}), 40)
    assert not flash._bwd_tiles_checked


def test_bwd_launch_geometry_is_cached_and_checked():
    flash._bwd_tma_geometry.cache_clear()
    first = flash._bwd_tma_geometry(1, 8192, 1024, 8, 80, "dkv")
    assert flash._bwd_tma_geometry(1, 8192, 1024, 8, 80, "dkv") is first
    geom = flash_tma.bwd_geometry(1, 8192, 1024, 8, 80, "dkv")
    assert list(first[0]) == list(flash_tma.bwd_geometry_arg(geom)) and first[1] == 2
    with pytest.raises(ValueError, match="no instantiation for D=64"):
        flash._bwd_tma_geometry(1, 128, 128, 2, 64, "dq")
    with pytest.raises(ValueError, match="'dkv' or 'dq'"):
        flash_tma.bwd_geometry(1, 128, 128, 2, 40, "fwd")


@pytest.mark.parametrize("kernel,change,message", [
    ("dkv", dict(swizzle=64), "no instantiation"),
    ("dkv", dict(grid=(32, 160, 65)), "parts of 64 query tiles"),
    ("dq", dict(grid=(32, 160, 2)), "parts of 64 query tiles"),
    ("dq", dict(q=dict(dims=(40, 8, 4128, 20), strides=(80, 640, 2641920), box=(64, 1, 64, 1))),
     "whole 64-row tiles"),
    ("dkv", dict(smem=240000), "shared memory"),
])
def test_bwd_violations_are_named(kernel, change, message):
    geom = dict(flash_tma.bwd_geometry(20, 4096, 4096, 8, 40, kernel), **change)
    bad = flash_tma.tma_violations(geom)
    assert bad and any(message in m for m in bad), bad


def test_backward_wrapper_refuses_cpu_tensors():
    """launch_bwd never runs a plain version in the kernels' place."""
    q = torch.zeros(1, 128, 80, dtype=torch.bfloat16)
    stats = torch.zeros(1, 2, 128)
    launches.reset()
    with pytest.raises(ValueError, match="unsupported device"):
        flash.launch_bwd(q, q, q, q, stats, stats, 2, 0.1)
    assert not launches.counts


def test_bench_flash_bwd_takes_chip_smokes_shapes_and_needs_the_card():
    """The backward bench times chip_smoke.py's training shapes on the card
    and refuses to run without one (no CPU numbers under a device's name)."""
    from vexpress_torch.tools import bench_flash_bwd

    cs = bench_flash_bwd._chip_smoke()
    assert cs.STAGE3_K1_SHAPES == STAGE3_K1_SHAPES and cs.TRAIN_K1_SHAPES == TRAIN_K1_SHAPES
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            bench_flash_bwd.main()


def _grad_row(stage, main_path, b=1, lq=4096, lk=4096, d=40, latent=64):
    bound = dict(ms=0.1, by="operations")
    return dict(shape=f"stage {stage}", B=b, Lq=lq, Lk=lk, D=d, stage=stage, main_path=main_path,
                latent=latent,
                fwd_ms=1.0, plain_fwd_ms=2.0, sdpa_fwd_ms=1.0, dkv_ms=1.0, dq_ms=1.0,
                plain_bwd_ms=3.0, sdpa_bwd_ms=2.0,
                bounds={k: bound for k in ("fwd", "dkv", "dq", "pair")},
                errors={k: dict(max_abs_err=1e-3) for k in ("out", "dq", "dk", "dv")})


def test_kernels_line_gives_train_full_launches_to_stage_2_rows_only():
    """chip_smoke.py's kernels line holds only what its run measured: a stage-3
    row at the same (B, Lq, Lk, D) as a stage-2 row does not take train_full's
    (or train_cli's, or train_dp's ranks') launches, nor does a stage-2 row at
    1024x1024's latent, and no row carries stage 3's or 1024x1024's reckoned
    launches; a stage-2 row sums the stage-2 paths, path by path and rank by
    rank; K2's line adds the sharded phase's ranks; the fp32 kernels'
    launches (the parity phases') stand apart."""
    import chip_smoke

    fwd = dict(B=1, Lq=4096, Lk=4096, D=40, dtype="bfloat16", main_path=True, kernel_ms=1.0,
               plain_ms=2.0, library_ms=1.0, bound_ms=0.1, bound_by="operations",
               max_abs_err=1e-3)
    variant = dict(ms=1.0, plain_ms=2.0, library_ms=1.0, bound_ms=0.1, bound_by="operations",
                   max_abs_err=1e-3, k1_ms=1.0)
    key = [1, 4096, 4096, 40]
    results = dict(
        full=dict(flash_launches=5, flash_launches_by_shape=[key + [5]]),
        train_full=dict(launches={"flash_fwd": 25, "flash_bwd_dkv": 5, "flash_bwd_dq": 5},
                        fwd_launches_by_shape=[key + [25]],
                        bwd_launches_by_shape=[["flash_bwd_dkv"] + key + [5],
                                               ["flash_bwd_dq"] + key + [5]]),
        train_cli=dict(launches={"flash_fwd": 20, "flash_bwd_dkv": 4, "flash_bwd_dq": 4,
                                 "flash_bwd_dkv_sum": 4},
                       fwd_launches_by_shape=[key + [20]],
                       bwd_launches_by_shape=[["flash_bwd_dkv"] + key + [4],
                                              ["flash_bwd_dq"] + key + [4]]),
        kernel=dict(rows=[fwd], lite_rows=[dict(fwd, k1_ms=1.0, exps=1)],
                    grad_rows=[_grad_row(2, True), _grad_row(3, False),
                               _grad_row(2, False, latent=128)]),
        train_dp=dict(launches=[{"flash_fwd": 10, "flash_bwd_dkv": 2, "flash_bwd_dq": 2}] * 2,
                      fwd_launches_by_shape=[[key + [10]]] * 2,
                      bwd_launches_by_shape=[[["flash_bwd_dkv"] + key + [2],
                                              ["flash_bwd_dq"] + key + [2]]] * 2),
        cli_full=dict(lite_launches=5, lite_launches_by_shape=[key + [5]]),
        parity=dict(launches={"flash_fwd": 7}, cli=dict(launches={"flash_lite_fwd": 9})),
        train_parity=dict(launches={"flash_fwd": 45, "flash_bwd_dkv": 45, "flash_bwd_dq": 45}),
        lora_parity=dict(launches={"flash_fwd": 27, "flash_bwd_dkv": 27, "flash_bwd_dq": 27}),
        dist_parity=dict(dp_launches=[{"flash_fwd": 6, "flash_bwd_dkv": 6,
                                       "flash_bwd_dq": 6}] * 2),
        sharded=dict(lite_launches=[3, 3], lite_launches_by_shape=[[key + [3]]] * 2),
        attn_variants=dict(rows=[dict(variant, kernel="flash_fwd_variant"),
                                 dict(variant, kernel="splash_fwd")],
                           bench_launches={"flash_fwd_variant": 12, "splash_fwd": 12}))
    kernels = {k["name"]: k for k in chip_smoke.kernels_line(results)}
    for name in ("flash_bwd_dkv", "flash_bwd_dq"):
        stage2, stage3, hires = kernels[name]["shapes"]
        rank = dict(flash_fwd=10, flash_bwd_dkv=2, flash_bwd_dq=2)
        assert stage2["launches_by_path"] == dict(
            train_full=dict(flash_fwd=25, flash_bwd_dkv=5, flash_bwd_dq=5),
            train_cli=dict(flash_fwd=20, flash_bwd_dkv=4, flash_bwd_dq=4),
            train_dp_rank0=rank, train_dp_rank1=rank)
        assert stage2["launches"] == dict(flash_fwd=65, flash_bwd_dkv=13, flash_bwd_dq=13)
        for row in (stage3, hires):
            assert "launches" not in row and "launches_by_path" not in row
        assert not any("reckoned" in k for row in (stage2, stage3, hires) for k in row)
        assert kernels[name]["launches"] == 13
        assert kernels[name]["launches_by_path"] == dict(train_full=5, train_cli=4,
                                                         train_dp_rank0=2, train_dp_rank1=2)
    lite = kernels["flash_lite_fwd"]
    assert lite["launches"] == 11
    assert lite["launches_by_path"] == dict(cli_full=5, sharded_rank0=3, sharded_rank1=3)
    # the fp32 kernels' launches, off the main path, apart from the main path's
    assert kernels["flash_fwd"]["fp32_launches_by_path"] == dict(parity=7)
    for name in ("flash_bwd_dkv", "flash_bwd_dq"):
        assert kernels[name]["fp32_launches_by_path"] == dict(
            train_parity=45, lora_parity=27, dist_parity_rank0=6, dist_parity_rank1=6)
    assert lite["fp32_launches_by_path"] == dict(parity_cli=9)
