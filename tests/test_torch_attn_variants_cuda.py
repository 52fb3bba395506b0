"""T1 (csrc/flash_variants.cu) and T2 (csrc/splash_fwd.cu), both the bf16
forward of csrc/flash_fwd_wgmma.cuh, against their plain versions on the card,
at every instantiation, at a small shape, on (B, H, L, D) tensors and on
head-major views of packed (B, L, H*D) ones; relaunches and the pairs a block
walks change no bit; the library's tiles are flash_tma's and the SASS holds
wgmma, TMA and ex2; the wrappers refuse what the kernels do not take. Marked
`cuda`: without a CUDA device every test skips. On a machine with an H100:

    python -m pytest tests/test_torch_attn_variants_cuda.py -q -m cuda --noconftest
"""

import ctypes

import pytest
import torch

from chip_smoke import SASS_FAMILIES, WGMMA_WAITS, within_variant_bar
from vexpress_torch.ops import flash, flash_tma, flash_variants, launches, splash
from vexpress_torch.tools.ptxas_report import sass_ops

pytestmark = pytest.mark.cuda

B, H, L, D = 2, 4, 512, 40  # B*H divisible by 4, L by 128
LAYOUTS = ("bhld", "packed_view")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(dev, dtype=torch.bfloat16, seed=0, layout="bhld"):
    """q, k, v as contiguous (B, H, L, D) tensors, or as head-major views of
    contiguous packed (B, L, H*D) ones."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if layout == "packed_view":
        return [torch.randn(B, L, H * D, generator=g, device=dev).to(dtype)
                .view(B, L, H, D).transpose(1, 2) for _ in range(3)]
    return [torch.randn(B, H, L, D, generator=g, device=dev).to(dtype) for _ in range(3)]


def _t1(q, k, v, tiling):
    bq, bk, dp, hb = tiling
    return flash_variants.flash_fwd_variant(q, k, v, D**-0.5, block_q=bq, block_k=bk,
                                            heads_per_block=hb, d_target=dp)


def _within_bar(out, plain):
    plain = plain.float()
    err = (out.float() - plain).abs()
    ok, tol = within_variant_bar(float(err.max()), float(err.mean()), float(plain.std()),
                                 float(plain.abs().max()))
    return ok and bool(torch.isfinite(out).all()), (float(err.max()), float(err.mean()), tol)


def _assert_matches(out, plain):
    ok, why = _within_bar(out, plain)
    assert ok, why


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("tiling", sorted(flash_variants.TILINGS))
def test_t1_matches_plain(dev, tiling, layout):
    q, k, v = _qkv(dev, layout=layout)
    launches.reset()
    out = _t1(q, k, v, tiling)
    torch.cuda.synchronize()
    assert dict(launches.counts) == {"flash_fwd_variant": 1}
    assert dict(launches.shapes) == {("flash_fwd_variant", B, H, L, L, D) + tiling: 1}
    assert out.stride() == q.stride()  # the output keeps the input's layout
    _assert_matches(out, flash_variants.flash_fwd_variant_reference(q, k, v, D**-0.5,
                                                                    block_k=tiling[1]))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("tiling", sorted(splash.TILINGS))
def test_t2_matches_plain(dev, tiling, layout):
    bq, bkv, dp = tiling
    q, k, v = _qkv(dev, seed=1, layout=layout)
    qs = q * torch.tensor(D**-0.5, dtype=q.dtype, device=dev)
    launches.reset()
    out = splash.splash_mha_fwd(qs, k, v, block_q=bq, block_kv=bkv, d_target=dp)
    torch.cuda.synchronize()
    assert dict(launches.counts) == {"splash_fwd": 1}
    assert dict(launches.shapes) == {("splash_fwd", B, H, L, L, D) + tiling: 1}
    _assert_matches(out, splash.splash_mha_reference(qs, k, v, block_kv=bkv))


def test_relaunch_and_layout_are_bitwise_equal(dev):
    """Each instantiation gives the same bits on a relaunch and on a
    head-major view of the same values."""
    q, k, v = _qkv(dev, seed=3, layout="packed_view")
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    for tiling in sorted(flash_variants.TILINGS):
        first = _t1(qc, kc, vc, tiling)
        assert torch.equal(_t1(qc, kc, vc, tiling), first), tiling
        assert torch.equal(_t1(q, k, v, tiling), first), tiling
    for bq, bkv, dp in sorted(splash.TILINGS):
        first = splash.splash_mha_fwd(qc, kc, vc, block_q=bq, block_kv=bkv, d_target=dp)
        again = splash.splash_mha_fwd(qc, kc, vc, block_q=bq, block_kv=bkv, d_target=dp)
        view = splash.splash_mha_fwd(q, k, v, block_q=bq, block_kv=bkv, d_target=dp)
        assert torch.equal(again, first) and torch.equal(view, first), (bq, bkv, dp)


def test_pairs_per_block_change_no_bit(dev):
    """A row's arithmetic depends on the key tile alone: HB = 2 and 4, and 128
    query rows a block, agree bitwise with one 64-row pair a block at 64 keys;
    HB = 4 with HB = 2 at 128 keys."""
    q, k, v = _qkv(dev, seed=4)
    one = _t1(q, k, v, (64, 64, 48, 1))
    for tiling in ((64, 64, 48, 2), (64, 64, 48, 4), (128, 64, 48, 2), (128, 64, 48, 4)):
        assert torch.equal(_t1(q, k, v, tiling), one), tiling
    assert torch.equal(_t1(q, k, v, (64, 128, 48, 4)), _t1(q, k, v, (64, 128, 48, 2)))


def test_pad128_completes(dev):
    """t1_pad128's second 64-column chunk lies wholly past D = 40: it is
    zeroed once and never loaded, so the ring's byte counts complete."""
    q, k, v = _qkv(dev, seed=5)
    out = _t1(q, k, v, (64, 64, 128, 1))
    torch.cuda.synchronize()
    _assert_matches(out, flash_variants.flash_fwd_variant_reference(q, k, v, D**-0.5))


def test_library_tiles_are_flash_tma_tiles(dev):
    """Each instantiation's tiling as the library reports it
    (vx_flash_fwd_variant_tile, vx_splash_mha_tile) is ops/flash_tma.py's."""
    lib = flash._library()
    out = (ctypes.c_longlong * len(flash_tma.VARIANT_TILE_FIELDS))()
    for tiling in flash_variants.TILINGS:
        assert lib.vx_flash_fwd_variant_tile(*tiling, out) == 0
        assert dict(zip(flash_tma.VARIANT_TILE_FIELDS, out)) == flash_tma.variant_tile("t1",
                                                                                       tiling)
    for tiling in splash.TILINGS:
        assert lib.vx_splash_mha_tile(*tiling, out) == 0
        assert dict(zip(flash_tma.VARIANT_TILE_FIELDS, out)) == flash_tma.variant_tile("t2",
                                                                                       tiling)
    assert lib.vx_flash_fwd_variant_tile(128, 128, 48, 1, out) != 0
    assert lib.vx_splash_mha_tile(64, 128, 48, out) != 0


def test_variant_kernels_use_wgmma_tma_and_ex2(dev):
    """T1's 9 and T2's 3 kernels hold HGMMA, UTMALDG and MUFU.EX2 in their
    SASS and no more WARPGROUP.DEPBAR than their fixed waits."""
    for part in ("flash_fwd_variant_wgmma", "splash_fwd_wgmma"):
        ops = sass_ops(flash.build(), part)
        assert len(ops) == SASS_FAMILIES[part], (part, sorted(ops))
        for name, found in ops.items():
            assert {"HGMMA", "UTMALDG", "MUFU.EX2"} <= set(found), (name, found)
            assert found["WARPGROUP.DEPBAR"] <= WGMMA_WAITS, (name, found)


def test_bar_tells_rounded_p_from_fp32_p(dev):
    """Each kernel against the other's plain version on the same pre-scaled
    q fails the bar: T1 rounds p to bf16 for P V, T2 keeps it fp32."""
    q, k, v = _qkv(dev, seed=2)
    qs = q * torch.tensor(D**-0.5, dtype=q.dtype, device=dev)
    t1 = flash_variants.flash_fwd_variant(qs, k, v, 1.0)
    t2 = splash.splash_mha_fwd(qs, k, v)
    t1_plain = flash_variants.flash_fwd_variant_reference(qs, k, v, 1.0)
    t2_plain = splash.splash_mha_reference(qs, k, v)
    _assert_matches(t1, t1_plain)
    _assert_matches(t2, t2_plain)
    assert not _within_bar(t1, t2_plain)[0]
    assert not _within_bar(t2, t1_plain)[0]


def test_t1_rejects_what_it_does_not_take(dev):
    q, k, v = _qkv(dev)
    launches.reset()
    with pytest.raises(ValueError, match="bfloat16"):
        flash_variants.flash_fwd_variant(*(t.float() for t in (q, k, v)), D**-0.5)
    with pytest.raises(ValueError, match="no instantiation"):
        flash_variants.flash_fwd_variant(q, k, v, D**-0.5, block_q=256)
    with pytest.raises(ValueError, match="head dim 40"):
        flash_variants.flash_fwd_variant(*(torch.nn.functional.pad(t, (0, 8)) for t in (q, k, v)),
                                         D**-0.5)
    assert not launches.counts


def test_t2_rejects_what_it_does_not_take(dev):
    q, k, v = _qkv(dev)
    launches.reset()
    with pytest.raises(ValueError, match="bfloat16"):
        splash.splash_mha_fwd(*(t.half() for t in (q, k, v)))
    with pytest.raises(ValueError, match="no instantiation"):
        splash.splash_mha_fwd(q, k, v, block_q=128, block_kv=64)
    assert not launches.counts


def test_kernel_refusal_surfaces_without_fallback(dev, monkeypatch):
    """A tiling the wrapper lets through but the library has no
    instantiation for: the launch error surfaces and no plain version runs."""
    q, k, v = _qkv(dev)
    monkeypatch.setattr(flash_variants, "TILINGS", flash_variants.TILINGS | {(128, 128, 48, 1)})
    monkeypatch.setattr(splash, "TILINGS", splash.TILINGS | {(64, 128, 48)})
    launches.reset()
    with pytest.raises(RuntimeError, match="T1 variant forward launch failed"):
        flash_variants.flash_fwd_variant(q, k, v, D**-0.5, block_q=128, block_k=128)
    with pytest.raises(RuntimeError, match="T2 splash forward launch failed"):
        splash.splash_mha_fwd(q, k, v, block_q=64, block_kv=128)
    assert not launches.counts
