"""The Hopper flash kernel (vexpress_torch/csrc/flash_fwd.cu; bf16 through
csrc/flash_fwd_wgmma.cuh) against its plain version on the card, and the
SASS of the bf16 kernels. Marked `cuda`: without a CUDA device every test
skips. On a machine with an H100:

    python -m pytest tests/test_torch_flash_cuda.py -q -m cuda --noconftest

(`--noconftest`: tests/conftest.py sets up JAX, which such a machine may lack.)
"""

import ctypes

import pytest
import torch

from chip_smoke import LSE_BAR, within_k1_bar
from vexpress_torch.ops import attention, flash, flash_tma, launches
from vexpress_torch.tools.ptxas_report import sass_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(dev, b, lq, lk, inner, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(b, l, inner, generator=g, device=dev).to(dtype) for l in (lq, lk, lk)]


def _assert_within_bar(out, ref):
    """chip_smoke.py's bar for K1 against its fp32 plain version."""
    err = (out.float() - ref).abs()
    ok, tol = within_k1_bar(out.dtype == torch.bfloat16, float(err.max()), float(err.mean()),
                            float(ref.std()))
    assert ok, (float(err.max()), float(err.mean()), tol)


@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_plain(dev, dtype, d):
    q, k, v = _qkv(dev, 2, 512, 1024, 2 * d, dtype)
    launches.reset()
    out = flash.flash_sdpa(q, k, v, 2)
    torch.cuda.synchronize()
    assert launches.counts["flash_fwd"] == 1 and launches.counts["flash_sdpa_reference"] == 0
    assert dict(launches.shapes) == {("flash_fwd", 2, 512, 1024, d): 1}
    ref = flash.flash_sdpa_reference(q.float(), k.float(), v.float(), 2)
    _assert_within_bar(out, ref)


def test_grouped_queries_through_sdpa(dev):
    q, k, v = _qkv(dev, 1, 4 * 1024, 1024, 320, torch.bfloat16, seed=1)
    launches.reset()
    out = attention.sdpa(q, k, v, 8)
    torch.cuda.synchronize()
    assert launches.counts["flash_fwd"] == 1 and launches.counts["flash_sdpa_reference"] == 0
    ref = flash.flash_sdpa_reference(q.float(), k.float(), v.float(), 8)
    _assert_within_bar(out, ref)


def test_unsupported_head_dim_raises(dev):
    q, k, v = _qkv(dev, 1, 512, 512, 2 * 64, torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        flash.flash_sdpa(q, k, v, 2)


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("lq,lk", [(128, 128), (192, 320)])  # one tile; trailing 64-row/key tiles
def test_tma_kernel_tiles(dev, lq, lk, d, with_lse):
    """The bf16 kernel at one 128-row tile and at a trailing 64-row query
    tile and 64-key tile, with and without the log-sum-exp."""
    q, k, v = _qkv(dev, 2, lq, lk, 2 * d, torch.bfloat16, seed=d)
    ref, ref_lse = flash.flash_sdpa_reference(q.float(), k.float(), v.float(), 2, return_lse=True)
    launches.reset()
    out, lse = flash._launch_fwd(q, k, v, 2, d**-0.5, with_lse=with_lse)
    torch.cuda.synchronize()
    assert dict(launches.counts) == {"flash_fwd": 1}
    _assert_within_bar(out, ref)
    if with_lse:
        assert float((lse - ref_lse).abs().max()) <= LSE_BAR
    else:
        assert lse is None


def test_library_tile_is_flash_tma_tile(dev):
    """The library's tiling per head dim (vx_flash_fwd_tile, from
    csrc/flash_fwd_wgmma.cuh's WgmmaTile) is ops/flash_tma.py's."""
    lib = flash._library()
    for d in flash_tma.SWIZZLE:
        out = (ctypes.c_longlong * len(flash_tma.TILE_FIELDS))()
        assert lib.vx_flash_fwd_tile(d, out) == 0
        assert dict(zip(flash_tma.TILE_FIELDS, out)) == flash_tma.tile(d)
    assert lib.vx_flash_fwd_tile(64, out) != 0


def test_bf16_forward_kernels_use_wgmma_and_tma(dev):
    """Every bf16 forward kernel in the built library (K1 and K2 at each of
    the 3 head dims) holds HGMMA (wgmma) and UTMALDG (TMA loads) in its SASS."""
    ops = sass_ops(flash.build(), "flash_fwd_wgmma")
    assert len(ops) == 6, sorted(ops)
    for name, found in ops.items():
        assert {"HGMMA", "UTMALDG"} <= set(found), (name, found)
