"""K2, the LITE variant of vexpress_torch/csrc/flash_fwd.cu (bf16:
csrc/flash_fwd_wgmma.cuh), against its plain
version (ops/flash_lite.py::flash_lite_reference) on the card. Marked `cuda`:
without a CUDA device every test skips. On a machine with an H100:

    python -m pytest tests/test_torch_flash_lite_cuda.py -q -m cuda --noconftest
"""

import pytest
import torch

from chip_smoke import within_k1_bar
from vexpress_torch.ops import flash, flash_tma, launches

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setattr(flash, "FLASH_LITE", True)
    return torch.device("cuda")


def _qkv(dev, b, lq, lk, inner, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(b, l, inner, generator=g, device=dev).to(dtype) for l in (lq, lk, lk)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,lq,lk,heads,d", [(2, 512, 1024, 2, 40),  # small
                                              (2, 1024, 1024, 8, 80),  # attn1 @32x32 heads
                                              (1, 8 * 4096, 4096, 8, 40)])  # attn1_5 @64x64
def test_k2_matches_plain(dev, dtype, b, lq, lk, heads, d):
    q, k, v = _qkv(dev, b, lq, lk, heads * d, dtype)
    launches.reset()
    out = flash.flash_sdpa(q, k, v, heads)
    torch.cuda.synchronize()
    assert dict(launches.counts) == {"flash_lite_fwd": 1}
    assert dict(launches.shapes) == {("flash_lite_fwd", b, lq, lk, d): 1}
    plain = flash.flash_lite_reference(q, k, v, heads)
    err = (out.float() - plain.float()).abs()
    # K1's bf16 bar in both types: the kernel's key tile is not the plain
    # version's, so bf16(s - m) rounds other numbers (fp32 inputs too)
    ok, tol = within_k1_bar(True, float(err.max()), float(err.mean()),
                            float(plain.float().std()))
    assert ok, (float(err.max()), float(err.mean()), tol)
    exact = flash.flash_sdpa_reference(q.float(), k.float(), v.float(), heads)
    assert float((out.float() - exact).abs().max()) < 0.03  # tests/test_flash_lite.py's bar


@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("lq,lk", [(128, 128), (192, 320)])  # one tile; trailing 64-row/key tiles
def test_k2_tma_kernel_tiles(dev, d, lq, lk):
    """The bf16 kernel (csrc/flash_fwd_wgmma.cuh) at one 128-row tile and at
    a trailing 64-row query tile and 64-key tile, under K2's two bars."""
    q, k, v = _qkv(dev, 2, lq, lk, 2 * d, torch.bfloat16, seed=d)
    launches.reset()
    out = flash.flash_sdpa(q, k, v, 2)
    torch.cuda.synchronize()
    assert dict(launches.counts) == {"flash_lite_fwd": 1}
    plain = flash.flash_lite_reference(q, k, v, 2).float()
    err = (out.float() - plain).abs()
    ok, tol = within_k1_bar(True, float(err.max()), float(err.mean()), float(plain.std()))
    assert ok, (float(err.max()), float(err.mean()), tol)
    exact = flash.flash_sdpa_reference(q.float(), k.float(), v.float(), 2)
    assert float((out.float() - exact).abs().max()) < 0.03


@pytest.mark.parametrize("length,inner", [(4096, 320), (1024, 640)])  # attn1 @64², @32²
def test_k2_relaunch_is_bitwise_equal(dev, length, inner):
    """K2 relaunched on the same inputs gives the same bits. Its P V once
    read its A fragments straight from the packed ex2's registers, and about
    one relaunch in 40 to 200 at attn1 @64² then differed in one warp's rows."""
    q, k, v = _qkv(dev, 48, length, length, inner, torch.bfloat16, seed=7)
    first = flash.flash_sdpa(q, k, v, 8)
    differ = sum(not torch.equal(flash.flash_sdpa(q, k, v, 8), first) for _ in range(200))
    assert differ == 0, f"{differ} of 200 relaunches differ from the first"


def test_k2_with_gradient_raises(dev):
    q, k, v = _qkv(dev, 1, 512, 512, 80, torch.bfloat16)
    with pytest.raises(ValueError, match="VEXPRESS_FLASH_LITE"):
        flash.flash_sdpa(q.requires_grad_(), k, v, 2)


def test_k2_unsupported_head_dim_raises(dev):
    q, k, v = _qkv(dev, 1, 512, 512, 2 * 64, torch.bfloat16)
    launches.reset()
    with pytest.raises(ValueError, match="head dims"):
        flash.flash_sdpa(q, k, v, 2)
    assert not launches.counts


def test_k2_failed_launch_raises_without_fallback(dev, monkeypatch):
    """The wrapper's checks off (inputs and TMA geometry), the kernel refuses
    D=64 itself: the error surfaces and no plain version runs in its place."""
    q, k, v = _qkv(dev, 1, 512, 512, 2 * 64, torch.bfloat16)
    monkeypatch.setattr(flash, "_check_kernel_inputs", lambda *a, **kw: None)
    monkeypatch.setattr(flash_tma, "tma_violations", lambda *a, **kw: [])
    launches.reset()
    with pytest.raises(RuntimeError, match="K2 forward launch failed"):
        flash.flash_sdpa(q, k, v, 2)
    assert not launches.counts
