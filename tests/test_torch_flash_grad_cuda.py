"""K1 with a gradient on the card: the forward with its log-sum-exp and the
backward kernels (vexpress_torch/csrc/flash_bwd.cu; bf16 at D=40, 80 and
160 through csrc/flash_bwd_wgmma.cuh, fp32 through csrc/flash_bwd_tf32.cuh,
whose own tests are tests/test_torch_flash_bwd_tf32_cuda.py) against their
plain versions, and
`flash_sdpa` on CUDA inputs that require a gradient; the wgmma backward at
trailing 64-row tiles, with the query axis split, launched twice (bitwise
equal), and its SASS. Marked `cuda`: without a CUDA device every test skips.
On a machine with an H100:

    python -m pytest tests/test_torch_flash_grad_cuda.py -q -m cuda --noconftest

(`--noconftest`: tests/conftest.py sets up JAX, which such a machine may lack.)
"""

import ctypes

import pytest
import torch

from chip_smoke import LSE_BAR, within_k1_grad_bar
from vexpress_torch.ops import attention, flash, flash_tma, launches
from vexpress_torch.tools.ptxas_report import sass_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, b, lq, lk, inner, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(b, l, inner, generator=g, device=dev).to(dtype)
            for l in (lq, lk, lk, lq)]


def _plain_grads(q, k, v, do, heads):
    """(out, lse, dq, dk, dv) of the fp32 plain versions on fp32 copies."""
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    out, lse = flash.flash_sdpa_reference(qf, kf, vf, heads, return_lse=True)
    return (out, lse) + flash.flash_sdpa_bwd_reference(qf, kf, vf, out, lse, dof, heads)


def _assert_within_bar(got, ref, what):
    """chip_smoke.py's bar for K1 under a gradient, held by the output and
    each gradient."""
    err = (got.float() - ref).abs()
    ok, tol = within_k1_grad_bar(got.dtype == torch.bfloat16, float(err.max()), float(err.mean()),
                                 float(ref.std()), float(ref.abs().max()))
    assert ok, (what, float(err.max()), float(err.mean()), tol)


@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lq,lk", [(512, 1024), (4 * 512, 512)])
def test_backward_kernels_match_plain(dev, dtype, d, lq, lk):
    heads = 2
    q, k, v, do = _inputs(dev, 2, lq, lk, heads * d, dtype)
    launches.reset()
    out, lse = flash.flash_sdpa_fwd(q, k, v, heads, d**-0.5)
    dq, dk, dv = flash.flash_sdpa_bwd(q, k, v, out, lse, do, heads, d**-0.5)
    torch.cuda.synchronize()
    assert launches.counts["flash_fwd"] == 1 and launches.counts["flash_bwd_dkv"] == 1
    assert launches.counts["flash_bwd_dq"] == 1
    assert launches.counts["flash_sdpa_reference"] == 0
    ref_out, ref_lse, rdq, rdk, rdv = _plain_grads(q, k, v, do, heads)
    _assert_within_bar(out, ref_out, "out")
    assert float((lse - ref_lse).abs().max()) <= LSE_BAR
    for name, got, ref in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        assert got.dtype == dtype and got.shape == ref.shape
        _assert_within_bar(got, ref, name)


def test_flash_sdpa_with_grad_has_grad_fn(dev):
    """The regression test of the detached gradient: on the card, flash_sdpa
    of inputs that require a gradient returns a tensor with a grad_fn, and
    backward launches the backward kernels (never the plain versions)."""
    heads = 8
    q, k, v, do = _inputs(dev, 2, 1024, 1024, 320, torch.bfloat16, seed=1)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    launches.reset()
    out = attention.sdpa(q, k, v, heads)
    assert out.grad_fn is not None
    out.backward(do)
    torch.cuda.synchronize()
    assert launches.counts["flash_fwd"] == 1
    assert launches.counts["flash_bwd_dkv"] == 1 and launches.counts["flash_bwd_dq"] == 1
    assert launches.counts["flash_sdpa_reference"] == 0
    assert launches.counts["flash_sdpa_bwd_reference"] == 0
    _, _, rdq, rdk, rdv = _plain_grads(q.detach(), k.detach(), v.detach(), do, heads)
    for name, got, ref in (("dq", q.grad, rdq), ("dk", k.grad, rdk), ("dv", v.grad, rdv)):
        _assert_within_bar(got, ref, name)


def test_dq_only_skips_dkv_kernel(dev):
    """attn1_5 at stage 2: the reference bank needs no gradient, so only the
    dq kernel runs; queries grouped against one bank, a non-contiguous do."""
    heads = 8
    q, k, v, _ = _inputs(dev, 1, 4 * 1024, 1024, 320, torch.bfloat16, seed=2)
    q.requires_grad_()
    do = torch.randn(1, 320, 4 * 1024, device=dev).to(torch.bfloat16).transpose(1, 2)
    launches.reset()
    out = attention.sdpa(q, k, v, heads)
    out.backward(do)
    torch.cuda.synchronize()
    assert launches.counts["flash_bwd_dq"] == 1 and launches.counts["flash_bwd_dkv"] == 0
    assert dict(launches.shapes)[("flash_bwd_dq", 1, 4096, 1024, 40)] == 1
    _, _, rdq, _, _ = _plain_grads(q.detach(), k, v, do, heads)
    _assert_within_bar(q.grad, rdq, "dq")


def test_no_grad_forward_writes_no_lse(dev):
    q, k, v, _ = _inputs(dev, 1, 512, 512, 80, torch.bfloat16, seed=3)
    q.requires_grad_()
    with torch.no_grad():
        out = flash.flash_sdpa(q, k, v, 2)
    assert out.grad_fn is None


def test_unsupported_inputs_raise_with_grad(dev):
    q, k, v, _ = _inputs(dev, 1, 512, 512, 2 * 64, torch.bfloat16)
    q.requires_grad_()
    with pytest.raises(ValueError, match="head dims"):
        flash.flash_sdpa(q, k, v, 2)
    q, k, v, _ = _inputs(dev, 1, 512, 512, 80, torch.bfloat16)
    out, lse = flash.flash_sdpa_fwd(q, k, v, 2, 40**-0.5)
    strided_do = torch.randn(1, 80, 512, device=dev).to(torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash.flash_sdpa_bwd(q, k, v, out, lse, strided_do, 2, 40**-0.5)
    with pytest.raises(ValueError, match="take"):
        flash.flash_sdpa_fwd(q.half(), k.half(), v.half(), 2, 40**-0.5)


def _tma_backward(dev, b, lq, lk, d, heads, seed):
    """The forward with its LSE, then both backward kernels through
    `launch_bwd`: (dq, dk, dv), the plain versions' (out, lse, dq, dk, dv),
    and the inputs."""
    q, k, v, do = _inputs(dev, b, lq, lk, heads * d, torch.bfloat16, seed=seed)
    out, lse = flash.flash_sdpa_fwd(q, k, v, heads, d**-0.5)
    di = flash.bwd_di(do, out, heads)
    launches.reset()
    grads = flash.launch_bwd(q, k, v, do, lse, di, heads, d**-0.5)
    torch.cuda.synchronize()
    return grads, _plain_grads(q, k, v, do, heads), (q, k, v, do, lse, di)


@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("lq,lk", [(192, 320), (320, 192), (64, 64)])
def test_wgmma_backward_trailing_tiles(dev, lq, lk, d):
    """A trailing 64-row tile inside a 128-row block on each axis (and a
    single 64-row tile on both): the wgmma kernels' idle warpgroup stores
    nothing, the rows they do store are within the bar, and nothing past
    Lq or Lk is written."""
    (dq, dk, dv), (_, _, rdq, rdk, rdv), _ = _tma_backward(dev, 2, lq, lk, d, 2, seed=d + lq)
    assert launches.counts["flash_bwd_dkv"] == 1 and launches.counts["flash_bwd_dq"] == 1
    for name, got, ref in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        assert bool(torch.isfinite(got).all()), name
        _assert_within_bar(got, ref, name)


@pytest.mark.parametrize("b,lq,lk,d", [(1, 8 * 1024, 1024, 80), (1, 1024, 1024, 80),
                                       (1, 1024, 1024, 40), (1, 8 * 1024, 1024, 160),
                                       (1, 1024, 1024, 160)])
def test_wgmma_backward_split_query_axis(dev, b, lq, lk, d):
    """The reference net's and attn1_5's B=1 rows: the dk/dv kernel cuts the
    query axis into parts (fp32 partial sums, added in order by
    flash_bwd_dkv_sum), within the same bar as one part."""
    heads = 8
    parts = flash_tma.dkv_splits(b, heads, lq, lk)
    assert parts > 1
    (dq, dk, dv), (_, _, rdq, rdk, rdv), _ = _tma_backward(dev, b, lq, lk, d, heads, seed=7)
    assert launches.counts["flash_bwd_dkv_sum"] == 1
    for name, got, ref in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        _assert_within_bar(got, ref, name)


@pytest.mark.parametrize("b,lq,lk,d", [(2, 1024, 1024, 40), (1, 8 * 1024, 1024, 80),
                                       (2, 1024, 1024, 160), (1, 8 * 1024, 1024, 160)])
def test_wgmma_backward_is_deterministic(dev, b, lq, lk, d):
    """Two launches on the same inputs give bitwise-equal dq, dk and dv, with
    one part and with the query axis split."""
    heads = 8
    first, _, (q, k, v, do, lse, di) = _tma_backward(dev, b, lq, lk, d, heads, seed=11)
    again = flash.launch_bwd(q, k, v, do, lse, di, heads, d**-0.5)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), first, again):
        assert torch.equal(x, y), name


def test_library_bwd_tile_is_flash_tma_bwd_tile(dev):
    """The library's backward tiling per head dim (vx_flash_bwd_tile, from
    csrc/flash_bwd_wgmma.cuh's BwdTile) is ops/flash_tma.py's."""
    lib = flash._library()
    out = (ctypes.c_longlong * len(flash_tma.BWD_TILE_FIELDS))()
    assert set(flash_tma.BWD_SWIZZLE) == {40, 80, 160}
    for d in flash_tma.BWD_SWIZZLE:
        assert lib.vx_flash_bwd_tile(d, out) == 0
        assert dict(zip(flash_tma.BWD_TILE_FIELDS, out)) == flash_tma.bwd_tile(d)
    assert lib.vx_flash_bwd_tile(64, out) != 0


def test_bf16_backward_kernels_use_wgmma_and_tma(dev):
    """Every bf16 wgmma backward kernel in the built library (dk/dv and dq at
    D=40, 80 and 160) holds HGMMA (wgmma) and UTMALDG (TMA loads) in its SASS,
    and the library holds no mma.sync (HMMA) backward kernel."""
    for part in ("flash_bwd_dkv_wgmma", "flash_bwd_dq_wgmma"):
        ops = sass_ops(flash.build(), part)
        assert len(ops) == 3, (part, sorted(ops))
        for name, found in ops.items():
            assert {"HGMMA", "UTMALDG"} <= set(found), (name, found)
    for name, found in sass_ops(flash.build(), "flash_bwd_d").items():  # every backward kernel
        assert "HMMA" not in found, (name, found)
