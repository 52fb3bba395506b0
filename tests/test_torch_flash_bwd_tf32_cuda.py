"""K1's fp32 backward on the card: the split pass and the 3xTF32 dk/dv and dq
kernels (vexpress_torch/csrc/flash_bwd.cu, csrc/flash_bwd_tf32.cuh) against
their plain versions, at trailing ring tiles, with the query axis split and
at D=160 (two CTAs of a cluster a block); relaunches, the library's tiling
and the kernels' SASS. Marked `cuda`: without a CUDA device every test
skips. On a machine with an H100:

    python -m pytest tests/test_torch_flash_bwd_tf32_cuda.py -q -m cuda --noconftest
"""

import ctypes

import pytest
import torch

from chip_smoke import LSE_BAR, within_k1_grad_bar
from vexpress_torch.ops import flash, flash_tma, launches
from vexpress_torch.tools.ptxas_report import sass_ops

pytestmark = pytest.mark.cuda

HEAD_DIMS = sorted(flash_tma.F32_BWD_TILES)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, b, lq, lk, inner, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(b, l, inner, generator=g, device=dev) for l in (lq, lk, lk, lq)]


def _backward(dev, b, lq, lk, d, heads, seed=0):
    """The fp32 forward with its LSE, then both backward kernels through
    `launch_bwd`: (dq, dk, dv), the plain versions' (lse, dq, dk, dv), and
    the inputs; `launches.counts` holds the backward's launches alone."""
    q, k, v, do = _inputs(dev, b, lq, lk, heads * d, seed=seed)
    out, lse = flash.flash_sdpa_fwd(q, k, v, heads, d**-0.5)
    di = flash.bwd_di(do, out, heads)
    launches.reset()
    grads = flash.launch_bwd(q, k, v, do, lse, di, heads, d**-0.5)
    torch.cuda.synchronize()
    ran = dict(launches.counts)
    ref_out, ref_lse = flash.flash_sdpa_reference(q, k, v, heads, return_lse=True)
    refs = flash.flash_sdpa_bwd_reference(q, k, v, ref_out, ref_lse, do, heads)
    launches.reset()
    launches.counts.update(ran)
    return grads, (lse, ref_lse) + refs, (q, k, v, do, lse, di)


def _assert_within_bar(got, ref, what):
    """chip_smoke.py's fp32 bar for K1's gradients."""
    err = (got - ref).abs()
    ok, tol = within_k1_grad_bar(False, float(err.max()), float(err.mean()), float(ref.std()),
                                 float(ref.abs().max()))
    assert ok, (what, float(err.max()), float(err.mean()), tol)


def _assert_grads(grads, refs):
    (lse, ref_lse), rest = refs[:2], refs[2:]
    assert float((lse - ref_lse).abs().max()) <= LSE_BAR
    for name, got, ref in zip(("dq", "dk", "dv"), grads, rest):
        assert got.dtype == torch.float32 and bool(torch.isfinite(got).all()), name
        _assert_within_bar(got, ref, name)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("lq,lk", [(192, 320), (320, 192), (64, 64), (512, 1024)])
def test_fp32_backward_kernels_tiles(dev, lq, lk, d):
    """Blocks of 64 rows on each axis, ring tiles of 16 or 32 rows, a single
    64-row block on both: every gradient within the fp32 bar, each kernel
    launched once and no plain version."""
    grads, refs, _ = _backward(dev, 2, lq, lk, d, 2, seed=d + lq)
    assert launches.counts["flash_bwd_dkv"] == 1 and launches.counts["flash_bwd_dq"] == 1
    assert launches.counts["flash_sdpa_bwd_reference"] == 0
    _assert_grads(grads, refs)


@pytest.mark.parametrize("b,lq,lk,heads,d", [(1, 1024, 512, 2, 40), (1, 2048, 256, 2, 80),
                                             (1, 1024, 512, 2, 160)])
def test_fp32_backward_split_query_axis(dev, b, lq, lk, heads, d):
    """Where the dk/dv kernel's CTAs do not fill the card it cuts the query
    axis into parts, summed in order by flash_bwd_dkv_sum in fp32: within
    the same bar as one part."""
    assert flash_tma.f32_dkv_splits(b, heads, lq, lk, d) > 1
    grads, refs, _ = _backward(dev, b, lq, lk, d, heads, seed=5)
    assert launches.counts["flash_bwd_dkv_sum"] == 1
    _assert_grads(grads, refs)


@pytest.mark.parametrize("b,lq,lk,heads,d", [(4, 1024, 1024, 2, 40), (1, 2048, 256, 2, 80),
                                             (2, 1024, 1024, 8, 160)])
def test_fp32_backward_relaunch_is_bitwise_equal(dev, b, lq, lk, heads, d):
    """Two launches on the same inputs give bitwise-equal dq, dk and dv (no
    atomics; the split's parts summed in order; the cluster's two CTAs add
    each other's partial sums in either order, which fp32 addition does not
    tell apart)."""
    first, _, (q, k, v, do, lse, di) = _backward(dev, b, lq, lk, d, heads, seed=11)
    for _ in range(5):
        again = flash.launch_bwd(q, k, v, do, lse, di, heads, d**-0.5)
        torch.cuda.synchronize()
        for name, x, y in zip(("dq", "dk", "dv"), first, again):
            assert torch.equal(x, y), name


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_fp32_split_pass_is_the_plain_split(dev, d):
    """The backward's split pass writes, bitwise, what flash.tf32_bwd_parts
    computes (the transposed parts only where a kernel reads them)."""
    b, heads, lq, lk = 2, 3, 192, 320
    q, k, v, do = _inputs(dev, b, lq, lk, heads * d, seed=3)
    parts = flash.launch_f32_bwd_split(q, k, v, do, heads)
    torch.cuda.synchronize()
    want = flash.tf32_bwd_parts(q, k, v, do, heads)
    got = torch.split(parts, [q.numel()] * 8 + [k.numel()] * 6)
    for name, g_ in zip(flash.TF32_BWD_PARTS, got):
        assert torch.equal(g_, want[name].reshape(-1)), name


def test_fp32_dq_only_and_dkv_only(dev):
    """attn1_5 at stage 2 asks for dq alone: the dq kernel alone runs. A
    frozen q asks for dk/dv alone: the dq kernel still runs first, for the
    log-sum-exp it hands the dk/dv kernel, and dq is not returned. The
    gradients equal the full backward's, bitwise."""
    d, heads = 40, 2
    grads, refs, (q, k, v, do, lse, di) = _backward(dev, 1, 1024, 256, d, heads, seed=9)
    launches.reset()
    dq, dk, dv = flash.launch_bwd(q, k, v, do, lse, di, heads, d**-0.5, need_dkv=False)
    torch.cuda.synchronize()
    assert dk is None and dv is None and dict(launches.counts) == {"flash_bwd_dq": 1}
    assert torch.equal(dq, grads[0])
    launches.reset()
    dq, dk, dv = flash.launch_bwd(q, k, v, do, lse, di, heads, d**-0.5, need_dq=False)
    torch.cuda.synchronize()
    assert dq is None and launches.counts["flash_bwd_dkv"] == 1
    assert launches.counts["flash_bwd_dq"] == 1
    assert torch.equal(dk, grads[1]) and torch.equal(dv, grads[2])


def test_library_f32_bwd_tile_is_flash_tma_f32_bwd_tile(dev):
    """The library's fp32 backward tiling per head dim (vx_flash_bwd_f32_tile,
    from csrc/flash_bwd_tf32.cuh's Tf32BwdTile) is ops/flash_tma.py's."""
    lib = flash._library()
    out = (ctypes.c_longlong * len(flash_tma.F32_BWD_TILE_FIELDS))()
    for d in HEAD_DIMS:
        assert lib.vx_flash_bwd_f32_tile(d, out) == 0
        assert dict(zip(flash_tma.F32_BWD_TILE_FIELDS, out)) == flash_tma.f32_bwd_tile(d)
    assert lib.vx_flash_bwd_f32_tile(64, out) != 0


def test_fp32_backward_kernels_use_tf32_wgmma_and_tma(dev):
    """Every fp32 backward kernel in the built library (dk/dv and dq at the
    3 head dims) holds HGMMA on TF32 operands only, UTMALDG (TMA loads) and
    MUFU.EX2 in its SASS, and the library holds no other fp32 backward
    kernel: the fp32 path launches no scalar kernel."""
    lib = flash.build()
    for part in ("flash_bwd_dkv_tf32", "flash_bwd_dq_tf32"):
        ops = sass_ops(lib, part, opcodes=("HGMMA", "F32.TF32", "UTMALDG", "MUFU.EX2"))
        assert len(ops) == 3, (part, sorted(ops))
        for name, found in ops.items():
            assert {"HGMMA", "UTMALDG", "MUFU.EX2"} <= set(found), (name, found)
            assert found["F32.TF32"] == found["HGMMA"], (name, found)
    backward = sass_ops(lib, "flash_bwd_d", opcodes=("HGMMA",))
    assert all(any(f in name for f in ("_wgmma", "_tf32", "flash_bwd_dkv_sum"))
               for name in backward), sorted(backward)
    assert not sass_ops(lib, "simt")
