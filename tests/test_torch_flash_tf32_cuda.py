"""K1's and K2's fp32 forward on the card: the split pass and the 3xTF32
kernel (vexpress_torch/csrc/flash_fwd.cu, csrc/flash_fwd_tf32.cuh) against
their plain versions, the tf32 operand probe, and the kernels' SASS. Marked
`cuda`: without a CUDA device every test skips. On a machine with an H100:

    python -m pytest tests/test_torch_flash_tf32_cuda.py -q -m cuda --noconftest
"""

import ctypes

import pytest
import torch

from chip_smoke import LSE_BAR, within_k1_bar
from vexpress_torch.ops import flash, flash_tma, launches
from vexpress_torch.tools.ptxas_report import sass_ops

pytestmark = pytest.mark.cuda

HEAD_DIMS = sorted(flash_tma.F32_TILES)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(dev, b, lq, lk, inner, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(b, l, inner, generator=g, device=dev) for l in (lq, lk, lk)]


def _assert_k1_bar(out, ref):
    err = (out - ref).abs()
    ok, tol = within_k1_bar(False, float(err.max()), float(err.mean()), float(ref.std()))
    assert ok, (float(err.max()), float(err.mean()), tol)


# one 64-row tile; trailing 64-row query tiles past 128-row blocks, and key
# counts that are whole 64-key tiles but odd multiples of the 16- and 32-key
# stages; a long key axis
EDGES = [(64, 64), (192, 320), (320, 1088)]


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("lq,lk", EDGES)
def test_k1_fp32_kernel_tiles(dev, lq, lk, d, with_lse):
    q, k, v = _qkv(dev, 2, lq, lk, 2 * d, seed=d)
    ref, ref_lse = flash.flash_sdpa_reference(q, k, v, 2, return_lse=True)
    launches.reset()
    out, lse = flash._launch_fwd(q, k, v, 2, d**-0.5, with_lse=with_lse)
    torch.cuda.synchronize()
    assert dict(launches.counts) == {"flash_fwd": 1}
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    _assert_k1_bar(out, ref)
    if with_lse:
        assert float((lse - ref_lse).abs().max()) <= LSE_BAR
    else:
        assert lse is None


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("lq,lk", EDGES)
def test_k2_fp32_kernel_tiles(dev, lq, lk, d):
    """K2 in fp32 under chip_smoke.k2_row's bars: K1's bf16 bar against
    flash_lite_reference over the kernel's key tiles (bf16(s - m) rounds at
    the running max of each tile) and 0.03 against exact attention."""
    q, k, v = _qkv(dev, 2, lq, lk, 2 * d, seed=d + 1)
    launches.reset()
    out = flash.launch_lite(q, k, v, 2, d**-0.5)
    torch.cuda.synchronize()
    assert dict(launches.counts) == {"flash_lite_fwd": 1}
    plain = flash.flash_lite_reference(q, k, v, 2, block_k=flash_tma.f32_tile(d)["tile_k"])
    err = (out - plain).abs()
    ok, tol = within_k1_bar(True, float(err.max()), float(err.mean()), float(plain.std()))
    assert ok, (float(err.max()), float(err.mean()), tol)
    exact = flash.flash_sdpa_reference(q, k, v, 2)
    assert float((out - exact).abs().max()) < 0.03


@pytest.mark.parametrize("lite", [False, True])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_split_pass_is_the_plain_split(dev, d, lite):
    """The split pass writes, bitwise, what flash.tf32_parts computes."""
    b, heads, lq, lk = 2, 3, 192, 320
    q, k, v = _qkv(dev, b, lq, lk, heads * d, seed=5)
    qmul = float(torch.tensor(d**-0.5, dtype=torch.float32)) if lite else 1.0
    parts = flash.launch_f32_split(q, k, v, heads, qmul)
    torch.cuda.synchronize()
    want = flash.tf32_parts(q, k, v, heads, qmul)
    got = torch.split(parts, [q.numel()] * 2 + [k.numel()] * 4)
    for name, g_, w in zip(("qh", "ql", "kh", "kl", "vh", "vl"), got, want):
        assert torch.equal(g_, w.reshape(-1)), name


def _run_on_parts(q, k, v, heads, parts):
    """The fp32 kernel (K1, no LSE) on the parts given, without the split pass."""
    b, lq, inner = q.shape
    lk, d = k.shape[1], inner // heads
    out = torch.empty_like(q)
    flat = torch.cat([p.reshape(-1) for p in parts])
    geom = flash._f32_geometry(b, lq, lk, heads, d)
    rc = flash._library().vx_flash_fwd_f32(flat.data_ptr(), out.data_ptr(), None, 0, b, heads,
                                           lq, lk, d, geom, d**-0.5,
                                           torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    return out


def test_tf32_operands_ignore_the_low_13_bits(dev):
    """The probe of the design's question: does wgmma .tf32 read an fp32
    operand's low 13 bits? The kernel run on parts whose hi is x itself (low
    bits set) and whose lo is 0 gives, bitwise, what it gives on x truncated
    to tf32 (low bits cleared), and not what it gives on x rounded to
    nearest: the tensor cores truncate."""
    d, heads, lq, lk = 40, 2, 128, 256
    q, k, v = _qkv(dev, 1, lq, lk, heads * d, seed=3)
    vt = (v.reshape(1, lk // 8, 8, heads, d)[:, :, list(flash.TF32_KEY_ORDER)]
          .permute(0, 3, 4, 1, 2).reshape(1, heads, d, lk))
    zq, zk = torch.zeros_like(q), torch.zeros_like(k)

    def run(qh, kh, vh):
        return _run_on_parts(q, k, v, heads, [qh, zq, kh, zk, vh, zk])

    def trunc(x):
        return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)

    rounded = flash.tf32_parts(q, k, v, heads)[::2]
    out_raw, out_trunc = run(q, k, vt), run(trunc(q), trunc(k), trunc(vt))
    out_rna = run(*rounded)
    print(f"low-13-bit probe: raw == truncated {torch.equal(out_raw, out_trunc)}, "
          f"raw == rounded {torch.equal(out_raw, out_rna)}, max |raw - rounded| "
          f"{float((out_raw - out_rna).abs().max()):.3e}")
    assert not torch.equal(out_trunc, out_rna)
    assert torch.equal(out_raw, out_trunc)


@pytest.mark.parametrize("lite", [False, True])
@pytest.mark.parametrize("length,inner", [(4096, 320), (1024, 640)])  # attn1 @64², @32²
def test_fp32_relaunch_is_bitwise_equal(dev, monkeypatch, length, inner, lite):
    monkeypatch.setattr(flash, "FLASH_LITE", lite)
    q, k, v = _qkv(dev, 48, length, length, inner, seed=7)
    first = flash.flash_sdpa(q, k, v, 8)
    differ = sum(not torch.equal(flash.flash_sdpa(q, k, v, 8), first) for _ in range(50))
    assert differ == 0, f"{differ} of 50 relaunches differ from the first"


def test_library_tile_is_flash_tma_f32_tile(dev):
    """The library's fp32 tiling per head dim (vx_flash_fwd_f32_tile, from
    csrc/flash_fwd_tf32.cuh's Tf32Tile) is ops/flash_tma.py's."""
    lib = flash._library()
    out = (ctypes.c_longlong * len(flash_tma.F32_TILE_FIELDS))()
    for d in HEAD_DIMS:
        assert lib.vx_flash_fwd_f32_tile(d, out) == 0
        assert dict(zip(flash_tma.F32_TILE_FIELDS, out)) == flash_tma.f32_tile(d)
    assert lib.vx_flash_fwd_f32_tile(64, out) != 0


def test_fp32_forward_kernels_use_tf32_wgmma_and_tma(dev):
    """Every fp32 forward kernel in the built library (K1 and K2 at each of
    the 3 head dims) holds HGMMA on TF32 operands only, UTMALDG (TMA loads)
    and MUFU.EX2 in its SASS."""
    ops = sass_ops(flash.build(), "flash_fwd_tf32",
                   opcodes=("HGMMA", "F32.TF32", "UTMALDG", "MUFU.EX2"))
    assert len(ops) == 6, sorted(ops)
    for name, found in ops.items():
        assert {"HGMMA", "UTMALDG", "MUFU.EX2"} <= set(found), (name, found)
        assert found["F32.TF32"] == found["HGMMA"], (name, found)
