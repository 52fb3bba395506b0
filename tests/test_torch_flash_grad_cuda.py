"""K1 with a gradient on the card: the forward with its log-sum-exp and the
backward kernels (vexpress_torch/csrc/flash_bwd.cu) against their plain
versions, and `flash_sdpa` on CUDA inputs that require a gradient. Marked
`cuda`: without a CUDA device every test skips. On a machine with an H100:

    python -m pytest tests/test_torch_flash_grad_cuda.py -q -m cuda --noconftest

(`--noconftest`: tests/conftest.py sets up JAX, which such a machine may lack.)
"""

import pytest
import torch

from chip_smoke import LSE_BAR, within_k1_grad_bar
from vexpress_torch.ops import attention, flash, launches

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
