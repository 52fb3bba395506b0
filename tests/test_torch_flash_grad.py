"""K1's gradient in the port on the CPU: `flash_sdpa_bwd_reference` (the plain
version of csrc/flash_bwd.cu) against torch autograd of `flash_sdpa_reference`
and against jax.grad of vexpress_tpu.ops.attention.sdpa (on the CPU, JAX runs
its chunked XLA attention, K1's plain reference); the log-sum-exp output; and
`FlashAttention`, whose CPU branch runs the plain versions. fp32, tolerance
1e-5 (atol and rtol).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vexpress_tpu.ops import attention as jattn
from vexpress_torch.ops import attention as tattn
from vexpress_torch.ops import flash, launches

from .torch_port_utils import close, rand, t

TOL = 1e-5
CASES = [(2, 256, 256, 2, 40), (1, 256, 128, 2, 80), (2, 4 * 128, 128, 2, 40),
         (1, 256, 128, 1, 160)]  # (B, Lq, Lk, H, D)


def _inputs(b, lq, lk, heads, d, seed=0):
    return [rand((b, l, heads * d), seed + i) for i, l in enumerate((lq, lk, lk, lq))]


def _plain_bwd(q, k, v, do, heads):
    with torch.no_grad():
        out, lse = flash.flash_sdpa_reference(t(q), t(k), t(v), heads, return_lse=True)
        return flash.flash_sdpa_bwd_reference(t(q), t(k), t(v), out, lse, t(do), heads)


@pytest.mark.parametrize("b,lq,lk,heads,d", CASES)
def test_bwd_reference_matches_autograd(b, lq, lk, heads, d):
    q, k, v, do = _inputs(b, lq, lk, heads, d)
    leaves = [t(x).requires_grad_() for x in (q, k, v)]
    flash.flash_sdpa_reference(*leaves, heads).backward(t(do))
    for name, got, leaf in zip("qkv", _plain_bwd(q, k, v, do, heads), leaves):
        close(got.numpy(), leaf.grad.numpy(), TOL, f"d{name}")


@pytest.mark.parametrize("b,lq,lk,heads,d", CASES)
def test_bwd_reference_matches_jax_grad(b, lq, lk, heads, d):
    q, k, v, do = _inputs(b, lq, lk, heads, d, seed=4)

    def f(qq, kk, vv):
        return jnp.sum(jattn.sdpa(qq, kk, vv, heads) * jnp.asarray(do))

    ref = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for name, got, want in zip("qkv", _plain_bwd(q, k, v, do, heads), ref):
        close(got.numpy(), np.asarray(want), TOL, f"d{name}")


def test_reference_lse_is_logsumexp():
    q, k, v, _ = _inputs(2, 256, 128, 2, 40, seed=8)
    _, lse = flash.flash_sdpa_reference(t(q), t(k), t(v), 2, q_chunk=96, return_lse=True)
    logits = torch.einsum("bqhd,bkhd->bhqk", t(q).reshape(2, 256, 2, 40),
                          t(k).reshape(2, 128, 2, 40)) * 40**-0.5
    assert lse.shape == (2, 2, 256) and lse.dtype == torch.float32
    close(lse.numpy(), torch.logsumexp(logits, -1).numpy(), TOL)


@pytest.mark.parametrize("grads", [(True, True, True), (True, False, False), (False, True, True)])
def test_flash_attention_function_on_cpu(grads):
    """The autograd Function's CPU branch: plain forward with its LSE, plain
    backward, and only the gradients asked for."""
    q, k, v, do = _inputs(1, 4 * 128, 128, 2, 40, seed=12)
    leaves = [t(x).requires_grad_(g) for x, g in zip((q, k, v), grads)]
    launches.reset()
    out = flash.FlashAttention.apply(*leaves, 2, 40**-0.5)
    out.backward(t(do))
    assert launches.counts["flash_sdpa_reference"] == 1
    assert launches.counts["flash_sdpa_bwd_reference"] == 1
    close(out.detach().numpy(), flash.flash_sdpa_reference(t(q), t(k), t(v), 2).numpy(), TOL)
    for name, leaf, want in zip("qkv", leaves, _plain_bwd(q, k, v, do, 2)):
        if leaf.requires_grad:
            close(leaf.grad.numpy(), want.numpy(), TOL, f"d{name}")
        else:
            assert leaf.grad is None


def test_sdpa_grad_on_cpu_goes_through_autograd_of_reference():
    """CPU tensors keep running flash_sdpa_reference under a gradient; the
    grouped attn1_5 layout (4 frames of queries against one bank) included."""
    q, k, v, do = _inputs(1, 4 * 512, 512, 2, 40, seed=16)
    leaves = [t(x).requires_grad_() for x in (q, k, v)]
    launches.reset()
    out = tattn.sdpa(*leaves, 2)
    assert out.grad_fn is not None and launches.counts["flash_sdpa_reference"] == 1
    out.backward(t(do))
    assert launches.counts["flash_sdpa_bwd_reference"] == 0
    for name, leaf, want in zip("qkv", leaves, _plain_bwd(q, k, v, do, 2)):
        close(leaf.grad.numpy(), want.numpy(), TOL, f"d{name}")


def test_bwd_wrapper_on_cpu_skips_unasked_grads():
    q, k, v, do = _inputs(1, 256, 128, 2, 40, seed=20)
    out, lse = flash.flash_sdpa_fwd(t(q), t(k), t(v), 2, 40**-0.5)
    dq, dk, dv = flash.flash_sdpa_bwd(t(q), t(k), t(v), out, lse, t(do), 2, 40**-0.5,
                                      need_dq=True, need_dkv=False)
    assert dk is None and dv is None
    close(dq.numpy(), _plain_bwd(q, k, v, do, 2)[0].numpy(), TOL)
