"""T2's plain version (vexpress_torch/ops/splash.py) against the JAX library's
Pallas TPU splash attention (`make_splash_mha` over a MultiHeadMask of
FullMask, interpret=True) on the CPU, vmapped over the batch with q scaled
first, as tools/bench_attn_variants.py calls it; the port's q pre-scale
against the JAX tool's; T2's wrapper on CPU tensors.

Bars, on numpy-seeded inputs at (B, H, L, D) = (2, 2, 256, 40), both sides fed
the same pre-scaled q:
  fp32: max |d| <= 2e-6 and mean <= 1e-7 (the same fp32 arithmetic in other
  orders; measured max 2.4e-7).
  bf16: max |d| <= 1 bf16 ulp of max|ref| and mean <= 1e-5 std(ref): p and
  P V are fp32 on both sides, so only the final rounding to bf16 can differ
  (measured: one ulp at a handful of elements, mean 6e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.splash_attention import splash_attention_kernel as sk
from jax.experimental.pallas.ops.tpu.splash_attention import splash_attention_mask as sm

from vexpress_torch.ops import launches
from vexpress_torch.ops.splash import splash_mha_fwd, splash_mha_reference
from vexpress_torch.tools.bench_attn_variants import prescale

from .test_torch_attn_variants import DTYPES, B, H, L, D, assert_within_bar, bhld_inputs


def library_splash(qs, k, v, d_target, block_q, block_kv):
    """tools/bench_attn_variants.py's splash_at call on q already scaled,
    interpreted."""
    heads, seq = qs.shape[1], qs.shape[2]
    mask = sm.MultiHeadMask([sm.FullMask((seq, seq)) for _ in range(heads)])
    small = min(128, seq)
    block = sk.BlockSizes(block_q=block_q, block_kv=block_kv, block_kv_compute=block_kv,
                          block_q_dkv=small, block_kv_dkv=small, block_kv_dkv_compute=small,
                          block_q_dq=small, block_kv_dq=small)
    kernel = sk.make_splash_mha(mask, block_sizes=block, head_shards=1, q_seq_shards=1,
                                interpret=True)
    pad = ((0, 0), (0, 0), (0, 0), (0, d_target - qs.shape[-1]))
    out = jax.vmap(kernel)(*(jnp.pad(x, pad) for x in (qs, k, v)))
    return np.asarray(out[..., : qs.shape[-1]].astype(jnp.float32))


@pytest.mark.parametrize("dtype,d_target,block_q,block_kv", [
    ("bfloat16", 40, 256, 128),
    ("float32", 64, 128, 256),
])
def test_plain_matches_splash_interpret(dtype, d_target, block_q, block_kv):
    tdt, jdt = DTYPES[dtype]
    q, k, v = bhld_inputs(2)
    qs = jnp.asarray(q, jdt) * D**-0.5  # the JAX tool's pre-scale, in the working dtype
    ref = library_splash(qs, jnp.asarray(k, jdt), jnp.asarray(v, jdt), d_target, block_q,
                         block_kv)
    qt = torch.from_numpy(np.array(qs.astype(jnp.float32))).to(tdt)  # exact: qs is in tdt
    got = splash_mha_reference(qt, *(torch.from_numpy(x).to(tdt) for x in (k, v)),
                               block_kv=block_kv)
    assert got.dtype == tdt
    assert_within_bar(got.float().numpy(), ref, dtype)


def test_prescale_matches_jax_tool():
    """The port's bench scales q as the JAX tool does (`prescale`): the
    weakly typed scale is cast to bf16 before the product (a float32 scale
    would round other values)."""
    q = bhld_inputs(3)[0]
    want = np.asarray((jnp.asarray(q, jnp.bfloat16) * D**-0.5).astype(jnp.float32))
    got = prescale(torch.from_numpy(q).to(torch.bfloat16), D**-0.5)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_wrapper_runs_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in bhld_inputs(4))
    launches.reset()
    out = splash_mha_fwd(q, k, v, block_q=128, block_kv=128)
    assert dict(launches.counts) == {"splash_mha_reference": 1}
    torch.testing.assert_close(out, splash_mha_reference(q, k, v, block_kv=128), rtol=0, atol=0)
    with pytest.raises(ValueError, match=r"\(B, H, L, D\)"):
        splash_mha_fwd(q[0], k[0], v[0])
