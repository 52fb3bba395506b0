"""T1's plain version (vexpress_torch/ops/flash_variants.py) against the JAX
library's Pallas TPU flash_attention run in interpret mode on the CPU, called
as tools/bench_attn_variants.py calls it (BlockSizes with block_b, the head
dim zero-padded in device memory and sliced off the output); T1's wrapper on
CPU tensors; and the ported bench tools at a tiny shape.

Bars, on numpy-seeded inputs at (B, H, L, D) = (2, 2, 256, 40):
  fp32: max |d| <= 2e-6 and mean <= 1e-7. Both sides compute the same fp32
  arithmetic in other orders (the library renormalises the accumulator at each
  key block, the plain version divides once at the end); measured max 2.1e-7.
  bf16: max |d| <= 1 bf16 ulp of max|ref| and mean <= 1e-5 std(ref). Both round
  p to bf16 against the same running max, so they differ only where the fp32
  order moves an output across a bf16 rounding boundary (measured: one ulp at
  a handful of elements, mean 8e-8).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import BlockSizes, flash_attention

from vexpress_torch.ops import launches
from vexpress_torch.ops.flash_variants import flash_fwd_variant, flash_fwd_variant_reference
from vexpress_torch.tools import bench_attn_variants, bench_motion_variants

DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float32": (torch.float32, jnp.float32)}
B, H, L, D = 2, 2, 256, 40


def bhld_inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, L, D)).astype(np.float32) for _ in range(3)]


def assert_within_bar(got: np.ndarray, ref: np.ndarray, dtype: str) -> None:
    err = np.abs(got - ref)
    if dtype == "bfloat16":
        ulp = 2.0 ** (math.floor(math.log2(float(np.abs(ref).max()))) - 7)
        max_bar, mean_bar = ulp, 1e-5 * float(ref.std())
    else:
        max_bar, mean_bar = 2e-6, 1e-7
    assert err.max() <= max_bar and err.mean() <= mean_bar, (err.max(), err.mean(), max_bar,
                                                              mean_bar)


def library_flash(q, k, v, scale, d_target, block_b, block_q, block_k):
    """tools/bench_attn_variants.py's flash_at/flash_bb call, interpreted."""
    pad = ((0, 0), (0, 0), (0, 0), (0, d_target - q.shape[-1]))
    small = min(128, q.shape[2])
    block = BlockSizes(block_q=block_q, block_k_major=block_k, block_k=block_k, block_b=block_b,
                       block_q_major_dkv=small, block_k_major_dkv=small, block_k_dkv=small,
                       block_q_dkv=small, block_k_major_dq=small, block_k_dq=small,
                       block_q_dq=small)
    with pltpu.force_tpu_interpret_mode():
        out = flash_attention(*(jnp.pad(x, pad) for x in (q, k, v)), causal=False,
                              sm_scale=float(scale), block_sizes=block)
    return np.asarray(out[..., : q.shape[-1]].astype(jnp.float32))


@pytest.mark.parametrize("dtype,block_b,d_target,block_q,block_k", [
    ("bfloat16", 1, 40, 128, 128),
    ("bfloat16", 2, 64, 256, 128),
    ("float32", 2, 40, 128, 256),
    ("float32", 1, 64, 256, 128),
])
def test_plain_matches_library_interpret(dtype, block_b, d_target, block_q, block_k):
    tdt, jdt = DTYPES[dtype]
    q, k, v = bhld_inputs()
    scale = D**-0.5
    ref = library_flash(*(jnp.asarray(x, jdt) for x in (q, k, v)), scale, d_target, block_b,
                        block_q, block_k)
    got = flash_fwd_variant_reference(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), scale,
                                      block_k=block_k)
    assert got.dtype == tdt
    assert_within_bar(got.float().numpy(), ref, dtype)


def test_wrapper_runs_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in bhld_inputs(1))
    launches.reset()
    out = flash_fwd_variant(q, k, v, D**-0.5, block_q=128, block_k=64, heads_per_block=4,
                            d_target=64)
    assert dict(launches.counts) == {"flash_fwd_variant_reference": 1}
    torch.testing.assert_close(out, flash_fwd_variant_reference(q, k, v, D**-0.5, block_k=64),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="below the head dim"):
        flash_fwd_variant(q, k, v, D**-0.5, d_target=32)


def test_bench_attn_variants_on_cpu(monkeypatch, capsys):
    rows = bench_attn_variants.main(["--device", "cpu", "--shape", "1", "4", "128", "40"])
    names = [r["name"] for r in rows]
    assert names == ["t1_pad128", "t1_native", "t1_pad64", "t2_native", "t2_pad64",
                     "t2_bigtile", "sdpa_dispatch"] + [
        f"t1_hb{hb}_q{bq}k{bk}" for hb in (2, 4) for bq, bk in ((64, 64), (128, 64), (64, 128))]
    # against exact fp32 attention of the bf16 inputs: bf16 output rounding,
    # and for T2 also the bf16 rounding of the pre-scaled q
    assert all(r["max_abs_err"] < 1e-2 for r in rows), rows
    assert capsys.readouterr().out.startswith("cpu")
    monkeypatch.setenv("VEXPRESS_BENCH_ONLY_BB", "1")
    rows = bench_attn_variants.main(["--device", "cpu", "--shape", "1", "4", "128", "40"])
    assert [r["name"] for r in rows] == ["t1_native"] + names[7:]


def test_bench_motion_variants_on_cpu():
    rows = bench_motion_variants.main(["--device", "cpu", "--shape", "1", "4", "64", "2", "8"])
    assert [r["name"] for r in rows] == ["prod_folded", "einsum_auto", "unroll_kf",
                                         "unroll_kf_bf16"]
    # the same attention; the unrolled rows keep the weights in fp32 where
    # prod_folded rounds them to bf16 for w v: a few bf16 ulps of |out| <= ~3
    assert all(r["max_abs_err"] < 0.05 for r in rows), rows
