"""K2's plain version (vexpress_torch/ops/flash_lite.py) against the JAX
package's Pallas kernel vexpress_tpu/ops/flash_lite.py::flash_lite_fwd, run in
interpret mode on the CPU, and K2's dispatch in ops/flash.py::flash_sdpa.

Bars: XLA:CPU in interpret mode keeps the exponential's result in fp32 where
the TPU kernel (and the plain version) round it to bf16. In bf16 that costs
at most an output ulp: max |d| <= 2 bf16 ulps of max|ref|, mean <= 1e-3
std(ref). For fp32 inputs the rounded p shows: max <= 2e-2 std(ref), mean <=
3e-3 std(ref) (measured max 4e-4 and mean 6.5e-5 at std(ref) 0.052).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vexpress_tpu.ops.flash_lite import flash_lite_fwd
from vexpress_torch.ops import flash, launches
from vexpress_torch.ops.flash_lite import flash_lite_reference

DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float32": (torch.float32, jnp.float32)}


def _bhld(b, h, l, d, seed):
    return np.random.default_rng(seed).standard_normal((b, h, l, d)).astype(np.float32)


def _packed(x: np.ndarray, dtype) -> torch.Tensor:
    b, h, l, d = x.shape
    return torch.from_numpy(x.transpose(0, 2, 1, 3).reshape(b, l, h * d).copy()).to(dtype)


def _unpack(t: torch.Tensor, h: int) -> np.ndarray:
    b, l, inner = t.shape
    return t.float().reshape(b, l, h, inner // h).permute(0, 2, 1, 3).numpy()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [40, 80])
@pytest.mark.parametrize("bk", [128, 512])
def test_plain_matches_jax_interpret(dtype, d, bk):
    tdt, jdt = DTYPES[dtype]
    b, h, l = 1, 2, 512
    q, k, v = (_bhld(b, h, l, d, s) for s in (1, 2, 3))
    scale = d**-0.5
    ref = np.asarray(flash_lite_fwd(*(jnp.asarray(x, jdt) for x in (q, k, v)), scale,
                                    block_k=bk, interpret=True), np.float32)
    got = _unpack(flash_lite_reference(*(_packed(x, tdt) for x in (q, k, v)), h, scale,
                                       block_k=bk), h)
    err = np.abs(got - ref)
    std = float(ref.std())
    if dtype == "bfloat16":
        ulp = 2.0 ** (math.floor(math.log2(float(np.abs(ref).max()))) - 7)
        max_bar, mean_bar = 2 * ulp, 1e-3 * std
    else:
        max_bar, mean_bar = 2e-2 * std, 3e-3 * std
    assert err.max() <= max_bar and err.mean() <= mean_bar, (err.max(), err.mean(), max_bar,
                                                              mean_bar)


def test_k2_within_exact_softmax_bar(monkeypatch):
    """tests/test_flash_lite.py's bar against fp32 softmax attention, through
    flash_sdpa with K2 on."""
    monkeypatch.setattr(flash, "FLASH_LITE", True)
    b, h, l, d = 2, 2, 256, 40
    q, k, v = (np.asarray(jax.random.normal(jax.random.PRNGKey(i), (b, h, l, d), jnp.bfloat16)
                          .astype(jnp.float32)) for i in range(3))
    launches.reset()
    out = flash.flash_sdpa(*(_packed(x, torch.bfloat16) for x in (q, k, v)), h)
    assert dict(launches.counts) == {"flash_lite_reference": 1}
    logits = np.einsum("bhqd,bhkd->bhqk", q, k) * d**-0.5
    w = np.exp(logits - logits.max(-1, keepdims=True))
    exact = np.einsum("bhqk,bhkd->bhqd", w / w.sum(-1, keepdims=True), v)
    assert np.abs(_unpack(out, h) - exact).max() < 0.03


def test_dispatch(monkeypatch):
    h, d = 2, 40
    q, k, v = (_packed(_bhld(1, h, 512, d, s), torch.float32) for s in (4, 5, 6))
    launches.reset()
    off = flash.flash_sdpa(q, k, v, h)
    assert dict(launches.counts) == {"flash_sdpa_reference": 1}  # off: K1's path as before
    torch.testing.assert_close(off, flash.flash_sdpa_reference(q, k, v, h), rtol=0, atol=0)

    monkeypatch.setattr(flash, "FLASH_LITE", True)
    launches.reset()
    on = flash.flash_sdpa(q, k, v, h)
    assert dict(launches.counts) == {"flash_lite_reference": 1}
    torch.testing.assert_close(on, flash_lite_reference(q, k, v, h), rtol=0, atol=0)

    # Lq = 17 * 128 fails lq % min(2048, lq) == 0: K1, as the JAX package dispatches
    q_odd = _packed(_bhld(1, h, 17 * 128, d, 7), torch.float32)
    launches.reset()
    flash.flash_sdpa(q_odd, k, v, h)
    assert dict(launches.counts) == {"flash_sdpa_reference": 1}

    with pytest.raises(ValueError, match="VEXPRESS_FLASH_LITE"):
        flash.flash_sdpa(q.clone().requires_grad_(), k, v, h)
