"""The reference's precision. `plain_fp32` keeps the card's fp32 products
in fp32 (no TF32). The controls, the step below the configuration's
precision that a program could take, round every operand of a product or
a convolution (F.linear, F.conv1d, F.conv2d, torch.einsum) before it and
accumulate in fp32, as tensor-core products do: `fp8_operands` to e4m3
under one scale a tensor that maps its largest magnitude to 448 (for a
bf16 configuration). The reference under a control must read as not
correct."""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under a per-tensor scale, returned in x's dtype."""
    if not x.is_floating_point():
        return x
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    q = (x.float() * scale).to(torch.float8_e4m3fn).float() / scale
    return q.to(x.dtype)


@contextlib.contextmanager
def plain_fp32() -> Iterator[None]:
    """Within the block, fp32 products and convolutions run in fp32 on the
    card, not in TF32."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@contextlib.contextmanager
def rounded_operands(round_fn) -> Iterator[None]:
    """Within the block, F.linear, F.conv1d, F.conv2d and torch.einsum take
    `round_fn` of each operand."""
    saved = (F.linear, F.conv1d, F.conv2d, torch.einsum)
    linear, conv1d, conv2d, einsum = saved

    def q_linear(x, w, b=None):
        return linear(round_fn(x), round_fn(w), b)

    def q_conv1d(x, w, b=None, *a, **k):
        return conv1d(round_fn(x), round_fn(w), b, *a, **k)

    def q_conv2d(x, w, b=None, *a, **k):
        return conv2d(round_fn(x), round_fn(w), b, *a, **k)

    def q_einsum(eq, *ops):
        return einsum(eq, *(round_fn(o) for o in ops))

    F.linear, F.conv1d, F.conv2d, torch.einsum = q_linear, q_conv1d, q_conv2d, q_einsum
    try:
        yield
    finally:
        F.linear, F.conv1d, F.conv2d, torch.einsum = saved


def fp8_operands():
    """The control of a bf16 configuration: fp8 (e4m3) operands."""
    return rounded_operands(round_fp8)
