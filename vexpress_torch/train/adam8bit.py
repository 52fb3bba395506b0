"""Blockwise 8-bit AdamW. Counterpart of vexpress_tpu/train/adam8bit.py (the
analog of bitsandbytes' AdamW8bit that the reference trains with when
`solver.use_8bit_adam` is set, train.py:464-472).

Both momenta are stored as int8 codes with one fp32 absmax scale per block of
256 elements (~9x smaller than fp32 state):

  * first moment m: signed mu-law companded codes in [-127, 127];
  * second moment v: mu-law of sqrt(v) / blockmax, codes 0..255 stored with an
    offset of -128 so the buffer is a true int8 tensor.

Leaves smaller than `min_quant_size` keep fp32 momenta. The update is the JAX
transformation's, step for step, written as a torch.optim.Optimizer that
updates the parameters in place: dequantize, the AdamW moment update with
optax's bias correction, requantize, p += (-lr * step) cast to p's dtype.
Elementwise plain torch: like the JAX package, which leaves it to XLA's
fusion, it has no hand-written kernel.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, NamedTuple, Union

import torch

_MU = 255.0  # mu-law companding constant
_LOG1P_MU = math.log1p(_MU)


class QTensor(NamedTuple):
    """A quantized moment: int8 codes (nblocks, block) and fp32 scales
    (nblocks, 1)."""

    codes: torch.Tensor
    scales: torch.Tensor


def _compand(xn: torch.Tensor) -> torch.Tensor:
    """mu-law: [-1, 1] -> [-1, 1], log-spaced resolution near zero."""
    return torch.sign(xn) * torch.log1p(_MU * torch.abs(xn)) / _LOG1P_MU


def _expand(y: torch.Tensor) -> torch.Tensor:
    return torch.sign(y) * torch.expm1(torch.abs(y) * _LOG1P_MU) / _MU


def _blocks(flat: torch.Tensor, block: int) -> torch.Tensor:
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block)


def quantize_signed(x: torch.Tensor, block: int) -> QTensor:
    blocks = _blocks(x.reshape(-1).float(), block)
    scale = blocks.abs().amax(dim=1, keepdim=True)
    y = _compand(blocks / torch.where(scale > 0, scale, torch.ones_like(scale)))
    codes = torch.clamp(torch.round(y * 127.0), -127, 127).to(torch.int8)
    return QTensor(codes, scale)


def dequantize_signed(q: QTensor, shape) -> torch.Tensor:
    xn = _expand(q.codes.float() / 127.0)
    return (xn * q.scales).reshape(-1)[: math.prod(shape)].reshape(shape)


def quantize_sqrt(x: torch.Tensor, block: int) -> QTensor:
    """Non-negative tensor, quantized as mu-law of sqrt(x) / blockmax."""
    blocks = _blocks(torch.sqrt(torch.clamp(x.float(), min=0.0)).reshape(-1), block)
    scale = blocks.amax(dim=1, keepdim=True)
    y = _compand(blocks / torch.where(scale > 0, scale, torch.ones_like(scale)))
    codes = (torch.clamp(torch.round(y * 255.0), 0, 255) - 128).to(torch.int8)
    return QTensor(codes, scale)


def dequantize_sqrt(q: QTensor, shape) -> torch.Tensor:
    root = _expand((q.codes.float() + 128.0) / 255.0) * q.scales
    return (root * root).reshape(-1)[: math.prod(shape)].reshape(shape)


class Adam8bit(torch.optim.Optimizer):
    """AdamW with blockwise int8 momenta (decoupled weight decay, bias
    correction as optax.adamw). `lr` is a float or a schedule of the update
    count, looked up before the count is incremented (as optax does)."""

    def __init__(self, params: Iterable[torch.Tensor],
                 lr: Union[float, Callable[[int], float]] = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0, block_size: int = 256,
                 min_quant_size: int = 4096):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                                      block_size=block_size, min_quant_size=min_quant_size))
        self.count = 0

    def _init_state(self, p: torch.Tensor, block: int, min_quant: int) -> dict:
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if p.numel() < min_quant:
            return dict(mu=z, nu=z.clone())
        return dict(mu=quantize_signed(z, block), nu=quantize_sqrt(z, block))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam8bit takes no closure")
        count = self.count + 1
        for group in self.param_groups:
            lr = group["lr"](self.count) if callable(group["lr"]) else group["lr"]
            b1, b2 = group["betas"]
            block, min_quant = group["block_size"], group["min_quant_size"]
            c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** count
            c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** count
            for p in group["params"]:
                state = self.state[p]
                if not state:
                    state.update(self._init_state(p, block, min_quant))
                g = (p.grad if p.grad is not None else torch.zeros_like(p)).float()
                quantized = isinstance(state["mu"], QTensor)
                mu = dequantize_signed(state["mu"], g.shape) if quantized else state["mu"]
                nu = dequantize_sqrt(state["nu"], g.shape) if quantized else state["nu"]
                mu = b1 * mu + (1.0 - b1) * g
                nu = b2 * nu + (1.0 - b2) * g * g
                c1d, c2d = c1.to(g.device), c2.to(g.device)
                upd = (mu / c1d) / (torch.sqrt(nu / c2d) + group["eps"])
                upd = upd + group["weight_decay"] * p.float()
                if quantized:
                    state["mu"], state["nu"] = quantize_signed(mu, block), quantize_sqrt(nu, block)
                else:
                    state["mu"], state["nu"] = mu, nu
                p.add_((-lr * upd).to(p.dtype))
        self.count = count
