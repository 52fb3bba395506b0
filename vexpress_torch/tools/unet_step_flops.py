"""The real FLOPs of one window step: the port of tools/unet_step_flops.py.

One denoising-UNet call of the production window step: CFG batch 2 x 24
frames, 64x64 latents (512x512), the SD1.5 UNet with its motion modules, 16
reference banks (full fusion), the zero-uncond-KV path, bf16.

The count is `torch.utils.flop_counter.FlopCounterMode`'s, in place of XLA's
cost model: every matmul-class aten op (convolutions, linear layers, the
attention einsums of the plain paths and the motion attention), forward and,
under a gradient, backward. The counter cannot see a kernel launched through
ctypes, so `count_flops` adds the port's flash kernels from the launches they
record by shape (`ops.launches.shapes`): 4n a forward (K1, K2), 8n a dk/dv
and 6n a dq kernel (each recomputes q k^T), n = B*H*Lq*Lk*D. Elementwise work
is not counted; that includes the audio attention over 5 tokens, which runs
unrolled (ops.attention._attend_tiny_kv; ~5.5 GFLOP of a window step).

    python -m vexpress_torch.tools.unet_step_flops                # on the card
    python -m vexpress_torch.tools.unet_step_flops --device meta  # shapes only, no card
    python -m vexpress_torch.tools.unet_step_flops --device cpu --tiny

`--device meta` builds the UNet and its inputs as fake tensors
(torch._subclasses.FakeTensorMode): no memory, no arithmetic, the plain
attention path, at full width on any machine.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
from typing import Dict, Iterator, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..models.unet_3d import DenoisingUNet3D, UNetConfig
from ..ops import launches
from .common import add_device_args, card_line, pipeline_models, tool_device

XLA_WINDOW_STEP_GFLOP = 47568.5  # the JAX tool's XLA count (tools/profile_train_step.py:150)
KERNEL_OPS = {"flash_fwd": 4, "flash_lite_fwd": 4, "flash_bwd_dkv": 8, "flash_bwd_dq": 6}


@contextlib.contextmanager
def count_flops(heads: int) -> Iterator[Dict]:
    """Counts the FLOPs of the enclosed work into the yielded dict on exit:
    `total`, the aten counter's by op (`aten`), and the flash kernels'
    (`kernels`; `heads` per attention, the UNet config's)."""
    before = collections.Counter(launches.shapes)
    result: Dict = {}
    with FlopCounterMode(display=False) as fc:
        yield result
    ran = collections.Counter(launches.shapes)
    ran.subtract(before)
    kernels = sum(KERNEL_OPS[name] * n * b * heads * lq * lk * d
                  for (name, b, lq, lk, d), n in ran.items() if name in KERNEL_OPS and n > 0)
    aten = {str(op): int(n) for op, n in fc.get_flop_counts().get("Global", {}).items()}
    result.update(total=int(fc.get_total_flops()) + kernels, aten=aten, kernels=kernels)


@contextlib.contextmanager
def shapes_only(dtype: torch.dtype):
    """Modules and tensors made inside are fake CPU tensors in `dtype`."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    old = torch.get_default_dtype()
    with FakeTensorMode(allow_non_fake_inputs=True):
        torch.set_default_dtype(dtype)
        try:
            yield
        finally:
            torch.set_default_dtype(old)


def window_step_inputs(cfg: UNetConfig, batch: int, frames: int, h: int, w: int,
                       dtype: torch.dtype, device, seed: int = 0) -> tuple:
    """(sample, timesteps, audio tokens, reference banks, kps features) of one
    CFG window step, seeded; the uncond half's conditioning is zero, as the
    pipeline gives it."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(device=device, dtype=dtype)

    half = batch // 2
    sample = rnd(batch, frames, h, w, cfg.in_channels)
    t = torch.full((batch,), 500, dtype=torch.long, device=device)
    audio = torch.cat([torch.zeros((half, frames, 5, cfg.cross_attention_dim), dtype=dtype,
                                   device=device), rnd(batch - half, frames, 5,
                                                       cfg.cross_attention_dim)])
    refs = tuple(torch.cat([torch.zeros((half, n, c), dtype=dtype, device=device),
                            rnd(batch - half, n, c)]) for n, c in cfg.ref_feature_shapes(h, w))
    kps = torch.cat([torch.zeros((half, frames, h, w, cfg.block_out_channels[0]), dtype=dtype,
                                 device=device),
                     rnd(batch - half, frames, h, w, cfg.block_out_channels[0])])
    return sample, t, audio, refs, kps


def window_step_flops(cfg: UNetConfig, frames: int, h: int, w: int, dtype: torch.dtype,
                      device: str, unet: Optional[DenoisingUNet3D] = None) -> Dict:
    """The count of one CFG window-step UNet call (batch 2 x frames). On
    `device="meta"` from shapes alone; else on that device, with `unet` or
    a default-initialised one."""
    fake = device == "meta"
    ctx = shapes_only(dtype) if fake else contextlib.nullcontext()
    with ctx, torch.inference_mode():
        dev = torch.device("cpu" if fake else device)
        if unet is None:
            unet = DenoisingUNet3D(cfg).eval()
            if not fake:
                unet = unet.to(device=dev, dtype=dtype)
        args = window_step_inputs(cfg, 2, frames, h, w, dtype, dev)
        with count_flops(cfg.attention_head_dim) as flops:
            out = unet(*args, 0.95, 3.0, zero_uncond_kv=True)
        if tuple(out.shape) != (2, frames, h, w, cfg.out_channels):
            raise RuntimeError(f"UNet output {tuple(out.shape)}")
    return flops


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_args(p)
    p.add_argument("--frames", type=int, default=24, help="frames a window")
    p.add_argument("--height", type=int, default=512, help="frame height and width")
    return p.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    if args.device == "meta":
        print("meta (shapes only, no device)", flush=True)
    else:
        print(card_line(tool_device("unet_step_flops", args.device)), flush=True)
    dtype = torch.float32 if args.device == "cpu" else torch.bfloat16
    cfg = pipeline_models(args.tiny, dtype).unet_config
    h = w = args.height // 8
    flops = window_step_flops(cfg, args.frames, h, w, dtype, args.device)
    rec = {"window_step_gflops": flops["total"] / 1e9,
           "aten_gflops": {k: v / 1e9 for k, v in flops["aten"].items()},
           "flash_kernel_gflops": flops["kernels"] / 1e9,
           "xla_window_step_gflops": XLA_WINDOW_STEP_GFLOP,
           "geometry": {"cfg_batch": 2, "window": args.frames, "latent": [h, w],
                        "tiny": args.tiny, "device": args.device, "dtype": str(dtype)}}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
