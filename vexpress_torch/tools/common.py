"""What the measurement tools share: the card's line, the H100's peaks,
CUDA-event timing, the chained marginal timer, the kernel families of a
torch.profiler trace, the peak memory of a pipeline call by stretch, the
device and model options, and the seeded pipeline and clip every pipeline
tool runs.

Every tool runs on the CUDA device unless given `--device cpu`; without a
card it raises. On the CPU the kernels' plain versions run and times are
host-clock times. `--tiny` swaps the SD1.5 geometry for a few-channel one
(`TINY_OVERRIDES`), for the CPU.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import re
import subprocess
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..io.loaders import apply_model_overrides, default_pipeline_models, init_pipeline_random_
from ..pipelines.pipeline import PipelineModels, VExpressPipeline

PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s
HBM_BPS = 3.35e12  # H100 SXM HBM3 bytes/s
CHAIN_N = 6  # applications of the op in one chained call (the JAX tools' N)

# a few-channel geometry of every module (the CPU tests' and the CPU runs')
TINY_OVERRIDES = {
    "unet": {"block_out_channels": (8, 16, 16, 16), "attention_head_dim": 2,
             "cross_attention_dim": 12, "norm_num_groups": 4,
             "motion_num_attention_heads": 2, "motion_max_len": 8},
    "vae": {"block_out_channels": (8, 8, 8, 8), "layers_per_block": 1, "norm_num_groups": 4},
    "wav2vec2": {"hidden_size": 16, "num_hidden_layers": 1, "num_attention_heads": 2,
                 "intermediate_size": 32, "conv_dim": (8, 8), "conv_kernel": (10, 3),
                 "conv_stride": (5, 2), "num_conv_pos_embeddings": 16,
                 "num_conv_pos_embedding_groups": 4},
    "audio_projection": {"dim": 16, "depth": 1, "dim_head": 4, "heads": 2, "num_queries": 5,
                         "embedding_dim": 16, "output_dim": 12, "max_seq_len": 10},
    "guider": {"conditioning_embedding_channels": 8, "block_out_channels": (4, 4, 8, 8)},
}

# device-time families of kernel names, first match wins
FAMILIES = [
    ("flash_fwd (K1, K2)", r"flash_fwd"),
    ("flash_bwd (K1 backward)", r"flash_bwd"),
    ("layout nchw<->nhwc (cuDNN)", r"nchwToNhwc|nhwcToNchw"),
    ("conv (cuDNN)", r"fprop|dgrad|wgrad|conv|cudnn|implicit_gemm"),
    ("gemm bf16 (cuBLAS)", r"nvjet|bf16.*gemm|gemm.*bf16|cutlass"),
    ("gemm fp32 (cuBLAS)", r"gemm"),
    ("group_norm", r"group_norm|GroupNorm|RowwiseMoments|ComputeFusedParams"),
    ("layer_norm", r"layer_norm|LayerNorm"),
    ("softmax", r"softmax"),
    ("median filter", r"[Mm]edian"),
    ("index/scatter/gather", r"index|scatter|gather"),
    ("reduce", r"reduce"),
    ("copy/cat/transpose", r"copy|Cat|transpose|Memcpy|Memset"),
    ("elementwise", r"elementwise|vectorized|unrolled|upsample"),
]


def family(name: str) -> str:
    for fam, pat in FAMILIES:
        if re.search(pat, name):
            return fam
    return "other"


def device_us(event) -> float:
    """Self device time of a profiler event, in microseconds."""
    return getattr(event, "self_device_time_total", None) or getattr(event, "self_cuda_time_total", 0)


def kernel_events(prof) -> list:
    """The device-side events (kernels, memcpy, memset) of a torch.profiler
    session; the host-side aten ops carry their kernels' time too and would
    count it twice."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0]


def families_ms(prof) -> Dict[str, float]:
    """Device ms by kernel family, largest first."""
    fams: "collections.Counter[str]" = collections.Counter()
    for e in kernel_events(prof):
        fams[family(e.key)] += device_us(e) / 1e3
    return dict(fams.most_common())


def add_device_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", help="cuda (the card, the default) or cpu")
    p.add_argument("--tiny", action="store_true",
                   help="the few-channel geometry of tools.common.TINY_OVERRIDES (CPU runs)")


def tool_device(name: str, device: str) -> torch.device:
    """The device a tool runs on: a CUDA device only if one is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{name}: no CUDA device (--device cpu runs on the CPU)")
    return dev


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu (plain versions, host clock)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[device.index or 0]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn: Callable[[], torch.Tensor], device: torch.device, reps: int) -> float:
    """Mean ms of fn() after one warm-up call: CUDA events on the card, the
    host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def chain_ms(op: Callable[[torch.Tensor], torch.Tensor], x0: torch.Tensor,
             device: torch.device, reps: int, n: int = CHAIN_N) -> float:
    """Marginal ms of one application of `op`: each call applies it `n` times
    with a data dependency (y = op(y) / 16 + x), and each call takes the last
    one's output, so no call can start before the previous one ends. The
    residual's elementwise work is part of the reading, as in the JAX tools."""
    state = {"x": x0}

    def chained():
        x = y = state["x"]
        for _ in range(n):
            y = op(y) * (1.0 / 16) + x
        state["x"] = y
        return y

    return time_ms(chained, device, reps) / n


def pipeline_models(tiny: bool, dtype: torch.dtype) -> PipelineModels:
    """The SD1.5 geometry (the reference's), or the tiny one."""
    models = default_pipeline_models(dtype)
    return apply_model_overrides(models, TINY_OVERRIDES) if tiny else models


def random_pipeline(tiny: bool, device: torch.device,
                    dtype: Optional[torch.dtype] = None) -> VExpressPipeline:
    """The pipeline with seeded random weights (no checkpoint is needed to
    time it): bf16 on the card, fp32 on the CPU unless `dtype` is given."""
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    return init_pipeline_random_(VExpressPipeline(pipeline_models(tiny, dtype), device=device),
                                 seed=0)


def clip_kwargs(frames: int, size: int, steps: int, window: int = 24, seed: int = 0) -> dict:
    """The JAX pipeline tools' call: seeded inputs of one clip (a uniform
    reference image, uniform uint8 keypoint frames, 0.1-scaled Gaussian audio
    at 16 kHz and 30 frames/s), `window`-frame windows with an overlap of 4,
    CFG 3.5, the median filter and YUV420 planes out."""
    rng = np.random.default_rng(seed)
    return dict(
        reference_image=rng.uniform(0, 1, (size, size, 3)).astype(np.float32),
        kps_images=rng.integers(0, 256, (frames, size, size, 3), dtype=np.uint8),
        audio_waveform=(0.1 * rng.standard_normal(int(frames / 30 * 16000))).astype(np.float32),
        width=size, height=size, video_length=frames, num_inference_steps=steps,
        guidance_scale=3.5, context_frames=window, context_overlap=4, seed=0,
        median_filter=True, output_yuv420=True)


@contextlib.contextmanager
def nonfinite_outputs(pipe: VExpressPipeline) -> Iterator[Callable[[], list]]:
    """Watches the denoising UNet's and the VAE decoder's calls within the
    block (uint8 video cannot show a non-finite value). The hooks keep one
    flag a module on the output's device, so no call waits on the host; the
    function yielded reads them, once the timed stretch is over, as the
    names of the modules whose output held a non-finite value. A flag is
    ORed in place, so a denoise step captured as a CUDA graph (the fused
    mode; its hooks run at the warm-up step and the capture) ORs into it at
    every replay."""
    flags: Dict[str, torch.Tensor] = {}

    def watch(name):
        def hook(_mod, _inp, out):
            hit = ~torch.isfinite(out).all()
            if name in flags:
                flags[name] |= hit
            else:
                flags[name] = hit
        return hook

    hooks = [pipe.denoising_unet.register_forward_hook(watch("denoising_unet")),
             pipe.vae.decoder.register_forward_hook(watch("vae.decoder"))]
    try:
        yield lambda: [name for name, hit in flags.items() if bool(hit)]
    finally:
        for h in hooks:
            h.remove()


class PeakSplit:
    """Peak allocated device memory by stretch of one pipeline call on the
    card, in GiB: up to the first denoising-UNet call (set-up and
    conditioning), up to the first VAE-decoder call (denoise), and the rest
    (decode). Each stretch resets the peaks for the next, the reserved peak
    too, so `reserved` keeps each stretch's reserved peak beside it: a
    whole-call peak is the largest of its stretches'."""

    def __init__(self, pipe: VExpressPipeline):
        self.peaks: Dict[str, float] = {}
        self.reserved: Dict[str, float] = {}
        self.hooks = [pipe.denoising_unet.register_forward_pre_hook(self._mark("conditioning")),
                      pipe.vae.decoder.register_forward_pre_hook(self._mark("denoise"))]

    def _read(self, name: str) -> None:
        self.peaks[name] = torch.cuda.max_memory_allocated() / 2**30
        self.reserved[name] = torch.cuda.max_memory_reserved() / 2**30

    def _mark(self, name):
        def hook(*_):
            if name not in self.peaks:
                self._read(name)
                torch.cuda.reset_peak_memory_stats()
        return hook

    def finish(self) -> Dict[str, float]:
        self._read("decode")
        for h in self.hooks:
            h.remove()
        return self.peaks


def peak_mib(device: torch.device) -> Optional[float]:
    """Peak allocated device memory since the last reset, in MiB (None on the
    CPU)."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**20


def add_clip_args(p: argparse.ArgumentParser, frames: int, steps: int) -> None:
    """The pipeline tools' clip options."""
    add_device_args(p)
    p.add_argument("--frames", type=int, default=frames, help="trimmed to whole windows")
    p.add_argument("--steps", type=int, default=steps)
    p.add_argument("--window", type=int, default=24, help="context frames (overlap 4)")
    p.add_argument("--height", type=int, default=512, help="frame height and width")


def timed_call(pipe: VExpressPipeline, kwargs: dict, progress_callback=None):
    """(seconds, output, names of non-finite UNet/decoder outputs) of one
    pipeline call; the call returns host arrays, so it has ended. The
    outputs' flags are read after the clock stops."""
    with nonfinite_outputs(pipe) as read_flags:
        t0 = time.perf_counter()
        video = pipe(**kwargs, progress_callback=progress_callback)
        seconds = time.perf_counter() - t0
    return seconds, video, read_flags()
