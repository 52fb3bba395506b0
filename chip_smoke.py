#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vexpress_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, in order; any failure raises and the script exits non-zero:
  card          the card's name and power limit (nvidia-smi)
  build         nvcc builds every kernel from the sources in the checkout
  sass          the wgmma kernels' SASS (K1's and K2's forward in bf16 and in
                fp32, T1's, T2's, the backward pair in bf16 and in fp32)
                holds HGMMA (wgmma; on TF32 in the fp32 kernels), UTMALDG
                (TMA loads) and MUFU.EX2, and no more wgmma waits than its
                code; the fp32 backward's no local-memory spill
  kernel        each kernel at the main paths' shapes against its plain
                version: K1's forward and K2 (VEXPRESS_FLASH_LITE's bf16-exp
                forward, also against exact fp32 attention) at the inference
                shapes, window_group 1 and 2, and in fp32 (3xTF32) at the
                first four and at D=160;
                at the training shapes of stage 2 and stage 3, at 512x512
                and at 1024x1024's D=160 level, and in fp32 (3xTF32) at
                stage 2's, K1 with its gradient
                (forward with log-sum-exp, dk/dv and dq kernels) through
                FlashAttention, with SDPA's backward alone, the di
                reduction and in fp32 the backward's split pass timed beside
                them, and stage 3's, 1024x1024's and fp32's
                backward launches reckoned; times of each kernel, its plain version, one
                PyTorch library call (a yardstick only), K1 beside K2 on the
                same inputs, and the card's bound; at
                the reference net's B=1 shapes also K1, K2 and the library
                call replayed from a CUDA graph and the host's time to issue
                one call. The log lines add the exp floor (exps over the
                SFUs' rate at the SM clock read beside the window)
  parity        a reduced-depth fp32 pipeline run on the card against the same
                run on the CPU (decoded-video PSNR); then the CLI's
                configuration on the same models: DPM-Solver++, save_memory,
                K2, YUV420 planes
  train_parity  the same reduced-depth models in fp32 at stage 3: loss and
                gradients, then 2 AdamW and 2 8-bit-Adam train steps, on the
                card against the CPU
  lora_parity   the same models at stage 2 with LoRA (rank 2, alpha 4, every
                default target of the denoising UNet): loss and factor
                gradients, then 2 build_lora_train_step steps, card against
                CPU; then the adapter exported after step 2 merged as the
                inference CLI's --lora_path merges it, and parity's CLI run
                on both
  full          the streamed pipeline at full SD1.5 width in bf16 at 512x512
                with seeded random weights; checks the output and the kernel
                launches
  fused         full's pipeline and inputs in mode="fused" (each denoise step
                one CUDA graph, K1 inside it) against full's streamed run;
                then the CLI's generate at cli_full's settings without
                --save_gpu_memory (DPM-Solver++ 12, K2 inside the graph) with
                --mode fused against --mode streamed, and again after an
                in-place load of new UNet weights (the cached graph serves
                it): each fused call replayed a graph, launched the kernels
                by shape as streamed did, stayed finite and reached PSNR > 45
                dB against streamed; capture and step times, memory by
                stretch and the graph pool's reserve are printed
  decode_tail   the chunked decode tail with an identity decode: every tail
                length from 1 to chunk + 1 at chunk 4, filter on and off,
                uint8 and YUV420, bitwise equal to the whole-clip route; and
                the device memory it allocates over a 248-frame 512x512 bf16
                clip on the card (at most 0.5 GiB), beside the whole-clip
                route's
  train_full    5 train steps of stage 2 (configs/stage_2.yaml's values) at
                full SD1.5 width in bf16, 20 frames at 512x512, seeded random
                weights; checks losses, frozen and moved parameters, and the
                kernel launches by shape against those reckoned from the
                stage's trainability
  train_cli     the training CLI (vexpress_torch.cli.train.train) at full
                SD1.5 width: stage 2's values plus a lora section (rank 8,
                alpha 8), bf16, 20 frames at 512x512, 4 steps from synthetic
                batches, checkpoints every 2 steps; checks the losses, the
                files, the restore of checkpoint-4 against the live state,
                the adapter's merge card against CPU, and K1's launches by
                shape against those reckoned
  cli_full      the inference CLI's build_pipeline with its defaults (SD1.5
                geometry, bf16, absent checkpoints so seeded random weights)
                and generate with --sampler dpmpp_2m --num_inference_steps 12
                --save_gpu_memory, K2 on, median filter and YUV420 output, on
                44 synthetic 512x512 frames; then a 1-step call without
                save_memory brings the released modules back
  tools         each measurement tool of vexpress_torch/tools/ (profilers, FLOP
                count, decode, save_memory and the long-clip sampler, the op and
                block benches, the convergence demo, psnr) through its main() at
                a reduced size: fields finite, no out-of-memory row, no plain
                flash version, K1 and K2 only at the kernel phase's shapes, and
                the card's FLOP count equal to the one from shapes alone
  dist_parity   the data-parallel path (vexpress_torch.parallel) on parity's
                reduced fp32 models, 2 spawned ranks sharing the card over gloo:
                the pipeline in mode="sharded" against the same call streamed
                (1e-5), the ranks' latents bitwise equal; 2 stage-3 train
                steps, batch 1 a rank, against the batch-2 step on the CPU
                (loss 1e-5, gradients 1e-4 of their max), the ranks'
                parameters bitwise equal; then one rank over NCCL, whose
                sharded call and data-parallel steps (under deterministic
                algorithms) equal the streamed call and the plain steps
                bitwise
  sharded       the inference CLI at cli_full's settings plus
                --do_multi_devices_inference on 2 ranks sharing the card: one
                window a rank; rank 0's video against cli_full's (PSNR > 45
                dB), the latents bitwise equal across ranks, each rank's K2
                launches as reckoned
  train_dp      the training CLI's train() at stage_2() on 2 ranks sharing the
                card, batch 1 a rank, 3 steps, ZeRO-2-sharded 8-bit Adam, the
                checkpoint and exports at the last: losses finite, parameters
                bitwise equal across ranks after every step, each rank's
                optimizer state within 10% of half, each rank's K1 backward
                launches as reckoned
  attn_variants T1 (K1's forward at other tilings) and T2 (full-mask splash MHA)
                at the attention-variant bench's shape (48, 8, 4096, 40) bf16:
                each row against its plain version and against exact fp32
                attention beside K1, timed beside K1, SDPA and the bound, and
                each kernel against the other's plain version as a control of
                the bar; then the bench's entry point (vexpress_torch.tools.
                bench_attn_variants.main) once on the card, whose launches are
                these kernels' counts
  trace         the CLI's generate on the parity phase's models with
                --profile_dir, whose trace must hold the port's flash kernel

It prints a `kernels` JSON line and, as its last line, the result line
{"ok": true, "device": {...}}. Without a CUDA device, or without the
vexpress_torch package beside it, it prints no result and exits non-zero.
Nothing here imports JAX or vexpress_tpu.
"""

from __future__ import annotations

import gc
import json
import math
import pathlib
import subprocess
import sys
import tempfile
import time

PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s
N_SMS, EX2_PER_CLK = 132, 16  # H100 SXM: SMs, ex2 results a clock on one SM (MUFU)
PEAK_FP32 = 67e12  # H100 SXM fp32 FLOP/s outside the tensor cores
PEAK_TF32 = 495e12  # H100 SXM dense TF32 tensor-core FLOP/s
# fp32-level products on the tensor cores: the fp32 kernels' bound. K1's fp32
# forward and backward take each product as three TF32 products (3xTF32);
# K2's, whose p is bf16-valued, takes S's as three and P V's as two, 2.5 on
# average.
PEAK_3XTF32 = PEAK_TF32 / 3
PEAK_K2_TF32 = PEAK_TF32 / 2.5
HBM_BPS = 3.35e12  # H100 SXM HBM3 bytes/s
FULL_STEPS = 25  # the reference's DDIM step count; the full phase takes ~20 s on an H100

# K1 at the main path's shapes: 512x512 frames (64x64 latent), CFG, 24-frame
# windows, window_group 1. (name, B, Lq, Lk, H*D, H)
K1_SHAPES = [
    ("attn1@64x64", 48, 4096, 4096, 320, 8),
    ("attn1_5@64x64 grouped", 1, 24 * 4096, 4096, 320, 8),
    ("attn1@32x32", 48, 1024, 1024, 640, 8),
    ("attn1_5@32x32 grouped", 1, 24 * 1024, 1024, 640, 8),
    ("reference-net attn1@64x64", 1, 4096, 4096, 320, 8),
    ("reference-net attn1@32x32", 1, 1024, 1024, 640, 8),
]
# the same at window_group 2 (the inference CLI's --window_group 2; the tools
# phase's bench_savemem runs it): two windows a UNet call, attn1 at twice the
# batch, attn1_5's queries over both windows' frames
K1_G2_SHAPES = [
    ("g2 attn1@64x64", 96, 4096, 4096, 320, 8),
    ("g2 attn1_5@64x64 grouped", 1, 48 * 4096, 4096, 320, 8),
    ("g2 attn1@32x32", 96, 1024, 1024, 640, 8),
    ("g2 attn1_5@32x32 grouped", 1, 48 * 1024, 1024, 640, 8),
]
# checks off the main path: fp32 (the parity phase's type, and the inference
# CLI's --dtype fp32 at the main path's four shapes) and D=160 (1024x1024's
# third level; in fp32 under --dtype fp32)
K1_EXTRA = [
    ("fp32 attn1@32x32", 2, 1024, 1024, 640, 8, "float32"),
    ("bf16 D=160", 2, 1024, 1024, 1280, 8, "bfloat16"),
    ("fp32 D=160", 2, 1024, 1024, 1280, 8, "float32"),
] + [("fp32 " + n, b, lq, lk, i, h, "float32") for n, b, lq, lk, i, h in K1_SHAPES[:4]]


# K1 with its gradient at the training path's shapes: stage 2 at 512x512 (64x64
# latent), batch 1, 20 frames. (name, B, Lq, Lk, H*D, H)
TRAIN_FRAMES = 20
TRAIN_K1_SHAPES = [
    ("train attn1@64x64", TRAIN_FRAMES, 4096, 4096, 320, 8),
    ("train attn1_5@64x64 grouped", 1, TRAIN_FRAMES * 4096, 4096, 320, 8),
    ("train attn1@32x32", TRAIN_FRAMES, 1024, 1024, 640, 8),
    ("train attn1_5@32x32 grouped", 1, TRAIN_FRAMES * 1024, 1024, 640, 8),
]
# the same at stage 3 (configs/stage_3.yaml: 8 frames, every module trains,
# so attn1_5 runs the dk/dv kernel and the reference net's attn1 both
# kernels); not run end to end at full width, its launches are reckoned
STAGE3_FRAMES = 8
STAGE3_K1_SHAPES = [
    ("stage 3 attn1@64x64", STAGE3_FRAMES, 4096, 4096, 320, 8),
    ("stage 3 attn1_5@64x64 grouped", 1, STAGE3_FRAMES * 4096, 4096, 320, 8),
    ("stage 3 attn1@32x32", STAGE3_FRAMES, 1024, 1024, 640, 8),
    ("stage 3 attn1_5@32x32 grouped", 1, STAGE3_FRAMES * 1024, 1024, 640, 8),
    ("stage 3 reference-net attn1@64x64", 1, 4096, 4096, 320, 8),
    ("stage 3 reference-net attn1@32x32", 1, 1024, 1024, 640, 8),
]
# K1 with its gradient at D=160, the third level (image/32) of the SD1.5
# UNet: at 512x512 that level has 16x16 = 256 tokens, below flash's Lk >= 512,
# but at 1024x1024 (128x128 latent; the CLIs' --image_width/--image_height,
# configs/stage_*.yaml's train_width/train_height) it has 32x32 = 1024 and K1
# runs there forward and backward. Stage 2 at 20 frames and stage 3 at 8, as
# above; not run end to end, their launches are reckoned
# (`reckoned_bwd_launches` at HIRES_LATENT)
HIRES_LATENT = 128
HIRES_K1_SHAPES = [
    ("1024² attn1@32x32", TRAIN_FRAMES, 1024, 1024, 1280, 8),
    ("1024² attn1_5@32x32 grouped", 1, TRAIN_FRAMES * 1024, 1024, 1280, 8),
    ("1024² stage 3 attn1@32x32", STAGE3_FRAMES, 1024, 1024, 1280, 8),
    ("1024² stage 3 attn1_5@32x32 grouped", 1, STAGE3_FRAMES * 1024, 1024, 1280, 8),
    ("1024² stage 3 reference-net attn1@32x32", 1, 1024, 1024, 1280, 8),
]
HIRES_STAGE3 = HIRES_K1_SHAPES[2:]
# off the training path: fp32 at the train_parity phase's head dim, and D=160
# at 512x512's batch 2 (the row the D=160 backward's earlier times were read at)
TRAIN_K1_EXTRA = [
    ("fp32 D=40", 4, 1024, 1024, 80, 2, "float32"),
    ("bf16 D=160", 2, 1024, 1024, 1280, 8, "bfloat16"),
]
# K1 with its gradient in fp32 (the training CLI's --dtype fp32, or a config
# without mixed precision) at stage 2's four shapes at 512x512 and its D=160
# pair at 1024x1024; not run end to end at full width, their launches a step
# are stage 2's, reckoned
TRAIN_K1_FP32 = [("fp32 " + n, b, lq, lk, i, h, "float32")
                 for n, b, lq, lk, i, h in TRAIN_K1_SHAPES + HIRES_K1_SHAPES[:2]]


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(torch, fn, min_total_ms: float = 200.0, max_iters: int = 50) -> float:
    """Mean time of fn() on the card: two warm-up calls, then CUDA events
    around enough calls to fill ~min_total_ms."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    first = max(start.elapsed_time(end), 1e-3)
    iters = int(max(3, min(max_iters, min_total_ms / first)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(torch, fn, calls: int = 20) -> float:
    """Mean device time of fn() when `calls` of them replay from one CUDA
    graph: the same launches with no host work between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_time_ms(torch, graph.replay) / calls


def host_time_ms(torch, fn, calls: int = 50) -> float:
    """Mean host time to issue fn() (the wrapper's Python and C++ work and
    the launch), the card idle at the start."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / calls


def small_shape_times(torch, fn) -> dict:
    """At the reference net's B=1 shapes, where a call's device time is near
    its host time: fn() replayed from a CUDA graph, and the host's time to
    issue it."""
    return dict(graph_ms=graph_time_ms(torch, fn), host_ms=host_time_ms(torch, fn))


def sm_clock_mhz() -> float:
    """The SM clock now (nvidia-smi), read right after a timed window."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.split()[0])


def exp_floor_ms(exps: float, clock_mhz: float) -> float:
    """The least time of `exps` exps on the SFUs: N_SMS x EX2_PER_CLK a clock."""
    return 1e3 * exps / (N_SMS * EX2_PER_CLK * clock_mhz * 1e6)


# WARPGROUP.DEPBAR lines in the SASS of each bf16 wgmma kernel, forward and
# backward: its fixed `wgmma_wait`s as ptxas lays them out on every path (5,
# against 14-36 HGMMA; read on the H100). One more is a wgmma it serialised.
# T1's and T2's kernels run the forward's code (one block walks its pairs in
# a loop that is not unrolled), so theirs are the forward's 5 too.
WGMMA_WAITS = 5
# kernels of each wgmma family in the library (a part of their mangled
# names): K1 and K2 at 3 head dims in bf16 and in fp32 (flash_fwd_tf32, every
# HGMMA on TF32), T1's 9 and T2's 3 tilings, the backward pair at D=40, 80
# and 160 in bf16 and in fp32 (flash_bwd_*_tf32, every HGMMA on TF32); each
# with at most WGMMA_WAITS fixed waits
SASS_FAMILIES = {"flash_fwd_wgmma": 6, "flash_fwd_tf32": 6, "flash_fwd_variant_wgmma": 9,
                 "splash_fwd_wgmma": 3, "flash_bwd_dkv_wgmma": 3, "flash_bwd_dq_wgmma": 3,
                 "flash_bwd_dkv_tf32": 3, "flash_bwd_dq_tf32": 3}
TF32_FAMILIES = ("flash_fwd_tf32", "flash_bwd_dkv_tf32", "flash_bwd_dq_tf32")
# the fp32 backward's kernels spill nothing: no local-memory store or load
NO_SPILL_FAMILIES = ("flash_bwd_dkv_tf32", "flash_bwd_dq_tf32")
SASS_OPS = ("HGMMA", "F32.TF32", "UTMALDG", "MUFU.EX2", "HMMA", "WARPGROUP.DEPBAR", "STL", "LDL")


def sass_phase() -> dict:
    """The built library's wgmma kernels (K1's and K2's forward in bf16,
    flash_fwd_wgmma, and in fp32, flash_fwd_tf32; T1's,
    flash_fwd_variant_wgmma; T2's, splash_fwd_wgmma; and the backward pair,
    flash_bwd_dkv_wgmma and flash_bwd_dq_wgmma, and in fp32
    flash_bwd_dkv_tf32 and flash_bwd_dq_tf32) hold HGMMA and UTMALDG in
    their SASS (the fp32 kernels' every HGMMA on TF32), their exps are on
    MUFU.EX2, and each holds no more WARPGROUP.DEPBAR than the fixed waits
    its code issues (ptxas adds one after every wgmma it serialises); the
    fp32 backward's kernels spill nothing (no STL or LDL)."""
    from vexpress_torch.ops import flash
    from vexpress_torch.tools.ptxas_report import sass_ops

    lib = flash.build()
    found = {part: sass_ops(lib, part, SASS_OPS) for part in SASS_FAMILIES}
    ok = all(len(found[p]) == n and all({"HGMMA", "UTMALDG", "MUFU.EX2"} <= set(o)
                                        and o["WARPGROUP.DEPBAR"] <= WGMMA_WAITS
                                        and (o["F32.TF32"] == o["HGMMA"]) == (p in TF32_FAMILIES)
                                        and not (p in NO_SPILL_FAMILIES and (o["STL"] or o["LDL"]))
                                        for o in found[p].values())
             for p, n in SASS_FAMILIES.items())
    for part, ops in found.items():
        log(f"[sass] {len(ops)} kernels {part}, HGMMA (TF32: {part in TF32_FAMILIES}), UTMALDG "
            f"and MUFU.EX2 in each and at most {WGMMA_WAITS} WARPGROUP.DEPBAR: {ok}; "
            + "; ".join(f"{n}: {dict(sorted(o.items()))}" for n, o in sorted(ops.items())))
    if not ok:
        raise PhaseError(f"a wgmma kernel lacks wgmma (on TF32 in fp32), TMA or ex2 in its SASS, "
                         f"holds more than {WGMMA_WAITS} wgmma waits, or spills: {found}")
    return dict(kernels={n: dict(o) for ops in found.values() for n, o in ops.items()})


def bound_ms(ops: float, nbytes: float, peak: float):
    """The card's least time for `ops` operations at `peak` and `nbytes` at the
    HBM rate: (ms, what bounds it)."""
    t_ops, t_bytes = ops / peak, nbytes / HBM_BPS
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def k1_bound_ms(b, lq, lk, inner, heads, itemsize, peak):
    d = inner // heads
    return bound_ms(4.0 * b * heads * lq * lk * d,
                    float(itemsize) * (2 * b * lq * inner + 2 * b * lk * inner), peak)


def k1_grad_bounds(b, lq, lk, inner, heads, itemsize, peak) -> dict:
    """Bounds of K1 under a gradient, each input read once and each output
    written once: the forward with its fp32 log-sum-exp (4 n operations), the
    dk/dv kernel (S, dP, dv, dk: 8 n), the dq kernel (S, dP, dq: 6 n) and the
    backward pair done at once (10 n), n = B*H*Lq*Lk*D."""
    n = float(b * heads * lq * lk * (inner // heads))
    q_bytes, k_bytes = float(itemsize) * b * lq * inner, float(itemsize) * b * lk * inner
    row_stats = 4.0 * b * heads * lq  # one fp32 per query row (lse or di)
    return dict(
        fwd=bound_ms(4 * n, 2 * q_bytes + 2 * k_bytes + row_stats, peak),
        dkv=bound_ms(8 * n, 2 * q_bytes + 4 * k_bytes + 2 * row_stats, peak),
        dq=bound_ms(6 * n, 3 * q_bytes + 2 * k_bytes + 2 * row_stats, peak),
        pair=bound_ms(10 * n, 3 * q_bytes + 4 * k_bytes + 2 * row_stats, peak))


def within_k1_bar(bf16: bool, max_err: float, mean_err: float, ref_std: float):
    """K1 against its fp32 plain version. The fixed bars allow for bf16 output
    rounding and another summation order; the bars on the reference's own
    scale are the tighter ones at long Lk, where outputs shrink as sqrt(e/Lk)
    (a correct kernel reads max ~0.04 std(ref), mean ~0.002 std(ref) in bf16)."""
    if bf16:
        max_bar, mean_bar = min(2e-2, 0.1 * ref_std), min(2e-3, 0.01 * ref_std)
    else:
        max_bar, mean_bar = min(1e-4, 1e-3 * ref_std), 1e-5 * ref_std
    return (max_err <= max_bar and mean_err <= mean_bar,
            f"max<={max_bar:.2e}, mean<={mean_bar:.2e} vs fp32 plain (std(ref) {ref_std:.3e})")


def within_k1_grad_bar(bf16: bool, max_err: float, mean_err: float, ref_std: float,
                       ref_max: float):
    """K1's bar for its gradients (and its forward under a gradient) against
    the fp32 plain version. A gradient's tails reach 20-40 std(ref), where
    the bf16 result's own rounding exceeds 0.1 std(ref) (rounding the fp32
    reference to bf16 alone uses up to 70% of that bar at the training
    shapes, and PyTorch's SDPA backward lands at the kernel's max errors), so
    the max bar also admits one bf16 ulp at max|ref|; the mean bar is K1's.
    In fp32 the bars are 1e-4 and 3e-6 of std(ref): K1's 1e-3 and 1e-5,
    tightened where the scalar kernels measured 6.6e-7 and 3.2e-8 at
    std(ref) 0.052."""
    if bf16:
        ulp = 2.0 ** (math.floor(math.log2(max(ref_max, 1e-30))) - 7)
        max_bar, mean_bar = min(2e-2, max(0.1 * ref_std, ulp)), min(2e-3, 0.01 * ref_std)
    else:
        max_bar, mean_bar = 1e-4 * ref_std, 3e-6 * ref_std
    return (max_err <= max_bar and mean_err <= mean_bar,
            f"max<={max_bar:.2e}, mean<={mean_bar:.2e} vs fp32 plain (std(ref) {ref_std:.3e}, "
            f"max|ref| {ref_max:.3e})")


LSE_BAR = 2e-5  # fp32 log-sum-exp against the plain version (the bf16 kernel reads
# 1.2e-5 at the D=40 training shapes, 1.4e-6 at D=80; the fp32 kernel 2.4e-6, scalar or
# 3xTF32)


def within_variant_bar(max_err: float, mean_err: float, ref_std: float, ref_max: float):
    """T1 or T2 in bf16 against its own plain version, which does the same
    arithmetic (T1 rounds p to bf16 for P V, T2 keeps p in fp32), so only the
    final rounding to bf16 may differ: within K1's bf16 bar and, tighter, max
    |d| <= 1 bf16 ulp of max|ref| and mean <= 1e-4 std(ref). The kernels read
    1 ulp and 0.8-1.0e-5 std(ref) at the bench's shape; one kernel's
    arithmetic against the other's plain version reads ~1.2e-3 std(ref) (the
    attn_variants phase's controls), so the bar tells p rounded to bf16 from p
    kept in fp32."""
    k1_ok, _ = within_k1_bar(True, max_err, mean_err, ref_std)
    ulp = 2.0 ** (math.floor(math.log2(max(ref_max, 1e-30))) - 7)
    max_bar, mean_bar = ulp, 1e-4 * ref_std
    return (k1_ok and max_err <= max_bar and mean_err <= mean_bar,
            f"max<={max_bar:.2e}, mean<={mean_bar:.2e} vs plain (std(ref) {ref_std:.3e}, "
            f"max|ref| {ref_max:.3e})")


def kernel_phase(torch) -> dict:
    """K1 against flash_sdpa_reference, and K2 (`k2_row`) on the same
    inputs, at every main-path shape and the checks off it."""
    import torch.nn.functional as F
    from vexpress_torch.ops import flash, launches

    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 case compares fp32 results
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, lite_rows = [], []
    cases = ([(n, b, lq, lk, i, h, "bfloat16")
              for n, b, lq, lk, i, h in K1_SHAPES + K1_G2_SHAPES] + K1_EXTRA)
    for name, b, lq, lk, inner, heads, dtype_name in cases:
        dtype = getattr(torch, dtype_name)
        d = inner // heads
        q = torch.randn(b, lq, inner, generator=gen, device=dev).to(dtype)
        k = torch.randn(b, lk, inner, generator=gen, device=dev).to(dtype)
        v = torch.randn(b, lk, inner, generator=gen, device=dev).to(dtype)
        launches.reset()
        out = flash.flash_sdpa(q, k, v, heads)
        torch.cuda.synchronize()
        if launches.counts["flash_fwd"] != 1 or launches.counts["flash_sdpa_reference"]:
            raise PhaseError(f"{name}: flash_sdpa did not launch the kernel: {dict(launches.counts)}")
        exact = flash.flash_sdpa_reference(q.float(), k.float(), v.float(), heads)
        err = (out.float() - exact).abs()
        max_err, mean_err = float(err.max()), float(err.mean())
        ref_std = float(exact.std())
        finite = bool(torch.isfinite(out).all())
        del err
        ok, tol = within_k1_bar(dtype == torch.bfloat16, max_err, mean_err, ref_std)
        ms = cuda_time_ms(torch, lambda: flash.flash_sdpa(q, k, v, heads))
        clock = sm_clock_mhz()  # beside the kernel's window
        plain_ms = cuda_time_ms(torch, lambda: flash.flash_sdpa_reference(q, k, v, heads),
                                max_iters=5)
        qh, kh, vh = (t.reshape(t.shape[0], t.shape[1], heads, d).transpose(1, 2).contiguous()
                      for t in (q, k, v))
        library_ms = cuda_time_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh))
        extra, note = {}, ""
        if name.startswith("reference-net"):
            extra.update(small_shape_times(torch, lambda: flash.flash_sdpa(q, k, v, heads)))
            lib_small = small_shape_times(
                torch, lambda: F.scaled_dot_product_attention(qh, kh, vh))
            extra.update(library_graph_ms=lib_small["graph_ms"],
                         library_host_ms=lib_small["host_ms"])
            note += (f", in a CUDA graph {extra['graph_ms']:.4f} ms (sdpa "
                     f"{extra['library_graph_ms']:.4f}), host issue {extra['host_ms']:.4f} ms a "
                     f"call (sdpa {extra['library_host_ms']:.4f})")
        del qh, kh, vh, out
        if dtype == torch.bfloat16:
            note += (f", exp floor {exp_floor_ms(b * heads * lq * lk, clock):.3f} ms at "
                     f"{clock:.0f} MHz")
        itemsize = q.element_size()
        if dtype == torch.bfloat16:
            bound_ms, bound_by = k1_bound_ms(b, lq, lk, inner, heads, itemsize, PEAK_BF16)
        else:  # 3xTF32; the fp32 FMA units' time beside it
            bound_ms, bound_by = k1_bound_ms(b, lq, lk, inner, heads, itemsize, PEAK_3XTF32)
            extra["fma_bound_ms"] = k1_bound_ms(b, lq, lk, inner, heads, itemsize, PEAK_FP32)[0]
            extra["split_ms"] = cuda_time_ms(torch, lambda: flash.launch_f32_split(q, k, v, heads))
            note += (f", at the fp32 FMA peak {extra['fma_bound_ms']:.3f} ms; its split pass "
                     f"{extra['split_ms']:.3f} ms")
        main_path = dtype == torch.bfloat16 and (name, b, lq, lk, inner, heads) in K1_SHAPES
        row = dict(shape=name, dtype=dtype_name, B=b, Lq=lq, Lk=lk, H=heads, D=d,
                   main_path=main_path, kernel_ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by, max_abs_err=max_err,
                   mean_abs_err=mean_err, tolerance=tol, **extra)
        rows.append(row)
        log(f"[kernel] {name} {dtype_name} B={b} Lq={lq} Lk={lk} D={d}: max|d|={max_err:.3e} "
            f"mean|d|={mean_err:.3e} kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"sdpa {library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}){note}")
        if not (ok and finite):
            raise PhaseError(f"K1 disagrees with its plain version at {name}: max {max_err:.3e}, "
                             f"mean {mean_err:.3e}, finite {finite} ({tol})")
        lite_rows.append(k2_row(torch, q, k, v, heads, exact, row))
        del q, k, v, exact
        torch.cuda.empty_cache()
    return dict(rows=rows, lite_rows=lite_rows, grad_rows=grad_kernel_rows(torch, gen))


K2_EXACT_BAR = 0.03  # tests/test_flash_lite.py:27-28, K2 against exact fp32 attention


def k2_row(torch, q, k, v, heads, exact, k1_row) -> dict:
    """K2 on K1's inputs: flash_sdpa with FLASH_LITE on launches it once; its
    output against flash_lite_reference under K1's bf16 bar and against the exact
    fp32 attention under K2_EXACT_BAR; K2, its plain version and K1 timed in
    turn. SDPA's time is the K1 row's, on the same inputs."""
    from vexpress_torch.ops import flash, launches

    b, lq, inner = q.shape
    lk, d = k.shape[1], inner // heads
    name = k1_row["shape"]
    flash.FLASH_LITE = True
    try:
        launches.reset()
        out = flash.flash_sdpa(q, k, v, heads)
        torch.cuda.synchronize()
        ran = {key: n for key, n in launches.counts.items() if n}
        if ran != {"flash_lite_fwd": 1}:
            raise PhaseError(f"{name}: flash_sdpa with K2 on launched {ran}")
        plain = flash.flash_lite_reference(q, k, v, heads).float()
        err = (out.float() - plain).abs()
        max_err, mean_err, plain_std = float(err.max()), float(err.mean()), float(plain.std())
        exact_err = float((out.float() - exact).abs().max())
        finite = bool(torch.isfinite(out).all())
        del out, plain, err
        # K1's bf16 bar in both types: the kernel's key tile is not the plain
        # version's, so bf16(s - m) rounds other numbers (fp32 inputs too)
        ok, tol = within_k1_bar(True, max_err, mean_err, plain_std)
        ms = cuda_time_ms(torch, lambda: flash.flash_sdpa(q, k, v, heads))
        clock = sm_clock_mhz()
        plain_ms = cuda_time_ms(torch, lambda: flash.flash_lite_reference(q, k, v, heads),
                                max_iters=5)
        small = (small_shape_times(torch, lambda: flash.flash_sdpa(q, k, v, heads))
                 if "graph_ms" in k1_row else {})
    finally:
        flash.FLASH_LITE = False
    k1_ms = cuda_time_ms(torch, lambda: flash.flash_sdpa(q, k, v, heads))
    exps = b * heads * lq * lk
    note = ""
    bound_ms, bound_by = k1_row["bound_ms"], k1_row["bound_by"]
    if k1_row["dtype"] == "float32":  # P V in two TF32 products, not three
        bound_ms, bound_by = k1_bound_ms(b, lq, lk, inner, heads, q.element_size(),
                                         PEAK_K2_TF32)
    if small:
        small["k1_graph_ms"] = graph_time_ms(torch, lambda: flash.flash_sdpa(q, k, v, heads))
        note = (f", in a CUDA graph {small['graph_ms']:.4f} ms (K1 {small['k1_graph_ms']:.4f}), "
                f"host issue {small['host_ms']:.4f} ms a call")
    row = dict(shape=name, dtype=k1_row["dtype"], B=b, Lq=lq, Lk=lk, H=heads, D=d,
               main_path=k1_row["main_path"], kernel_ms=ms, k1_ms=k1_ms, plain_ms=plain_ms,
               library_ms=k1_row["library_ms"], bound_ms=bound_ms, bound_by=bound_by,
               exps=exps, max_abs_err=max_err,
               mean_abs_err=mean_err, tolerance=tol, exact_max_abs_err=exact_err,
               exact_tolerance=f"max<{K2_EXACT_BAR} vs exact fp32", **small)
    log(f"[kernel] K2 {name} {row['dtype']} B={b} Lq={lq} Lk={lk} D={d}: max|d|={max_err:.3e} "
        f"mean|d|={mean_err:.3e} vs plain, max|d|={exact_err:.3e} vs exact; kernel {ms:.3f} ms, "
        f"K1 {k1_ms:.3f} ms, plain {plain_ms:.3f} ms, sdpa {row['library_ms']:.3f} ms, bound "
        f"{row['bound_ms']:.3f} ms ({row['bound_by']}), {exps:.3e} exps, exp floor "
        f"{exp_floor_ms(exps, clock):.3f} ms (packed pairs {exp_floor_ms(exps / 2, clock):.3f}) "
        f"at {clock:.0f} MHz{note}")
    if not (ok and finite and exact_err < K2_EXACT_BAR):
        raise PhaseError(f"K2 disagrees at {name}: vs plain max {max_err:.3e} mean {mean_err:.3e} "
                         f"({tol}), vs exact max {exact_err:.3e} (<{K2_EXACT_BAR}), finite {finite}")
    return row


def reckoned_bwd_launches(stage: int, latent: int) -> dict:
    """K1's backward launches of one train step of stage 2 (TRAIN_FRAMES
    frames) or stage 3 (STAGE3_FRAMES) at a square latent of `latent` (64 at
    512x512, HIRES_LATENT at 1024x1024) on the SD1.5 geometry, by (kernel,
    B, Lq, Lk, D), reckoned by `expected_bwd_launches` from the stage's
    trainability."""
    from vexpress_torch.models.unet_3d import UNetConfig
    from vexpress_torch.train import TrainConfig

    frames = TRAIN_FRAMES if stage == 2 else STAGE3_FRAMES
    return expected_bwd_launches(TrainConfig.stage(f"stage_{stage}", num_frames=frames),
                                 UNetConfig(), latent, latent, frames)


def bwd_kernel_times(torch, q, k, v, do, out, lse, heads) -> dict:
    """K1's backward at one shape of packed (B, L, H*D) inputs, each part
    timed alone: the dk/dv kernel, the dq kernel, the plain di reduction
    (`flash.bwd_di`) and, as a yardstick, SDPA's backward alone from one saved
    forward (its own di included). In fp32 the 3xTF32 kernels are timed on
    one split pass's parts, dk/dv on the dq kernel's log-sum-exp, and the
    split pass beside them (`split_ms`); another checkout's kernels without
    that split (bench_flash_bwd on a parent) are timed through `launch_bwd`.
    `out` and `lse` are K1's forward's."""
    import torch.nn.functional as F
    from vexpress_torch.ops import flash

    d = q.shape[-1] // heads
    scale = d**-0.5
    di = flash.bwd_di(do, out, heads)
    times = dict(di_ms=cuda_time_ms(torch, lambda: flash.bwd_di(do, out, heads)))
    if q.dtype == torch.float32 and hasattr(flash, "launch_f32_dq"):
        parts = flash.launch_f32_bwd_split(q, k, v, do, heads)
        lse_dkv = torch.empty_like(lse)
        times.update(
            split_ms=cuda_time_ms(torch, lambda: flash.launch_f32_bwd_split(q, k, v, do, heads)),
            dq_ms=cuda_time_ms(torch, lambda: flash.launch_f32_dq(parts, q, k, lse, di, heads,
                                                                  scale, lse_dkv)),
            dkv_ms=cuda_time_ms(torch, lambda: flash.launch_f32_dkv(parts, q, k, lse_dkv, di,
                                                                    heads, scale)))
        del parts
    else:
        times.update(
            dkv_ms=cuda_time_ms(torch, lambda: flash.launch_bwd(q, k, v, do, lse, di, heads,
                                                                scale, need_dq=False)),
            dq_ms=cuda_time_ms(torch, lambda: flash.launch_bwd(q, k, v, do, lse, di, heads,
                                                               scale, need_dkv=False)))
    qh, kh, vh, doh = (x.reshape(x.shape[0], x.shape[1], heads, d).transpose(1, 2).contiguous()
                       for x in (q, k, v, do))
    qh, kh, vh = (x.requires_grad_() for x in (qh, kh, vh))
    saved = F.scaled_dot_product_attention(qh, kh, vh)
    times["sdpa_bwd_ms"] = cuda_time_ms(
        torch, lambda: torch.autograd.grad(saved, (qh, kh, vh), doh, retain_graph=True))
    return times


def grad_kernel_rows(torch, gen) -> list:
    """K1 with its gradient at every training shape of stages 2 and 3, at
    512x512 and at 1024x1024's D=160 level, and in fp32 at stage 2's
    (TRAIN_K1_FP32): flash_sdpa on inputs that require a gradient
    (FlashAttention), .backward with a fixed do; the forward's output and
    log-sum-exp and dq, dk, dv against the fp32 plain versions; then each
    kernel timed alone, beside the di reduction, SDPA's backward alone and,
    in fp32, the backward's split pass."""
    import torch.nn.functional as F
    from vexpress_torch.ops import flash, flash_tma, launches

    dev = torch.device("cuda")
    rows = []
    hires_names = {n for n, *_ in HIRES_K1_SHAPES}
    reckoned_by = {key: reckoned_bwd_launches(*key)
                   for key in ((2, 64), (3, 64), (2, HIRES_LATENT), (3, HIRES_LATENT))}
    cases = ([(n, b, lq, lk, i, h, "bfloat16") for n, b, lq, lk, i, h in TRAIN_K1_SHAPES
              + STAGE3_K1_SHAPES + HIRES_K1_SHAPES] + TRAIN_K1_EXTRA + TRAIN_K1_FP32)
    for name, b, lq, lk, inner, heads, dtype_name in cases:
        dtype = getattr(torch, dtype_name)
        bf16 = dtype == torch.bfloat16
        d = inner // heads
        scale = d**-0.5
        q, k, v, do = (torch.randn(b, n, inner, generator=gen, device=dev).to(dtype)
                       for n in (lq, lk, lk, lq))
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        launches.reset()
        out = flash.flash_sdpa(*leaves, heads)
        out.backward(do)
        torch.cuda.synchronize()
        ran = {key: n for key, n in launches.counts.items() if n}
        parts = (flash_tma.dkv_splits(b, heads, lq, lk) if bf16
                 else flash_tma.f32_dkv_splits(b, heads, lq, lk, d))
        want = {"flash_fwd": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}
        if parts > 1:
            want["flash_bwd_dkv_sum"] = 1
        if out.grad_fn is None or ran != want:
            raise PhaseError(f"{name}: flash_sdpa under a gradient launched {ran}, not {want}")
        with torch.no_grad():
            no_grad_out = flash.flash_sdpa(q, k, v, heads)
        if not torch.equal(no_grad_out, out.detach()):
            raise PhaseError(f"{name}: the forward with and without the log-sum-exp disagree")
        out_k, lse = flash.flash_sdpa_fwd(q, k, v, heads, scale)
        qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
        ref_out, ref_lse = flash.flash_sdpa_reference(qf, kf, vf, heads, return_lse=True)
        refs = dict(zip(("dq", "dk", "dv"),
                        flash.flash_sdpa_bwd_reference(qf, kf, vf, ref_out, ref_lse, dof, heads)))
        qh, kh, vh, doh = (x.reshape(x.shape[0], x.shape[1], heads, d).transpose(1, 2)
                           .contiguous() for x in (q, k, v, do))
        qh, kh, vh = (x.requires_grad_() for x in (qh, kh, vh))
        sdpa_out = F.scaled_dot_product_attention(qh, kh, vh)
        sdpa = dict(zip(("dq", "dk", "dv"), torch.autograd.grad(sdpa_out, (qh, kh, vh), doh)))
        sdpa["out"] = sdpa_out.detach()
        errs, fails = {}, []
        for what, got, ref in (("out", out_k, ref_out), ("dq", leaves[0].grad, refs["dq"]),
                               ("dk", leaves[1].grad, refs["dk"]),
                               ("dv", leaves[2].grad, refs["dv"])):
            err = (got.float() - ref).abs()
            mx, mean, std = float(err.max()), float(err.mean()), float(ref.std())
            ref_max = float(ref.abs().max())
            lib = sdpa[what].transpose(1, 2).reshape(ref.shape).float() - ref
            ok, tol = within_k1_grad_bar(bf16, mx, mean, std, ref_max)
            errs[what] = dict(max_abs_err=mx, mean_abs_err=mean, ref_std=std, ref_max=ref_max,
                              sdpa_max_abs_err=float(lib.abs().max()),
                              sdpa_mean_abs_err=float(lib.abs().mean()), tolerance=tol)
            if not (ok and bool(torch.isfinite(got).all())):
                fails.append(f"{what} max {mx:.3e} mean {mean:.3e} ({tol})")
        lse_err = float((lse - ref_lse).abs().max())
        errs["lse"] = dict(max_abs_err=lse_err, tolerance=f"max<={LSE_BAR:.0e}")
        if lse_err > LSE_BAR:
            fails.append(f"lse max {lse_err:.3e}")
        del qf, kf, vf, dof, ref_out, ref_lse, refs, leaves, out, no_grad_out, sdpa, sdpa_out
        if fails:
            raise PhaseError(f"K1's gradient disagrees with its plain version at {name}: "
                             + "; ".join(fails))

        fwd_ms = cuda_time_ms(torch, lambda: flash.flash_sdpa_fwd(q, k, v, heads, scale))
        fwd_clock = sm_clock_mhz()
        bwd = bwd_kernel_times(torch, q, k, v, do, out_k, lse, heads)
        plain_fwd_ms = cuda_time_ms(
            torch, lambda: flash.flash_sdpa_reference(q, k, v, heads, return_lse=True),
            max_iters=3)
        plain_bwd_ms = cuda_time_ms(
            torch, lambda: flash.flash_sdpa_bwd_reference(q, k, v, out_k, lse, do, heads, scale),
            max_iters=3)
        with torch.no_grad():
            sdpa_fwd_ms = cuda_time_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh))

        def sdpa_fwd_bwd():
            torch.autograd.grad(F.scaled_dot_product_attention(qh, kh, vh), (qh, kh, vh), doh)

        sdpa_fwd_bwd_ms = cuda_time_ms(torch, sdpa_fwd_bwd)
        del qh, kh, vh, doh
        bounds = k1_grad_bounds(b, lq, lk, inner, heads, q.element_size(),
                                PEAK_BF16 if bf16 else PEAK_3XTF32)
        fma = ({} if bf16 else dict(fma_bounds_ms={
            k_: ms for k_, (ms, _) in k1_grad_bounds(b, lq, lk, inner, heads, q.element_size(),
                                                     PEAK_FP32).items()}))
        del q, k, v, do, out_k, lse
        key = (b, lq, lk, d)
        case = (name, b, lq, lk, inner, heads)
        latent = HIRES_LATENT if case in HIRES_K1_SHAPES or name[5:] in hires_names else 64
        row = dict(shape=name, dtype=dtype_name, B=b, Lq=lq, Lk=lk, H=heads, D=d,
                   main_path=bf16 and case in TRAIN_K1_SHAPES,
                   stage=3 if case in STAGE3_K1_SHAPES + HIRES_STAGE3 else 2, latent=latent,
                   dkv_parts=parts, fwd_ms=fwd_ms, **bwd,
                   plain_fwd_ms=plain_fwd_ms, plain_bwd_ms=plain_bwd_ms,
                   sdpa_fwd_ms=sdpa_fwd_ms, sdpa_fwd_bwd_ms=sdpa_fwd_bwd_ms,
                   bounds={k_: dict(ms=ms, by=by) for k_, (ms, by) in bounds.items()},
                   errors=errs, **fma)
        rows.append(row)
        # stage 3's, 1024x1024's and fp32's launches are reckoned, not run:
        # the log line has them and the row (which the kernels line prints)
        # has not
        reckoned_here = (row["stage"] == 3 or latent == HIRES_LATENT
                         or (name, b, lq, lk, inner, heads, dtype_name) in TRAIN_K1_FP32)
        reckoning = reckoned_by.get((row["stage"], latent)) if reckoned_here else None
        reckoned = {kernel: reckoning.get((kernel,) + key, 0)
                    for kernel in ("flash_bwd_dkv", "flash_bwd_dq")} if reckoning else None
        log(f"[kernel] {name} {dtype_name} B={b} Lq={lq} Lk={lk} D={d} with gradient: "
            f"fwd+lse {fwd_ms:.3f} ms (bound {bounds['fwd'][0]:.3f}, exp floor "
            f"{exp_floor_ms(b * heads * lq * lk, fwd_clock):.3f} at {fwd_clock:.0f} MHz), "
            f"dk/dv {bwd['dkv_ms']:.3f} ms in {parts} part(s) (bound {bounds['dkv'][0]:.3f}), "
            f"dq {bwd['dq_ms']:.3f} ms (bound {bounds['dq'][0]:.3f}), di {bwd['di_ms']:.3f} ms, "
            f"pair bound {bounds['pair'][0]:.3f} ms"
            + (f" (at the fp32 FMA peak: fwd {fma['fma_bounds_ms']['fwd']:.3f}, dk/dv "
               f"{fma['fma_bounds_ms']['dkv']:.3f}, dq {fma['fma_bounds_ms']['dq']:.3f}); "
               f"backward split pass {bwd['split_ms']:.3f} ms" if fma else "")
            + f"; sdpa bwd alone {bwd['sdpa_bwd_ms']:.3f} ms; "
            f"plain fwd {plain_fwd_ms:.3f} ms, plain bwd "
            f"{plain_bwd_ms:.3f} ms, sdpa fwd {sdpa_fwd_ms:.3f} ms, fwd+bwd "
            f"{sdpa_fwd_bwd_ms:.3f} ms"
            + (f"; stage-{row['stage']} launches a step at latent {latent}² (reckoned) "
               f"{reckoned}" if reckoned else "")
            + "; max|d| "
            + ", ".join(f"{w_} {e['max_abs_err']:.2e}" for w_, e in errs.items())
            + "; mean|d| " + ", ".join(f"{w_} {e['mean_abs_err']:.2e}" for w_, e in errs.items()
                                       if "mean_abs_err" in e)
            + "; sdpa's max|d| " + ", ".join(f"{w_} {e['sdpa_max_abs_err']:.2e}"
                                             for w_, e in errs.items() if "sdpa_max_abs_err" in e))
        torch.cuda.empty_cache()
    return rows


VARIANT_KERNELS = {"t1": "flash_fwd_variant", "t2": "splash_fwd"}
VARIANT_PLAIN = ("flash_fwd_variant_reference", "splash_mha_reference", "flash_sdpa_reference")


def attn_variants_phase(torch) -> dict:
    """T1 and T2 at the attention-variant bench's shape, on the bench's own
    rows (`bench_attn_variants.variant_rows`): each row launches its kernel
    once and is held against its plain version at the kernel's key tile (T1:
    flash_fwd_variant_reference, T2: splash_mha_reference on the same
    pre-scaled q) under `within_variant_bar`; its error against exact fp32
    attention of the unscaled q is printed beside K1's on the same inputs; the
    row, its plain version, K1 and SDPA are timed and the bound reckoned.
    Controls: each kernel against the other's plain version on the same
    pre-scaled q must fail that bar. Then the bench's main() runs once on the
    card with the counts reset: those launches are T1's and T2's on this
    slice's path."""
    import torch.nn.functional as F
    from vexpress_torch.ops import flash, launches
    from vexpress_torch.ops.flash_variants import flash_fwd_variant, flash_fwd_variant_reference
    from vexpress_torch.ops.splash import splash_mha_fwd, splash_mha_reference
    from vexpress_torch.tools import bench_attn_variants as bench

    dev = torch.device("cuda")
    b, h, l, d = bench.parse_args([]).shape  # (48, 8, 4096, 40), bf16
    scale = d**-0.5
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(b, h, l, d, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    qs = bench.prescale(q, scale)
    packed = [t.transpose(1, 2).reshape(b, l, h * d) for t in (q, k, v)]
    exact = (flash.flash_sdpa_reference(*(t.float() for t in packed), h)
             .reshape(b, l, h, d).transpose(1, 2))
    k1_out = flash.flash_sdpa(*packed, h).reshape(b, l, h, d).transpose(1, 2)
    k1_exact_err = float((k1_out.float() - exact).abs().max())
    del k1_out
    k1_ms = cuda_time_ms(torch, lambda: flash.flash_sdpa(*packed, h))
    sdpa_ms = cuda_time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v))
    bound, bound_by = k1_bound_ms(b, l, l, h * d, h, 2, PEAK_BF16)
    log(f"[attn_variants] (B, H, L, D) = {(b, h, l, d)} bf16: K1 {k1_ms:.3f} ms, max|d| "
        f"{k1_exact_err:.3e} vs exact fp32; sdpa {sdpa_ms:.3f} ms; bound {bound:.3f} ms "
        f"({bound_by})")
    rows = []
    for name, fn in bench.variant_rows(q, k, v, scale):
        kernel = VARIANT_KERNELS.get(name[:2])
        if kernel is None:  # sdpa_dispatch is K1, checked by the kernel phase
            continue
        launches.reset()
        out = fn()
        torch.cuda.synchronize()
        ran = {key: n for key, n in launches.counts.items() if n}
        if ran != {kernel: 1}:
            raise PhaseError(f"{name}: launched {ran}, expected {kernel} once")
        (tiling,) = [key[6:] for key in launches.shapes]
        if kernel == "splash_fwd":
            def plain_fn():
                return splash_mha_reference(qs, k, v, block_kv=tiling[1])
        else:
            def plain_fn():
                return flash_fwd_variant_reference(q, k, v, scale, block_k=tiling[1])
        plain = plain_fn().float()
        err = (out.float() - plain).abs()
        max_err, mean_err, plain_std = float(err.max()), float(err.mean()), float(plain.std())
        plain_max = float(plain.abs().max())
        exact_err = float((out.float() - exact).abs().max())
        finite = bool(torch.isfinite(out).all())
        del out, plain, err
        ok, tol = within_variant_bar(max_err, mean_err, plain_std, plain_max)
        ms = cuda_time_ms(torch, fn)
        plain_ms = cuda_time_ms(torch, plain_fn, max_iters=3)
        row = dict(name=name, kernel=kernel, tiling=list(tiling), B=b, H=h, L=l, D=d, ms=ms,
                   k1_ms=k1_ms, plain_ms=plain_ms, library_ms=sdpa_ms, bound_ms=bound,
                   bound_by=bound_by, max_abs_err=max_err, mean_abs_err=mean_err,
                   mean_over_std=mean_err / plain_std, tolerance=tol,
                   exact_max_abs_err=exact_err, k1_exact_max_abs_err=k1_exact_err)
        rows.append(row)
        log(f"[attn_variants] {name} ({kernel}, tiling {tiling}): max|d|={max_err:.3e} "
            f"mean|d|={mean_err:.3e} ({mean_err / plain_std:.2e} std) vs plain ({tol}); "
            f"max|d|={exact_err:.3e} vs exact (K1 "
            f"{k1_exact_err:.3e}); kernel {ms:.3f} ms, K1 {k1_ms:.3f} ms, plain {plain_ms:.3f} "
            f"ms, sdpa {sdpa_ms:.3f} ms, bound {bound:.3f} ms ({bound_by})")
        if not (ok and finite):
            raise PhaseError(f"{name} disagrees with its plain version: max {max_err:.3e}, "
                             f"mean {mean_err:.3e}, finite {finite} ({tol})")
        torch.cuda.empty_cache()

    controls = {}
    for name, out_fn, plain_fn in (
            ("t1_kernel_vs_t2_plain", lambda: flash_fwd_variant(qs, k, v, 1.0),
             lambda: splash_mha_reference(qs, k, v)),
            ("t2_kernel_vs_t1_plain", lambda: splash_mha_fwd(qs, k, v),
             lambda: flash_fwd_variant_reference(qs, k, v, 1.0))):
        out, plain = out_fn().float(), plain_fn().float()
        err = (out - plain).abs()
        max_err, mean_err, plain_std = float(err.max()), float(err.mean()), float(plain.std())
        fails, tol = within_variant_bar(max_err, mean_err, plain_std, float(plain.abs().max()))
        del out, plain, err
        controls[name] = dict(max_abs_err=max_err, mean_abs_err=mean_err,
                              mean_over_std=mean_err / plain_std, passes_bar=fails, tolerance=tol)
        log(f"[attn_variants] control {name} on the pre-scaled q: max|d|={max_err:.3e} "
            f"mean|d|={mean_err:.3e} ({mean_err / plain_std:.2e} std), must fail ({tol})")
        if fails:
            raise PhaseError(f"control {name} passes the variants' bar: it cannot tell p rounded "
                             f"to bf16 from p kept in fp32")
        torch.cuda.empty_cache()
    del q, k, v, qs, packed, exact

    launches.reset()
    t0 = time.perf_counter()
    bench_rows = bench.main([])
    bench_s = time.perf_counter() - t0
    counts = {key: n for key, n in launches.counts.items() if n}
    by_tiling = {(key[0],) + key[6:]: n for key, n in launches.shapes.items()
                 if key[0] in VARIANT_KERNELS.values()}
    log(f"[attn_variants] bench_attn_variants.main() on the card: {bench_s:.1f} s, launches "
        f"{counts}, by tiling {by_tiling}")
    missing = sorted({(r["kernel"],) + tuple(r["tiling"]) for r in rows} - set(by_tiling))
    if missing or any(counts.get(p) for p in VARIANT_PLAIN) or not counts.get("flash_fwd"):
        raise PhaseError(f"the bench did not launch every row's kernel ({missing} missing) or "
                         f"ran a plain version: {counts}")
    return dict(rows=rows, controls=controls, k1_ms=k1_ms, sdpa_ms=sdpa_ms, bound_ms=bound,
                k1_exact_max_abs_err=k1_exact_err, bench_rows=bench_rows, bench_s=bench_s,
                bench_launches=counts,
                bench_launches_by_tiling=[[*key, n] for key, n in sorted(by_tiling.items())])


def _flash_eligible(lq: int, lk: int) -> bool:
    return lq % 128 == 0 and lk % 128 == 0 and lk >= 512


def expected_flash_launches(cfg, h: int, w: int, frames: int, unet_calls: int) -> int:
    """K1 launches of one pipeline call at latent (h, w): per denoising-UNet
    call, attn1 (self) and attn1_5 (frames*h*w queries grouped against the
    h*w bank) of each transformer block whose level has an eligible token
    count; once, attn1 of the same blocks of the reference net."""
    attn1 = attn1_5 = 0
    for i in range(3):  # levels with attention; the mid block sits at /8
        hw = (h >> i) * (w >> i)
        n = 2 * cfg.layers_per_block + 1  # down-block layers + up-block layers
        attn1 += n if _flash_eligible(hw, hw) else 0
        attn1_5 += n if _flash_eligible(frames * hw, hw) else 0
    return unet_calls * (attn1 + attn1_5) + attn1


def synthetic_inputs(h: int, w: int, frames: int, seed: int, fps: float = 30.0):
    """Seeded reference image, 16 kHz speech-like waveform and uint8 keypoint
    frames (three dots moving on black, as rendered kps images look)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ref = rng.uniform(size=(h, w, 3)).astype(np.float32)
    n = int(frames / fps * 16000) + 400
    tt = np.arange(n) / 16000.0
    wave = (0.3 * np.sin(2 * np.pi * 180 * tt) * (1 + np.sin(2 * np.pi * 3 * tt))
            + 0.05 * rng.standard_normal(n)).astype(np.float32)
    kps = np.zeros((frames, h, w, 3), np.uint8)
    base = rng.uniform(0.3, 0.7, size=(3, 2))
    for f in range(frames):
        for j, (cy, cx) in enumerate(base):
            y = int((cy + 0.03 * np.sin(f / 4 + j)) * h)
            x = int((cx + 0.03 * np.cos(f / 5 + j)) * w)
            kps[f, max(y - 3, 0): y + 3, max(x - 3, 0): x + 3, j] = 255
    return ref, kps, wave


def reduced_models(torch):
    """The reduced-depth fp32 configuration of the parity phases: level 0 has
    80 channels / 2 heads = D 40, so a 32x32 latent (1024 tokens) takes K1."""
    from vexpress_torch.models import UNetConfig, VAEConfig, Wav2Vec2Config
    from vexpress_torch.pipelines import PipelineModels

    return PipelineModels(
        unet_config=UNetConfig(block_out_channels=(80, 160, 160, 160), layers_per_block=1,
                               attention_head_dim=2, cross_attention_dim=16, norm_num_groups=16,
                               motion_num_attention_heads=2, motion_max_len=8),
        vae_config=VAEConfig(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
                             norm_num_groups=4),
        wav2vec2_config=Wav2Vec2Config(hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                                       intermediate_size=32, conv_dim=(8, 8),
                                       conv_kernel=(10, 3), conv_stride=(5, 2),
                                       num_conv_pos_embeddings=16,
                                       num_conv_pos_embedding_groups=4),
        audio_projection_kwargs=dict(dim=16, depth=1, dim_head=4, heads=2, num_queries=5,
                                     embedding_dim=16, output_dim=16, max_seq_len=10),
        guider_kwargs=dict(conditioning_embedding_channels=80, block_out_channels=(4, 4, 8, 8)),
        dtype=torch.float32)


def card_and_cpu_pipelines(torch, seed: int):
    """The reduced models with the same seeded weights on the card and on the
    CPU; TF32 off, so the card computes in fp32 too."""
    from vexpress_torch.io import init_pipeline_random_
    from vexpress_torch.pipelines import VExpressPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    models = reduced_models(torch)
    cpu = init_pipeline_random_(VExpressPipeline(models, device="cpu"), seed=seed)
    card = VExpressPipeline(models, device="cuda")
    for name, mod in card.components().items():
        mod.load_state_dict(cpu.components()[name].state_dict())
    return card, cpu


def parity_setup(torch):
    """The reduced models on the card and on the CPU with the same seeded
    weights, and the keyword arguments of one call on both: fp32 256x256, 12
    frames in 8-frame windows, CFG 2.0, 2 steps, the same inputs and noise."""
    card, cpu = card_and_cpu_pipelines(torch, seed=11)
    return card, cpu, parity_call_kwargs()


def parity_call_kwargs() -> dict:
    """parity_setup's keyword arguments of one call."""
    import numpy as np

    H = W = 256
    L, ctx, ovl, steps = 12, 8, 4, 2
    ref, kps, wave = synthetic_inputs(H, W, L, seed=5)
    noise = np.random.default_rng(6).standard_normal((L, H // 8, W // 8, 4)).astype(np.float32)
    return dict(reference_image=ref, kps_images=kps, audio_waveform=wave, width=W, height=H,
                video_length=L, num_inference_steps=steps, guidance_scale=2.0,
                context_frames=ctx, context_overlap=ovl, latents=noise)


def parity_phase(torch) -> dict:
    """A reduced-depth fp32 pipeline on the card against the same run on the
    CPU: same seeded weights, inputs and initial noise."""
    import numpy as np
    from vexpress_torch.ops import launches

    card, cpu, kw = parity_setup(torch)
    launches.reset()
    t0 = time.perf_counter()
    on_card = card(**kw)
    card_s = time.perf_counter() - t0
    card_launches = dict(launches.counts)
    t0 = time.perf_counter()
    on_cpu = cpu(**kw)
    cpu_s = time.perf_counter() - t0
    psnr = _psnr(on_card, on_cpu)
    max_err = float(np.abs(on_card - on_cpu).max())
    log(f"[parity] fp32 256x256, 12 frames, CFG 2.0, 2 steps: PSNR {psnr:.2f} dB, "
        f"max|d| {max_err:.3e}, card {card_s:.1f} s, cpu {cpu_s:.1f} s, launches {card_launches}")
    if card_launches.get("flash_fwd", 0) <= 0 or card_launches.get("flash_sdpa_reference", 0):
        raise PhaseError(f"parity run on the card did not go through K1: {card_launches}")
    if not (psnr > 45.0 and np.isfinite(on_card).all()):
        raise PhaseError(f"card and CPU disagree: PSNR {psnr:.2f} dB (needs > 45)")
    return dict(psnr_db=psnr, max_abs_err=max_err, card_s=card_s, cpu_s=cpu_s,
                launches=card_launches, cli=cli_parity_run(torch, card, cpu, kw))


def _psnr(a, b) -> float:
    import numpy as np

    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 10.0 * math.log10(1.0 / max(mse, 1e-20))


def cli_parity_run(torch, card, cpu, kw) -> dict:
    """The CLI's configuration on the parity phase's models and inputs, card
    against CPU: DPM-Solver++ (2M) at 2 steps, save_memory, K2 on (its fp32
    3xTF32 kernel on the card, its plain version on the CPU); the decoded
    video (PSNR > 45 dB) and its median-filtered YUV420 planes (within 1)."""
    import numpy as np
    from vexpress_torch.ops import flash, launches

    kw = dict(kw, sampler="dpmpp_2m", save_memory=True, return_latents=True)
    out, card_launches, released = {}, {}, 0.0
    flash.FLASH_LITE = True
    try:
        for name, pipe in (("card", card), ("cpu", cpu)):
            launches.reset()
            latents = torch.from_numpy(pipe(**kw))
            if name == "card":
                released = pipe.last_released_cond_mib
            video = pipe.decode_latents(latents)
            planes = pipe.decode_latents(latents, median_filter=True, as_yuv420=True)
            if name == "card":
                torch.cuda.synchronize()
                card_launches = {k: n for k, n in launches.counts.items() if n}
            out[name] = (video, planes)
    finally:
        flash.FLASH_LITE = False
    psnr = _psnr(out["card"][0], out["cpu"][0])
    yuv_diff = max(int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
                   for a, b in zip(out["card"][1], out["cpu"][1]))
    log(f"[parity] CLI configuration (DPM-Solver++ 2 steps, save_memory, K2): PSNR {psnr:.2f} "
        f"dB, YUV420 planes max|d| {yuv_diff}, released {released:.1f} MiB on the card, "
        f"launches {card_launches}")
    if set(card_launches) != {"flash_lite_fwd"}:
        raise PhaseError(f"the CLI run on the card launched {card_launches}; K2 alone expected")
    if not (psnr > 45.0 and np.isfinite(out["card"][0]).all()):
        raise PhaseError(f"card and CPU disagree in the CLI configuration: PSNR {psnr:.2f} dB")
    if yuv_diff > 1:
        raise PhaseError(f"YUV420 planes differ by {yuv_diff} between card and CPU")
    if released <= 0:
        raise PhaseError("save_memory released nothing on the card")
    return dict(psnr_db=psnr, yuv_max_abs_diff=yuv_diff, released_mib=released,
                launches=card_launches)


def trace_phase(torch) -> dict:
    """The CLI's generate with --profile_dir on the parity phase's card
    pipeline and inputs, in the CLI's configuration (DPM-Solver++ 2 steps,
    save_memory, K2's fp32 kernel): exactly one trace file, holding CUDA
    kernel events and among them the port's flash kernel by name. It runs
    last, after every timed phase, so that no profiler session precedes
    them in this process."""
    from vexpress_torch.cli import infer
    from vexpress_torch.ops import flash

    card, _, kw = parity_setup(torch)
    inputs = dict(reference_image=kw["reference_image"], kps_images=kw["kps_images"],
                  audio=kw["audio_waveform"], video_length=kw["video_length"])
    with tempfile.TemporaryDirectory() as trace_dir:
        args = infer.parse_args([
            "--reference_image_path", "synthetic", "--audio_path", "synthetic",
            "--image_width", str(kw["width"]), "--image_height", str(kw["height"]),
            "--sampler", "dpmpp_2m", "--num_inference_steps", "2",
            "--guidance_scale", str(kw["guidance_scale"]),
            "--context_frames", str(kw["context_frames"]),
            "--context_overlap", str(kw["context_overlap"]), "--save_gpu_memory",
            "--profile_dir", trace_dir])
        flash.FLASH_LITE = True
        try:
            t0 = time.perf_counter()
            infer.generate(card, inputs, args, output_yuv420=True)
            run_s = time.perf_counter() - t0
        finally:
            flash.FLASH_LITE = False
        traces = sorted(pathlib.Path(trace_dir).glob("*.pt.trace.json"))
        trace_mib = sum(t.stat().st_size for t in traces) / 2**20
        events = json.loads(traces[0].read_text())["traceEvents"] if traces else []
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    flash_names = sorted({n for n in kernels if "flash_fwd" in n})
    log(f"[trace] CLI generate with --profile_dir: {run_s:.1f} s, {len(traces)} trace file(s) "
        f"of {trace_mib:.1f} MiB, {len(events)} events, {len(kernels)} CUDA kernel events, "
        f"flash kernels {flash_names}")
    if len(traces) != 1 or not flash_names:
        raise PhaseError(f"--profile_dir wrote {len(traces)} trace files; kernel events "
                         f"{len(kernels)}, flash kernels among them {flash_names}")
    return dict(run_s=run_s, trace_mib=trace_mib, events=len(events), kernel_events=len(kernels),
                flash_kernels=flash_names)


FULL_SIZE, FULL_FRAMES, FULL_CONTEXT, FULL_OVERLAP = 512, 44, 24, 4
# what a phase keeps for a later one: full's pipeline, inputs, video and
# final latents (fused), cli_full's YUV420 planes (sharded)
KEPT = {}


def full_pipeline(torch, steps: int):
    """The full-width configuration: the SD1.5 geometry in bf16 with seeded
    random weights on the card, and the keyword arguments of one streamed call
    at 512x512 (44 frames in 24-frame windows, CFG 3.5, window_group 1)."""
    from vexpress_torch.io import default_pipeline_models, init_pipeline_random_
    from vexpress_torch.pipelines import VExpressPipeline

    pipe = init_pipeline_random_(VExpressPipeline(default_pipeline_models(torch.bfloat16),
                                                  device="cuda"), seed=0)
    ref, kps, wave = synthetic_inputs(FULL_SIZE, FULL_SIZE, FULL_FRAMES, seed=1)
    kw = dict(reference_image=ref, kps_images=kps, audio_waveform=wave, width=FULL_SIZE,
              height=FULL_SIZE, video_length=FULL_FRAMES, num_inference_steps=steps,
              guidance_scale=3.5, context_frames=FULL_CONTEXT, context_overlap=FULL_OVERLAP,
              window_group=1, seed=42, median_filter=True, output_uint8=True)
    return pipe, kw


def full_phase(torch, steps: int) -> dict:
    """The streamed pipeline at SD1.5 width, bf16, 512x512, seeded random
    weights. Returns, besides times and memory, K1's launches by shape."""
    import numpy as np
    from vexpress_torch.ops import launches
    from vexpress_torch.pipelines.context import compute_context_windows
    from vexpress_torch.tools.common import PeakSplit

    H = W = FULL_SIZE
    L, ctx, ovl = FULL_FRAMES, FULL_CONTEXT, FULL_OVERLAP
    torch.cuda.reset_peak_memory_stats()
    resident_gib = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    pipe, kw = full_pipeline(torch, steps)
    models = pipe.m
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for m in pipe.components().values() for p in m.parameters())

    nonfinite = []

    def watch(name):
        def hook(_mod, _inp, out):
            if not bool(torch.isfinite(out).all()):
                nonfinite.append(name)
        return hook

    hooks = [pipe.denoising_unet.register_forward_hook(watch("denoising_unet")),
             pipe.vae.decoder.register_forward_hook(watch("vae.decoder"))]
    denoise = pipe._denoise  # the final latents are kept for the fused phase

    def keep_latents(*a, **k):
        KEPT["full_latents"] = denoise(*a, **k)
        return KEPT["full_latents"]

    pipe._denoise = keep_latents
    split = PeakSplit(pipe)
    launches.reset()
    t0 = time.perf_counter()
    video = pipe(**kw)
    run_s = time.perf_counter() - t0
    counts = dict(launches.counts)
    by_shape = {k[1:]: n for k, n in launches.shapes.items() if k[0] == "flash_fwd"}
    for h in hooks:
        h.remove()
    del pipe._denoise
    KEPT["full"] = dict(pipe=pipe, kw=kw, video=video, phases_s=dict(pipe.timings),
                        by_shape=by_shape)
    n_windows = compute_context_windows(L, ctx, ovl)[0].shape[0]
    expected = expected_flash_launches(models.unet_config, H // 8, W // 8, ctx, steps * n_windows)
    peaks = split.finish()
    peak_gib = max(peaks.values())
    log(f"[full] {models.dtype} {H}x{W}, {L} frames ({n_windows} windows of {ctx}), CFG 3.5, "
        f"{steps} DDIM steps, {n_params / 1e9:.3f} B params: setup {setup_s:.1f} s, "
        f"pipeline {run_s:.1f} s, phases {json.dumps(pipe.timings)}, peak "
        f"{peak_gib:.2f} GiB (by stretch {json.dumps(peaks)}; {resident_gib:.2f} GiB allocated "
        f"before set-up), launches {counts} (expected "
        f"flash_fwd {expected}), flash_fwd by (B, Lq, Lk, D) {by_shape}")
    if video.shape != (L, H, W, 3) or video.dtype != np.uint8:
        raise PhaseError(f"output {video.shape} {video.dtype}, expected ({L}, {H}, {W}, 3) uint8")
    if nonfinite:
        raise PhaseError(f"non-finite values out of {sorted(set(nonfinite))}")
    if counts.get("flash_fwd", 0) != expected:
        raise PhaseError(f"K1 launched {counts.get('flash_fwd', 0)} times, expected {expected}")
    if counts.get("flash_sdpa_reference", 0):
        raise PhaseError("the plain flash version ran on the card's main path")
    checked = {_shape_key(row) for row in K1_SHAPES}
    if set(by_shape) != checked:
        raise PhaseError(f"K1 ran at shapes {sorted(by_shape)}; the kernel phase checks "
                         f"{sorted(checked)}")
    return dict(flash_launches=counts.get("flash_fwd", 0), expected_launches=expected,
                flash_launches_by_shape=[[*key, n] for key, n in sorted(by_shape.items())],
                setup_s=setup_s, pipeline_s=run_s, phases_s=dict(pipe.timings),
                peak_alloc_gib=peak_gib, peak_by_stretch_gib=peaks,
                resident_before_gib=resident_gib, params=n_params,
                steps=steps, frames=L,
                windows=n_windows, video_std=float(video.std()))


def _pipeline_run(torch, pipe, call):
    """One pipeline call made by `call()` with its launches and final
    latents: (output, latents, seconds, flash launches by kernel and shape,
    the fused cache entry the call ran, its replays in the call, whether the
    call captured it)."""
    from vexpress_torch.ops import launches

    kept, denoise = {}, pipe._denoise

    def keep_latents(*a, **k):
        latents = denoise(*a, **k)
        kept["latents"] = latents.clone()  # a fused call's are its graph's output buffer
        return latents

    pipe._denoise = keep_latents
    before = {id(e): (e, e.replays, e.graph) for e in pipe._step_cache.values()}
    try:
        launches.reset()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        del pipe._denoise
    by_shape = {k: n for k, n in launches.shapes.items() if k[0].startswith("flash")}
    ran = [e for e in pipe._step_cache.values()
           if id(e) not in before or e.replays != before[id(e)][1]]
    entry = ran[0] if len(ran) == 1 else None
    replays = entry.replays - before.get(id(entry), (None, 0))[1] if entry else 0
    captured = entry is not None and before.get(id(entry), (None, 0, None))[2] is None
    return out, kept["latents"], run_s, by_shape, entry, replays, captured


def _planes_psnr(a, b) -> float:
    import numpy as np

    return _psnr(np.concatenate([p.reshape(-1) for p in a]).astype(np.float32) / 255.0,
                 np.concatenate([p.reshape(-1) for p in b]).astype(np.float32) / 255.0)


def fused_phase(torch) -> dict:
    """The fused mode at full width, each denoise step one CUDA graph: (a)
    full's pipeline and inputs (SD1.5 geometry, bf16, 512x512, 44 frames,
    CFG 3.5, DDIM 25) in mode="fused" against full's streamed run: capture
    s, s/step beside streamed's, peak allocated and reserved by stretch, K1
    launches by shape, max |d| of the latents, PSNR of the decoded video;
    (b) the CLI's generate at cli_full's settings without --save_gpu_memory
    (DPM-Solver++ 12, K2, YUV420) with --mode fused against --mode
    streamed; (c) an in-place load of new weights into the denoising UNet
    and (b) again, the fused call served by its cached graph. Each fused
    call must have replayed a torch.cuda.CUDAGraph, launched the kernels by
    shape as its streamed twin did, kept its outputs finite and reached
    PSNR > 45 dB against it."""
    import numpy as np
    from vexpress_torch.cli import infer
    from vexpress_torch.io.loaders import init_random_
    from vexpress_torch.ops import flash
    from vexpress_torch.tools.common import PeakSplit, nonfinite_outputs

    full = KEPT.pop("full")
    streamed_latents = KEPT.pop("full_latents")
    pipe, kw = full["pipe"], full["kw"]
    steps = kw["num_inference_steps"]
    failures = []

    def check(name, entry, replays, want_replays, by_shape, want_by_shape, psnr, latents,
              nonfinite=()):
        if not isinstance(getattr(entry, "graph", None), torch.cuda.CUDAGraph):
            failures.append(f"{name}: no CUDA graph replayed")
        if replays != want_replays:
            failures.append(f"{name}: {replays} replays, expected {want_replays}")
        if by_shape != want_by_shape or not by_shape:
            failures.append(f"{name}: launches by shape {by_shape}, streamed {want_by_shape}")
        if not psnr > 45.0:
            failures.append(f"{name}: PSNR {psnr:.2f} dB against streamed (needs > 45)")
        if nonfinite or not bool(torch.isfinite(latents).all()):
            failures.append(f"{name}: non-finite values (modules {sorted(nonfinite)})")

    # (a) DDIM 25 at full's settings
    split = PeakSplit(pipe)
    with nonfinite_outputs(pipe) as read_flags:
        video, latents, run_s, by_shape, entry, replays, _ = _pipeline_run(
            torch, pipe, lambda: pipe(**kw, mode="fused"))
    peaks, reserved = split.finish(), dict(split.reserved)
    nonfinite = read_flags()
    timings = dict(pipe.timings)
    capture_s = timings.get("fused warm-up step and capture", float("nan"))
    fused_step_s = (timings["denoise"] - capture_s) / (steps - 1)
    streamed_step_s = full["phases_s"]["denoise"] / steps
    max_err = float((latents - streamed_latents).abs().max())
    psnr = _psnr(pipe.decode_latents(latents), pipe.decode_latents(streamed_latents))
    want = {("flash_fwd",) + k: n for k, n in full["by_shape"].items()}
    check("ddim", entry, replays, steps - 1, by_shape, want, psnr, latents, nonfinite)
    if video.shape != full["video"].shape or video.dtype != np.uint8:
        failures.append(f"ddim: video {video.shape} {video.dtype}")
    # what the graph's private pool holds: the reserve before and after the
    # entry is dropped, each after empty_cache
    torch.cuda.empty_cache()
    reserved_with = torch.cuda.memory_reserved() / 2**30
    pipe._step_cache.clear()
    entry = None
    gc.collect()
    torch.cuda.empty_cache()
    pool_gib = reserved_with - torch.cuda.memory_reserved() / 2**30
    log(f"[fused] DDIM {steps}, {kw['video_length']} frames at {kw['width']}x{kw['height']}, "
        f"CFG {kw['guidance_scale']}: warm-up step and capture {capture_s:.2f} s, s/step "
        f"fused {fused_step_s:.4f} (replays) against streamed {streamed_step_s:.4f}, denoise "
        f"{timings['denoise']:.2f} s (streamed {full['phases_s']['denoise']:.2f}), call "
        f"{run_s:.2f} s, phases {json.dumps(timings)}; peak allocated by stretch "
        f"{json.dumps(peaks)} GiB, reserved {json.dumps(reserved)} GiB, graph pool "
        f"{pool_gib:.2f} GiB; K1 launches by shape {by_shape}; latents max|d| {max_err:.3e}; "
        f"decoded PSNR {psnr:.2f} dB; replays {replays}")
    ddim = dict(capture_s=capture_s, fused_s_per_step=fused_step_s,
                streamed_s_per_step=streamed_step_s, denoise_s=timings["denoise"],
                streamed_denoise_s=full["phases_s"]["denoise"], call_s=run_s, phases_s=timings,
                peak_alloc_by_stretch_gib=peaks, peak_reserved_by_stretch_gib=reserved,
                graph_pool_gib=pool_gib, latents_max_abs_err=max_err, psnr_db=psnr,
                replays=replays, launches=sum(by_shape.values()),
                launches_by_shape=[[*k, n] for k, n in sorted(by_shape.items())])

    # (b) and (c): the CLI's generate, DPM-Solver++ 12 with K2, fused against streamed
    argv = [a for a in CLI_FULL_ARGV if a != "--save_gpu_memory"]
    size, frames = infer.parse_args(argv).image_width, FULL_FRAMES
    ref, kps, wave = synthetic_inputs(size, size, frames, seed=1)
    inputs = dict(reference_image=ref, kps_images=kps, audio=wave, video_length=frames)
    cli = {}
    flash.FLASH_LITE = True
    try:
        for run in ("cli", "reload"):
            if run == "reload":
                init_random_(pipe.denoising_unet, seed=77)  # copies into the same storages
            out = {}
            for mode in ("fused", "streamed"):
                args = infer.parse_args(argv + ["--mode", mode])
                infer._check_ported(args)
                out[mode] = _pipeline_run(torch, pipe,
                                       lambda: infer.generate(pipe, inputs, args, True))
            planes, latents, run_s, by_shape, entry, replays, captured = out["fused"]
            psnr = _planes_psnr(planes, out["streamed"][0])
            max_err = float((latents - out["streamed"][1]).abs().max())
            check(run, entry, replays, CLI_STEPS - 1 if run == "cli" else CLI_STEPS, by_shape,
                  out["streamed"][3], psnr, latents)
            if run == "reload":
                if captured or len(pipe._step_cache) != 1:
                    failures.append("reload: the in-place load was not served by the cache")
                moved = float((latents - cli["cli"]["latents"]).abs().max())
                if not moved > 0:
                    failures.append("reload: the new weights did not change the latents")
            cli[run] = dict(latents=latents, fused_s=run_s, streamed_s=out["streamed"][2],
                            captured=captured, replays=replays, psnr_db=psnr,
                            latents_max_abs_err=max_err,
                            capture_s=entry.capture_s if entry is not None else None,
                            launches=sum(by_shape.values()),
                            launches_by_shape=[[*k, n] for k, n in sorted(by_shape.items())])
            log(f"[fused] CLI generate --mode fused ({run}: DPM-Solver++ {CLI_STEPS}, K2, YUV420"
                f"{', after an in-place load of new UNet weights' if run == 'reload' else ''}): "
                f"{run_s:.2f} s against streamed {out['streamed'][2]:.2f} s, captured "
                f"{captured}, replays {replays}, planes PSNR {psnr:.2f} dB, latents max|d| "
                f"{max_err:.3e}, launches by shape {by_shape}")
    finally:
        flash.FLASH_LITE = False
        pipe._step_cache.clear()
    for run in cli.values():
        run.pop("latents")
    if failures:
        raise PhaseError("; ".join(failures))
    return dict(ddim=ddim, cli=cli["cli"], reload=cli["reload"])


TAIL_LENGTHS = (1, 2, 3, 4, 5, 8, 9, 12, 13)  # chunk 4: every tail from 1 to chunk + 1
TAIL_CHUNK, TAIL_FRAMES, TAIL_BAR_GIB = 4, 248, 0.5


def decode_tail_phase(torch) -> dict:
    """The decode tail (`pipeline.decode_packed`) on the card with an identity
    decode: (a) random bf16 64x64 clips of every TAIL_LENGTHS length at chunk
    4, with and without the median filter, uint8 and YUV420, each bitwise
    equal to the whole-clip route (to_uint8 / to_yuv420 of median_filter_3d
    over the clip); (b) a 248-frame 512x512 bf16 clip already on the card:
    the device memory the tail allocates beyond it (at most TAIL_BAR_GIB)
    and its seconds, beside the whole-clip route's, and their outputs
    bitwise equal."""
    import types

    import numpy as np
    from vexpress_torch.pipelines import VExpressPipeline
    from vexpress_torch.pipelines.media import median_filter_3d, to_uint8, to_yuv420

    dev = torch.device("cuda")
    stub = types.SimpleNamespace(device=dev, _decode_chunk=lambda frames: frames)
    gen = torch.Generator(device=dev).manual_seed(0)

    def tail(video, chunk, median_filter, yuv):
        out = VExpressPipeline.decode_latents(stub, video, chunk=chunk,
                                              median_filter=median_filter,
                                              as_uint8=not yuv, as_yuv420=yuv)
        return list(out) if yuv else [out]

    def whole(video, median_filter, yuv):
        with torch.inference_mode():
            v = median_filter_3d(video) if median_filter else video
            out = to_yuv420(v) if yuv else (to_uint8(v),)
            return [p.cpu().numpy() for p in out]

    def same(a, b):
        return len(a) == len(b) and all(x.shape == y.shape and np.array_equal(x, y)
                                        for x, y in zip(a, b))

    bad = []
    for f in TAIL_LENGTHS:
        video = torch.rand((f, 64, 64, 3), generator=gen, device=dev).to(torch.bfloat16)
        for median_filter in (True, False):
            for yuv in (False, True):
                if not same(tail(video, TAIL_CHUNK, median_filter, yuv),
                            whole(video, median_filter, yuv)):
                    bad.append((f, median_filter, "yuv420" if yuv else "uint8"))
    clip = torch.rand((TAIL_FRAMES, 512, 512, 3), generator=gen, device=dev).to(torch.bfloat16)
    rows, outs = {}, {}
    for route in ("chunked", "whole"):
        for yuv in (False, True):
            name = f"{route}_{'yuv420' if yuv else 'uint8'}"
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            outs[name] = (tail(clip, 16, True, yuv) if route == "chunked"
                          else whole(clip, True, yuv))
            torch.cuda.synchronize()
            rows[name] = dict(seconds=time.perf_counter() - t0,
                              increase_gib=(torch.cuda.max_memory_allocated() - base) / 2**30)
    equal = {k: same(outs[f"chunked_{k}"], outs[f"whole_{k}"]) for k in ("uint8", "yuv420")}
    log(f"[decode_tail] identity decode, chunk {TAIL_CHUNK}, 64x64 bf16, lengths "
        f"{list(TAIL_LENGTHS)}, filter on and off, uint8 and YUV420: "
        f"{len(TAIL_LENGTHS) * 4 - len(bad)} of {len(TAIL_LENGTHS) * 4} bitwise equal to the "
        f"whole-clip route; {TAIL_FRAMES} frames 512x512 bf16, filtered, chunk 16: "
        f"{json.dumps(rows)}, chunked equal to whole {equal}")
    if bad:
        raise PhaseError(f"the chunked tail differs from the whole-clip route at (frames, "
                         f"filter, output) {bad}")
    if not all(equal.values()):
        raise PhaseError(f"the chunked tail differs from the whole-clip route at "
                         f"{TAIL_FRAMES} frames: {equal}")
    over = {k: r["increase_gib"] for k, r in rows.items()
            if k.startswith("chunked") and r["increase_gib"] > TAIL_BAR_GIB}
    if over:
        raise PhaseError(f"the chunked tail allocated {over} GiB beyond its "
                         f"{TAIL_FRAMES}-frame clip (bar {TAIL_BAR_GIB})")
    return dict(lengths=list(TAIL_LENGTHS), chunk=TAIL_CHUNK, frames=TAIL_FRAMES, rows=rows)


def _shape_key(row) -> tuple:
    """(B, Lq, Lk, D) of a K1_SHAPES row, as ops.launches.shapes keys it."""
    _, b, lq, lk, inner, heads = row[:6]
    return (b, lq, lk, inner // heads)


def stage_2() -> dict:
    """configs/stage_2.yaml's training values (vexpress_torch.train.recipe) at
    TRAIN_FRAMES frames, routed into a TrainConfig by the training CLI's
    train_config."""
    from vexpress_torch.train.recipe import stage_config

    cfg = stage_config("stage_2")
    cfg["data"]["num_frames"] = TRAIN_FRAMES
    return cfg


TRAIN_STEPS = 5


def expected_bwd_launches(cfg, unet_cfg, h: int, w: int, frames: int, batch: int = 1) -> dict:
    """K1 backward launches of one train step, by (kernel, B, Lq, Lk, D), from
    the stage's trainability and the UNets' layout at latent (h, w).

    Denoising UNet: a transformer block's attn1 runs both backward kernels
    when its input carries a gradient; its attn1_5 runs the dq kernel then,
    and the dk/dv kernel when the reference bank or attn1_5's own projections
    train. The first block's input carries a gradient only if the UNet's first
    layers or the kps guider train; every later block's does whenever anything
    trains (at stage 2: the first block's attn2 and motion module). Reference
    net: when it trains, every attn1 runs both kernels (its frozen up_blocks.3
    still passes the gradient to its banks' inputs); otherwise it runs without
    a gradient."""
    import collections

    ch, heads, lp = unet_cfg.block_out_channels, unet_cfg.attention_head_dim, unet_cfg.layers_per_block
    levels = [0] * lp + [1] * lp + [2] * lp + [3] + [2] * (lp + 1) + [1] * (lp + 1) + [0] * (lp + 1)
    x_grad = cfg.train_denoising_unet or cfg.train_v_kps_guider
    later = x_grad or cfg.train_audio_projection or cfg.train_motion_module or cfg.train_reference_net
    kv_grad = cfg.train_reference_net or cfg.train_denoising_unet
    out = collections.Counter()
    for i, lvl in enumerate(levels):
        grad = x_grad if i == 0 else later
        hw = (h >> lvl) * (w >> lvl)
        d = ch[lvl] // heads
        for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
            if _flash_eligible(hw, hw) and grad:
                out[(kernel, batch * frames, hw, hw, d)] += 1
            if _flash_eligible(hw, hw) and cfg.train_reference_net:
                out[(kernel, batch, hw, hw, d)] += 1
        if _flash_eligible(frames * hw, hw):
            if grad:
                out[("flash_bwd_dq", batch, frames * hw, hw, d)] += 1
            if kv_grad:
                out[("flash_bwd_dkv", batch, frames * hw, hw, d)] += 1
    return dict(out)


def synthetic_train_batch(torch, size: int, frames: int, audio_dim: int, seed: int, device):
    """vexpress_torch.train.recipe.synthetic_train_batch at batch 1."""
    from vexpress_torch.train.recipe import synthetic_train_batch as batch

    return batch(size, frames, audio_dim, seed, device)


TRAIN_PARITY_SIZE, TRAIN_PARITY_FRAMES = 256, 4


def train_parity_phase(torch) -> dict:
    """Stage 3 (every module trains, so dk/dv flow into the reference net
    through attn1_5) on the reduced fp32 models, card against CPU with shared
    weights, batch and draws: loss and gradients of one loss_fn, then 2
    AdamW and 2 8-bit-Adam train steps. Bars: loss 1e-5 relative, each
    trainable tensor's gradient within 1e-4 of its max, params within 1e-5."""
    from vexpress_torch.ops import launches
    from vexpress_torch.train import (TrainConfig, TrainState, build_train_step, make_optimizer,
                                      sample_draws)

    card, cpu = card_and_cpu_pipelines(torch, seed=21)
    size, frames = TRAIN_PARITY_SIZE, TRAIN_PARITY_FRAMES
    lat = size // 8
    batches = {"card": synthetic_train_batch(torch, size, frames, 16, seed=4, device="cuda")}
    batches["cpu"] = {k: v.cpu() for k, v in batches["card"].items()}
    pipes = {"card": card, "cpu": cpu}
    # lr 1e-5 and eps 1e-3 keep Adam's first steps smooth in the gradient, so
    # the card-CPU difference of the params reflects that of the gradients
    kw = dict(num_frames=frames, learning_rate=1e-5, adam_epsilon=1e-3, lip_loss_weight=2.0)
    cfg = TrainConfig.stage("stage_3", **kw)
    draws = sample_draws(torch.Generator().manual_seed(5), cfg, 1, frames, (lat, lat))
    card_launches = {}

    def on(name, fn):
        launches.reset()
        out = fn()
        if name == "card":
            torch.cuda.synchronize()
            for key, n in launches.counts.items():
                card_launches[key] = card_launches.get(key, 0) + n
        return out

    losses, grads = {}, {}
    for name, pipe in pipes.items():
        opt, mask = make_optimizer(pipe.components(), cfg)
        _, loss_fn = build_train_step(pipe, cfg, opt)

        def grad_run():
            loss = loss_fn(pipe.components(), batches[name],
                           {k: v.to(pipe.device) for k, v in draws.items()})
            loss.backward()
            return float(loss.detach())

        losses[name] = on(name, grad_run)
        grads[name] = {f"{m}.{n}": (p.grad.detach().cpu() if p.grad is not None else None)
                       for m, mod in pipe.components().items()
                       for n, p in mod.named_parameters() if p.requires_grad}
        opt.zero_grad()
    loss_rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    worst = (0.0, "")
    for key, ref in grads["cpu"].items():
        got = grads["card"][key]
        if ref is None or got is None:
            if (ref is None) != (got is None):
                raise PhaseError(f"{key}: a gradient on one device only")
            continue
        rel = float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
        worst = max(worst, (rel, key))

    step_losses = {"card": [], "cpu": []}
    for i, reduce in enumerate((False, True)):
        step_cfg = TrainConfig.stage("stage_3", reduce_optimizer_memory=reduce, **kw)
        for name, pipe in pipes.items():
            opt, _ = make_optimizer(pipe.components(), step_cfg)
            step_fn, _ = build_train_step(pipe, step_cfg, opt)
            state, gen = TrainState(pipe.components(), opt), torch.Generator().manual_seed(7 + i)

            def two_steps():
                nonlocal state
                for _ in range(2):
                    state, metrics = step_fn(state, batches[name], gen)
                    step_losses[name].append(float(metrics["loss"]))

            on(name, two_steps)
    param_err = max(float((pc.detach().cpu() - ph.detach()).abs().max())
                    for mod in card.components() for pc, ph in
                    zip(card.components()[mod].parameters(), cpu.components()[mod].parameters()))
    log(f"[train_parity] fp32 stage 3, {size}x{size}, {frames} frames: loss card "
        f"{losses['card']:.6f} cpu {losses['cpu']:.6f} (rel {loss_rel:.2e}); worst gradient "
        f"max|d|/max|g| {worst[0]:.2e} ({worst[1]}); after 2 AdamW + 2 8-bit steps params "
        f"max|d| {param_err:.2e}; step losses card {step_losses['card']} cpu "
        f"{step_losses['cpu']}; K1 launches on the card {card_launches}")
    if card_launches.get("flash_sdpa_reference") or card_launches.get("flash_sdpa_bwd_reference"):
        raise PhaseError(f"a plain flash version ran on the card: {card_launches}")
    reckoned = expected_bwd_launches(cfg, card.m.unet_config, lat, lat, frames)
    for kernel in ("flash_bwd_dkv", "flash_bwd_dq"):
        want = 5 * sum(n for key, n in reckoned.items() if key[0] == kernel)  # 1 + 4 backwards
        if card_launches.get(kernel, 0) != want or not want:
            raise PhaseError(f"{kernel} ran {card_launches.get(kernel, 0)} times on the card, "
                             f"reckoned {want}: {card_launches}")
    if loss_rel > 1e-5 or worst[0] > 1e-4 or param_err > 1e-5:
        raise PhaseError(f"card and CPU training disagree: loss rel {loss_rel:.2e} (<=1e-5), "
                         f"gradient {worst[0]:.2e} at {worst[1]} (<=1e-4), params "
                         f"{param_err:.2e} (<=1e-5)")
    return dict(loss_card=losses["card"], loss_cpu=losses["cpu"], loss_rel=loss_rel,
                worst_grad_rel=worst[0], worst_grad_tensor=worst[1], param_max_abs_err=param_err,
                step_losses=step_losses, launches=card_launches)


LORA_PARITY = dict(rank=2, alpha=4.0)  # every default target of the denoising UNet


def lora_bwd_launches(cfg, unet_cfg, h: int, w: int, frames: int, batch: int = 1) -> dict:
    """K1 backward launches of one LoRA train step over the denoising UNet's
    default targets: every attn1, attn1_5 and attn2 projection carries a
    factor gradient, so every transformer block's q, k and v need one, as
    when the whole denoising UNet trains (`expected_bwd_launches` with its
    flag on); the reference net runs without a gradient."""
    import dataclasses

    return expected_bwd_launches(dataclasses.replace(cfg, train_denoising_unet=True,
                                                     train_reference_net=False),
                                 unet_cfg, h, w, frames, batch)


def lora_parity_phase(torch) -> dict:
    """Stage-2 LoRA (rank 2, alpha 4, every default target of the denoising
    UNet) on the reduced fp32 models, card against CPU with shared weights,
    factors, batch and draws: loss and factor gradients of one loss, then two
    build_lora_train_step steps (train_parity's bars); then the inference
    CLI's adapter merge (--lora_path) of the card's adapter exported after
    step 2 on both pipelines, and cli_parity_run's call and bars on them."""
    from vexpress_torch.cli import infer
    from vexpress_torch.io.torch_export import save_torch_checkpoint
    from vexpress_torch.ops import launches
    from vexpress_torch.train import TrainConfig, TrainState, sample_draws
    from vexpress_torch.train import lora as tl

    card, cpu = card_and_cpu_pipelines(torch, seed=31)
    size, frames = TRAIN_PARITY_SIZE, TRAIN_PARITY_FRAMES
    lat = size // 8
    batches = {"card": synthetic_train_batch(torch, size, frames, 16, seed=4, device=card.device)}
    batches["cpu"] = {k: v.cpu() for k, v in batches["card"].items()}
    pipes = {"card": card, "cpu": cpu}
    cfg = TrainConfig.stage("stage_2", num_frames=frames, learning_rate=1e-5, adam_epsilon=1e-3,
                            lip_loss_weight=2.0)
    lcfg = tl.LoraConfig(**LORA_PARITY)
    draws = sample_draws(torch.Generator().manual_seed(5), cfg, 1, frames, (lat, lat))
    losses, grads, step_losses, factors, card_launches = {}, {}, {}, {}, {}
    workdir = tempfile.TemporaryDirectory(prefix="lora_parity_")
    adapter = str(pathlib.Path(workdir.name) / "lora-2.pth")
    for name, pipe in pipes.items():
        comps = pipe.components()
        lora = tl.init_lora(comps, lcfg, seed=0)
        g = torch.Generator().manual_seed(3)  # B off zero, so both factors get a gradient
        for f in (f for sub in lora.values() for f in sub.values()):
            f.lora_B.weight.data.copy_(0.05 * torch.randn(f.lora_B.weight.shape, generator=g))
        optimizer = tl.make_lora_optimizer(lora, cfg)
        step_fn, loss_fn = tl.build_lora_train_step(pipe, cfg, optimizer, lcfg, lora)
        launches.reset()
        loss = loss_fn(comps, batches[name], {k: v.to(pipe.device) for k, v in draws.items()})
        loss.backward()
        losses[name] = float(loss.detach())
        grads[name] = [p.grad.detach().cpu() for p in tl.lora_parameters(lora)]
        optimizer.zero_grad()
        state, gen = TrainState(comps, optimizer), torch.Generator().manual_seed(7)
        step_losses[name] = []
        for _ in range(2):
            state, metrics = step_fn(state, batches[name], gen)
            step_losses[name].append(float(metrics["loss"]))
        if name == "card":
            torch.cuda.synchronize()
            card_launches = {k: n for k, n in launches.counts.items() if n}
            save_torch_checkpoint(tl.lora_to_torch_state_dict(lora, lcfg), adapter)
        factors[name] = [p.detach().cpu() for p in tl.lora_parameters(lora)]
        tl.detach_lora(comps, lora)
        for mod in comps.values():
            mod.eval()
    loss_rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    grad_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(grads["card"], grads["cpu"]))
    factor_err = max(float((a - b).abs().max()) for a, b in zip(factors["card"], factors["cpu"]))
    reckoned = lora_bwd_launches(cfg, card.m.unet_config, lat, lat, frames)
    log(f"[lora_parity] fp32 stage 2, LoRA {LORA_PARITY} over {len(grads['card']) // 2} "
        f"projections, {size}x{size}, {frames} frames: loss card {losses['card']:.6f} cpu "
        f"{losses['cpu']:.6f} (rel {loss_rel:.2e}); worst factor gradient max|d|/max|g| "
        f"{grad_rel:.2e}; factors after 2 steps max|d| {factor_err:.2e}; step losses card "
        f"{step_losses['card']} cpu {step_losses['cpu']}; K1 launches on the card "
        f"{card_launches}, backward reckoned a step {sorted(reckoned.items())}")
    if card_launches.get("flash_sdpa_reference") or card_launches.get("flash_sdpa_bwd_reference"):
        raise PhaseError(f"a plain flash version ran on the card: {card_launches}")
    for kernel in ("flash_bwd_dkv", "flash_bwd_dq"):
        want = 3 * sum(n for key, n in reckoned.items() if key[0] == kernel)  # 1 + 2 backwards
        if card_launches.get(kernel, 0) != want or not want:
            raise PhaseError(f"{kernel} ran {card_launches.get(kernel, 0)} times on the card, "
                             f"reckoned {want}: {card_launches}")
    if loss_rel > 1e-5 or grad_rel > 1e-4 or factor_err > 1e-5:
        raise PhaseError(f"card and CPU LoRA training disagree: loss rel {loss_rel:.2e} "
                         f"(<=1e-5), factor gradient {grad_rel:.2e} (<=1e-4), factors "
                         f"{factor_err:.2e} (<=1e-5)")
    for pipe in pipes.values():  # what build_pipeline does with --lora_path
        infer.merge_lora_adapter(pipe, adapter)
    workdir.cleanup()
    cli = cli_parity_run(torch, card, cpu, parity_call_kwargs())
    return dict(loss_card=losses["card"], loss_cpu=losses["cpu"], loss_rel=loss_rel,
                worst_factor_grad_rel=grad_rel, factor_max_abs_err=factor_err,
                step_losses=step_losses, launches=card_launches, cli=cli)


def train_full_phase(torch) -> dict:
    """Stage 2 at full SD1.5 width: configs/stage_2.yaml's values, bf16 (the
    resolve_dtype(cfg, "bf16") route), seeded random weights, stage_zero_init,
    the denoising UNet checkpointed per block, 20 frames at 512x512, batch 1,
    TRAIN_STEPS steps of train_step. Times each step and splits it with CUDA
    events (conditioning, UNet forward, backward, optimizer)."""
    from vexpress_torch.io import default_pipeline_models
    from vexpress_torch.ops import launches
    from vexpress_torch.train import TrainState
    from vexpress_torch.train.config import resolve_dtype
    from vexpress_torch.train.recipe import build_stage_step
    from vexpress_torch.train.step_split import StepSplit

    stage = stage_2()
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[resolve_dtype(stage, "bf16")]
    models = default_pipeline_models(dtype)
    size, frames = stage["data"]["train_width"], stage["data"]["num_frames"]
    t0 = time.perf_counter()
    run = build_stage_step(models, "stage_2", frames, size, "cuda")
    cfg, comps, optimizer, mask, step_fn, batch = (run.config, run.models, run.optimizer,
                                                   run.mask, run.step_fn, run.batch)
    checkpointing = run.unet_config.gradient_checkpointing
    frozen = {f"{m}.{n}": p.detach().cpu() for m, mod in comps.items()
              for n, p in mod.named_parameters() if not mask[m][n]}
    zeroed = {f"denoising_unet.{n}": p for n, p in comps["denoising_unet"].named_parameters()
              if ".attn2.to_out.0." in "." + n or ".temporal_transformer.proj_out." in "." + n}
    n_train = run.trainable_params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    split = StepSplit(comps["denoising_unet"], optimizer)
    state, gen = TrainState(comps, optimizer), torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    step_s, losses = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        split.begin()
        state, metrics = step_fn(state, batch, gen)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    counts = dict(launches.counts)
    by_shape = {k: n for k, n in launches.shapes.items()}
    split.remove()
    splits = split.splits()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    changed_frozen = [f"{m}.{n}" for m, mod in comps.items() for n, p in mod.named_parameters()
                      if f"{m}.{n}" in frozen and not torch.equal(p.detach().cpu(), frozen[f"{m}.{n}"])]
    still_zero = [k for k, p in zeroed.items() if not bool(p.detach().any())]
    lat = size // 8
    expected = {k: n * TRAIN_STEPS for k, n in
                expected_bwd_launches(cfg, models.unet_config, lat, lat, frames).items()}
    measured = {k: n for k, n in by_shape.items() if k[0].startswith("flash_bwd")}
    fwd_by_shape = {k[1:]: n for k, n in by_shape.items() if k[0] == "flash_fwd"}
    later = step_s[1:]
    split_mean = {k: sum(s[k] for s in splits[1:]) / len(later) for k in splits[0]}
    log(f"[train_full] stage 2, {dtype}, {size}x{size}, {frames} frames, batch 1, "
        f"checkpointing {checkpointing}, 8-bit Adam {cfg.reduce_optimizer_memory}, "
        f"{n_train / 1e6:.1f} M trainable params: setup {setup_s:.1f} s, step 1 "
        f"{step_s[0]:.3f} s, steps 2-{TRAIN_STEPS} {sum(later) / len(later):.3f} s/step "
        f"({', '.join(f'{x:.3f}' for x in later)}), split of steps 2-{TRAIN_STEPS} "
        f"{json.dumps(split_mean)}, step 1 split {json.dumps(splits[0])}, peak "
        f"{peak_gib:.2f} GiB, losses {losses}, frozen params changed {len(changed_frozen)} of "
        f"{len(frozen)}, zero-initialised still zero {len(still_zero)} of {len(zeroed)}; "
        f"launches {counts}; forward by (B, Lq, Lk, D) {fwd_by_shape}; backward measured "
        f"{sorted(measured.items())}, reckoned {sorted(expected.items())}")
    if not all(math.isfinite(x) for x in losses):
        raise PhaseError(f"non-finite loss: {losses}")
    if changed_frozen:
        raise PhaseError(f"frozen parameters changed: {changed_frozen[:5]}")
    if still_zero or not zeroed:
        raise PhaseError(f"zero-initialised projections did not move: {still_zero[:5]}")
    if measured != expected:
        raise PhaseError(f"K1 backward launches {measured} differ from the reckoned {expected}")
    if counts.get("flash_sdpa_reference") or counts.get("flash_sdpa_bwd_reference"):
        raise PhaseError(f"a plain flash version ran on the card: {counts}")
    checked = {_shape_key(row) for row in K1_SHAPES + TRAIN_K1_SHAPES}
    if not set(fwd_by_shape) <= checked:
        raise PhaseError(f"K1 ran at shapes {sorted(fwd_by_shape)}; the kernel phase checks "
                         f"{sorted(checked)}")
    return dict(step_s=step_s, step1_s=step_s[0], steps_2_on_s=sum(later) / len(later),
                split_s=split_mean, step1_split_s=splits[0], peak_alloc_gib=peak_gib,
                losses=losses, setup_s=setup_s, trainable_params=n_train, launches=counts,
                fwd_launches_by_shape=[[*k, n] for k, n in sorted(fwd_by_shape.items())],
                bwd_launches_by_shape=[[*k, n] for k, n in sorted(measured.items())],
                bwd_launches_expected=[[*k, n] for k, n in sorted(expected.items())])


TRAIN_CLI_STEPS = 4
TRAIN_CLI_LORA = {"rank": 8, "alpha": 8}  # modules: denoising_unet; the default targets


def _bf16_ulps(a, b):
    """Largest |a - b| per element in bf16 ulps of the larger magnitude."""
    import torch

    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(2.0**-126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((a - b).abs() / ulp).max())


def train_cli_phase(torch) -> dict:
    """The training CLI's train() at full SD1.5 width: stage_2() plus a lora
    section (rank 8, alpha 8, the denoising UNet's default targets), bf16,
    seeded random base weights (the loader's, as train_full's), 20 frames at
    512x512, batch 1 from synthetic_train_batch, TRAIN_CLI_STEPS steps with a
    checkpoint every 2 into a temporary directory. Checks the losses, the
    files, the restore of the last checkpoint against the live state
    (bitwise, on the card), and the adapter's merge on the card against the
    CPU merge of the same tensors (<= 1 bf16 ulp a weight)."""
    from vexpress_torch.cli import train as train_cli
    from vexpress_torch.io.checkpoints import restore_train_state
    from vexpress_torch.ops import launches
    from vexpress_torch.train import lora as tl
    from vexpress_torch.train.lora import base_named_parameters, load_and_merge_lora
    from vexpress_torch.train.step_split import StepSplit

    stage = stage_2()
    size, frames = stage["data"]["train_width"], stage["data"]["num_frames"]
    with tempfile.TemporaryDirectory() as out_dir:
        cfg = dict(stage, lora=dict(TRAIN_CLI_LORA),
                   checkpointing_steps=2, output_dir=out_dir, seed=0)
        cfg_path = pathlib.Path(out_dir) / "stage_2_lora.json"
        cfg_path.write_text(json.dumps(cfg))
        args = train_cli.parse_args(["--config", str(cfg_path), "--dtype", "bf16",
                                     "--max_steps_override", str(TRAIN_CLI_STEPS)])

        def batches():
            for i in range(TRAIN_CLI_STEPS):
                batch = synthetic_train_batch(torch, size, frames, 768, seed=3 + i, device="cpu")
                yield {k: v.numpy() for k, v in batch.items()}

        # StepSplit splits each step as train_full's are, set by wrapping
        # the step that train() builds
        split, real_build = [], tl.build_lora_train_step

        def timed_build(pipeline, tcfg, optimizer, *a, **kw):
            step_fn, loss_fn = real_build(pipeline, tcfg, optimizer, *a, **kw)
            split.append(StepSplit(pipeline.denoising_unet, optimizer))

            def timed_step(*step_args):
                split[0].begin()
                return step_fn(*step_args)

            return timed_step, loss_fn

        torch.cuda.reset_peak_memory_stats()
        launches.reset()
        tl.build_lora_train_step = timed_build
        try:
            t0 = time.perf_counter()
            run = train_cli.train(cfg, args, batches())
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        finally:
            tl.build_lora_train_step = real_build
            for sp in split:
                sp.remove()
        splits = split[0].splits()
        counts = {k: n for k, n in launches.counts.items() if n}
        by_shape = dict(launches.shapes)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        out = pathlib.Path(out_dir)
        files = {name: (out / name).exists() for name in (
            "checkpoints/checkpoint-2", "checkpoints/checkpoint-4", "lora-2.pth", "lora-4.pth",
            "metrics.jsonl")}

        state, lora, pipe = run["state"], run["lora"], run["pipeline"]
        comps = pipe.components()
        factors = tl.lora_parameters(lora)
        n_pairs, n_factor = sum(len(sub) for sub in lora.values()), sum(p.numel() for p in factors)
        # restore checkpoint-4 into the live structures after wiping them
        live = dict(factors=[p.detach().clone() for p in factors],
                    moments=[{k: v.clone() for k, v in state.optimizer.inner.state[p].items()}
                             for p in factors],
                    count=state.optimizer.inner.count, step=state.step)
        with torch.no_grad():
            for p in factors:
                p.zero_()
                state.optimizer.inner.state[p] = {}
        state.optimizer.inner.count, state.step = 0, 0
        restore_train_state(str(out / "checkpoints" / "checkpoint-4"), state)
        restored = (state.step == live["step"] and state.optimizer.inner.count == live["count"]
                    and all(torch.equal(a, b) for a, b in zip(factors, live["factors"]))
                    and all(m.keys() == state.optimizer.inner.state[p].keys()
                            and all(torch.equal(v, state.optimizer.inner.state[p][k])
                                    for k, v in m.items())
                            for p, m in zip(factors, live["moments"])))
        # the adapter of step 4 merged into the same base weights on the card
        # and on the CPU, and against the live parametrized weights
        base = {m: dict(base_named_parameters(mod)) for m, mod in comps.items()}
        merged = load_and_merge_lora(base, str(out / "lora-4.pth"), comps)["denoising_unet"]
        keys = [name + ".weight" for name in lora["denoising_unet"]]
        host = load_and_merge_lora({"denoising_unet": {k: base["denoising_unet"][k].cpu()
                                                       for k in keys}},
                                   str(out / "lora-4.pth"), comps)["denoising_unet"]
        ulps = max(_bf16_ulps(merged[k].cpu(), host[k]) for k in keys)
        unet = comps["denoising_unet"]
        live_equal = all(torch.equal(merged[k], getattr(unet.get_submodule(k[:-7]), "weight"))
                         for k in keys)
        moved = sum(not torch.equal(merged[k], base["denoising_unet"][k]) for k in keys)
    losses, step_s = run["losses"], run["step_s"]
    later = step_s[1:]
    fwd_by_shape = {k[1:]: n for k, n in by_shape.items() if k[0] == "flash_fwd"}
    measured = {k: n for k, n in by_shape.items() if k[0].startswith("flash_bwd")}
    lat = size // 8
    tcfg = train_cli.train_config(cfg)
    expected = {k: n * TRAIN_CLI_STEPS for k, n in
                lora_bwd_launches(tcfg, pipe.m.unet_config, lat, lat, frames).items()}
    per_step = {f"{k[0]} B={k[1]} Lq={k[2]} Lk={k[3]} D={k[4]}": n / TRAIN_CLI_STEPS
                for k, n in sorted({**measured, **{("flash_fwd",) + k: n for k, n in
                                                   fwd_by_shape.items()}}.items())}
    per_step["flash_bwd_dkv_sum"] = counts.get("flash_bwd_dkv_sum", 0) / TRAIN_CLI_STEPS
    split_mean = {k: sum(s[k] for s in splits[1:]) / len(later) for k in splits[0]}
    log(f"[train_cli] cli.train.train, stage 2 + lora {TRAIN_CLI_LORA} ({n_pairs} adapted "
        f"projections, {n_factor / 1e6:.3f} M factor params), {pipe.m.dtype}, {size}x{size}, "
        f"{frames} frames, batch 1, {TRAIN_CLI_STEPS} steps: wall {wall_s:.1f} s, step 1 "
        f"{step_s[0]:.3f} s, steps 2-{TRAIN_CLI_STEPS} {sum(later) / len(later):.3f} s/step "
        f"({', '.join(f'{x:.3f}' for x in later)}), split of steps 2-{TRAIN_CLI_STEPS} "
        f"{json.dumps(split_mean)}, step 1 split {json.dumps(splits[0])}, peak "
        f"{peak_gib:.2f} GiB, losses {losses}; "
        f"files {files}; restore of checkpoint-4 equals the live state {restored}; adapter merge "
        f"card vs CPU max {ulps:.2f} bf16 ulps, equal to the live weights {live_equal}, "
        f"{moved} of {len(keys)} weights moved; launches {counts}; K1 launches a step by "
        f"kernel and shape {json.dumps(per_step)}; backward measured {sorted(measured.items())}, "
        f"reckoned {sorted(expected.items())}")
    if not all(math.isfinite(x) for x in losses) or len(losses) != TRAIN_CLI_STEPS:
        raise PhaseError(f"losses {losses}")
    if not all(files.values()):
        raise PhaseError(f"the run did not write {[k for k, v in files.items() if not v]}")
    if not restored:
        raise PhaseError("checkpoint-4 does not restore to the live state")
    if ulps > 1.0 or not live_equal or not moved:
        raise PhaseError(f"adapter merge: card vs CPU {ulps:.2f} bf16 ulps (<= 1), equal to the "
                         f"live weights {live_equal}, {moved} weights moved")
    if counts.get("flash_sdpa_reference") or counts.get("flash_sdpa_bwd_reference"):
        raise PhaseError(f"a plain flash version ran on the card: {counts}")
    if measured != expected:
        raise PhaseError(f"K1 backward launches {measured} differ from the reckoned {expected}")
    checked = {_shape_key(row) for row in K1_SHAPES + TRAIN_K1_SHAPES}
    bwd_shapes = {k[1:] for k in measured}
    if not set(fwd_by_shape) <= checked or not bwd_shapes <= checked:
        raise PhaseError(f"K1 ran at shapes {sorted(set(fwd_by_shape) | bwd_shapes)}; the kernel "
                         f"phase checks {sorted(checked)}")
    return dict(step_s=step_s, step1_s=step_s[0], steps_2_on_s=sum(later) / len(later),
                split_s=split_mean, step1_split_s=splits[0],
                wall_s=wall_s, peak_alloc_gib=peak_gib, losses=losses, adapted=n_pairs,
                factor_params=n_factor, merge_max_bf16_ulps=ulps, launches=counts,
                launches_per_step=per_step,
                fwd_launches_by_shape=[[*k, n] for k, n in sorted(fwd_by_shape.items())],
                bwd_launches_by_shape=[[*k, n] for k, n in sorted(measured.items())])


CLI_STEPS = 12
# the CLI's flags of cli_full: DPM-Solver++ 12 steps, save_memory (K2 is set apart)
CLI_FULL_ARGV = ["--reference_image_path", "synthetic", "--audio_path", "synthetic",
                 "--sampler", "dpmpp_2m", "--num_inference_steps", str(CLI_STEPS),
                 "--save_gpu_memory"]

def cli_full_phase(torch) -> dict:
    """The inference CLI on the card: build_pipeline with the CLI's defaults
    (no checkpoint exists here, so each module keeps its seeded random
    weights), then generate with --sampler dpmpp_2m --num_inference_steps 12
    --save_gpu_memory, K2 on, median filter and YUV420 planes, on 44
    synthetic 512x512 frames; the inputs stand in for prepare_inputs, which
    needs cv2. A second, 1-step call without save_memory brings the released
    modules back to the card."""
    from vexpress_torch.cli import infer
    from vexpress_torch.ops import flash, launches
    from vexpress_torch.pipelines.context import compute_context_windows
    from vexpress_torch.tools.common import PeakSplit

    args = infer.parse_args(CLI_FULL_ARGV)
    size, frames, ctx = args.image_width, FULL_FRAMES, args.context_frames
    ref, kps, wave = synthetic_inputs(size, size, frames, seed=1)
    inputs = dict(reference_image=ref, kps_images=kps, audio=wave, video_length=frames)
    torch.cuda.reset_peak_memory_stats()
    resident_gib = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    pipe = infer.build_pipeline(args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    nonfinite = []

    def watch(name):
        def hook(_mod, _inp, out):
            if not bool(torch.isfinite(out).all()):
                nonfinite.append(name)
        return hook

    hooks = [pipe.denoising_unet.register_forward_hook(watch("denoising_unet")),
             pipe.vae.decoder.register_forward_hook(watch("vae.decoder"))]
    split = PeakSplit(pipe)
    flash.FLASH_LITE = True
    try:
        launches.reset()
        t0 = time.perf_counter()
        planes = infer.generate(pipe, inputs, args, output_yuv420=True)
        run_s = time.perf_counter() - t0
        KEPT["cli_full_planes"] = planes
        counts = {k: n for k, n in launches.counts.items() if n}
        by_shape = {k[1:]: n for k, n in launches.shapes.items() if k[0] == "flash_lite_fwd"}
        peaks = split.finish()
        peak_gib = max(peaks.values())
        timings, released = dict(pipe.timings), pipe.last_released_cond_mib
        off_card = sorted(pipe.released)
        again = infer.parse_args(["--reference_image_path", "synthetic", "--audio_path",
                                  "synthetic", "--sampler", "dpmpp_2m",
                                  "--num_inference_steps", "1"])
        t0 = time.perf_counter()
        infer.generate(pipe, inputs, again, output_yuv420=True)
        again_s = time.perf_counter() - t0
    finally:
        flash.FLASH_LITE = False
        for h in hooks:
            h.remove()
    comps = pipe.components()
    back = all(p.is_cuda for name in pipe.RELEASABLE_COND_MODULES
               for p in comps[name].parameters())
    n_windows = compute_context_windows(frames, ctx, args.context_overlap)[0].shape[0]
    expected = expected_flash_launches(pipe.m.unet_config, size // 8, size // 8, ctx,
                                       CLI_STEPS * n_windows)
    log(f"[cli_full] build_pipeline {build_s:.1f} s; generate ({pipe.m.dtype}, {size}x{size}, "
        f"{frames} frames, {n_windows} windows, DPM-Solver++ {CLI_STEPS} steps, save_memory, K2) "
        f"{run_s:.1f} s, phases {json.dumps(timings)}, peak {peak_gib:.2f} GiB (by stretch "
        f"{json.dumps(peaks)}; {resident_gib:.2f} GiB allocated before set-up), released "
        f"{released:.1f} MiB ({off_card} on the host after the call), launches {counts} "
        f"(expected flash_lite_fwd {expected}), by (B, Lq, Lk, D) {by_shape}; second 1-step "
        f"call {again_s:.1f} s, modules back on the card {back}")
    y, u, v = planes
    want = ((frames, size, size), (frames, size // 2, size // 2), (frames, size // 2, size // 2))
    if tuple(x.shape for x in planes) != want or any(str(x.dtype) != "uint8" for x in planes):
        raise PhaseError(f"planes {[(x.shape, x.dtype) for x in planes]}, expected {want} uint8")
    if nonfinite:
        raise PhaseError(f"non-finite values out of {sorted(set(nonfinite))}")
    if counts != {"flash_lite_fwd": expected}:
        raise PhaseError(f"launches {counts}; expected flash_lite_fwd {expected} and nothing else")
    checked = {_shape_key(row) for row in K1_SHAPES}
    if set(by_shape) != checked:
        raise PhaseError(f"K2 ran at shapes {sorted(by_shape)}; the kernel phase checks "
                         f"{sorted(checked)}")
    if released <= 0 or off_card != sorted(pipe.RELEASABLE_COND_MODULES) or not back:
        raise PhaseError(f"save_memory: released {released} MiB, {off_card} on the host, "
                         f"back on the card {back}")
    return dict(lite_launches=counts["flash_lite_fwd"], expected_launches=expected,
                lite_launches_by_shape=[[*key, n] for key, n in sorted(by_shape.items())],
                build_s=build_s, generate_s=run_s, phases_s=timings, peak_alloc_gib=peak_gib,
                peak_by_stretch_gib=peaks, resident_before_gib=resident_gib,
                released_mib=released, second_call_s=again_s, steps=CLI_STEPS, frames=frames,
                windows=n_windows, y_std=float(y.std()))


TOOLS_CLIP = ["--frames", str(FULL_FRAMES), "--steps", "2"]
# each measurement tool at a reduced size: (tool, argv, K2 on)
TOOLS_RUNS = [
    ("unet_step_flops", [], False),
    ("profile_step", ["--reps", "2"], False),
    ("bench_window_step", ["--frames", str(FULL_FRAMES), "--reps", "2"], False),
    ("bench_decode", ["--chunks", "4", "8", "--reps", "1"], False),
    ("microbench_ops", ["--reps", "2"], False),
    ("bench_blocks", ["--reps", "1"], False),
    ("bench_perf_table", ["--reps", "1"], False),
    ("profile_train_step", ["--reps", "1"], False),
    ("bench_savemem", TOOLS_CLIP, True),  # its window_group 2 row: K1_G2_SHAPES
    ("bench_savemem_overhead", TOOLS_CLIP, True),
    ("bench_long_sampler", TOOLS_CLIP, True),
    ("train_convergence_demo", ["--steps", "4", "--stages", "stage_2"], False),
]


def _tool_numbers(rec):
    if isinstance(rec, dict):
        for v in rec.values():
            yield from _tool_numbers(v)
    elif isinstance(rec, (list, tuple)):
        for v in rec:
            yield from _tool_numbers(v)
    elif isinstance(rec, (int, float)) and not isinstance(rec, bool):
        yield rec


def tools_phase(torch) -> dict:
    """Each measurement tool of vexpress_torch/tools/ through its main() on
    the card at a reduced size (TOOLS_RUNS; the clip tools under K2, as
    cli_full), and psnr on two stacks. Fails on a non-finite field, an
    out-of-memory row, a non-finite UNet or decoder output, a plain flash
    version run, K1 or K2 at a shape the kernel phase does not check, or a
    card FLOP count that differs from the one from shapes alone."""
    import importlib

    import numpy as np
    from vexpress_torch.ops import flash, launches
    from vexpress_torch.tools import psnr, unet_step_flops

    # shapes alone first: the fake tensors take the plain attention path
    meta = unet_step_flops.main(["--device", "meta"])
    launches.reset()
    out, wall = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv, lite in TOOLS_RUNS:
            if name == "train_convergence_demo":
                argv = argv + ["--out", str(pathlib.Path(tmp) / "convergence")]
            tool = importlib.import_module(f"vexpress_torch.tools.{name}")
            gc.collect()
            torch.cuda.empty_cache()
            flash.FLASH_LITE = lite
            t0 = time.perf_counter()
            try:
                out[name] = tool.main(argv)
            finally:
                flash.FLASH_LITE = False
            wall[name] = time.perf_counter() - t0
        a = np.random.default_rng(0).uniform(size=(4, 64, 64, 3)).astype(np.float32)
        np.save(pathlib.Path(tmp) / "a.npy", a)
        np.save(pathlib.Path(tmp) / "b.npy", np.clip(a + 0.01, 0, 1))
        stacks = [str(pathlib.Path(tmp) / f) for f in ("a.npy", "b.npy")]
        out["psnr"] = psnr.main(stacks)
    counts = {k: n for k, n in launches.counts.items() if n}
    ran = {k for k in launches.shapes if k[0] in ("flash_fwd", "flash_lite_fwd")}
    checked = {_shape_key(row) for row in K1_SHAPES + K1_G2_SHAPES + TRAIN_K1_SHAPES}
    bad = [k for k in out if not all(math.isfinite(x) for x in _tool_numbers(out[k]))]
    ooms = [r["chunk"] for r in out["bench_decode"] if r["oom"]]
    nonfinite = [k for k, rec in out.items() for r in (rec if isinstance(rec, list) else [rec])
                 if isinstance(r, dict) and r.get("nonfinite")]
    card_flops, meta_flops = (out["unet_step_flops"]["window_step_gflops"],
                              meta["window_step_gflops"])
    log(f"[tools] wall by tool {json.dumps(wall)}; launches {counts}; K1/K2 shapes "
        f"{sorted(ran)}; window step {card_flops:.1f} GFLOP on the card, {meta_flops:.1f} from "
        f"shapes; profile_train_step {out['profile_train_step']['median_step_s']:.3f} s/step, "
        f"bench_window_step {out['bench_window_step']['unet_call_ms']:.1f} ms a UNet call")
    if bad:
        raise PhaseError(f"non-finite fields out of {bad}")
    if ooms:
        raise PhaseError(f"bench_decode ran out of memory at chunks {ooms}")
    if nonfinite:
        raise PhaseError(f"non-finite UNet or decoder outputs in {nonfinite}")
    plain = {k: n for k, n in counts.items() if k.endswith("_reference")}
    if plain:
        raise PhaseError(f"a plain flash version ran on the card: {plain}")
    if not {(b, lq, lk, d) for _, b, lq, lk, d in ran} <= checked or not ran:
        raise PhaseError(f"K1/K2 ran at shapes {sorted(ran)}; the kernel phase checks "
                         f"{sorted(checked)}")
    if card_flops != meta_flops:
        raise PhaseError(f"the card's FLOP count {card_flops} differs from the shapes' "
                         f"{meta_flops}")
    return dict(wall_s=wall, launches=counts, window_step_gflops=card_flops,
                profile_train_step={k: out["profile_train_step"][k] for k in
                                    ("median_step_s", "split_s", "train_step_gflop", "mfu")},
                window_unet_call_ms=out["bench_window_step"]["unet_call_ms"],
                long_sampler_e2e_s=out["bench_long_sampler"]["e2e_s"])


# ------------------------------------------------------------ two-rank phases

DIST_RANKS = 2
DIST_TIMEOUT_S = 900  # a two-rank phase's processes end within this, or the phase fails


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank, world, port, backend, env, out_dir, job, args):
    """One rank of run_ranks: sets `env`, joins the group on the card, runs
    job(torch, mesh, *args), saves what it returns."""
    import os

    os.environ.update(env)
    import torch
    import torch.distributed as dist
    from vexpress_torch.parallel import mesh as pmesh

    pmesh.initialize_distributed(f"127.0.0.1:{port}", world, rank, backend=backend)
    try:
        result = job(torch, pmesh.create_mesh(), *args)
        torch.save(result, pathlib.Path(out_dir) / f"{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(torch, job, world: int, *args, backend="gloo", env=None,
              timeout: float = DIST_TIMEOUT_S):
    """job(torch, mesh, *args) in `world` spawned processes on the card, one
    rank each, joined over localhost (gloo, so that several ranks share the
    one card; backend=None: NCCL for CUDA tensors), with `env` added to
    their environment. Returns their results by rank. A rank that raises, or
    a job that outlives `timeout`, kills every rank and fails the phase."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as out_dir:
        ctx = mp.start_processes(_rank_entry, args=(world, _free_port(), backend, env or {},
                                                    out_dir, job, args),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise PhaseError(f"{job.__name__} on {world} ranks outlived {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(pathlib.Path(out_dir) / f"{r}.pt", weights_only=False)
                for r in range(world)]


def param_digest(torch, tensors) -> list:
    """An exact integer checksum of each tensor's bits: the sum of its words
    and their sum weighted by position, in int64 on the tensor's device."""
    out = []
    for t in tensors:
        word = {2: torch.int16, 4: torch.int32}[t.element_size()]
        x = t.detach().reshape(-1).view(word).long()
        pos = torch.arange(1, x.numel() + 1, device=x.device)
        out.append((int(x.sum()), int((x * pos).sum())))
    return out


def _card_pipeline(torch, state_path):
    """parity_setup's reduced fp32 models on the card, TF32 off, with the
    weights saved at `state_path`."""
    from vexpress_torch.pipelines import VExpressPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pipe = VExpressPipeline(reduced_models(torch), device="cuda")
    state = torch.load(state_path, weights_only=True)
    for name, mod in pipe.components().items():
        mod.load_state_dict(state[name])
    return pipe


def _sharded_parity_job(torch, mesh, state_path, kw):
    from vexpress_torch.ops import launches

    pipe = _card_pipeline(torch, state_path)
    launches.reset()
    latents = pipe(mode="sharded", mesh=mesh, return_latents=True, **kw)
    torch.cuda.synchronize()
    return dict(latents=latents, launches={k: n for k, n in launches.counts.items() if n})


def _dp_steps(torch, pipe, cfg, batch, mesh, steps: int, seed: int):
    """`steps` train steps of build_train_step on this rank's rows of
    `batch` (all of them without a mesh): the losses, the gradients the
    optimizer stepped with at step 1 (on the CPU), each step's digest of
    the trainable tensors, and the tensors at the end (on the CPU)."""
    from vexpress_torch.train import TrainState, build_train_step, make_optimizer

    optimizer, _ = make_optimizer(pipe.components(), cfg, mesh)
    step_fn, _ = build_train_step(pipe, cfg, optimizer)
    b = batch["target_images"].shape[0] // (1 if mesh is None else mesh.size)
    r = 0 if mesh is None else mesh.rank
    mine = {k: v[r * b:(r + 1) * b].to(pipe.device) for k, v in batch.items()}
    grads, inner_step = [], optimizer.inner.step

    def spy():
        if not grads:
            grads.extend(p.grad.detach().cpu() for p in optimizer.params)
        return inner_step()

    optimizer.inner.step = spy
    state, gen = TrainState(pipe.components(), optimizer), torch.Generator().manual_seed(seed)
    losses, digests = [], []
    for _ in range(steps):
        state, metrics = step_fn(state, mine, gen)
        losses.append(metrics["loss"].cpu())
        digests.append(param_digest(torch, optimizer.params))
    optimizer.inner.step = inner_step
    return dict(losses=losses, grads=grads, digests=digests,
                params=[p.detach().cpu() for p in optimizer.params],
                state_tensors=sum(1 for p in optimizer.params if optimizer.inner.state[p]))


def _dp_parity_job(torch, mesh, state_path, cfg, batch):
    from vexpress_torch.ops import launches

    pipe = _card_pipeline(torch, state_path)
    launches.reset()
    out = _dp_steps(torch, pipe, cfg, batch, mesh, steps=2, seed=5)
    torch.cuda.synchronize()
    return dict(out, launches={k: n for k, n in launches.counts.items() if n})


def _world1_job(torch, mesh, state_path, kw, cfg, batch):
    """On a one-rank NCCL group: a streamed and a sharded pipeline call; 2
    plain train steps twice (does the card's training step reproduce as it
    is?); then, with PyTorch's deterministic algorithms, 2 plain train steps
    twice and 2 data-parallel ones; each run from the same weights."""
    import torch.distributed as dist

    pipe = _card_pipeline(torch, state_path)
    streamed = pipe(return_latents=True, **kw)
    sharded = pipe(mode="sharded", mesh=mesh, return_latents=True, **kw)

    def two_steps(m):
        return _dp_steps(torch, _card_pipeline(torch, state_path), cfg, batch, m, steps=2, seed=5)

    eager = [two_steps(None), two_steps(None)]
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True)
    plain = [two_steps(None), two_steps(None)]
    return dict(streamed=streamed, sharded=sharded, backend=str(dist.get_backend()),
                eager=eager, plain=plain, dp=two_steps(mesh))


def dist_parity_phase(torch) -> dict:
    """The data-parallel path on parity_setup's reduced fp32 models, on the
    card: (a) the pipeline in mode="sharded" on 2 ranks against the same call
    streamed in this process (the CLI parity call's settings with DDIM);
    (b) 2 stage-3 train steps on 2 ranks with batch 1 each against the
    batch-2 step on the CPU with the same draws; (c) a one-rank group on
    NCCL, whose sharded call must equal the streamed call bitwise, and whose
    data-parallel steps the plain steps, under PyTorch's deterministic
    algorithms (whether the plain steps reproduce without them is logged)."""
    import numpy as np
    from vexpress_torch.train import TrainConfig, build_train_step, make_optimizer, sample_draws

    card, cpu = card_and_cpu_pipelines(torch, seed=41)
    kw = parity_call_kwargs()
    workdir = tempfile.TemporaryDirectory(prefix="dist_parity_")
    state_path = str(pathlib.Path(workdir.name) / "state.pt")
    torch.save({n: m.state_dict() for n, m in card.components().items()}, state_path)

    # (a) the window-parallel pipeline
    streamed = card(return_latents=True, **kw)
    t0 = time.perf_counter()
    ranks = run_ranks(torch, _sharded_parity_job, DIST_RANKS, state_path, kw)
    sharded_s = time.perf_counter() - t0
    lat = [r["latents"] for r in ranks]
    ranks_equal = all(np.array_equal(x, lat[0]) for x in lat)
    sharded_err = float(np.abs(lat[0] - streamed).max())
    sharded_ok = bool(np.allclose(lat[0], streamed, atol=1e-5, rtol=1e-5))
    sharded_launches = [r["launches"] for r in ranks]

    # (b) the data-parallel step against the batch-2 step on the CPU
    size, frames = TRAIN_PARITY_SIZE, TRAIN_PARITY_FRAMES
    lat_hw = size // 8
    rows = [synthetic_train_batch(torch, size, frames, 16, seed=4 + r, device="cpu")
            for r in range(DIST_RANKS)]
    batch = {k: torch.cat([row[k] for row in rows]) for k in rows[0]}
    cfg = TrainConfig.stage("stage_3", num_frames=frames, learning_rate=1e-5, adam_epsilon=1e-3,
                            lip_loss_weight=2.0, max_grad_norm=1e9)
    t0 = time.perf_counter()
    ranks = run_ranks(torch, _dp_parity_job, DIST_RANKS, state_path, cfg, batch)
    dp_s = time.perf_counter() - t0
    opt, _ = make_optimizer(cpu.components(), cfg)
    _, loss_fn = build_train_step(cpu, cfg, opt)
    draws = sample_draws(torch.Generator().manual_seed(5), cfg, DIST_RANKS, frames,
                         (lat_hw, lat_hw))
    loss = loss_fn(cpu.components(), batch, draws)
    loss.backward()
    cpu_loss = float(loss.detach())
    loss_rel = max(abs(float(r["losses"][0]) - cpu_loss) / abs(cpu_loss) for r in ranks)
    cpu_grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in opt.params]
    grad_rel = max(float((g - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
                   for g, ref in zip(ranks[0]["grads"], cpu_grads))
    dp_equal = (all(r["digests"] == ranks[0]["digests"] for r in ranks)
                and all(torch.equal(a, b) for r in ranks
                        for a, b in zip(r["params"], ranks[0]["params"])))
    owned = [r["state_tensors"] for r in ranks]
    dp_launches = [r["launches"] for r in ranks]

    # (c) one rank over NCCL
    t0 = time.perf_counter()
    (one,) = run_ranks(torch, _world1_job, 1, state_path, kw, cfg,
                       {k: v[:1] for k, v in batch.items()}, backend=None,
                       env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})  # deterministic cuBLAS
    world1_s = time.perf_counter() - t0
    w1_pipe = bool(np.array_equal(one["sharded"], one["streamed"]))

    def same_steps(a, b):
        return (all(torch.equal(x, y) for x, y in zip(a["losses"], b["losses"]))
                and all(torch.equal(x, y) for x, y in zip(a["params"], b["params"])))

    w1_eager = same_steps(*one["eager"])
    w1_control = same_steps(*one["plain"])
    w1_steps = same_steps(one["dp"], one["plain"][0])
    workdir.cleanup()
    log(f"[dist_parity] (a) sharded on {DIST_RANKS} ranks (gloo, one card) against streamed: "
        f"max|d| {sharded_err:.3e} (allclose 1e-5: {sharded_ok}), ranks bitwise equal "
        f"{ranks_equal}, launches by rank {sharded_launches}, {sharded_s:.1f} s; (b) stage-3 "
        f"data-parallel step against the CPU batch-2 step: loss rel {loss_rel:.2e}, worst "
        f"gradient max|d|/max|g| {grad_rel:.2e}, params after 2 steps equal across ranks "
        f"{dp_equal}, tensors with state by rank {owned} of {len(opt.params)}, launches by rank "
        f"{dp_launches}, {dp_s:.1f} s; (c) one rank over {one['backend']}: sharded = streamed "
        f"{w1_pipe}; plain steps = plain steps again {w1_eager}; deterministic algorithms "
        f"on: plain steps = plain steps again "
        f"{w1_control}, data-parallel steps = plain steps {w1_steps}, {world1_s:.1f} s")
    if not (sharded_ok and ranks_equal):
        raise PhaseError(f"sharded against streamed: max|d| {sharded_err:.3e}, ranks equal "
                         f"{ranks_equal}")
    if any(not r.get("flash_fwd") or r.get("flash_sdpa_reference") for r in sharded_launches):
        raise PhaseError(f"the sharded ranks did not all run K1: {sharded_launches}")
    if loss_rel > 1e-5 or grad_rel > 1e-4 or not dp_equal:
        raise PhaseError(f"data-parallel step: loss rel {loss_rel:.2e} (<= 1e-5), gradient "
                         f"{grad_rel:.2e} (<= 1e-4), ranks equal {dp_equal}")
    if sum(owned) != len(opt.params) or min(owned) == 0:
        raise PhaseError(f"optimizer state on {owned} tensors by rank, {len(opt.params)} trained")
    if not (w1_pipe and w1_control and w1_steps):
        raise PhaseError(f"one rank over NCCL: sharded = streamed {w1_pipe}, plain steps "
                         f"reproduce {w1_control}, data-parallel steps = plain {w1_steps}")
    return dict(sharded_max_abs_err=sharded_err, sharded_ranks_equal=ranks_equal,
                sharded_launches=sharded_launches, sharded_s=sharded_s, dp_loss_rel=loss_rel,
                dp_worst_grad_rel=grad_rel, dp_ranks_equal=dp_equal, dp_state_tensors=owned,
                dp_launches=dp_launches, dp_s=dp_s, world1_backend=one["backend"],
                world1_sharded_equal=w1_pipe, world1_eager_repeats=w1_eager,
                world1_plain_repeats=w1_control,
                world1_steps_equal=w1_steps, world1_s=world1_s)


def _sharded_job(torch, mesh, argv, frames):
    """The inference CLI's build_pipeline and generate on this rank, K2 on:
    the planes (rank 0), the final latents, times, peak and launches."""
    from vexpress_torch.cli import infer
    from vexpress_torch.ops import flash, launches

    args = infer.parse_args(argv)
    size = args.image_width
    ref, kps, wave = synthetic_inputs(size, size, frames, seed=1)
    inputs = dict(reference_image=ref, kps_images=kps, audio=wave, video_length=frames)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = infer.build_pipeline(args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    final, denoise = {}, pipe._denoise

    def keep_latents(*a, **k):
        final["latents"] = denoise(*a, **k)
        return final["latents"]

    pipe._denoise = keep_latents
    flash.FLASH_LITE = True
    launches.reset()
    t0 = time.perf_counter()
    planes = infer.generate(pipe, inputs, args, output_yuv420=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    return dict(planes=planes, latents=final["latents"].cpu().numpy(), build_s=build_s,
                generate_s=run_s, phases_s=dict(pipe.timings),
                peak_alloc_gib=torch.cuda.max_memory_allocated() / 2**30,
                launches={k: n for k, n in launches.counts.items() if n},
                lite_by_shape={k[1:]: n for k, n in launches.shapes.items()
                               if k[0] == "flash_lite_fwd"})


def sharded_phase(torch) -> dict:
    """The inference CLI at cli_full's settings plus --do_multi_devices_inference
    on 2 ranks sharing the card (gloo): 44 synthetic 512x512 frames, 2
    windows, one a rank. Rank 0's video against cli_full's (PSNR of the
    YUV420 planes > 45 dB), the ranks' latents bitwise equal, and each
    rank's K2 launches against those reckoned for its windows."""
    import numpy as np
    from vexpress_torch.models import UNetConfig
    from vexpress_torch.parallel.mesh import Mesh, local_window_tables
    from vexpress_torch.pipelines.context import compute_context_windows

    frames = FULL_FRAMES
    argv = CLI_FULL_ARGV + ["--do_multi_devices_inference"]
    t0 = time.perf_counter()
    ranks = run_ranks(torch, _sharded_job, DIST_RANKS, argv, frames)
    wall_s = time.perf_counter() - t0
    windows, inv = compute_context_windows(frames, FULL_CONTEXT, FULL_OVERLAP)
    expected = [expected_flash_launches(
        UNetConfig(), FULL_SIZE // 8, FULL_SIZE // 8, FULL_CONTEXT,
        CLI_STEPS * local_window_tables(windows, inv, Mesh(None, r, DIST_RANKS))[0].shape[0])
        for r in range(DIST_RANKS)]
    latents_equal = all(np.array_equal(r["latents"], ranks[0]["latents"]) for r in ranks)
    ref = KEPT["cli_full_planes"]
    got = ranks[0]["planes"]
    flat = [np.concatenate([p.reshape(-1) for p in planes]).astype(np.float64) / 255.0
            for planes in (got, ref)]
    psnr = _psnr(flat[0], flat[1])
    max_diff = int(max(np.abs(a.astype(np.int16) - b.astype(np.int16)).max()
                       for a, b in zip(got, ref)))
    lite = [r["launches"].get("flash_lite_fwd", 0) for r in ranks]
    log(f"[sharded] cli.infer with --do_multi_devices_inference on {DIST_RANKS} ranks (gloo, one "
        f"card), cli_full's settings: wall {wall_s:.1f} s; by rank build "
        f"{[round(r['build_s'], 1) for r in ranks]} s, generate "
        f"{[round(r['generate_s'], 1) for r in ranks]} s, phases "
        f"{[r['phases_s'] for r in ranks]}, peak {[round(r['peak_alloc_gib'], 2) for r in ranks]} "
        f"GiB, K2 launches {lite} (reckoned {expected}), launches "
        f"{[r['launches'] for r in ranks]}; "
        f"rank 1's output {ranks[1]['planes']}; latents bitwise equal across ranks "
        f"{latents_equal}; rank 0's planes against cli_full's: PSNR {psnr:.2f} dB, max|d| "
        f"{max_diff}")
    if got is None or ranks[1]["planes"] is not None:
        raise PhaseError("rank 0 must return the video and rank 1 nothing")
    if not latents_equal:
        raise PhaseError("the ranks' latents differ")
    if not psnr > 45.0:
        raise PhaseError(f"rank 0's video against cli_full's: PSNR {psnr:.2f} dB (needs > 45)")
    if lite != expected or any(set(r["launches"]) != {"flash_lite_fwd"} for r in ranks):
        raise PhaseError(f"launches by rank {[r['launches'] for r in ranks]}; K2 reckoned "
                         f"{expected} and nothing else")
    checked = {_shape_key(row) for row in K1_SHAPES}
    if any(not set(r["lite_by_shape"]) <= checked for r in ranks):
        raise PhaseError(f"K2 ran at shapes the kernel phase does not check: "
                         f"{[sorted(r['lite_by_shape']) for r in ranks]}")
    return dict(wall_s=wall_s, build_s=[r["build_s"] for r in ranks],
                generate_s=[r["generate_s"] for r in ranks],
                phases_s=[r["phases_s"] for r in ranks],
                peak_alloc_gib=[r["peak_alloc_gib"] for r in ranks], lite_launches=lite,
                expected_launches=expected, latents_equal=latents_equal, psnr_db=psnr,
                max_abs_diff=max_diff,
                lite_launches_by_shape=[[[*k, n] for k, n in sorted(r["lite_by_shape"].items())]
                                        for r in ranks])


TRAIN_DP_STEPS = 3


def _train_dp_job(torch, mesh, cfg, steps):
    """The training CLI's train() on this rank with synthetic batches (its
    own rows of each global batch): losses, step times and split, the
    collectives' times, a digest of the trainable tensors after each step,
    the optimizer-state bytes it keeps, peak and launches."""
    import hashlib

    from vexpress_torch import train as vt
    from vexpress_torch.cli import train as train_cli
    from vexpress_torch.ops import launches
    from vexpress_torch.train import train_step as vts
    from vexpress_torch.train.step_split import StepSplit

    size, frames = cfg["data"]["train_width"], cfg["data"]["num_frames"]
    cfg_path = pathlib.Path(cfg["output_dir"]) / f"stage_2_rank{mesh.rank}.json"
    cfg_path.write_text(json.dumps(cfg))
    args = train_cli.parse_args(["--config", str(cfg_path), "--dtype", "bf16",
                                 "--max_steps_override", str(steps)])

    def batches():
        for i in range(steps):
            batch = synthetic_train_batch(torch, size, frames, 768,
                                          seed=3 + mesh.size * i + mesh.rank, device="cpu")
            yield {k: v.numpy() for k, v in batch.items()}

    split, digests, comm = [], [], []
    real_build = vt.build_train_step

    def timed_build(pipeline, tcfg, optimizer, *a, **kw):
        step_fn, loss_fn = real_build(pipeline, tcfg, optimizer, *a, **kw)
        split.append(StepSplit(pipeline.denoising_unet, optimizer))

        def timed_step(*step_args):
            split[0].begin()
            comm.append({})
            out = step_fn(*step_args)
            digests.append(param_digest(torch, optimizer.params))
            return out

        return timed_step, loss_fn

    def timed(name, fn):
        def run(tensors, *a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(tensors, *a)
            torch.cuda.synchronize()
            if comm and len(tensors) > 1:  # the gradients' all-reduce, the owners' broadcast
                comm[-1][name] = comm[-1].get(name, 0.0) + time.perf_counter() - t0
            return out
        return run

    real_reduce, real_bcast = vts.all_reduce_mean, vts.broadcast_owned
    vt.build_train_step = timed_build
    vts.all_reduce_mean = timed("all_reduce_s", real_reduce)
    vts.broadcast_owned = timed("broadcast_s", real_bcast)
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    try:
        t0 = time.perf_counter()
        run = train_cli.train(cfg, args, batches())
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        vt.build_train_step = real_build
        vts.all_reduce_mean, vts.broadcast_owned = real_reduce, real_bcast
        for sp in split:
            sp.remove()
    opt = run["state"].optimizer

    def nbytes(v):
        parts = (v.codes, v.scales) if hasattr(v, "codes") else (v,)
        return sum(x.numel() * x.element_size() for x in parts)

    state_bytes = sum(nbytes(v) for p in opt.owned() for v in opt.inner.state[p].values())
    sha = hashlib.sha256()
    for p in opt.params:
        sha.update(p.detach().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return dict(losses=run["losses"], step_s=run["step_s"], wall_s=wall_s,
                splits=split[0].splits(), comm_s=comm, digests=digests, sha256=sha.hexdigest(),
                state_bytes=state_bytes, owned=len(opt.owned()), trained=len(opt.params),
                trained_params=sum(p.numel() for p in opt.params),
                peak_alloc_gib=torch.cuda.max_memory_allocated() / 2**30,
                launches={k: n for k, n in launches.counts.items() if n},
                by_shape=dict(launches.shapes))


def train_dp_phase(torch) -> dict:
    """The training CLI's train() on 2 ranks sharing the card (gloo):
    stage_2() (8-bit Adam, checkpointed UNet), bf16, 20 frames at 512x512,
    batch 1 a rank, TRAIN_DP_STEPS steps, the checkpoint and the trained
    modules' exports at the last. Losses finite, the trainable tensors
    bitwise equal across ranks after every step, each rank's optimizer state
    within 10% of half the whole, each rank's K1 backward launches as
    reckoned for batch 1."""
    import shutil

    from vexpress_torch.cli.train import train_config
    from vexpress_torch.models import UNetConfig

    stage = stage_2()
    with tempfile.TemporaryDirectory(prefix="train_dp_") as out_dir:
        cfg = dict(stage, checkpointing_steps=TRAIN_DP_STEPS,
                   save_all=False, output_dir=out_dir, seed=0)
        t0 = time.perf_counter()
        ranks = run_ranks(torch, _train_dp_job, DIST_RANKS, cfg, TRAIN_DP_STEPS)
        wall_s = time.perf_counter() - t0
        out = pathlib.Path(out_dir)
        files = sorted(str(f.relative_to(out)) for f in out.rglob("*") if f.is_file()
                       and not f.name.endswith(".json"))
        written_gib = sum(f.stat().st_size for f in out.rglob("*") if f.is_file()) / 2**30
        free_gib = shutil.disk_usage(out_dir).free / 2**30
    size, frames = stage["data"]["train_width"], stage["data"]["num_frames"]
    lat = size // 8
    per_step = expected_bwd_launches(train_config(stage, DIST_RANKS), UNetConfig(), lat, lat,
                                     frames)
    expected = {k: n * TRAIN_DP_STEPS for k, n in per_step.items()}
    measured = [{k: n for k, n in r["by_shape"].items() if k[0].startswith("flash_bwd")}
                for r in ranks]
    total = sum(r["state_bytes"] for r in ranks)
    share = [r["state_bytes"] / (total / DIST_RANKS) for r in ranks]
    digests_equal = all(r["digests"] == ranks[0]["digests"] for r in ranks)
    sha_equal = len({r["sha256"] for r in ranks}) == 1
    losses = ranks[0]["losses"]
    later = {r_i: r["step_s"][1:] for r_i, r in enumerate(ranks)}
    split_mean = [{k: sum(s[k] for s in r["splits"][1:]) / (TRAIN_DP_STEPS - 1)
                   for k in r["splits"][0]} for r in ranks]
    comm_mean = [{k: sum(c.get(k, 0.0) for c in r["comm_s"][1:]) / (TRAIN_DP_STEPS - 1)
                  for k in ("all_reduce_s", "broadcast_s")} for r in ranks]
    log(f"[train_dp] cli.train.train on {DIST_RANKS} ranks (gloo, one card), stage 2, bf16, "
        f"{size}x{size}, {frames} frames, batch 1 a rank (global {DIST_RANKS}), "
        f"{TRAIN_DP_STEPS} steps, {ranks[0]['trained_params'] / 1e6:.1f} M trainable params in "
        f"{ranks[0]['trained']} tensors: wall {wall_s:.1f} s (train() by rank "
        f"{[round(r['wall_s'], 1) for r in ranks]}); step s by rank "
        f"{[[round(x, 3) for x in r['step_s']] for r in ranks]}; split of steps 2-"
        f"{TRAIN_DP_STEPS} by rank {json.dumps(split_mean)}, all-reduce and broadcast in it "
        f"{json.dumps(comm_mean)}; step 1 split {json.dumps([r['splits'][0] for r in ranks])}; "
        f"peak by rank {[round(r['peak_alloc_gib'], 2) for r in ranks]} GiB; losses {losses} "
        f"(rank 1 {ranks[1]['losses']}); digests equal after every step {digests_equal}, "
        f"final sha256 equal {sha_equal}; optimizer state by rank "
        f"{[r['state_bytes'] for r in ranks]} bytes ({[round(x, 4) for x in share]} of half), "
        f"tensors owned {[r['owned'] for r in ranks]}; files {files} ({written_gib:.2f} GiB, "
        f"{free_gib:.0f} GiB free there); launches by rank {[r['launches'] for r in ranks]}; "
        f"backward by rank {[sorted(m.items()) for m in measured]}, reckoned a rank "
        f"{sorted(expected.items())}")
    if len(losses) != TRAIN_DP_STEPS or not all(math.isfinite(x) for x in losses) \
            or any(r["losses"] != losses for r in ranks):
        raise PhaseError(f"losses by rank {[r['losses'] for r in ranks]}")
    if not (digests_equal and sha_equal):
        raise PhaseError("the ranks' trainable tensors differ")
    if any(abs(x - 1.0) > 0.1 for x in share) or sum(r["owned"] for r in ranks) != \
            ranks[0]["trained"]:
        raise PhaseError(f"optimizer state by rank {[r['state_bytes'] for r in ranks]} bytes, "
                         f"owned {[r['owned'] for r in ranks]} of {ranks[0]['trained']}")
    if any(m != expected for m in measured):
        raise PhaseError(f"K1 backward launches by rank {measured}, reckoned {expected}")
    checked = {_shape_key(row) for row in K1_SHAPES + TRAIN_K1_SHAPES}
    ran = {k[1:] for r in ranks for k in r["by_shape"]
           if k[0] in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
    if not ran <= checked:
        raise PhaseError(f"K1 ran at shapes {sorted(ran)}; the kernel phase checks "
                         f"{sorted(checked)}")
    if any(r["launches"].get("flash_sdpa_reference") or r["launches"].get(
            "flash_sdpa_bwd_reference") for r in ranks):
        raise PhaseError(f"a plain flash version ran: {[r['launches'] for r in ranks]}")
    want_files = {f"checkpoints/checkpoint-{TRAIN_DP_STEPS}/train_state.pt",
                  f"denoising_unet-{TRAIN_DP_STEPS}.pth", f"motion_module-{TRAIN_DP_STEPS}.pth",
                  f"audio_projection-{TRAIN_DP_STEPS}.pth", "metrics.jsonl"}
    if not want_files <= set(files):
        raise PhaseError(f"the run wrote {files}; expected {sorted(want_files)} among them")
    return dict(wall_s=wall_s, step_s=[r["step_s"] for r in ranks],
                steps_2_on_s=[sum(x) / len(x) for x in later.values()], split_s=split_mean,
                comm_s=comm_mean, step1_split_s=[r["splits"][0] for r in ranks],
                peak_alloc_gib=[r["peak_alloc_gib"] for r in ranks], losses=losses,
                state_bytes=[r["state_bytes"] for r in ranks], state_share_of_half=share,
                owned=[r["owned"] for r in ranks], trained_tensors=ranks[0]["trained"],
                written_gib=written_gib, launches=[r["launches"] for r in ranks],
                bwd_launches_by_shape=[[[*k, n] for k, n in sorted(m.items())] for m in measured],
                fwd_launches_by_shape=[[[*k[1:], n] for k, n in sorted(r["by_shape"].items())
                                        if k[0] == "flash_fwd"] for r in ranks])


def kernels_line(results: dict) -> list:
    """The `kernels` JSON entries: each kernel's launches on the main paths
    (inference `full` and `cli_full`, training `train_full` and `train_cli`,
    and each rank of `sharded` and `train_dp`) and its times summed over the
    main-path shapes at which those runs launched it, one call each."""
    inf_by_shape = {tuple(key): n for *key, n in results["full"]["flash_launches_by_shape"]}
    # the training paths: train_full, train_cli, and each rank of train_dp
    dp = results["train_dp"]
    train_paths = ("train_full", "train_cli") + tuple(f"train_dp_rank{i}"
                                                      for i in range(len(dp["launches"])))
    counts = {p: results[p]["launches"] for p in train_paths[:2]}
    counts.update({f"train_dp_rank{i}": c for i, c in enumerate(dp["launches"])})
    fwd_rows_by = {p: results[p]["fwd_launches_by_shape"] for p in train_paths[:2]}
    fwd_rows_by.update({f"train_dp_rank{i}": c for i, c in enumerate(dp["fwd_launches_by_shape"])})
    bwd_rows_by = {p: results[p]["bwd_launches_by_shape"] for p in train_paths[:2]}
    bwd_rows_by.update({f"train_dp_rank{i}": c for i, c in enumerate(dp["bwd_launches_by_shape"])})
    train_fwd = {p: {tuple(key): n for *key, n in fwd_rows_by[p]} for p in train_paths}
    train_bwd = {p: {tuple(key): n for *key, n in bwd_rows_by[p]} for p in train_paths}
    fwd_rows = results["kernel"]["rows"]
    grad_rows = results["kernel"]["grad_rows"]
    for r in fwd_rows:  # the inference paths run bf16
        r["launches"] = (inf_by_shape.get((r["B"], r["Lq"], r["Lk"], r["D"]), 0)
                         if r["dtype"] == "bfloat16" else 0)
    for r in grad_rows:
        if r["stage"] != 2 or r["latent"] != 64:  # the training paths run stage 2 at 512x512
            continue
        key = (r["B"], r["Lq"], r["Lk"], r["D"])
        r["launches_by_path"] = {p: dict(flash_fwd=train_fwd[p].get(key, 0),
                                         flash_bwd_dkv=train_bwd[p].get(("flash_bwd_dkv",) + key, 0),
                                         flash_bwd_dq=train_bwd[p].get(("flash_bwd_dq",) + key, 0))
                                 for p in train_paths}
        r["launches"] = {k: sum(by[k] for by in r["launches_by_path"].values())
                         for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}

    def entry(name, source, replaces, parts, launches,
              times_are="sums over the main-path shapes at which it ran, one call each",
              **extra):
        """parts: (ms, plain_ms, library_ms, bound_ms, bound_by, max_abs_err) per shape."""
        by = {k: sum(p[3] for p in parts if p[4] == k) for k in ("operations", "bytes")}
        return dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                    max_abs_err=max(p[5] for p in parts), ms=sum(p[0] for p in parts),
                    plain_ms=sum(p[1] for p in parts), library_ms=sum(p[2] for p in parts),
                    bound_ms=sum(p[3] for p in parts), bound_by=max(by, key=by.get),
                    times_are=times_are, **extra)

    main_grad = [r for r in grad_rows if r["main_path"]]
    fwd_parts = ([(r["kernel_ms"], r["plain_ms"], r["library_ms"], r["bound_ms"], r["bound_by"],
                   r["max_abs_err"]) for r in fwd_rows if r["main_path"] and r["launches"]]
                 + [(r["fwd_ms"], r["plain_fwd_ms"], r["sdpa_fwd_ms"], r["bounds"]["fwd"]["ms"],
                     r["bounds"]["fwd"]["by"], r["errors"]["out"]["max_abs_err"])
                    for r in main_grad if r["launches"]["flash_fwd"]])
    fwd_by_path = dict(full=results["full"]["flash_launches"],
                       fused=results["fused"]["ddim"]["launches"],
                       **{p: counts[p].get("flash_fwd", 0) for p in train_paths})
    sources = ["vexpress_torch/csrc/flash_fwd_wgmma.cuh (bf16)",
               "vexpress_torch/csrc/flash_fwd_tf32.cuh (fp32, 3xTF32)",
               "vexpress_torch/csrc/flash_fwd.cu (launches, fp32 split pass)"]
    # the fp32 kernels run off the main path: on the parity phase's models
    parity = results["parity"]
    kernels = [entry("flash_fwd", "vexpress_torch/csrc/flash_fwd_wgmma.cuh",
                     "vexpress_tpu/ops/flash.py:42", fwd_parts, sum(fwd_by_path.values()),
                     sources=sources, launches_by_path=fwd_by_path,
                     fp32_launches_by_path=dict(parity=parity["launches"].get("flash_fwd", 0)),
                     shapes=fwd_rows + [dict(r, kernel="flash_fwd") for r in main_grad])]
    for name, key, grads, lib_line in (
            ("flash_bwd_dkv", "dkv", ("dk", "dv"), ":941 _flash_attention_bwd_dkv"),
            ("flash_bwd_dq", "dq", ("dq",), ":1287 _flash_attention_bwd_dq")):
        parts = [(r[f"{key}_ms"], r["plain_bwd_ms"], r["sdpa_bwd_ms"], r["bounds"][key]["ms"],
                  r["bounds"][key]["by"], max(r["errors"][g]["max_abs_err"] for g in grads))
                 for r in main_grad if r["launches"][name]]
        by_path = {p: counts[p].get(name, 0) for p in train_paths}
        # the fp32 kernels run off the main path: on the parity phases' models
        fp32_by = dict(train_parity=results["train_parity"]["launches"].get(name, 0),
                       lora_parity=results["lora_parity"]["launches"].get(name, 0),
                       **{f"dist_parity_rank{i}": r.get(name, 0)
                          for i, r in enumerate(results["dist_parity"]["dp_launches"])})
        extra = dict(launches_by_path=by_path, fp32_launches_by_path=fp32_by)
        if name == "flash_bwd_dkv":
            extra["split_sum_launches"] = sum(counts[p].get("flash_bwd_dkv_sum", 0)
                                              for p in train_paths)
        kernels.append(entry(
            name, "vexpress_torch/csrc/flash_bwd_wgmma.cuh",
            "vexpress_tpu/ops/flash.py:93, which reaches the library's "
            "jax/experimental/pallas/ops/tpu/flash_attention.py" + lib_line, parts,
            sum(by_path.values()),
            sources=["vexpress_torch/csrc/flash_bwd_wgmma.cuh (bf16)",
                     "vexpress_torch/csrc/flash_bwd_tf32.cuh (fp32, 3xTF32)",
                     "vexpress_torch/csrc/flash_bwd.cu (launches, split sum, fp32 split pass)"],
            plain_is="flash_sdpa_bwd_reference (dq, dk and dv at once)",
            library_is="scaled_dot_product_attention's backward alone (dq, dk and dv at "
                       "once, its own di included), from one saved forward",
            pair_bound_ms=sum(r["bounds"]["pair"]["ms"] for r in main_grad),
            shapes=grad_rows, **extra))
    lite_paths = {"cli_full": results["cli_full"]["lite_launches_by_shape"],
                  **{f"sharded_rank{i}": rows for i, rows in
                     enumerate(results["sharded"]["lite_launches_by_shape"])}}
    lite_by = {p: {tuple(key): n for *key, n in rows} for p, rows in lite_paths.items()}
    lite_rows = results["kernel"]["lite_rows"]
    for r in lite_rows:  # the CLI's paths run bf16
        key = (r["B"], r["Lq"], r["Lk"], r["D"])
        r["launches_by_path"] = {p: by.get(key, 0) if r["dtype"] == "bfloat16" else 0
                                 for p, by in lite_by.items()}
        r["launches"] = sum(r["launches_by_path"].values())
    ran = [r for r in lite_rows if r["main_path"] and r["launches"]]
    kernels.append(entry(
        "flash_lite_fwd", "vexpress_torch/csrc/flash_fwd_wgmma.cuh",
        "vexpress_tpu/ops/flash_lite.py:68 flash_lite_fwd (pallas_call :89, body _fwd_kernel :33)",
        [(r["kernel_ms"], r["plain_ms"], r["library_ms"], r["bound_ms"], r["bound_by"],
          r["max_abs_err"]) for r in ran],
        results["cli_full"]["lite_launches"] + sum(results["sharded"]["lite_launches"])
        + results["fused"]["cli"]["launches"] + results["fused"]["reload"]["launches"],
        plain_is="flash_lite_reference", sources=sources, k1_ms=sum(r["k1_ms"] for r in ran),
        fp32_launches_by_path=dict(
            parity_cli=parity["cli"]["launches"].get("flash_lite_fwd", 0)),
        exps=sum(r["exps"] for r in ran),
        launches_by_path=dict(cli_full=results["cli_full"]["lite_launches"],
                              fused_cli=results["fused"]["cli"]["launches"],
                              fused_cli_reload=results["fused"]["reload"]["launches"],
                              **{f"sharded_rank{i}": n for i, n in
                                 enumerate(results["sharded"]["lite_launches"])}),
        shapes=lite_rows))
    av = results["attn_variants"]
    for name, source, replaces, plain_is in (
            ("flash_fwd_variant", "vexpress_torch/csrc/flash_fwd_wgmma.cuh",
             "tools/bench_attn_variants.py:77 flash_at and :156 flash_bb, which reach the "
             "library's jax/experimental/pallas/ops/tpu/flash_attention.py:758 (pallas_call)",
             "flash_fwd_variant_reference"),
            ("splash_fwd", "vexpress_torch/csrc/flash_fwd_wgmma.cuh",
             "tools/bench_attn_variants.py:106 splash_at, which reaches the library's "
             "jax/experimental/pallas/ops/tpu/splash_attention/splash_attention_kernel.py:1137 "
             "(pallas_call; body flash_attention_kernel :696)", "splash_mha_reference")):
        rows = [r for r in av["rows"] if r["kernel"] == name]
        launcher = "flash_variants.cu" if name == "flash_fwd_variant" else "splash_fwd.cu"
        kernels.append(entry(
            name, source, replaces,
            [(r["ms"], r["plain_ms"], r["library_ms"], r["bound_ms"], r["bound_by"],
              r["max_abs_err"]) for r in rows], av["bench_launches"][name],
            times_are="sums over the bench's rows (tilings) at its shape, one call each",
            plain_is=plain_is, k1_ms=sum(r["k1_ms"] for r in rows),
            sources=["vexpress_torch/csrc/flash_fwd_wgmma.cuh (the kernel)",
                     f"vexpress_torch/csrc/{launcher} (its instantiations and launch)"],
            launches_by_path=dict(bench_attn_variants=av["bench_launches"][name]), rows=rows))
    return kernels


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from vexpress_torch.ops import flash
    except ImportError as e:
        print(f"chip_smoke: the vexpress_torch package is missing ({e})", file=sys.stderr)
        return 2

    card = card_line()
    log(f"[card] {card}")
    t0 = time.perf_counter()
    lib = flash.build()
    log(f"[build] {lib.name}: {time.perf_counter() - t0:.1f} s")
    sass = sass_phase()

    flash.FLASH_LITE = False  # K1 unless a phase turns K2 on
    results = {}
    wall = {}
    # the timed full-width phases run before attn_variants (GiB-scale plain
    # versions) and trace (a profiler session), so that neither is in their way
    for name, run in (("kernel", lambda: kernel_phase(torch)),
                      ("parity", lambda: parity_phase(torch)),
                      ("train_parity", lambda: train_parity_phase(torch)),
                      ("lora_parity", lambda: lora_parity_phase(torch)),
                      ("full", lambda: full_phase(torch, FULL_STEPS)),
                      ("fused", lambda: fused_phase(torch)),
                      ("decode_tail", lambda: decode_tail_phase(torch)),
                      ("train_full", lambda: train_full_phase(torch)),
                      ("train_cli", lambda: train_cli_phase(torch)),
                      ("cli_full", lambda: cli_full_phase(torch)),
                      ("tools", lambda: tools_phase(torch)),
                      ("dist_parity", lambda: dist_parity_phase(torch)),
                      ("sharded", lambda: sharded_phase(torch)),
                      ("train_dp", lambda: train_dp_phase(torch)),
                      ("attn_variants", lambda: attn_variants_phase(torch)),
                      ("trace", lambda: trace_phase(torch))):
        gc.collect()  # what an earlier phase left must not count in this one's memory
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        results[name] = run()
        wall[name] = time.perf_counter() - t0
        log(f"[{name}] phase wall time {wall[name]:.1f} s")
    print(json.dumps({"phases": {k: v for k, v in results.items()
                                 if k not in ("kernel", "attn_variants")},
                      "phase_wall_s": wall, "card": card, "sass": sass}))

    kernels = kernels_line(results)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
