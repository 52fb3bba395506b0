"""Context-window scheduling for long-video denoising.

Reference: pipelines/context.py — overlapping sliding windows of
`context_size` frames with `context_overlap`, plus the bit-reversed
`ordered_halving` jitter. V-Express inference builds the queue ONCE with
step=0 (v_express_pipeline.py:486-496), and trims video_length to whole
windows (inference.py:255-264), so at inference the schedule is the static
stride pattern below; the general jittered generator is kept for parity.

The window set is a static [num_windows, context_size] index array and the
per-frame blending weights a precomputed table. A torch-free copy of
vexpress_tpu/pipelines/context.py (numpy only).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def ordered_halving(val: int) -> float:
    """Bit-reversed fraction in [0, 1) (pipelines/context.py:22-27)."""
    bin_str = f"{val:064b}"
    return int(bin_str[::-1], 2) / (1 << 64)


def uniform_context_windows(
    step: int,
    num_frames: int,
    context_size: int = 24,
    context_stride: int = 1,
    context_overlap: int = 4,
    closed_loop: bool = False,
) -> List[List[int]]:
    """The reference's `uniform` generator (pipelines/context.py:30-59)."""
    if num_frames <= context_size:
        return [list(range(num_frames))]

    context_stride = min(context_stride, int(np.ceil(np.log2(num_frames / context_size))) + 1)

    windows = []
    for context_step in 1 << np.arange(context_stride):
        pad = int(round(num_frames * ordered_halving(step)))
        start = int(ordered_halving(step) * context_step) + pad
        stop = num_frames + pad + (0 if closed_loop else -context_overlap)
        stride = context_size * context_step - context_overlap
        for j in range(start, stop, stride):
            window = []
            for e in range(j, j + context_size * context_step, context_step):
                if e >= num_frames:
                    e = num_frames - 2 - e % num_frames
                    # the reference relies on torch negative indexing when this
                    # underflows (pipelines/context.py:56); normalize explicitly
                    e %= num_frames
                window.append(int(e))
            windows.append(window)
    return windows


def compute_num_context(video_length: int, context_size: int, context_overlap: int) -> int:
    """pipelines/context.py:7-10."""
    step = context_size - context_overlap
    return (video_length - context_size) // step + 1


def compute_video_length(init_video_length: int, context_size: int, context_overlap: int) -> int:
    """Trim to whole context windows (inference.py:258-262)."""
    n = compute_num_context(init_video_length, context_size, context_overlap)
    return (n - 1) * (context_size - context_overlap) + context_size


def compute_context_windows(
    video_length: int,
    context_size: int = 24,
    context_overlap: int = 4,
) -> Tuple[np.ndarray, np.ndarray]:
    """Static inference schedule: (windows [N, size] int32, inv_counts [L] f32).

    inv_counts[f] = 1 / number of windows containing frame f — the blending
    weight of v_express_pipeline.py:498-500,553.
    """
    windows = uniform_context_windows(
        step=0,
        num_frames=video_length,
        context_size=context_size,
        context_stride=1,
        context_overlap=context_overlap,
        closed_loop=False,
    )
    win = np.asarray(windows, dtype=np.int32)
    counts = np.zeros((video_length,), dtype=np.float32)
    for w in windows:
        counts[np.asarray(w)] += 1.0
    if (counts == 0).any():
        missing = np.nonzero(counts == 0)[0]
        raise ValueError(
            f"context schedule leaves frames uncovered: {missing[:8]}...; "
            f"trim video_length with compute_video_length() first"
        )
    return win, (1.0 / counts).astype(np.float32)
