"""The reference's decode tail: the 3x3x3 median filter over the whole clip
(reflect padding in frames and space) and the BT.601 studio-swing YUV420
planes, written out plainly."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def median_filter_3d(video: torch.Tensor) -> torch.Tensor:
    """(F, H, W, C) -> the median of each 3x3x3 neighbourhood, reflect-padded
    (the edge is not repeated; a one-frame clip repeats its frame)."""
    f, h, w = video.shape[:3]
    idx = torch.arange(-1, f + 1).abs()
    idx = torch.zeros_like(idx) if f == 1 else torch.where(idx >= f, 2 * (f - 1) - idx, idx)
    v = F.pad(video[idx.to(video.device)].permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    out = []
    for t in range(f):
        patches = [v[t + dt, :, dy : dy + h, dx : dx + w]
                   for dt in range(3) for dy in range(3) for dx in range(3)]
        out.append(torch.stack(patches).median(dim=0).values)
    return torch.stack(out).permute(0, 2, 3, 1)


def to_yuv420(video: torch.Tensor):
    """(F, H, W, 3) RGB in [0, 1] -> uint8 Y (F, H, W), U, V (F, H/2, W/2),
    the chroma the mean of each 2x2 block."""
    x = video.float().clamp(0.0, 1.0) * 255.0
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 16.0 + (65.738 * r + 129.057 * g + 25.064 * b) / 256.0
    u = 128.0 + (-37.945 * r - 74.494 * g + 112.439 * b) / 256.0
    v = 128.0 + (112.439 * r - 94.154 * g - 18.285 * b) / 256.0

    def pool(c):
        return F.avg_pool2d(c[:, None], 2)[:, 0]

    return (torch.round(y).clamp(16, 235).to(torch.uint8),
            torch.round(pool(u)).clamp(16, 240).to(torch.uint8),
            torch.round(pool(v)).clamp(16, 240).to(torch.uint8))
