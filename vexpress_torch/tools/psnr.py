"""PSNR between two videos or frame stacks: the port's copy of tools/psnr.py.

Reads `.npy` stacks as they are, or videos through
`pipelines.media.read_video_rgb` (cv2) as floats in [0, 1]; both are cut to
the shorter one's frames (and to `--max_frames`), then compared frame by
frame. It runs on the host: no device is involved.

    python -m vexpress_torch.tools.psnr a.mp4 b.mp4 [--max_frames N]
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np

from ..pipelines.media import read_video_rgb


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(data_range**2 / mse)


def load_frames(path: str, max_frames: Optional[int] = None) -> np.ndarray:
    if path.endswith(".npy"):
        frames = np.load(path)
    else:
        frames = read_video_rgb(path, max_frames).astype(np.float32) / 255.0
    return frames if max_frames is None else frames[:max_frames]


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--max_frames", type=int, default=None)
    args = p.parse_args(argv)

    a = load_frames(args.a, args.max_frames)
    b = load_frames(args.b, args.max_frames)
    n = min(len(a), len(b))
    a, b = a[:n], b[:n]
    if a.shape != b.shape:
        raise SystemExit(f"shape mismatch: {a.shape} vs {b.shape}")

    per_frame = [psnr(a[i], b[i]) for i in range(n)]
    rec = {"frames": n, "mean": float(np.mean(per_frame)), "min": float(np.min(per_frame)),
           "max": float(np.max(per_frame))}
    print(f"frames: {n}  mean PSNR: {rec['mean']:.2f} dB  min: {rec['min']:.2f}  "
          f"max: {rec['max']:.2f}")
    return rec


if __name__ == "__main__":
    main()
