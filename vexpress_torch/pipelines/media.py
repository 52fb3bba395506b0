"""Media around the pipeline. Counterpart of vexpress_tpu/pipelines/media.py:
the device-side post-processing of the decoded video (the reference's
save_video flicker filter, pipelines/utils.py:46-61, the uint8 conversion and
the BT.601 YUV420 conversion the mp4 encode needs), and the host-side file
IO (`save_video`, `save_video_yuv`, `load_image_rgb`, `read_video_rgb`). cv2
is imported only inside the functions that use it.
"""

from __future__ import annotations

import pathlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.media_native import mux_audio_video, native_available


def reflect_index(n: int, pad: int) -> torch.Tensor:
    """Indices [-pad, n + pad) of an axis of length n reflected at both ends
    (numpy's and jnp.pad's "reflect": the edge is not repeated; an axis of
    one element repeats it)."""
    i = torch.arange(-pad, n + pad).abs()
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = i % period
    return torch.where(i >= n, period - i, i)


def median_filter_3d(video: torch.Tensor, kernel_size: int = 3,
                     frame_chunk: int = 4) -> torch.Tensor:
    """3-D median over (F, H, W, C), reflect padding in frames and space;
    `frame_chunk` output frames at a time bound the k^3-patch stack. The
    frame axis is reflected through an index vector, as `jnp.pad` reflects
    it, so a clip of any length (one frame too) is filtered."""
    k = kernel_size
    pad = k // 2
    f, h, w, c = video.shape
    v = video.permute(0, 3, 1, 2)[reflect_index(f, pad).to(video.device)]  # (F+2p, C, H, W)
    v = F.pad(v, (pad, pad, pad, pad), mode="reflect")
    outs = []
    for s in range(0, f, frame_chunk):
        n = min(frame_chunk, f - s)
        seg = v[s : s + n + 2 * pad]  # (n + 2p, C, H+2p, W+2p)
        patches = [seg[dt : dt + n, :, dy : dy + h, dx : dx + w]
                   for dt in range(k) for dy in range(k) for dx in range(k)]
        outs.append(torch.stack(patches, dim=0).median(dim=0).values)
    return torch.cat(outs, dim=0).permute(0, 2, 3, 1)


def to_uint8(video: torch.Tensor) -> torch.Tensor:
    """[0, 1] float -> uint8 (truncating, as the JAX package's astype)."""
    return (video.float().clamp(0.0, 1.0) * 255).to(torch.uint8)


def to_yuv420(video: torch.Tensor):
    """(F, H, W, 3) RGB in [0, 1] -> studio-swing BT.601 YUV420 planes: Y
    uint8 (F, H, W), U and V uint8 (F, H/2, W/2) from the 2x2 mean of the
    full-resolution chroma. What the mp4 encode needs, computed on the device
    so that 1.5 bytes per pixel leave it instead of 3."""
    x = video.float().clamp(0.0, 1.0) * 255.0
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 16.0 + (65.738 * r + 129.057 * g + 25.064 * b) / 256.0
    u = 128.0 + (-37.945 * r - 74.494 * g + 112.439 * b) / 256.0
    v = 128.0 + (112.439 * r - 94.154 * g - 18.285 * b) / 256.0
    f, h, w = y.shape
    u = u.reshape(f, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
    v = v.reshape(f, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
    return (torch.round(y).clamp(16, 235).to(torch.uint8),
            torch.round(u).clamp(16, 240).to(torch.uint8),
            torch.round(v).clamp(16, 240).to(torch.uint8))


def _mux_or_keep(temp: str, audio_path: Optional[str], out: pathlib.Path) -> None:
    """Mux the audio into the video-only `temp` file, or keep it as the
    output when there is no audio, no native muxer, or the mux fails (a
    finished generation is never lost to a mux error)."""
    if audio_path and native_available():
        try:
            mux_audio_video(temp, audio_path, str(out))
        except RuntimeError as e:
            print(f"[vexpress] WARNING: audio mux failed ({e}); saving video without audio")
            pathlib.Path(temp).rename(out)
            return
        pathlib.Path(temp).unlink()
    else:
        pathlib.Path(temp).rename(out)


def save_video(video: np.ndarray, audio_path: Optional[str], output_path: str,
               fps: float = 30.0, apply_median_filter: bool = True) -> None:
    """video: (F, H, W, 3) RGB, float in [0, 1] or uint8 (the pipeline's
    `output_uint8`, already median-filtered: pass apply_median_filter=False
    then). Writes an mp4 with cv2, then muxes the audio."""
    import cv2

    out = pathlib.Path(output_path)
    out.parent.mkdir(exist_ok=True, parents=True)
    video = np.asarray(video)
    if apply_median_filter:
        if video.dtype == np.uint8:
            video = video.astype(np.float32) / 255.0
        video = median_filter_3d(torch.from_numpy(np.ascontiguousarray(video))).numpy()
    frames = video if video.dtype == np.uint8 else (np.clip(video, 0.0, 1.0) * 255).astype(np.uint8)
    f, h, w, _ = frames.shape
    temp = str(out.with_name(out.stem + "-temp" + out.suffix))
    writer = cv2.VideoWriter(temp, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"cv2.VideoWriter failed to open {temp}")
    for i in range(f):
        writer.write(cv2.cvtColor(frames[i], cv2.COLOR_RGB2BGR))
    writer.release()
    _mux_or_keep(temp, audio_path, out)


def save_video_yuv(y: np.ndarray, u: np.ndarray, v: np.ndarray, audio_path: Optional[str],
                   output_path: str, fps: float = 30.0) -> None:
    """Write an mp4 straight from YUV420 planes (the pipeline's
    `output_yuv420`): Y (F, H, W), U and V (F, H/2, W/2) uint8, through the
    native streaming encoder, then mux the audio as save_video does."""
    from ..utils.media_native import NativeVideoEncoder

    out = pathlib.Path(output_path)
    out.parent.mkdir(exist_ok=True, parents=True)
    f, h, w = y.shape
    if u.shape != (f, h // 2, w // 2) or v.shape != u.shape:
        raise ValueError(f"YUV420 planes disagree: {y.shape}, {u.shape}, {v.shape}")
    temp = str(out.with_name(out.stem + "-temp" + out.suffix))
    with NativeVideoEncoder(temp, w, h, fps) as enc:
        for i in range(f):
            enc.write(y[i], u[i], v[i])
    _mux_or_keep(temp, audio_path, out)


def load_image_rgb(path: str, height: int, width: int) -> np.ndarray:
    """-> (H, W, 3) float32 RGB in [0, 1], resized with cv2's bilinear
    filter (the reference resizes with PIL's, inference.py:235-236)."""
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"cannot read image {path}")
    img = cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0


def read_video_rgb(path: str) -> np.ndarray:
    """-> (F, H, W, 3) uint8 RGB frames, decoded with cv2."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise RuntimeError(f"no frames decoded from {path}")
    return np.stack(frames)
