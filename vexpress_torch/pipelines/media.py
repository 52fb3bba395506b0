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


def halo_index(n: int, start: int, stop: int) -> torch.Tensor:
    """The frames `_median_core` filters frames [start, stop) of an n-frame
    clip from: [start - 1, stop + 1), a one-frame halo on each side,
    reflected at the clip's ends as numpy's and jnp.pad's "reflect" does
    (the edge is not repeated; a one-frame clip repeats its frame)."""
    i = torch.arange(start - 1, stop + 1).abs()
    if n == 1:
        return torch.zeros_like(i)
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _median_core(seg: torch.Tensor, frame_chunk: int = 4) -> torch.Tensor:
    """3x3x3 median of the core frames of `seg` (F + 2, H, W, C), whose first
    and last frames are halo, with reflect padding in space: (F, H, W, C).
    `frame_chunk` output frames at a time bound the 27-patch stack."""
    k, pad = 3, 1
    f, h, w = seg.shape[0] - 2 * pad, seg.shape[1], seg.shape[2]
    v = F.pad(seg.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    outs = []
    for s in range(0, f, frame_chunk):
        n = min(frame_chunk, f - s)
        part = v[s : s + n + 2 * pad]  # (n + 2p, C, H+2p, W+2p)
        patches = [part[dt : dt + n, :, dy : dy + h, dx : dx + w]
                   for dt in range(k) for dy in range(k) for dx in range(k)]
        outs.append(torch.stack(patches, dim=0).median(dim=0).values)
    return torch.cat(outs, dim=0).permute(0, 2, 3, 1)


def median_filter_3d(video: torch.Tensor, frame_chunk: int = 4) -> torch.Tensor:
    """3-D median over (F, H, W, C), reflect padding in frames and space. The
    frame axis is reflected through an index vector, as `jnp.pad` reflects
    it, so a clip of any length (one frame too) is filtered."""
    f = video.shape[0]
    return _median_core(video[halo_index(f, 0, f).to(video.device)], frame_chunk)


def median_filter_3d_chunked(video: torch.Tensor, chunk: int = 32) -> torch.Tensor:
    """`median_filter_3d` in chunks of `chunk` frames, each filtered from
    itself and a one-frame halo on each side, so that no more than chunk + 2
    frames are copied at a time; equal to the whole-clip filter."""
    f = video.shape[0]
    return torch.cat([_median_core(video[halo_index(f, s, min(s + chunk, f)).to(video.device)])
                      for s in range(0, f, chunk)], dim=0)


def to_uint8(video: torch.Tensor) -> torch.Tensor:
    """[0, 1] float -> uint8 (truncating, as the JAX package's astype)."""
    return (video.float().clamp(0.0, 1.0) * 255).to(torch.uint8)


def to_yuv420(video: torch.Tensor):
    """(F, H, W, 3) RGB in [0, 1] -> studio-swing BT.601 YUV420 planes: Y
    uint8 (F, H, W), U and V uint8 (F, H/2, W/2) from the 2x2 mean of the
    full-resolution chroma. What the mp4 encode needs, computed on the device
    so that 1.5 bytes per pixel leave it instead of 3. Every step is
    elementwise (the 2x2 mean too), so a frame's planes do not depend on the
    frames converted beside it."""
    x = video.float().clamp(0.0, 1.0) * 255.0
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 16.0 + (65.738 * r + 129.057 * g + 25.064 * b) / 256.0
    u = 128.0 + (-37.945 * r - 74.494 * g + 112.439 * b) / 256.0
    v = 128.0 + (112.439 * r - 94.154 * g - 18.285 * b) / 256.0
    u = (u[:, 0::2, 0::2] + u[:, 0::2, 1::2] + u[:, 1::2, 0::2] + u[:, 1::2, 1::2]) / 4
    v = (v[:, 0::2, 0::2] + v[:, 0::2, 1::2] + v[:, 1::2, 0::2] + v[:, 1::2, 1::2]) / 4
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
        video = median_filter_3d_chunked(torch.from_numpy(np.ascontiguousarray(video))).numpy()
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


def read_video_rgb(path: str, max_frames: Optional[int] = None) -> np.ndarray:
    """-> (F, H, W, 3) uint8 RGB frames, decoded with cv2; decoding stops
    after `max_frames` frames when it is given."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        if max_frames is not None and len(frames) >= max_frames:
            break
    cap.release()
    if not frames:
        raise RuntimeError(f"no frames decoded from {path}")
    return np.stack(frames)
