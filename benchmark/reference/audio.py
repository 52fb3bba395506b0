"""Audio embedding windowing: wav2vec2 frames -> per-video-frame token
windows. Counterpart of vexpress_tpu/pipelines/audio.py:
  1. wav2vec2 last_hidden_state (T', C)
  2. fp32 linear interpolation (align_corners=False) to 2 * video_length
  3. zero-pad 2*num_pad frames on both ends
  4. frame i gets the slice [2i : 2i + 2*(2*num_pad + 1)] (10 embeddings)
"""

from __future__ import annotations

import torch


def interpolate_linear(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """F.interpolate(mode='linear', align_corners=False) along axis 0 of x (T, C)."""
    t_in = x.shape[0]
    x32 = x.float()
    pos = (torch.arange(out_len, dtype=torch.float32, device=x.device) + 0.5) * (t_in / out_len) - 0.5
    pos = pos.clamp(0.0, t_in - 1)
    lo = pos.floor().long()
    hi = torch.clamp(lo + 1, max=t_in - 1)
    frac = (pos - lo.float())[:, None]
    return (x32[lo] * (1.0 - frac) + x32[hi] * frac).to(x.dtype)


def audio_frame_windows(audio_embeddings: torch.Tensor, video_length: int,
                        num_pad_audio_frames: int = 2) -> torch.Tensor:
    """(T', C) -> (video_length, 2*(2*num_pad+1), C) per-frame embedding windows."""
    emb = interpolate_linear(audio_embeddings, 2 * video_length)
    pad = emb.new_zeros((2 * num_pad_audio_frames, emb.shape[-1]))
    emb = torch.cat([pad, emb, pad], dim=0)
    window = 2 * (2 * num_pad_audio_frames + 1)
    starts = 2 * torch.arange(video_length, device=emb.device)
    idx = starts[:, None] + torch.arange(window, device=emb.device)[None, :]
    return emb[idx]
