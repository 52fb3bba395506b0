"""Model FLOPs and attention operations, reckoned from the configuration.

`clip_flops` counts one clip of the pipeline as the plain reference computes
it: the products and convolutions of every module call (as
torch.utils.flop_counter counts them: 2 per multiply-add), traced over the
frozen reference modules on the meta device at the configuration's shapes,
so no value is computed and nothing of the program is read. The count is
that of the model's mathematics at these sizes, whatever runs it: the
unconditional half of classifier-free guidance in full, no recompute.

`flash_attention_ops` counts the attention products (4 B H Lq Lk D: QK^T
and PV) of the calls that take the flash kernels' shapes (Lq and Lk
multiples of 128, Lk >= 512): attn1 (self-attention of every frame) and
attn1_5 (every frame's queries against the reference bank) of the
denoising UNet, attn1 of the reference net; under guidance attn1_5's
unconditional half attends to zero keys and is not a product anyone needs."""

from __future__ import annotations

import functools
import json
from typing import Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference.context import compute_context_windows
from .reference.pipeline import build_models


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


@functools.lru_cache(maxsize=8)
def _clip_parts(cfg_json: str, frames: int, window: int, cfg_batch: int) -> Dict[str, int]:
    cfg = json.loads(cfg_json)
    m = build_models(cfg, "meta")
    u, h, w = cfg["unet"], cfg["height"], cfg["width"]
    lh, lw = h // 8, w // 8
    meta = dict(device="meta")
    ctx = torch.zeros((1, 1, u["cross_attention_dim"]), **meta)
    t0 = torch.zeros((1,), dtype=torch.long, **meta)
    lat1 = torch.zeros((1, lh, lw, u.get("in_channels", 4)), **meta)
    parts = {}
    parts["vae_encode"] = _count(lambda: m["vae"].encode(torch.zeros((1, h, w, 3), **meta)))
    parts["reference_net"] = _count(lambda: m["reference_net"](lat1, t0, ctx))
    parts["kps_guider_frame"] = _count(
        lambda: m["v_kps_guider"](torch.zeros((1, 1, h, w, 3), **meta)))
    with torch.no_grad():
        _, feats = m["reference_net"](lat1, t0, ctx)
    feats = tuple(f.expand((cfg_batch,) + tuple(f.shape[1:])) for f in feats)
    ap = cfg["audio_projection"]
    tokens = ap["num_queries"]
    lat = torch.zeros((cfg_batch, window, lh, lw, u.get("in_channels", 4)), **meta)
    aud = torch.zeros((cfg_batch, window, tokens, u["cross_attention_dim"]), **meta)
    kps = torch.zeros((cfg_batch, window, lh, lw, u["block_out_channels"][0]), **meta)
    ts = torch.zeros((cfg_batch,), dtype=torch.long, **meta)
    parts["unet_window"] = _count(lambda: m["denoising_unet"](lat, ts, aud, feats, kps, 1.0, 1.0))
    parts["vae_decode_frame"] = _count(
        lambda: m["vae"].decode(torch.zeros((1, lh, lw, 4), **meta)))
    seconds = frames / cfg["fps"]
    samples = int(seconds * cfg["sample_rate"])
    parts["wav2vec2"] = _count(lambda: m["wav2vec2"](torch.zeros((1, samples), **meta)))
    parts["audio_projection"] = _count(lambda: m["audio_projection"](
        torch.zeros((frames, 2 * (2 * cfg["num_pad_audio_frames"] + 1),
                     ap["embedding_dim"]), **meta)))
    return parts


def clip_flops(cfg: Dict, frames: int, steps: int) -> int:
    """Model FLOPs of one clip of `frames` frames and `steps` denoise steps."""
    window, overlap = cfg["context_frames"], cfg["context_overlap"]
    cfg_batch = 2 if cfg["guidance_scale"] > 1.0 else 1
    windows, _ = compute_context_windows(frames, window, overlap)
    p = _clip_parts(json.dumps(cfg, sort_keys=True), frames, window, cfg_batch)
    return (p["vae_encode"] + p["reference_net"] + frames * p["kps_guider_frame"]
            + p["wav2vec2"] + p["audio_projection"]
            + steps * len(windows) * p["unet_window"] + frames * p["vae_decode_frame"])


def _levels(cfg: Dict) -> List[Tuple[int, int, int, int]]:
    """(tokens, heads, head dim, transformer blocks) of each attention level
    of the UNet, down blocks then mid then up blocks."""
    u = cfg["unet"]
    ch, heads, lp = u["block_out_channels"], u["attention_head_dim"], u["layers_per_block"]
    n = len(ch)
    hw = (cfg["height"] // 8) * (cfg["width"] // 8)
    out = []
    for i in range(n - 1):  # down blocks with attention (the last has none)
        out.append((hw // 4**i, heads, ch[i] // heads, lp))
    out.append((hw // 4 ** (n - 1), heads, ch[-1] // heads, 1))  # mid
    for i in range(1, n):  # up blocks with attention (the first has none)
        c = ch[n - 1 - i]
        out.append((hw // 4 ** (n - 1 - i), heads, c // heads, lp + 1))
    return out


def flash_eligible(lq: int, lk: int) -> bool:
    return lq % 128 == 0 and lk % 128 == 0 and lq >= 128 and lk >= 512


def flash_attention_ops(cfg: Dict, frames: int, steps: int) -> int:
    """Attention operations of one clip at the flash kernels' shapes."""
    window, overlap = cfg["context_frames"], cfg["context_overlap"]
    cfg_batch = 2 if cfg["guidance_scale"] > 1.0 else 1
    windows, _ = compute_context_windows(frames, window, overlap)
    unet, ref = 0, 0
    for tokens, heads, d, blocks in _levels(cfg):
        if flash_eligible(tokens, tokens):
            attn1 = 4 * heads * tokens * tokens * d
            unet += blocks * (cfg_batch * window * attn1 + window * attn1)  # attn1 + attn1_5
            ref += blocks * attn1
    return steps * len(windows) * unet + ref
