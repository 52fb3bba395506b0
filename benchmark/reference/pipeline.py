"""The plain reference of one V-Express clip, in fp32: the same modules as
the program (copies, plain attention), run one window at a time with the
unconditional half computed in full, the samplers' host steps, the whole
clip decoded and filtered at once, and the YUV420 planes. Reads the
configuration's sizes and the clip's inputs; nothing of the program's."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .audio import audio_frame_windows
from .audio_projection import AudioProjection
from .context import compute_context_windows
from .ddim import DDIMScheduler, SchedulerConfig
from .dpm_solver import DPMSolverMultistepScheduler
from .media import median_filter_3d, to_yuv420
from .unet_2d import ReferenceUNet2D
from .unet_3d import DenoisingUNet3D, UNetConfig
from .vae import AutoencoderKL, VAEConfig
from .vkps_guider import VKpsGuider
from .wav2vec2 import Wav2Vec2Config, Wav2Vec2Model

LATENT_SCALE = 0.18215


def _tuples(d: Dict) -> Dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def build_models(cfg: Dict, device, dtype=torch.float32) -> Dict[str, torch.nn.Module]:
    """The six modules of the configuration, keyed as the program's
    `components()`, with the parameter names of the program's modules."""
    with torch.device(device):
        mods = {
            "vae": AutoencoderKL(VAEConfig(**_tuples(cfg["vae"]))),
            "reference_net": ReferenceUNet2D(UNetConfig(**_tuples(cfg["unet"]))),
            "denoising_unet": DenoisingUNet3D(UNetConfig(**_tuples(cfg["unet"]))),
            "v_kps_guider": VKpsGuider(**_tuples(cfg["guider"])),
            "wav2vec2": Wav2Vec2Model(Wav2Vec2Config(**_tuples(cfg["wav2vec2"]))),
            "audio_projection": AudioProjection(**_tuples(cfg["audio_projection"])),
        }
    for m in mods.values():
        m.to(device=device, dtype=dtype).eval().requires_grad_(False)
    return mods


@torch.no_grad()
def generate_clip(mods: Dict[str, torch.nn.Module], cfg: Dict, run: Dict,
                  inputs: Dict[str, np.ndarray]):
    """One clip: `run` holds the call's settings (frames, steps, sampler,
    guidance_scale, ...), `inputs` the reference image (H, W, 3), the kps
    frames (F, H, W, 3) uint8, the waveform and the initial latents
    (F, h, w, 4). Returns the (Y, U, V) uint8 planes as numpy arrays."""
    dev = next(mods["vae"].parameters()).device
    f = run["frames"]
    ucfg = cfg["unet"]
    vae, unet = mods["vae"], mods["denoising_unet"]

    image = torch.as_tensor(inputs["reference_image"], device=dev).float()
    ref_latent = vae.encode(image[None] * 2.0 - 1.0) * LATENT_SCALE
    ctx = torch.zeros((1, 1, ucfg["cross_attention_dim"]), device=dev)
    _, feats = mods["reference_net"](ref_latent, torch.zeros((1,), dtype=torch.long, device=dev),
                                     ctx)
    do_cfg = run["guidance_scale"] > 1.0
    if do_cfg:
        feats = tuple(torch.cat([torch.zeros_like(x), x]) for x in feats)
    kps = torch.as_tensor(inputs["kps_images"], device=dev).float() / 255.0
    kps_feat = mods["v_kps_guider"](kps[None])[0]
    wave = torch.as_tensor(inputs["audio_waveform"], device=dev).float()
    emb = mods["wav2vec2"](wave[None])[0]
    audio_tok = mods["audio_projection"](audio_frame_windows(emb, f, run["num_pad_audio_frames"]))

    windows, inv_counts = compute_context_windows(f, run["context_frames"], run["context_overlap"])
    inv = torch.as_tensor(inv_counts, device=dev)
    sched = DDIMScheduler(SchedulerConfig(**cfg["scheduler"]))
    steps = run["steps"]
    timesteps = sched.timesteps(steps)
    dpm = DPMSolverMultistepScheduler(sched.config) if run["sampler"] == "dpmpp_2m" else None
    latents = torch.as_tensor(inputs["latents"], device=dev).float() * sched.init_noise_sigma
    state = dpm.init_state(latents) if dpm else None
    scale = run["guidance_scale"]
    for i, t in enumerate(timesteps):
        acc = torch.zeros_like(latents)
        for win in windows:
            w = torch.as_tensor(np.asarray(win), device=dev, dtype=torch.long)
            lat, kp, au = latents[w][None], kps_feat[w][None], audio_tok[w][None]
            if do_cfg:
                lat = torch.cat([lat, lat])
                kp = torch.cat([torch.zeros_like(kp), kp])
                au = torch.cat([torch.zeros_like(au), au])
            ts = torch.full((lat.shape[0],), int(t), dtype=torch.long, device=dev)
            pred = unet(lat, ts, au, feats, kp, run["reference_attention_weight"],
                        run["audio_attention_weight"])
            if do_cfg:
                uncond, cond = pred.chunk(2)
                pred = uncond + scale * (cond - uncond)
            acc.index_add_(0, w, pred[0] * inv[w][:, None, None, None])
        if dpm is None:
            latents = sched.step(acc, int(t), latents, steps)
        else:
            latents, state = dpm.step(acc, i, timesteps, latents, state)

    frames = [torch.clamp(vae.decode(latents[s : s + 8] / LATENT_SCALE) * 0.5 + 0.5, 0.0, 1.0)
              for s in range(0, f, 8)]
    video = torch.cat(frames)
    if run["median_filter"]:
        video = median_filter_3d(video)
    return tuple(p.cpu().numpy() for p in to_yuv420(video))
