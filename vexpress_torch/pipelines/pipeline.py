"""VExpressPipeline: streamed, fused and window-parallel inference.
Counterpart of vexpress_tpu/pipelines/pipeline.py in `mode="streamed"`,
`"fused"` and `"sharded"`, on the exact unbucketed path the JAX package takes
off the TPU: DDIM (eta 0 or above) or DPM-Solver++ (2M), `strength`,
`save_memory`, YUV420 output. `piecewise` and `shape_bucketing` are not
ported.

The window set is a static [N, context_frames] index table computed once
(the reference builds its context queue with step=0 for every denoise step).
Each denoise step gathers one window group, runs the UNet under CFG
(uncond half first, with zero uncond kps/audio/reference inputs and the
zero-KV attention shortcut), scatter-adds the 1/count-weighted predictions
into an fp32 accumulator and applies one sampler step to all frames. Every
window reads pre-step latents and the update is elementwise, so this equals
the reference's sequential per-window loop. `mode="sharded"` spreads the
window table over the ranks of a process group (vexpress_torch.parallel):
each rank blends its rows, the accumulators are summed over the group, and
every rank applies the same sampler step to the same latents.

Every mode runs one step body (`_build_denoise_step`), which takes the grid
index as a device tensor and reads nothing on the host. `mode="fused"`
keeps it in `_step_cache` as a `FusedStep` over static buffers: on a CUDA
device captured once as a CUDA graph and replayed at every timestep (the
counterpart of JAX's one compiled program a step), on the CPU called.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
import weakref
from typing import Any, Callable, Dict, Optional, Set

import numpy as np
import torch

from ..device import resolve_device
from ..diffusion.ddim import DDIMScheduler
from ..diffusion.dpm_solver import DPMSolverMultistepScheduler
from ..models.audio_projection import AudioProjection
from ..models.unet_2d import ReferenceUNet2D
from ..models.unet_3d import DenoisingUNet3D, UNetConfig
from ..models.vae import AutoencoderKL, VAEConfig
from ..models.vkps_guider import VKpsGuider
from ..models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
from ..ops import flash, launches
from .audio import audio_frame_windows
from .context import compute_context_windows
from .media import _median_core, halo_index, median_filter_3d_chunked, to_uint8, to_yuv420

LATENT_SCALE = 0.18215


def _window_tables(windows: np.ndarray, inv_counts: np.ndarray, window_group: int):
    """Windows padded to whole groups: (n_groups, g, win) frame indices and
    blending weights (inv_counts gathered, zero for pad windows)."""
    n_windows, win_size = windows.shape
    g = min(window_group, n_windows)
    n_groups = -(-n_windows // g)
    pad = n_groups * g - n_windows
    win_idx = np.concatenate([windows, np.zeros((pad, win_size), np.int64)]) if pad else windows
    win_mask = np.concatenate([np.ones(n_windows, np.float32), np.zeros(pad, np.float32)])
    win_w = (inv_counts[win_idx] * win_mask[:, None]).reshape(n_groups, g, win_size)
    return win_idx.reshape(n_groups, g, win_size).astype(np.int64), win_w.astype(np.float32)


class HostDownload:
    """The packed chunks of an n-frame clip, copied in clip order into one
    host buffer a plane. On the card the buffers are pinned and each copy is
    enqueued on a copy stream once an event of the compute stream has passed,
    so that one chunk's download overlaps the next chunk's decode and filter;
    `result` waits for the copies once."""

    def __init__(self, n: int, device: torch.device):
        self.n, self.at, self.host = n, 0, None
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(self, planes) -> None:
        if self.host is None:
            self.host = [torch.empty((self.n,) + tuple(p.shape[1:]), dtype=p.dtype,
                                     pin_memory=self.stream is not None) for p in planes]
        k = planes[0].shape[0]
        dst = [h[self.at : self.at + k] for h in self.host]
        self.at += k
        if self.stream is None:
            for d, p in zip(dst, planes):
                d.copy_(p)
            return
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(planes[0].device))
        self.stream.wait_event(ready)
        with torch.cuda.stream(self.stream):
            for d, p in zip(dst, planes):
                d.copy_(p, non_blocking=True)
        for p in planes:
            p.record_stream(self.stream)  # its memory is not reused before the copy lands

    def result(self) -> list:
        if self.stream is not None:
            self.stream.synchronize()
        return [h.numpy() for h in self.host]


def decode_packed(decode: Callable[[torch.Tensor], torch.Tensor], latents: torch.Tensor,
                  chunk: int, median_filter: bool, pack) -> list:
    """The decode tail one chunk at a time: decode, 3x3x3 median filter,
    `pack` (to_uint8 or to_yuv420) on the device, download. Chunk i + 1 is
    decoded before chunk i is filtered, since its first frame is chunk i's
    right halo; the frame before chunk i is kept as its left halo. At the
    clip's ends the halo is reflected through `halo_index` (the last frame's
    reflection, frame n - 2, lies in the previous chunk when the last chunk
    holds one frame). No device tensor holds more than chunk + 2 frames of
    the clip. Returns the host planes (n, ...) of `pack`."""
    n = latents.shape[0]
    out = HostDownload(n, latents.device)
    before, cur = None, decode(latents[:chunk])
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        nxt = decode(latents[e : e + chunk]) if e < n else None
        piece = cur
        if median_filter:
            frames = ([before] if before is not None else []) + list(cur.split(1))
            if nxt is not None:
                frames.append(nxt[:1])
            lo = s - 1 if before is not None else s  # the clip index of frames[0]
            piece = _median_core(torch.cat([frames[i - lo] for i in
                                            halo_index(n, s, e).tolist()]))
            before = cur[-1:].clone()
        planes = pack(piece)
        out.put(planes if isinstance(planes, tuple) else (planes,))
        cur = nxt
    return out.result()


def blend_windows(predict_fn, latents: torch.Tensor, t,
                  cond_of_group: Callable[[int], Any], win_idx, win_w) -> torch.Tensor:
    """The fp32 sum over window groups of 1/count-weighted predictions:
    `predict_fn(lat, t, w_idx, cond_of_group(gi)) -> pred` maps group gi's
    (g, win, h, w, 4) window latents to CFG-combined predictions. The tables
    (`_window_tables`) are numpy arrays, uploaded here, or tensors already
    on the latents' device, which the pipeline's step passes."""
    idx = torch.as_tensor(win_idx, device=latents.device)
    weights = torch.as_tensor(win_w, device=latents.device)
    acc = torch.zeros_like(latents, dtype=torch.float32)
    for gi in range(idx.shape[0]):
        w_idx = idx[gi]
        pred = predict_fn(latents[w_idx], t, w_idx, cond_of_group(gi))
        pred = pred.float() * weights[gi][..., None, None, None]
        acc.index_add_(0, w_idx.reshape(-1), pred.reshape((-1,) + pred.shape[2:]))
    return acc


def build_blended_denoise_step(
    predict_fn,
    scheduler: DDIMScheduler,
    windows: np.ndarray,
    inv_counts: np.ndarray,
    num_inference_steps: int,
    window_group: int = 1,
):
    """One DDIM denoise step: gather windows -> predict in groups of
    `window_group` -> scatter-add 1/count-weighted predictions -> DDIM step.

    `predict_fn(lat, t, w_idx, cond) -> pred` maps (g, win, h, w, 4) window
    latents (plus the conditioning `cond`) to CFG-combined predictions."""
    win_idx, win_w = _window_tables(windows, inv_counts, window_group)

    def step_fn(latents: torch.Tensor, t: int, cond) -> torch.Tensor:
        acc = blend_windows(predict_fn, latents, t, lambda _gi: cond, win_idx, win_w)
        return scheduler.step(acc, t, latents, num_inference_steps)

    return step_fn


def _module_tensors(mod: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return dict(itertools.chain(mod.named_parameters(), mod.named_buffers()))


class FusedStep:
    """The fused mode's denoise step: a step body (`_build_denoise_step`)
    over static buffers, which each call copies its inputs into (the
    conditioning once a pipeline call, through `load`).

    On a CUDA device the first call is the capture's warm-up: it runs the
    body once on a side stream, which is that call's step, and then
    captures the body as one CUDA graph (`graph`); every later call, in this
    pipeline call or the next with the same cache key, replays the graph
    and adds the kernel launches the capture recorded to `ops.launches`, so
    that the counts are those of the kernels that ran. A failed capture or
    replay raises. On the CPU every call runs the body.

    The entry keeps the denoising UNet's parameters and buffers as it built
    them (`weights`), so their memory cannot be reused while the graph may
    read it; `serves` tells whether the module still holds them."""

    def __init__(self, step: Callable, unet: torch.nn.Module):
        self.step = step
        self.unet = weakref.ref(unet)
        self.weights = {k: v.detach() for k, v in _module_tensors(unet).items()}
        self.static: Optional[Dict[str, Any]] = None
        self.graph = None
        self.record = None
        self.out = None
        self.replays = 0
        self.capture_s: Optional[float] = None  # the warm-up step and the capture

    def serves(self, unet: torch.nn.Module) -> bool:
        """Whether `unet` is the module the entry was built on, each of its
        parameters and buffers still in the storage the graph reads."""
        now = _module_tensors(unet)
        return (self.unet() is unet and now.keys() == self.weights.keys()
                and all(v.data_ptr() == self.weights[k].data_ptr() for k, v in now.items()))

    def load(self, latents: torch.Tensor, cond, with_noise: bool) -> None:
        """Copy a pipeline call's conditioning (kps_feat, audio_tok,
        ref_feats, ref_scale, audio_scale) into the static buffers, made at
        the first call in the shapes of this one."""
        flat = (cond[0], cond[1], *cond[2], cond[3], cond[4])
        if self.static is None:
            dev = latents.device
            self.static = dict(
                latents=torch.empty_like(latents),
                idx=torch.zeros((), dtype=torch.long, device=dev),
                noise=torch.empty_like(latents) if with_noise else None,
                prev_x0=torch.empty_like(latents),
                has_prev=torch.zeros((), dtype=torch.bool, device=dev),
                cond=[torch.empty_like(c) for c in flat])
        for dst, src in zip(self.static["cond"], flat):
            dst.copy_(src)

    def _body(self):
        s = self.static
        c = s["cond"]
        cond = (c[0], c[1], tuple(c[2:-2]), c[-2], c[-1])
        return self.step(s["latents"], s["idx"], cond, s["noise"], s["prev_x0"], s["has_prev"])

    def __call__(self, latents, idx: int, noise, prev_x0, has_prev):
        s = self.static
        for name, src in (("latents", latents), ("noise", noise), ("prev_x0", prev_x0),
                          ("has_prev", has_prev)):
            if src is not None and src is not s[name]:
                s[name].copy_(src)
        s["idx"].fill_(idx)
        if self.graph is not None:
            self.graph.replay()
            launches.replay(self.record)
            self.replays += 1
            return self.out
        if latents.device.type != "cuda":
            return self._body()
        t0 = time.perf_counter()
        dev = latents.device
        main, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            first = self._body()
        main.wait_stream(side)
        for t in first:
            t.record_stream(main)  # the caller reads them on the main stream
        graph = torch.cuda.CUDAGraph()
        with launches.recording() as record, torch.cuda.graph(graph):
            self.out = self._body()
        torch.cuda.synchronize(dev)
        self.graph, self.record, self.capture_s = graph, record, time.perf_counter() - t0
        return first


@dataclasses.dataclass
class PipelineModels:
    unet_config: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    vae_config: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    wav2vec2_config: Wav2Vec2Config = dataclasses.field(default_factory=Wav2Vec2Config)
    audio_projection_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    guider_kwargs: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: dict(conditioning_embedding_channels=320,
                                     block_out_channels=(16, 32, 96, 256)))
    dtype: torch.dtype = torch.float32


class VExpressPipeline:
    """Streamed V-Express inference on one device.

    The modules are built on `device` (the CUDA device unless the caller
    passes another) in `models.dtype`, with PyTorch's default init; load
    weights with `vexpress_torch.io` before use."""

    # save_memory moves these to host copies once conditioning is done (the
    # reference's --save_gpu_memory frees them, v_express_pipeline.py:473-483);
    # the kps guider stays, since save_memory runs it per window group
    RELEASABLE_COND_MODULES = ("reference_net", "wav2vec2", "audio_projection")

    def __init__(self, models: PipelineModels, device=None,
                 scheduler: Optional[DDIMScheduler] = None):
        self.device = resolve_device(device)
        self.m = models
        with torch.device(self.device):
            self.vae = AutoencoderKL(models.vae_config)
            self.reference_net = ReferenceUNet2D(models.unet_config)
            self.denoising_unet = DenoisingUNet3D(models.unet_config)
            self.v_kps_guider = VKpsGuider(**models.guider_kwargs)
            self.audio_encoder = Wav2Vec2Model(models.wav2vec2_config)
            self.audio_projection = AudioProjection(**models.audio_projection_kwargs)
        for mod in self.components().values():
            mod.to(device=self.device, dtype=models.dtype).eval().requires_grad_(False)
        self.scheduler = scheduler or DDIMScheduler()
        self.timings: Dict[str, float] = {}
        self.released: Set[str] = set()  # conditioning modules now on their host copies
        self._step_cache: Dict[tuple, FusedStep] = {}  # mode="fused": a step a cache key
        self.last_released_cond_mib = 0.0
        self._host_cond: Dict[str, Dict[str, torch.Tensor]] = {}

    def components(self) -> Dict[str, torch.nn.Module]:
        """The modules keyed as the JAX pipeline's param tree."""
        return {"vae": self.vae, "reference_net": self.reference_net,
                "denoising_unet": self.denoising_unet, "v_kps_guider": self.v_kps_guider,
                "wav2vec2": self.audio_encoder, "audio_projection": self.audio_projection}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------ save_memory module moves

    def keep_host_copies(self) -> None:
        """Take host copies of the releasable modules' tensors now (the
        loader calls this once the weights are in), so that releasing them
        copies nothing back. Call it again after changing their weights: a
        release swaps the modules onto these copies."""
        comps = self.components()
        self.ensure_conditioning_params()
        with torch.inference_mode(False):
            for name in self.RELEASABLE_COND_MODULES:
                self._host_cond[name] = {k: v.detach().to("cpu")
                                         for k, v in _module_tensors(comps[name]).items()}

    def release_conditioning_params(self) -> float:
        """Put the reference net, wav2vec2 and the audio projection on their
        host copies (taken here if the loader did not), freeing their device
        memory; returns the MiB freed. The caching allocator hands the memory
        to later work on the same stream only, so kernels already queued that
        read these tensors are safe."""
        comps = self.components()
        freed = 0
        with torch.inference_mode(False):  # plain tensors, even when called from __call__
            for name in self.RELEASABLE_COND_MODULES:
                if name in self.released:
                    continue
                tensors = _module_tensors(comps[name])
                if name not in self._host_cond:
                    self._host_cond[name] = {k: v.detach().to("cpu") for k, v in tensors.items()}
                host = self._host_cond[name]
                for k, v in tensors.items():
                    if v.device != host[k].device:
                        freed += v.numel() * v.element_size()
                    v.data = host[k]
                self.released.add(name)
        return freed / 2**20

    def ensure_conditioning_params(self) -> None:
        """Bring released modules back to the device, in their dtype."""
        comps = self.components()
        with torch.inference_mode(False):
            for name in sorted(self.released):
                for v in _module_tensors(comps[name]).values():
                    v.data = v.data.to(self.device)
                self.released.discard(name)

    # ------------------------------------------------------------ conditioning

    def _encode_reference(self, image: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) in [0,1] -> scaled latent (1, h, w, 4)."""
        return self.vae.encode(image[None] * 2.0 - 1.0) * LATENT_SCALE

    def _reference_features(self, ref_latent: torch.Tensor, do_cfg: bool):
        ctx = torch.zeros((1, 1, self.m.unet_config.cross_attention_dim), dtype=self.m.dtype,
                          device=self.device)
        _, feats = self.reference_net(ref_latent, torch.zeros((1,), dtype=torch.long,
                                                              device=self.device), ctx)
        if do_cfg:
            feats = tuple(torch.cat([torch.zeros_like(f), f], dim=0) for f in feats)
        return feats

    def _kps_features(self, kps_images: torch.Tensor) -> torch.Tensor:
        """(L, H, W, 3) in [0,1] (or uint8) -> (L, h, w, C)."""
        if kps_images.dtype == torch.uint8:
            kps_images = kps_images.to(self.m.dtype) / 255.0
        return self.v_kps_guider(kps_images[None])[0]

    def _kps_features_window(self, kps_frames: torch.Tensor) -> torch.Tensor:
        """save_memory's conditioning of one window group: (g, win, H, W, 3)
        raw frames -> (g, win, h, w, C). The guider is per frame, so this
        equals gathering the whole video's features."""
        g, win = kps_frames.shape[:2]
        x = kps_frames.reshape((g * win,) + kps_frames.shape[2:])
        feats = self._kps_features(x if x.dtype == torch.uint8 else x.to(self.m.dtype))
        return feats.reshape((g, win) + feats.shape[1:])

    def _audio_tokens(self, waveform: torch.Tensor, video_length: int,
                      num_pad: int) -> torch.Tensor:
        """(T,) -> (L, tokens, cross_dim)."""
        emb = self.audio_encoder(waveform[None])[0]
        return self.audio_projection(audio_frame_windows(emb, video_length, num_pad))

    # ------------------------------------------------------------------ decode

    def _decode_chunk(self, latents: torch.Tensor) -> torch.Tensor:
        img = self.vae.decode(latents / LATENT_SCALE)
        return torch.clamp(img * 0.5 + 0.5, 0.0, 1.0)

    def decode_latents(self, latents: torch.Tensor, chunk: int = 16, median_filter: bool = False,
                       as_uint8: bool = False, as_yuv420: bool = False):
        """(L, h, w, 4) -> (L, H, W, 3), decoded `chunk` frames at a time.
        Float32 in [0, 1], uint8 when `as_uint8`, or the (Y, U, V) uint8
        planes of `to_yuv420` when `as_yuv420`. Packed output is filtered,
        packed and downloaded a chunk at a time (`decode_packed`); float
        output keeps the whole clip on the device."""
        if as_uint8 and as_yuv420:
            raise ValueError("pick one of as_uint8 / as_yuv420")
        latents = torch.as_tensor(latents, device=self.device)
        with torch.inference_mode():
            if as_uint8 or as_yuv420:
                planes = decode_packed(self._decode_chunk, latents, chunk, median_filter,
                                       to_yuv420 if as_yuv420 else to_uint8)
                return tuple(planes) if as_yuv420 else planes[0]
            video = torch.cat([self._decode_chunk(latents[i : i + chunk])
                               for i in range(0, latents.shape[0], chunk)], dim=0)
            if median_filter:
                video = median_filter_3d_chunked(video)
            return video.float().cpu().numpy()

    # ------------------------------------------------------------------ denoise

    def _predict_fn(self, guidance_scale: float):
        do_cfg = guidance_scale > 1.0
        dt = self.m.dtype

        def predict(lat, t, w_idx, cond):
            kps_feat, audio_tok, ref_feats, ref_scale, audio_scale, pregathered = cond
            lat = lat.to(dt)
            kps = (kps_feat if pregathered else kps_feat[w_idx]).to(dt)
            aud = audio_tok[w_idx].to(dt)
            if do_cfg:
                lat = torch.cat([lat, lat], dim=0)
                kps = torch.cat([torch.zeros_like(kps), kps], dim=0)
                aud = torch.cat([torch.zeros_like(aud), aud], dim=0)
            # t: a 0-d int64 tensor on the device (the pipeline's step) or an int
            ts = torch.as_tensor(t, dtype=torch.long, device=lat.device).expand(lat.shape[0])
            pred = self.denoising_unet(lat, ts, aud, ref_feats, kps, ref_scale, audio_scale,
                                       zero_uncond_kv=do_cfg)
            if do_cfg:
                uncond, cond_p = pred.chunk(2, dim=0)
                pred = uncond + guidance_scale * (cond_p - uncond)
            return pred

        return predict

    def _build_denoise_step(self, windows, inv_counts, num_inference_steps, guidance_scale,
                            window_group, eta=0.0, sampler="ddim", mesh=None,
                            kps_raw_host=None):
        """One denoise step over every context window, the step body of
        every mode (JAX's `_build_denoise_step`): `step(latents, idx, cond,
        noise, prev_x0, has_prev) -> (latents, prev_x0, has_prev)`.

        `idx` is the grid index, a 0-d int64 tensor on the device; it picks
        the timestep and the sampler's constants out of tables that are put
        on the device here, as are the window tables. `cond` = (kps_feat,
        audio_tok, ref_feats, ref_scale, audio_scale); `noise` is DDIM's
        unit noise (eta > 0, else None); `prev_x0` and `has_prev` (a 0-d
        bool tensor) are DPM-Solver++'s state, which DDIM passes through. A
        call reads nothing on the host and copies nothing to the device, so
        it can be captured in a CUDA graph; except that with `kps_raw_host`
        (save_memory, kps_feat None) each window group's guider features
        come from its raw frames, gathered on the host and kept on the
        device while the window table's frames fit
        VEXPRESS_SAVEMEM_DEV_CACHE_MB (2048 by default), else uploaded at
        every step; and a `mesh` runs this rank's rows of the padded window
        table and sums the blend over the group."""
        dev = self.device
        if mesh is None:
            win_idx, win_w = _window_tables(windows, inv_counts, window_group)
            blend = blend_windows
        else:
            from ..parallel.mesh import blend_sharded, local_window_tables

            win_idx, win_w = local_window_tables(windows, inv_counts, mesh, window_group)

            def blend(*a):
                return blend_sharded(*a, mesh)
        idx_dev, w_dev = torch.as_tensor(win_idx, device=dev), torch.as_tensor(win_w, device=dev)
        grid = torch.as_tensor(self.scheduler.timesteps(num_inference_steps), device=dev)
        if sampler == "dpmpp_2m":
            dpm_step = DPMSolverMultistepScheduler(self.scheduler.config).build_step(
                num_inference_steps, device=dev)
        else:
            ddim_step = self.scheduler.build_step(num_inference_steps, eta=eta, device=dev)
        if kps_raw_host is not None:
            budget = int(os.environ.get("VEXPRESS_SAVEMEM_DEV_CACHE_MB", "2048")) << 20
            table_bytes = kps_raw_host.dtype.itemsize * kps_raw_host[0].size * win_idx.size
            raw_groups = None
            if table_bytes <= budget:
                raw_groups = [self._upload_kps(kps_raw_host[win_idx[gi]])
                              for gi in range(win_idx.shape[0])]

            def raw_of_group(gi):
                return (raw_groups[gi] if raw_groups is not None
                        else self._upload_kps(kps_raw_host[win_idx[gi]]))
        predict = self._predict_fn(guidance_scale)

        def step(latents, idx, cond, noise=None, prev_x0=None, has_prev=None):
            if kps_raw_host is None:
                def cond_of_group(_gi):
                    return (*cond, False)
            else:
                def cond_of_group(gi):
                    return (self._kps_features_window(raw_of_group(gi)), *cond[1:], True)
            acc = blend(predict, latents, grid.take(idx), cond_of_group, idx_dev, w_dev)
            if sampler == "dpmpp_2m":
                return dpm_step(acc, idx, latents, prev_x0, has_prev)
            return ddim_step(acc, idx, latents, noise), prev_x0, has_prev

        return step

    def _denoise(self, run, latents, timesteps, num_inference_steps, eta=0.0, generator=None,
                 progress_callback=None):
        """The denoise loop of every mode: `run(latents, i, noise, prev_x0,
        has_prev)` takes one step at grid index i. The grid index of the
        first step is > 0 when `strength` trimmed the schedule (the step's
        tables cover the full grid). With eta > 0 each step's unit noise is
        drawn here from `generator`, in the same order in every mode."""
        idx0 = num_inference_steps - len(timesteps)
        prev_x0 = torch.zeros_like(latents)
        has_prev = torch.zeros((), dtype=torch.bool, device=latents.device)
        for i, t in enumerate(timesteps):
            noise = (None if eta == 0.0 else
                     torch.randn(latents.shape, generator=generator, device=latents.device))
            latents, prev_x0, has_prev = run(latents, idx0 + i, noise, prev_x0, has_prev)
            if progress_callback is not None:
                self._sync()
                progress_callback(i, int(t))
        return latents

    def _fused_step(self, key, build: Callable[[], Callable]) -> "FusedStep":
        """The cached fused step of `key`, made from `build()` on a miss.
        First every entry whose graph no longer reads the denoising UNet's
        weights is evicted: a replaced module, parameter or buffer (a new
        storage) evicts it, an in-place load (`load_state_dict`, `copy_`)
        does not, as JAX evicts its params-bound steps when `params` is
        reassigned."""
        for k in [k for k, e in self._step_cache.items() if not e.serves(self.denoising_unet)]:
            del self._step_cache[k]
        if key not in self._step_cache:
            self._step_cache[key] = FusedStep(build(), self.denoising_unet)
        return self._step_cache[key]

    def _upload_kps(self, frames: np.ndarray) -> torch.Tensor:
        """Raw kps frames to the device: uint8 as they are, float in the
        compute dtype."""
        if frames.dtype == np.uint8:
            return torch.from_numpy(frames).to(self.device)
        return torch.as_tensor(frames, dtype=self.m.dtype, device=self.device)

    # -------------------------------------------------------------------- main

    def __call__(
        self,
        reference_image: np.ndarray,  # (H, W, 3) float [0,1]
        kps_images: np.ndarray,  # (L, H, W, 3) float [0,1] or uint8
        audio_waveform: np.ndarray,  # (T,) float 16 kHz mono
        width: int = 512,
        height: int = 512,
        video_length: Optional[int] = None,
        num_inference_steps: int = 25,
        guidance_scale: float = 3.5,
        strength: float = 1.0,
        eta: float = 0.0,  # stochastic DDIM (Song et al. eq. 12); 0 = the reference's
        sampler: str = "ddim",  # or "dpmpp_2m" (DPM-Solver++ 2M)
        context_schedule: str = "uniform",  # the only schedule the reference ships
        context_frames: int = 24,
        context_overlap: int = 4,
        reference_attention_weight: float = 0.95,
        audio_attention_weight: float = 3.0,
        num_pad_audio_frames: int = 2,
        seed: int = 42,
        window_group: int = 1,
        mode: str = "streamed",  # "fused": one captured step; "sharded": over `mesh`'s ranks
        mesh=None,  # vexpress_torch.parallel.Mesh; sharded mode's default: create_mesh()
        save_memory: bool = False,
        return_latents: bool = False,
        median_filter: bool = False,
        output_uint8: bool = False,
        output_yuv420: bool = False,  # (Y, U, V) uint8 planes for the native encoder
        latents: Optional[np.ndarray] = None,  # (L, h, w, 4) unit initial noise
        progress_callback=None,  # progress_callback(step_index, timestep) after each step
    ):
        """Generate a talking-head video: (L, H, W, 3) float32 in [0,1], or
        uint8 when `output_uint8`, or (Y, U, V) planes when `output_yuv420`;
        the final latents when `return_latents`.

        `strength` < 1 runs only the last `strength` fraction of the schedule
        (the reference's get_timesteps). `eta` > 0 draws each step's noise
        from a torch.Generator seeded by `seed` (the one that draws the
        initial latents when they are not given). `save_memory` keeps the raw
        kps frames on the host, runs the guider per window group and moves
        the reference net, wav2vec2 and audio projection to their host copies
        once conditioning is done (`last_released_cond_mib`); the next call
        brings them back.

        `mode="fused"` runs the same steps as streamed through the cached
        `FusedStep` of the call's settings (`_step_cache`): on a CUDA device
        one CUDA graph, captured at the key's first call and replayed at
        every timestep after that; on the CPU the step called. It takes no
        `save_memory`, as in JAX.

        `mode="sharded"`: every rank of the mesh's group makes this call with
        the same arguments; each computes the conditioning, runs its share of
        the windows and keeps latents equal to every other rank's. Rank 0
        returns the video; the others return None (the latents as well under
        `return_latents`)."""
        if mode not in ("streamed", "fused", "sharded"):
            raise ValueError(f"unknown mode {mode!r} (use 'streamed', 'fused' or 'sharded')")
        if save_memory and mode not in ("streamed", "sharded"):
            raise ValueError("save_memory requires mode='streamed' or 'sharded'")
        if mode == "sharded" and mesh is None:
            from ..parallel.mesh import create_mesh

            mesh = create_mesh()
        if sampler not in ("ddim", "dpmpp_2m"):
            raise ValueError(f"unknown sampler {sampler!r}; choose 'ddim' or 'dpmpp_2m'")
        if sampler == "dpmpp_2m" and eta != 0.0:
            raise ValueError("eta > 0 is the stochastic-DDIM knob; "
                             "dpmpp_2m is a deterministic ODE solver (use eta=0)")
        if not 0.0 < strength <= 1.0:
            raise ValueError(f"strength must be in (0, 1], got {strength}")
        if context_schedule != "uniform":
            # the reference's get_context_scheduler has only "uniform"
            raise ValueError(f"unknown context_schedule {context_schedule!r}")
        if video_length is None:
            video_length = len(kps_images)
        if len(kps_images) != video_length:
            raise ValueError(f"{len(kps_images)} kps frames for video_length={video_length}")
        do_cfg = guidance_scale > 1.0
        dt, dev = self.m.dtype, self.device
        self.timings = {}

        def mark(name: str, t0: float) -> float:
            self._sync()
            now = time.perf_counter()
            self.timings[name] = now - t0
            return now

        with torch.inference_mode():
            t0 = time.perf_counter()
            # a previous save_memory call may have released these
            self.ensure_conditioning_params()
            kps_images = np.asarray(kps_images)
            ref_latent = self._encode_reference(torch.as_tensor(reference_image, dtype=dt,
                                                                device=dev))
            t0 = mark("encode reference latent", t0)
            ref_feats = self._reference_features(ref_latent, do_cfg)
            t0 = mark("reference-net features", t0)
            kps_feat = None
            if not save_memory:
                kps_feat = self._kps_features(self._upload_kps(kps_images))
                t0 = mark("kps features", t0)
            audio_tok = self._audio_tokens(torch.as_tensor(audio_waveform, dtype=dt, device=dev),
                                           video_length, num_pad_audio_frames)
            t0 = mark("audio tokens", t0)
            self.last_released_cond_mib = 0.0
            if save_memory:
                self.last_released_cond_mib = self.release_conditioning_params()

            windows, inv_counts = compute_context_windows(video_length, context_frames,
                                                          context_overlap)
            h, w = height // 8, width // 8
            if latents is not None:
                latents = torch.as_tensor(np.asarray(latents), dtype=torch.float32, device=dev)
                if tuple(latents.shape) != (video_length, h, w, 4):
                    raise ValueError(f"latents shape {tuple(latents.shape)} != "
                                     f"{(video_length, h, w, 4)}")
            gen = torch.Generator(device=dev).manual_seed(seed)
            if latents is None:
                latents = torch.randn((video_length, h, w, 4), generator=gen, device=dev)
            latents = latents * self.scheduler.init_noise_sigma

            ref_scale = torch.tensor(reference_attention_weight, dtype=dt, device=dev)
            audio_scale = torch.tensor(audio_attention_weight, dtype=dt, device=dev)
            timesteps = self.scheduler.timesteps(num_inference_steps)
            if strength < 1.0:
                # the last `strength` fraction of the schedule; steps keep
                # the full grid's spacing
                init_timestep = min(int(num_inference_steps * strength), num_inference_steps)
                timesteps = timesteps[max(num_inference_steps - init_timestep, 0):]
            cond = (kps_feat, audio_tok, ref_feats, ref_scale, audio_scale)
            step_args = (windows, inv_counts, num_inference_steps, guidance_scale, window_group,
                         eta, sampler)
            if mode == "fused":
                # JAX's key, plus what sets the static buffers' shapes, the
                # scheduler whose tables the step holds, and the kernel the
                # graph launches (K1, or K2 under VEXPRESS_FLASH_LITE)
                key = ("fused", video_length, context_frames, context_overlap,
                       num_inference_steps, float(guidance_scale), window_group, float(eta),
                       sampler, height, width, num_pad_audio_frames, self.scheduler.config,
                       flash.FLASH_LITE)
                run = self._fused_step(key, lambda: self._build_denoise_step(*step_args))
                run.load(latents, cond, with_noise=eta != 0.0)
                uncaptured = run.graph is None
            else:
                step = self._build_denoise_step(
                    *step_args, mesh=mesh if mode == "sharded" else None,
                    kps_raw_host=kps_images if save_memory else None)
                grid = torch.arange(num_inference_steps, device=dev)

                def run(lat, i, *state):
                    return step(lat, grid[i], cond, *state)
            latents = self._denoise(run, latents, timesteps, num_inference_steps, eta=eta,
                                    generator=gen, progress_callback=progress_callback)
            t0 = mark("denoise", t0)
            if mode == "fused" and uncaptured and run.graph is not None:  # captured in this call
                self.timings["fused warm-up step and capture"] = run.capture_s
            if return_latents:
                return latents.cpu().numpy()
            if mode == "sharded" and mesh.rank != 0:
                return None
            video = self.decode_latents(latents, median_filter=median_filter,
                                        as_uint8=output_uint8, as_yuv420=output_yuv420)
            mark("decode", t0)
            return video
