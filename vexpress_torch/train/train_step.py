"""Training: the three-stage progressive conditional-dropout recipe.
Counterpart of vexpress_tpu/train/train_step.py.

Reference: train.py -- Net.forward (:44-119), stage trainability wiring
(:363-419), loss construction (:625-638: MSE x lip-mask weight x Min-SNR),
conditional dropout (:622 uncond_ratio; kps_drop_rate :77-82;
reference_drop_rate mutual_self_attention.py:210-213), noise offset (:580-584),
v-prediction targets (:606-614).

PyTorch mapping: the models are the port's modules (a VExpressPipeline's
components), updated in place. `make_optimizer` marks frozen parameters
`requires_grad_(False)` and builds optimizer state for the trainable ones
only (the JAX package's mask_tree); autograd then builds no graph through
frozen modules. The optimizer is optax's chain written out: global-norm
clipping, then AdamW (fp32 or bf16 first moment) or the blockwise 8-bit Adam,
optionally inside optax.MultiSteps' gradient accumulation. Every random draw
of a step is an explicit input of `loss_fn` (`sample_draws` makes them), so a
test can feed both packages the same numbers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from ..diffusion.ddim import DDIMScheduler
from ..parallel.mesh import all_reduce_mean, broadcast_owned, shard_opt_state_zero2
from ..pipelines.pipeline import LATENT_SCALE
from .adam8bit import Adam8bit


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Mirrors training_configs/stage_{1,2,3}.yaml solver/data sections."""

    train_stage: str = "stage_1"
    num_frames: int = 1
    # module_training flags
    train_denoising_unet: bool = True
    train_reference_net: bool = True
    train_v_kps_guider: bool = True
    train_audio_projection: bool = False
    train_motion_module: bool = False
    # solver
    learning_rate: float = 1e-6
    lr_scheduler: str = "constant"  # {constant, linear, cosine}
    lr_warmup_steps: int = 1
    max_train_steps: int = 40000
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    gradient_accumulation_steps: int = 1
    # optimizer state: False/"off" fp32 momenta; True/"8bit" blockwise int8
    # momenta (adam8bit.py); "bf16" a bfloat16 first moment only
    reduce_optimizer_memory: Any = False
    # objective
    prediction_type: str = "v_prediction"  # enable_zero_snr -> v_prediction
    snr_gamma: float = 5.0
    uncond_ratio: float = 0.1
    noise_offset: float = 0.05
    lip_loss_weight: float = 1.0
    kps_drop_rate: float = 0.0
    reference_drop_rate: float = 0.0

    @staticmethod
    def stage(name: str, **overrides) -> "TrainConfig":
        presets = {
            "stage_1": dict(train_stage="stage_1", num_frames=1,
                            train_denoising_unet=True, train_reference_net=True,
                            train_v_kps_guider=True, train_audio_projection=False,
                            train_motion_module=False),
            "stage_2": dict(train_stage="stage_2", num_frames=20,
                            train_denoising_unet=False, train_reference_net=False,
                            train_v_kps_guider=False, train_audio_projection=True,
                            train_motion_module=True),
            # stage_2 restarted from a mid-stage checkpoint: identical
            # trainability, but stage_zero_init is skipped (train.py:380-381)
            "stage_2_resume": dict(train_stage="stage_2_resume", num_frames=20,
                                   train_denoising_unet=False, train_reference_net=False,
                                   train_v_kps_guider=False, train_audio_projection=True,
                                   train_motion_module=True),
            "stage_3": dict(train_stage="stage_3", num_frames=8,
                            train_denoising_unet=True, train_reference_net=True,
                            train_v_kps_guider=True, train_audio_projection=True,
                            train_motion_module=True),
        }
        return TrainConfig(**{**presets[name], **overrides})


@dataclasses.dataclass
class TrainState:
    models: Dict[str, nn.Module]  # updated in place by each step
    optimizer: "TrainOptimizer"
    step: int = 0


@torch.no_grad()
def stage_zero_init(models: Dict[str, nn.Module], train_stage: str) -> Dict[str, nn.Module]:
    """Stage-start zero-init of the denoising UNet's audio-attention output
    (`attn2.to_out.0`) and motion-module output (`temporal_transformer.proj_out`)
    projections (train.py:363-390), in place. Applied at stages 1/2/3 so the
    audio and motion branches start as exact no-ops; `stage_2_resume` skips it
    (train.py:380-381). Returns `models`."""
    if train_stage == "stage_2_resume":
        return models
    if train_stage not in ("stage_1", "stage_2", "stage_3"):
        raise NotImplementedError(f"{train_stage} not implemented")
    for name, p in models["denoising_unet"].named_parameters():
        key = "." + name
        if ".attn2.to_out.0." in key or ".temporal_transformer.proj_out." in key:
            p.zero_()
    return models


def is_trainable(module: str, name: str, cfg: TrainConfig) -> bool:
    """Whether parameter `name` of `module` trains in this stage (train.py:400-419):

    * reference_net: cfg flag, but up_blocks.3 always frozen (:404-406)
    * denoising_unet: cfg flag; motion_modules follow the motion flag;
      attn2/norm2 inside attentions follow the audio_projection flag (:412-419)
    * v_kps_guider / audio_projection: cfg flags; vae and wav2vec2 frozen
    """
    parts = name.split(".")
    if module == "reference_net":
        return cfg.train_reference_net and not name.startswith("up_blocks.3.")
    if module == "v_kps_guider":
        return cfg.train_v_kps_guider
    if module == "audio_projection":
        return cfg.train_audio_projection
    if module == "denoising_unet":
        if "motion_modules" in name:
            return cfg.train_motion_module
        if "attentions" in name and any(x in ("attn2", "norm2") for x in parts):
            return cfg.train_audio_projection
        return cfg.train_denoising_unet
    return False  # vae, wav2vec2


def trainable_mask(models: Dict[str, nn.Module], cfg: TrainConfig) -> Dict[str, Dict[str, bool]]:
    """{module: {parameter name: trains in this stage}}."""
    return {mod: {n: is_trainable(mod, n, cfg) for n, _ in m.named_parameters()}
            for mod, m in models.items()}


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule, in fp32 as optax computes it."""
    if steps <= 0:
        return lambda count: init

    def value(count: int) -> float:
        frac = 1.0 - _f32(min(max(count, 0), steps)) / steps
        return float((init - end) * frac + end)

    return value


def _join(first: Callable[[int], float], second: Callable[[int], float],
          boundary: int) -> Callable[[int], float]:
    """optax.join_schedules with one boundary."""
    return lambda count: first(count) if count < boundary else second(count - boundary)


def make_lr_schedule(cfg: TrainConfig) -> Union[float, Callable[[int], float]]:
    """The HF get_scheduler equivalents of the reference (train.py:484-489),
    as optax computes them: a float, or a function of the update count."""
    warmup = max(cfg.lr_warmup_steps, 0)
    total = max(cfg.max_train_steps, warmup + 1)
    lr = cfg.learning_rate
    if cfg.lr_scheduler == "constant":
        if warmup <= 1:
            return lr
        return _linear(0.0, lr, warmup)
    if cfg.lr_scheduler == "linear":
        return _join(_linear(0.0, lr, warmup), _linear(lr, 0.0, total - warmup), warmup)
    if cfg.lr_scheduler == "cosine":
        decay = total - warmup

        def cosine(count: int) -> float:  # optax.cosine_decay_schedule, fp32
            c = _f32(min(count, decay))
            return float(lr * (0.5 * (1.0 + torch.cos(_f32(math.pi) * c / decay))))

        return _join(_linear(0.0, lr, warmup), cosine, warmup)
    raise ValueError(f"unsupported lr_scheduler {cfg.lr_scheduler}")


class AdamW(torch.optim.Optimizer):
    """optax.adamw, updating in place: fp32 second moment, first moment in
    `mu_dtype` (fp32, or bf16 for the "bf16" memory option; the update itself
    uses the fp32 value before the cast, as optax does), decoupled weight
    decay on the pre-update parameter, p += (-lr * update) cast to p's dtype.
    `lr` is a float or a schedule of the update count (looked up before the
    count is incremented)."""

    def __init__(self, params, lr: Union[float, Callable[[int], float]] = 1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 1e-4,
                 mu_dtype: torch.dtype = torch.float32):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                                      mu_dtype=mu_dtype))
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW takes no closure")
        count = self.count + 1
        for group in self.param_groups:
            lr = group["lr"](self.count) if callable(group["lr"]) else group["lr"]
            b1, b2 = group["betas"]
            c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** count
            c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** count
            for p in group["params"]:
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros(p.shape, dtype=group["mu_dtype"], device=p.device)
                    state["nu"] = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                g = (p.grad if p.grad is not None else torch.zeros_like(p)).float()
                # b1 * mu in mu's dtype, b1 rounded to it first, as optax computes it
                mu = (1.0 - b1) * g + torch.tensor(b1, dtype=state["mu"].dtype) * state["mu"]
                nu = (1.0 - b2) * (g * g) + b2 * state["nu"]
                c1d, c2d = c1.to(g.device), c2.to(g.device)
                upd = (mu / c1d) / (torch.sqrt(nu / c2d) + group["eps"])
                upd = upd + group["weight_decay"] * p.float()
                state["mu"], state["nu"] = mu.to(group["mu_dtype"]), nu
                p.add_((upd * -lr).to(p.dtype))
        self.count = count


class TrainOptimizer:
    """optax.chain(clip_by_global_norm(max_norm), inner), inside
    optax.MultiSteps when accumulating, over the trainable parameters.

    `step()` reads each parameter's .grad (None counts as zero), which autograd
    gives in the parameter's dtype, as jax.grad does. With accumulation_steps
    k > 1 it keeps the running mean of the mini-steps' gradients,
    (g + n * acc) / (n + 1), in fp32 and updates only at every k-th call;
    returns whether it updated. The clipped gradient, g / |g| * max_norm when
    the global norm |g| (accumulated in fp32) is not below max_norm, is left in
    .grad in the parameter's dtype for the inner optimizer.

    Data-parallel (`mesh` given): at an update the gradients (the running
    mean when accumulating, which is linear, so once) are averaged over the
    group (`all_reduce_mean`), every rank clips alike, `inner` steps the
    tensors this rank owns (`owners[i]` is the rank of `params[i]`;
    `make_optimizer` builds `inner` over those only) and each owner
    broadcasts its updated tensors."""

    def __init__(self, params: List[torch.Tensor], inner: torch.optim.Optimizer,
                 max_grad_norm: float, accumulation_steps: int = 1, mesh=None,
                 owners: Optional[List[int]] = None):
        self.params = params
        self.inner = inner
        self.max_grad_norm = max_grad_norm
        self.k = accumulation_steps
        self.mini_step = 0
        self.acc: Optional[List[torch.Tensor]] = None
        self.mesh = mesh
        self.owners = owners if owners is not None else [0] * len(params)

    @torch.no_grad()
    def step(self) -> bool:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.k > 1:
            n = self.mini_step
            if self.acc is None:
                self.acc = [torch.zeros_like(g, dtype=torch.float32) for g in grads]
            self.acc = [(g.float() + n * a) / (n + 1) for g, a in zip(grads, self.acc)]
            self.mini_step = (n + 1) % self.k
            if self.mini_step:
                return False
            grads = [a.to(p.dtype) for a, p in zip(self.acc, self.params)]
            self.acc = None
        if self.mesh is not None:
            grads = all_reduce_mean(grads, self.mesh)
        norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
        if not bool(norm < self.max_grad_norm):
            grads = [(g / norm.to(g.dtype)) * self.max_grad_norm for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g
        self.inner.step()
        if self.mesh is not None:
            broadcast_owned(self.params, self.owners, self.mesh)
        return True

    def owned(self) -> List[torch.Tensor]:
        """The parameters whose optimizer state this rank keeps."""
        rank = 0 if self.mesh is None else self.mesh.rank
        return [p for p, r in zip(self.params, self.owners) if r == rank]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None


def sharded_optimizer(named: Dict[str, torch.Tensor], make_inner, max_grad_norm: float,
                      accumulation_steps: int = 1, mesh=None) -> TrainOptimizer:
    """A TrainOptimizer over the tensors of `named`, its inner optimizer
    `make_inner(param_groups)` built over the tensors this rank owns
    (`shard_opt_state_zero2`; all of them without a mesh)."""
    params = list(named.values())
    owners = None
    if mesh is not None:
        by_name = shard_opt_state_zero2(named, mesh)
        owners = [by_name[n] for n in named]
    opt = TrainOptimizer(params, None, max_grad_norm, accumulation_steps, mesh, owners)
    opt.inner = make_inner([{"params": opt.owned()}])
    return opt


def make_optimizer(models: Dict[str, nn.Module], cfg: TrainConfig, mesh=None
                   ) -> Tuple[TrainOptimizer, Dict[str, Dict[str, bool]]]:
    """Global-norm clipping, then AdamW or the 8-bit Adam, on the trainable
    parameters only (train.py:464-489 + accelerate grad-accum). Sets
    requires_grad on every parameter of `models` from the stage's mask, so
    frozen parameters get no gradient and no optimizer state. With a `mesh`,
    the optimizer state is ZeRO-2-sharded (`TrainOptimizer`)."""
    mask = trainable_mask(models, cfg)
    named = {}
    for mod, m in models.items():
        for name, p in m.named_parameters():
            p.requires_grad_(mask[mod][name])
            if mask[mod][name]:
                named[f"{mod}.{name}"] = p
    lr = make_lr_schedule(cfg)
    betas = (cfg.adam_beta1, cfg.adam_beta2)
    reduce = cfg.reduce_optimizer_memory
    if reduce is True or reduce == "8bit":
        def make_inner(groups):
            return Adam8bit(groups, lr, betas=betas, eps=cfg.adam_epsilon,
                            weight_decay=cfg.adam_weight_decay)
    else:
        def make_inner(groups):
            return AdamW(groups, lr, betas=betas, eps=cfg.adam_epsilon,
                         weight_decay=cfg.adam_weight_decay,
                         mu_dtype=torch.bfloat16 if reduce == "bf16" else torch.float32)
    return sharded_optimizer(named, make_inner, cfg.max_grad_norm,
                             cfg.gradient_accumulation_steps, mesh), mask


def sample_draws(generator: torch.Generator, cfg: TrainConfig, batch_size: int, frames: int,
                 latent_hw: Tuple[int, int], num_train_timesteps: int = 1000,
                 device=None) -> Dict[str, torch.Tensor]:
    """Every random number of one step (the draws of the JAX loss_fn's eight
    keys), drawn on the generator's device and moved to `device`:

      timesteps (B,) int; noise (B, F, h, w, 4) and offset_noise
      (B, 1, 1, 1, 4) fp32; uncond () bool (whole-batch unconditional
      forward); kps_keep (B, 1, 1, 1, 1) and reference_keep (B, 1, 1) fp32
      (used only when the drop rates are > 0); vae_target (B*F, h, w, 4) and
      vae_reference (B, h, w, 4) fp32, the VAE posterior noises.

    A CPU generator thus gives the same draws to a run on the card and one on
    the CPU."""
    b, f = batch_size, frames
    h, w = latent_hw
    kw = dict(generator=generator, device=generator.device)
    draws = dict(
        timesteps=torch.randint(0, num_train_timesteps, (b,), **kw),
        noise=torch.randn((b, f, h, w, 4), **kw),
        offset_noise=torch.randn((b, 1, 1, 1, 4), **kw),
        uncond=torch.rand((), **kw) < cfg.uncond_ratio,
        kps_keep=(torch.rand((b, 1, 1, 1, 1), **kw) >= cfg.kps_drop_rate).float(),
        reference_keep=(torch.rand((b, 1, 1), **kw) >= cfg.reference_drop_rate).float(),
        vae_target=torch.randn((b * f, h, w, 4), **kw),
        vae_reference=torch.randn((b, h, w, 4), **kw),
    )
    return {k: v.to(device) for k, v in draws.items()}


def build_train_step(pipeline, cfg: TrainConfig, optimizer: TrainOptimizer,
                     scheduler: Optional[DDIMScheduler] = None):
    """Returns (train_step, loss_fn).

    `pipeline` is a VExpressPipeline of the port (its `.m` and
    `components()`); its modules are put in training mode, which turns on the
    denoising UNet's gradient checkpointing where its config asks for it.

    loss_fn(models, batch, draws) -> scalar loss; train_step(state, batch,
    generator) -> (state, {"loss": float tensor}) draws with `sample_draws`,
    back-propagates and steps the optimizer. Data-parallel (the optimizer's
    `mesh`): `batch` is this rank's b rows of a global batch of b * world,
    the draws are the global batch's (the same generator state on every
    rank) cut to this rank's rows, and the loss returned is the global
    mean.

    batch (the dataset's tensors, on the models' device):
      target_images: (B, F, H, W, 3) in [-1, 1]
      reference_image: (B, H, W, 3) in [-1, 1]
      kps_images: (B, F, H, W, 3) in [0, 1]
      audio_frame_embeddings: (B, F, 10, 768) precomputed wav2vec2 windows
      lip_masks: (B, F, h, w) in [0, 1] at latent resolution
    """
    sched = scheduler or DDIMScheduler(
        prediction_type=cfg.prediction_type,
        rescale_betas_zero_snr=cfg.prediction_type == "v_prediction",
    )
    cross_dim = pipeline.m.unet_config.cross_attention_dim
    for mod in pipeline.components().values():
        mod.train()

    def loss_fn(models: Dict[str, nn.Module], batch: Dict[str, torch.Tensor],
                draws: Dict[str, torch.Tensor]) -> torch.Tensor:
        vae = models["vae"]
        target = batch["target_images"]
        b, f = target.shape[0], target.shape[1]

        # frozen VAE encodes (train.py:571-577, 595-598): sampled posterior
        with torch.no_grad():
            flat = target.reshape((b * f,) + tuple(target.shape[2:]))
            latents = vae.encode_sample(flat, draws["vae_target"])
            latents = latents.reshape((b, f) + tuple(latents.shape[1:])) * LATENT_SCALE
            ref_latents = vae.encode_sample(batch["reference_image"],
                                            draws["vae_reference"]) * LATENT_SCALE

        # noise + offset (train.py:579-584)
        noise = draws["noise"].float()
        if cfg.noise_offset > 0:
            noise = noise + cfg.noise_offset * draws["offset_noise"].float()
        timesteps = draws["timesteps"]
        noisy = sched.add_noise(latents, noise, timesteps[:, None])
        if cfg.prediction_type == "epsilon":
            target_pred = noise
        else:
            target_pred = sched.get_velocity(latents, noise, timesteps[:, None])

        # conditional dropout: whole-batch unconditional forward (train.py:622)
        keep_cond = 1.0 - draws["uncond"].float()

        # kps conditioning (+ per-sample dropout, train.py:77-82)
        kps_feat = models["v_kps_guider"](batch["kps_images"])
        if cfg.kps_drop_rate > 0:
            kps_feat = kps_feat * draws["kps_keep"].to(kps_feat.dtype)
        kps_feat = kps_feat * keep_cond.to(kps_feat.dtype)

        # audio tokens (train.py:84-90)
        afe = batch["audio_frame_embeddings"]
        tok = models["audio_projection"](afe.reshape((-1,) + tuple(afe.shape[2:])))
        tok = tok.reshape((b, f) + tuple(tok.shape[1:])) * keep_cond.to(tok.dtype)

        # reference features at t=0 (train.py:92-110); uncond zeroes the banks
        ctx0 = torch.zeros((b, 1, cross_dim), dtype=latents.dtype, device=latents.device)
        _, ref_feats = models["reference_net"](
            ref_latents, torch.zeros((b,), dtype=torch.long, device=latents.device), ctx0)
        ref_feats = tuple(r * keep_cond.to(r.dtype) for r in ref_feats)
        if cfg.reference_drop_rate > 0:
            ref_feats = tuple(r * draws["reference_keep"].to(r.dtype) for r in ref_feats)

        pred = models["denoising_unet"](noisy, timesteps, tok, ref_feats, kps_feat, 1.0, 1.0)

        # loss (train.py:625-638)
        loss = (pred.float() - target_pred.float()) ** 2
        if cfg.lip_loss_weight != 1.0 and "lip_masks" in batch:
            w = (cfg.lip_loss_weight - 1.0) * batch["lip_masks"][..., None].float() + 1.0
            loss = loss * w
        if cfg.snr_gamma != 0:
            snr = sched.snr(timesteps)
            if cfg.prediction_type == "v_prediction":
                snr = snr + 1.0
            weights = torch.clamp(snr, max=cfg.snr_gamma) / snr
            loss = loss.mean(dim=tuple(range(1, loss.dim()))) * weights
        return loss.mean()

    mesh = None if optimizer is None else optimizer.mesh  # None: a caller of loss_fn alone

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        target = batch["target_images"]
        b, f, hh, ww = target.shape[:4]
        world, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
        # the draws of the global batch, from a generator in the same state
        # on every rank; this rank's rows (uncond is one for the whole batch)
        draws = sample_draws(generator, cfg, b * world, f, (hh // 8, ww // 8),
                             sched.config.num_train_timesteps, device=target.device)
        draws = {k: v if v.dim() == 0 else
                 v[rank * b * (f if k == "vae_target" else 1):
                   (rank + 1) * b * (f if k == "vae_target" else 1)]
                 for k, v in draws.items()}
        loss = loss_fn(state.models, batch, draws)
        loss.backward()
        state.optimizer.step()
        state.optimizer.zero_grad()
        state.step += 1
        loss = loss.detach()
        if mesh is not None:  # the global batch's mean
            loss = all_reduce_mean([loss], mesh)[0]
        return state, {"loss": loss}

    return train_step, loss_fn
