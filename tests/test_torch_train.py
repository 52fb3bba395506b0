"""Parity of vexpress_torch's training path with vexpress_tpu's on the CPU, fp32.

The JAX side is compiled once for the module: one jitted value_and_grad of
`build_train_step`'s loss_fn over every parameter (a stop_gradient on frozen
parameters does not change the loss or the trainable parameters' gradients,
so one compile serves stages 2 and 3). Its random draws are replayed with
JAX's own keys and calls (`jax.random.split(rng, 8)` as loss_fn splits it)
and handed to the port's `loss_fn`, so both sides compute from the same
numbers. The optimizer half of the JAX step (mask_tree, make_optimizer's tx,
apply_updates_masked, as its train_step runs them) runs eagerly.

Tolerances: loss 1e-5 relative; gradients max|d| <= 1e-4 * max|g| per tensor;
parameters after a step 1e-6 absolute (lr 1e-3); schedules, DDIM helpers and
the 8-bit Adam 1e-6 to 1e-7 as stated at each test.
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from vexpress_tpu.diffusion.ddim import DDIMScheduler as JDDIM
from vexpress_tpu.models import unet_3d as j_u3
from vexpress_tpu.models import vae as j_vae
from vexpress_tpu.models import wav2vec2 as j_w
from vexpress_tpu.pipelines import pipeline as j_pipe
from vexpress_tpu.train import adam8bit as j_a8
from vexpress_tpu.train import config as j_config
from vexpress_tpu.train import train_step as jts
from vexpress_torch.diffusion.ddim import DDIMScheduler as TDDIM
from vexpress_torch.io import load_pipeline_jax_params
from vexpress_torch.io.torch_export import export_to_torch_state_dict, wav2vec2_torch_key
from vexpress_torch.models import unet_3d as t_u3
from vexpress_torch.models import vae as t_vae
from vexpress_torch.models import wav2vec2 as t_w
from vexpress_torch.pipelines import pipeline as t_pipe
from vexpress_torch.train import adam8bit as t_a8
from vexpress_torch.train import config as t_config
from vexpress_torch.train import train_step as tts

from .torch_port_utils import close, jax_apply, jax_init, rand, t

CROSS = 12
H = W = 64
h = w = H // 8
B, F = 2, 2
UNET_KW = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1, attention_head_dim=2,
               cross_attention_dim=CROSS, norm_num_groups=4, motion_num_attention_heads=2,
               motion_max_len=8)
VAE_KW = dict(block_out_channels=(8, 8, 8, 8), layers_per_block=1, norm_num_groups=4)
W2V_KW = dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2, intermediate_size=32,
              conv_dim=(8, 8), conv_kernel=(10, 3), conv_stride=(5, 2),
              num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
APROJ_KW = dict(dim=16, depth=1, dim_head=4, heads=2, num_queries=5, embedding_dim=16,
                output_dim=CROSS, max_seq_len=10)
GUIDER_KW = dict(conditioning_embedding_channels=8, block_out_channels=(4, 4, 8, 8))
# what the loss depends on besides the models; trainability comes from the stage
LOSS_KW = dict(num_frames=F, lip_loss_weight=2.0, kps_drop_rate=0.5, reference_drop_rate=0.5,
               learning_rate=1e-3, adam_epsilon=1e-3)
KEY = 3  # a jax.random.PRNGKey whose draws keep the batch conditional (uncond False)
STAGES = ("stage_1", "stage_2", "stage_2_resume", "stage_3")


def _jax_params(jp, cfg):
    f32 = np.float32
    refs = tuple(jnp.zeros((1, l, c), f32) for l, c in cfg.ref_feature_shapes(h, w))
    return {
        "vae": jax_init(jp.vae, jnp.zeros((1, H, W, 3), f32), seed=1),
        "reference_net": jax_init(jp.reference_net, jnp.zeros((1, h, w, 4), f32),
                                  jnp.zeros((1,), jnp.int32), jnp.zeros((1, 1, CROSS), f32), seed=2),
        "denoising_unet": jax_init(jp.denoising_unet, jnp.zeros((1, 2, h, w, 4), f32),
                                   jnp.zeros((1,), jnp.int32), jnp.zeros((1, 2, 5, CROSS), f32),
                                   refs, jnp.zeros((1, 2, h, w, 8), f32), seed=3),
        "v_kps_guider": jax_init(jp.v_kps_guider, jnp.zeros((1, 1, H, W, 3), f32), seed=4),
        "wav2vec2": jax_init(jp.audio_encoder, jnp.zeros((1, 4000), f32), seed=5),
        "audio_projection": jax_init(jp.audio_projection, jnp.zeros((1, 10, 16), f32), seed=6),
    }


def _batch():
    rng = np.random.default_rng(0)
    f32 = np.float32
    return {
        "target_images": rng.uniform(-1, 1, size=(B, F, H, W, 3)).astype(f32),
        "reference_image": rng.uniform(-1, 1, size=(B, H, W, 3)).astype(f32),
        "kps_images": rng.uniform(0, 1, size=(B, F, H, W, 3)).astype(f32),
        "audio_frame_embeddings": rng.normal(size=(B, F, 10, 16)).astype(f32),
        "lip_masks": rng.uniform(0, 1, size=(B, F, h, w)).astype(f32),
    }


def replay_draws(key, cfg) -> dict:
    """The draws of the JAX loss_fn for `key`, with its own keys and calls."""
    r_t, r_noise, r_uncond, r_kps, r_refdrop, r_vae1, r_vae2, r_off = jax.random.split(key, 8)
    uniform, normal = jax.random.uniform, jax.random.normal
    draws = dict(
        timesteps=jax.random.randint(r_t, (B,), 0, 1000),
        noise=normal(r_noise, (B, F, h, w, 4), jnp.float32),
        offset_noise=normal(r_off, (B, 1, 1, 1, 4), jnp.float32),
        uncond=uniform(r_uncond, ()) < cfg.uncond_ratio,
        kps_keep=(uniform(r_kps, (B, 1, 1, 1, 1)) >= cfg.kps_drop_rate).astype(jnp.float32),
        reference_keep=(uniform(r_refdrop, (B, 1, 1)) >= cfg.reference_drop_rate).astype(
            jnp.float32),
        vae_target=normal(r_vae1, (B * F, h, w, 4), jnp.float32),
        vae_reference=normal(r_vae2, (B, h, w, 4), jnp.float32),
    )
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX reference, one compile for the module: its pipeline, params,
    batch, the jitted value_and_grad of loss_fn over every parameter, and
    that function's loss and gradients at the params."""
    jm = j_pipe.PipelineModels(
        unet_config=j_u3.UNetConfig(**UNET_KW), vae_config=j_vae.VAEConfig(**VAE_KW),
        wav2vec2_config=j_w.Wav2Vec2Config(**W2V_KW), audio_projection_kwargs=APROJ_KW,
        guider_kwargs=GUIDER_KW)
    jp = j_pipe.VExpressPipeline(jm, {})
    params = _jax_params(jp, jm.unet_config)
    batch = _batch()
    jcfg = jts.TrainConfig.stage("stage_3", **LOSS_KW)
    tx, _ = jts.make_optimizer(params, jcfg)
    _, loss_fn = jts.build_train_step(jp, jcfg, tx, mask=None)
    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    loss, grads = value_and_grad(params, batch, jax.random.PRNGKey(KEY))
    return dict(pipe=jp, params=params, batch=batch, value_and_grad=value_and_grad,
                loss=float(loss), grads=jax.device_get(grads))


def port_pipeline(params, checkpointing=False):
    tm = t_pipe.PipelineModels(
        unet_config=t_u3.UNetConfig(**UNET_KW, gradient_checkpointing=checkpointing),
        vae_config=t_vae.VAEConfig(**VAE_KW), wav2vec2_config=t_w.Wav2Vec2Config(**W2V_KW),
        audio_projection_kwargs=APROJ_KW, guider_kwargs=GUIDER_KW)
    return load_pipeline_jax_params(t_pipe.VExpressPipeline(tm, device="cpu"), params)


def _torch_tree(params_module, module: str) -> dict:
    """A JAX module tree in the port's state-dict keys and layouts."""
    sd = export_to_torch_state_dict(params_module)
    if module == "wav2vec2":
        sd = {wav2vec2_torch_key(k): v for k, v in sd.items()}
    return sd


# ------------------------------------------------------------ DDIM and VAE


def test_ddim_training_helpers_match_jax():
    """add_noise, get_velocity and snr at 1e-6."""
    js, ts_ = JDDIM(), TDDIM()
    steps = np.array([0, 1, 250, 998, 999], np.int32)
    x, n = rand((5, 2, 3, 3, 4), 1), rand((5, 2, 3, 3, 4), 2)
    for name in ("add_noise", "get_velocity"):
        ref = np.asarray(getattr(js, name)(jnp.asarray(x), jnp.asarray(n), jnp.asarray(steps)[:, None]))
        got = getattr(ts_, name)(t(x), t(n), torch.from_numpy(steps)[:, None]).numpy()
        close(got, ref, 1e-6, name)
    close(ts_.snr(torch.from_numpy(steps)).numpy(), np.asarray(js.snr(jnp.asarray(steps))), 1e-6)


def test_vae_encode_sample_matches_jax(jax_side):
    """encode_moments and encode_sample with shared posterior noise at 1e-5."""
    jp, params = jax_side["pipe"], jax_side["params"]
    vae = port_pipeline(params).vae
    x = np.random.default_rng(3).uniform(-1, 1, (2, H, W, 3)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    noise = np.asarray(jax.random.normal(key, (2, h, w, 4), jnp.float32))
    ref = jax_apply(jp.vae, params["vae"], jnp.asarray(x), key, method=j_vae.AutoencoderKL.encode_sample)
    mean_ref, logvar_ref = jax_apply(jp.vae, params["vae"], jnp.asarray(x),
                                     method=j_vae.AutoencoderKL.encode_moments)
    with torch.no_grad():
        mean, logvar = vae.encode_moments(t(x))
        got = vae.encode_sample(t(x), noise=t(noise))
    close(mean.numpy(), mean_ref, 1e-5, "mean")
    close(logvar.numpy(), logvar_ref, 1e-5, "logvar")
    close(got.numpy(), ref, 1e-5, "sample")


def test_gradient_checkpointing_matches_plain(jax_side):
    """The denoising UNet's per-block checkpointing in training mode (the
    JAX package's nn.remat): the same outputs and gradients with the flag on
    and off, at 1e-5."""
    params = jax_side["params"]
    plain = port_pipeline(params).denoising_unet.train()
    ckpt = port_pipeline(params, checkpointing=True).denoising_unet.train()
    cfg = plain.config
    rng = np.random.default_rng(17)
    refs = [t(rng.normal(size=(1, l, c))) for l, c in cfg.ref_feature_shapes(h, w)]
    args = (t(rng.normal(size=(1, F, h, w, 4))), torch.tensor([250]),
            t(rng.normal(size=(1, F, 5, CROSS))), refs, t(rng.normal(size=(1, F, h, w, 8))),
            0.9, 2.0)
    outs = []
    for unet in (plain, ckpt):
        unet.requires_grad_(True)
        out = unet(*args)
        (out**2).mean().backward()
        outs.append((out.detach(), {n: p.grad for n, p in unet.named_parameters()}))
    close(outs[1][0].numpy(), outs[0][0].numpy(), 1e-5, "output")
    assert outs[0][1].keys() == outs[1][1].keys()
    for name, g in outs[0][1].items():
        close(outs[1][1][name].numpy(), g.numpy(), 1e-5, name)


# ------------------------------------------------------------ stage wiring


@pytest.mark.parametrize("stage", STAGES)
def test_trainable_mask_matches_jax(jax_side, stage):
    """The port's trainable parameter names equal the JAX mask's True leaves
    mapped through the export key map."""
    params = jax_side["params"]
    jmask = jts.trainable_mask(params, jts.TrainConfig.stage(stage))
    tmask = tts.trainable_mask(port_pipeline(params).components(), tts.TrainConfig.stage(stage))
    for module, tree in jmask.items():
        flags = _torch_tree(jax.tree_util.tree_map(np.float32, tree), module)
        want = {k for k, v in flags.items() if v}
        got = {k for k, v in tmask[module].items() if v}
        assert set(flags) == set(tmask[module]), module
        assert got == want, (module, sorted(got ^ want)[:10])


def test_stage_zero_init_matches_jax(jax_side):
    params = jax_side["params"]
    for stage in ("stage_2", "stage_2_resume"):
        models = tts.stage_zero_init(port_pipeline(params).components(), stage)
        want = _torch_tree(jts.stage_zero_init(params, stage)["denoising_unet"], "denoising_unet")
        got = models["denoising_unet"].state_dict()
        assert want.keys() == got.keys()
        assert all(np.array_equal(got[k].numpy(), want[k]) for k in want)
        zeroed = {k for k, v in want.items() if not v.any()}  # jax_init makes no zero leaf
        assert bool(zeroed) == (stage != "stage_2_resume")
        assert all(".attn2.to_out.0." in "." + k or ".temporal_transformer.proj_out." in "." + k
                   for k in zeroed)


# ------------------------------------------------------------- optimizers


@pytest.mark.parametrize("kind", ["constant", "warmup", "linear", "cosine"])
def test_lr_schedule_matches_optax(kind):
    """make_lr_schedule over 50 steps at 1e-7 of the peak rate."""
    lr = 1e-4
    cfg = dict(constant=dict(lr_scheduler="constant", lr_warmup_steps=1),
               warmup=dict(lr_scheduler="constant", lr_warmup_steps=10),
               linear=dict(lr_scheduler="linear", lr_warmup_steps=5, max_train_steps=40),
               cosine=dict(lr_scheduler="cosine", lr_warmup_steps=5, max_train_steps=40))[kind]
    jsched = jts.make_lr_schedule(jts.TrainConfig(learning_rate=lr, **cfg))
    tsched = tts.make_lr_schedule(tts.TrainConfig(learning_rate=lr, **cfg))
    for count in range(50):
        want = float(jsched(count)) if callable(jsched) else jsched
        got = tsched(count) if callable(tsched) else tsched
        assert abs(got - want) <= 1e-7 * lr, (count, got, want)


def _small_tree(seed):
    """(70 x 100) quantized leaf (7000 elements, a padded last block), a (64,)
    leaf that stays fp32."""
    return {"lat": rand((70, 100), seed, 0.1), "vec": rand((64,), seed + 1, 0.1)}


def test_adam8bit_matches_jax():
    """Three steps of the 8-bit Adam with identical grads: codes equal except
    at rounding ties (at most 0.1% off by one), scales and params at 1e-6."""
    params = _small_tree(0)
    jtx = j_a8.adam8bit(1e-2, weight_decay=1e-2)
    jp_ = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp_)
    tp = {k: torch.nn.Parameter(t(v)) for k, v in params.items()}
    topt = t_a8.Adam8bit(list(tp.values()), 1e-2, weight_decay=1e-2)
    for step in range(3):
        grads = _small_tree(10 + 2 * step)
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jp_)
        jp_ = optax.apply_updates(jp_, upd)
        for k, p in tp.items():
            p.grad = t(grads[k])
        topt.step()
    for k, p in tp.items():
        close(p.detach().numpy(), np.asarray(jp_[k]), 1e-6, k)
    for moment in ("mu", "nu"):
        jq = getattr(jstate, moment)["lat"]
        tq = topt.state[tp["lat"]][moment]
        diff = np.abs(tq.codes.numpy().astype(int) - np.asarray(jq.codes).astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (moment, diff.max())
        close(tq.scales.numpy(), np.asarray(jq.scales), 1e-6, moment)
    close(topt.state[tp["vec"]]["mu"].numpy(), np.asarray(jstate.mu["vec"]), 1e-6)


class _Leaves(torch.nn.Module):
    def __init__(self, tree):
        super().__init__()
        for k, v in tree.items():
            setattr(self, k, torch.nn.Parameter(t(v)))


@pytest.mark.parametrize("reduce,accumulate", [(False, 1), ("bf16", 1), (True, 1), (False, 2)])
def test_make_optimizer_matches_jax(reduce, accumulate):
    """make_optimizer (global-norm clipping, then AdamW, AdamW with a bf16
    first moment, or the 8-bit Adam; optionally MultiSteps accumulation) on a
    two-leaf module over four steps with identical grads, params at 1e-6."""
    tree = _small_tree(3)
    kw = dict(train_audio_projection=True, learning_rate=1e-2, max_grad_norm=0.5,
              lr_scheduler="linear", lr_warmup_steps=2, max_train_steps=10,
              reduce_optimizer_memory=reduce, gradient_accumulation_steps=accumulate)
    jparams = {"audio_projection": {"params": {k: jnp.asarray(v) for k, v in tree.items()}}}
    jtx, jmask = jts.make_optimizer(jparams, jts.TrainConfig(**kw))
    jstate = jtx.init(jts.mask_tree(jparams, jmask))
    mod = _Leaves(tree)
    topt, _ = tts.make_optimizer({"audio_projection": mod}, tts.TrainConfig(**kw))
    for step in range(4):
        grads = {k: rand(v.shape, 20 + 2 * step + i, 1.0 if step % 2 else 0.01)
                 for i, (k, v) in enumerate(tree.items())}
        jg = {"audio_projection": {"params": {k: jnp.asarray(v) for k, v in grads.items()}}}
        upd, jstate = jtx.update(jts.mask_tree(jg, jmask), jstate, jts.mask_tree(jparams, jmask))
        jparams = jts.apply_updates_masked(jparams, upd, jmask)
        for k, p in mod.named_parameters():
            p.grad = t(grads[k])
        topt.step()
        topt.zero_grad()
        for k, p in mod.named_parameters():
            close(p.detach().numpy(), np.asarray(jparams["audio_projection"]["params"][k]), 1e-6,
                  f"step {step} {k}")


@pytest.mark.parametrize("name", ["stage_1", "stage_2", "stage_3"])
def test_config_routing_matches_jax(name):
    with open(f"configs/{name}.yaml") as f:
        cfg = yaml.safe_load(f)
    assert t_config.check_config_keys(cfg) == j_config.check_config_keys(cfg)
    bad = dict(cfg, typo_key=1, solver=dict(cfg["solver"], use_8bit_adm=True))
    assert t_config.check_config_keys(bad) == j_config.check_config_keys(bad)
    for cli in ("", "bf16", "fp16", "fp32"):
        assert t_config.resolve_dtype(cfg, cli) == j_config.resolve_dtype(cfg, cli)
    for n in (1, 8):
        assert t_config.effective_learning_rate(cfg, n) == j_config.effective_learning_rate(cfg, n)
        scaled = dict(cfg, solver=dict(cfg["solver"], scale_lr=True))
        assert (t_config.effective_learning_rate(scaled, n)
                == j_config.effective_learning_rate(scaled, n))
    t_config.validate_config(cfg)
    for zero_snr in (True, False):
        assert (t_config.scheduler_kwargs(cfg, zero_snr)
                == j_config.scheduler_kwargs(cfg, zero_snr))
    for broken in (dict(cfg, data=dict(cfg["data"], audio_embeddings_type="frame")),
                   dict(cfg, weight_dtype="int8")):
        with pytest.raises(ValueError):
            t_config.validate_config(broken)
        with pytest.raises(ValueError):
            j_config.validate_config(broken)


# ------------------------------------------------------- loss and train step


def _port_setup(params, stage, checkpointing, **overrides):
    pipe = port_pipeline(params, checkpointing)
    cfg = tts.TrainConfig.stage(stage, **LOSS_KW, **overrides)
    optimizer, mask = tts.make_optimizer(pipe.components(), cfg)
    step_fn, loss_fn = tts.build_train_step(pipe, cfg, optimizer)
    batch = {k: t(v) for k, v in _batch().items()}
    return pipe, cfg, optimizer, mask, step_fn, loss_fn, batch


def _assert_grads_match(models, mask, jgrads):
    for module, flags in mask.items():
        want = _torch_tree(jgrads[module], module)
        for name, p in models[module].named_parameters():
            if not flags[name]:
                assert p.grad is None and not p.requires_grad, (module, name)
                continue
            g = np.zeros_like(want[name]) if p.grad is None else p.grad.numpy()
            scale = max(float(np.abs(want[name]).max()), 1e-12)
            err = float(np.abs(g - want[name]).max())
            assert err <= 1e-4 * scale, (module, name, err, scale)


@pytest.mark.parametrize("stage,checkpointing", [("stage_2", True), ("stage_3", False)])
def test_loss_and_grads_match_jax(jax_side, stage, checkpointing):
    """loss_fn and its gradients with replayed draws: loss at 1e-5 relative,
    each trainable tensor's gradient within 1e-4 of its max; frozen tensors
    get no gradient. Stage 2 runs the UNet under gradient checkpointing, as
    configs/stage_2.yaml does."""
    params, jloss, jgrads = jax_side["params"], jax_side["loss"], jax_side["grads"]
    pipe, cfg, _, mask, _, loss_fn, batch = _port_setup(params, stage, checkpointing)
    draws = replay_draws(jax.random.PRNGKey(KEY), cfg)
    assert not bool(draws["uncond"]) and draws["kps_keep"].sum() == 1  # conditional, one kept
    loss = loss_fn(pipe.components(), batch, draws)
    loss.backward()
    assert abs(float(loss) - jloss) <= 1e-5 * abs(jloss)
    _assert_grads_match(pipe.components(), mask, jgrads)


def _jax_optimizer_step(params, grads, cfg):
    """The optimizer half of the JAX train_step: mask_tree, make_optimizer's
    tx, apply_updates_masked. The 8-bit Adam quantizes leaf by leaf, so it
    runs on the trees. AdamW is elementwise and the clip reads one global
    norm, so it runs, far faster eagerly, on the trainable leaves concatenated
    into one leaf (make_optimizer on a one-leaf tree of a trainable module)."""
    tx, mask = jts.make_optimizer(params, cfg)
    p_tree, g_tree = jts.mask_tree(params, mask), jts.mask_tree(grads, mask)
    if cfg.reduce_optimizer_memory:
        updates, _ = tx.update(g_tree, tx.init(p_tree), p_tree)
        return jts.apply_updates_masked(params, updates, mask)
    p_leaves, g_leaves = jax.tree_util.tree_leaves(p_tree), jax.tree_util.tree_leaves(g_tree)

    def one(leaves):
        return {"audio_projection": {"params": {"v": jnp.concatenate(
            [jnp.ravel(x) for x in leaves])}}}

    tx1, _ = jts.make_optimizer(one(p_leaves), cfg)
    flat, _ = tx1.update(one(g_leaves), tx1.init(one(p_leaves)), one(p_leaves))
    flat = flat["audio_projection"]["params"]["v"]
    offsets = np.cumsum([0] + [x.size for x in p_leaves])
    updates = [flat[a:b].reshape(x.shape) for a, b, x in zip(offsets, offsets[1:], p_leaves)]
    return jts.apply_updates_masked(params, updates, mask)


@pytest.mark.parametrize("stage,reduce", [("stage_2", True), ("stage_3", False)])
def test_train_step_matches_jax(jax_side, monkeypatch, stage, reduce):
    """One whole train_step (its draws replaced by the replayed JAX draws)
    against the JAX step from the same gradients, after stage_zero_init on
    both sides: the 8-bit Adam at stage 2 (as the stage YAMLs set it, with
    the UNet checkpointed as configs/stage_2.yaml sets it), AdamW at stage 3.
    Loss at 1e-5 relative, params at 1e-6, frozen params bitwise unchanged,
    every trainable param moved."""
    jp, batch_np = jax_side["pipe"], jax_side["batch"]
    zparams = jts.stage_zero_init(jax_side["params"], stage)
    pipe, cfg, optimizer, mask, step_fn, loss_fn, batch = _port_setup(
        zparams, stage, stage == "stage_2", reduce_optimizer_memory=reduce)
    draws = replay_draws(jax.random.PRNGKey(KEY), cfg)
    monkeypatch.setattr(tts, "sample_draws", lambda *a, **k: draws)
    before = {m: {n: p.detach().clone() for n, p in mod.named_parameters()}
              for m, mod in pipe.components().items()}
    state = tts.TrainState(pipe.components(), optimizer)
    state, metrics = step_fn(state, batch, torch.Generator())
    assert state.step == 1 and np.isfinite(float(metrics["loss"]))

    # the module's compiled loss_fn (its stage_3 config differs from this one
    # only in trainability, which the unmasked loss does not read)
    jloss, jgrads = jax_side["value_and_grad"](zparams, batch_np, jax.random.PRNGKey(KEY))
    assert abs(float(metrics["loss"]) - float(jloss)) <= 1e-5 * abs(float(jloss))
    jcfg = jts.TrainConfig.stage(stage, **LOSS_KW, reduce_optimizer_memory=reduce)
    jnew = _jax_optimizer_step(zparams, jgrads, jcfg)
    moved = 0
    for module, mod in pipe.components().items():
        want = _torch_tree(jax.device_get(jnew[module]), module)
        for name, p in mod.named_parameters():
            got = p.detach()
            if not mask[module][name]:
                assert torch.equal(got, before[module][name]), (module, name)
                continue
            close(got.numpy(), want[name], 1e-6, f"{module}.{name}")
            moved += int(not torch.equal(got, before[module][name]))
    assert moved == sum(sum(f.values()) for f in mask.values())


def test_data_parallel_step_matches_jax(jax_side, tmp_path):
    """One train_step on 2 gloo ranks (tests/torch_dist_workers.py), one row
    of `_batch()` each, the global batch's replayed draws in place of
    sample_draws, no clipping: the global loss against the JAX loss of the
    whole batch at 1e-5 relative; the averaged gradients each rank's
    optimizer steps with against JAX's within 2e-4 of each tensor's max (the
    mean of two one-row backward passes rounds apart from JAX's one two-row
    pass: 1.08e-4 at worst, the mid block's norm1, |g| <= 8.4e-4); each
    tensor's optimizer state on one rank; the parameters after the ZeRO-2
    update bitwise equal on both ranks."""
    from .torch_dist_workers import dp_step_job, run_ranks

    params, jloss, jgrads = jax_side["params"], jax_side["loss"], jax_side["grads"]
    pipe = port_pipeline(params)
    cfg = tts.TrainConfig.stage("stage_3", **LOSS_KW, max_grad_norm=1e9)
    path = tmp_path / "state.pt"
    torch.save({n: m.state_dict() for n, m in pipe.components().items()}, path)
    draws = replay_draws(jax.random.PRNGKey(KEY), cfg)
    out = run_ranks(dp_step_job, 2, pipe.m, str(path), cfg, _batch(), draws)
    mask = tts.trainable_mask(pipe.components(), cfg)
    n_trainable = sum(sum(f.values()) for f in mask.values())
    assert sum(o["state_tensors"] for o in out) == n_trainable  # each owned once
    assert 0 < out[0]["state_tensors"] < n_trainable
    for o in out:
        assert abs(o["loss"] - jloss) <= 1e-5 * abs(jloss), (o["loss"], jloss)
        assert o["grads"].keys() == o["params"].keys() == out[0]["params"].keys()
        assert all(torch.equal(p, out[0]["params"][n]) for n, p in o["params"].items())
    for module, flags in mask.items():
        want = _torch_tree(jgrads[module], module)
        for name, trains in flags.items():
            if not trains:
                continue
            got = out[0]["grads"][f"{module}.{name}"].numpy()
            scale = max(float(np.abs(want[name]).max()), 1e-12)
            err = float(np.abs(got - want[name]).max())
            assert err <= 2e-4 * scale, (module, name, err, scale)
