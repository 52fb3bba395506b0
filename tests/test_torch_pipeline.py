"""Parity of vexpress_torch's streamed pipeline with vexpress_tpu's on the CPU.

DDIM at 1e-6, context windows and audio windowing equal, and the whole
streamed pipeline at 256x256 frames (a 32x32 latent: 1024 tokens, so
attn1/attn1_5 at the first level take the flash dispatch), 12 frames in
8-frame windows with overlap 4, 2 DDIM steps, with and without CFG, on shared
weights and shared initial noise: PSNR > 45 dB and max |d| <= 7e-3, the bar of
tests/test_parity_full_pipeline.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vexpress_tpu.diffusion.ddim import DDIMScheduler as JDDIM
from vexpress_tpu.models import unet_3d as j_u3
from vexpress_tpu.models import vae as j_vae
from vexpress_tpu.models import wav2vec2 as j_w
from vexpress_tpu.pipelines import audio as j_audio
from vexpress_tpu.pipelines import context as j_ctx
from vexpress_tpu.pipelines import media as j_media
from vexpress_tpu.pipelines import pipeline as j_pipe
from vexpress_torch.diffusion.ddim import DDIMScheduler as TDDIM
from vexpress_torch.io import load_pipeline_jax_params
from vexpress_torch.models import unet_3d as t_u3
from vexpress_torch.models import vae as t_vae
from vexpress_torch.models import wav2vec2 as t_w
from vexpress_torch.ops import launches
from vexpress_torch.pipelines import audio as t_audio
from vexpress_torch.pipelines import context as t_ctx
from vexpress_torch.pipelines import media as t_media
from vexpress_torch.pipelines import pipeline as t_pipe

from .torch_port_utils import close, jax_init, psnr, rand, t

# ----------------------------------------------------------------- DDIM


@pytest.mark.parametrize("n", [1, 2, 25, 50])
def test_ddim_timesteps(n):
    np.testing.assert_array_equal(TDDIM().timesteps(n), JDDIM().timesteps(n))


def test_ddim_tables():
    np.testing.assert_array_equal(TDDIM().alphas_cumprod, JDDIM().alphas_cumprod)


@pytest.mark.parametrize("pred", ["v_prediction", "epsilon"])
@pytest.mark.parametrize("step_index", [0, 12, 24])
def test_ddim_step(pred, step_index):
    js, ts_ = JDDIM(prediction_type=pred), TDDIM(prediction_type=pred)
    n = 25
    timestep = int(js.timesteps(n)[step_index])
    out, sample = rand((3, 8, 8, 4), 1), rand((3, 8, 8, 4), 2)
    ref = np.asarray(js.step(jnp.asarray(out), timestep, jnp.asarray(sample), n))
    got = ts_.step(t(out), timestep, t(sample), n).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)


# --------------------------------------------------- windows and audio


@pytest.mark.parametrize("length,size,overlap", [(12, 8, 4), (44, 24, 4), (64, 24, 4), (7, 8, 4)])
def test_context_windows(length, size, overlap):
    wt, it = t_ctx.compute_context_windows(length, size, overlap)
    wj, ij = j_ctx.compute_context_windows(length, size, overlap)
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_array_equal(it, ij)


def test_interpolate_and_audio_windows():
    emb = rand((57, 6), 3)
    for out_len in (7, 26, 40):
        np.testing.assert_allclose(
            t_audio.interpolate_linear(t(emb), out_len).numpy(),
            np.asarray(j_audio.interpolate_linear(jnp.asarray(emb), out_len)), atol=1e-6)
    np.testing.assert_allclose(
        t_audio.audio_frame_windows(t(emb), 16, 2).numpy(),
        np.asarray(j_audio.audio_frame_windows(jnp.asarray(emb), 16, 2)), atol=1e-6)


def test_median_filter_and_uint8():
    for frames in (5, 1, 2):  # one and two frames: the reflected frame axis's edge cases
        video = np.random.default_rng(4).uniform(size=(frames, 9, 11, 3)).astype(np.float32)
        got = t_media.median_filter_3d(t(video), frame_chunk=2).numpy()
        np.testing.assert_array_equal(got,
                                      np.asarray(j_media.median_filter_3d(jnp.asarray(video))))
    ramp = np.linspace(-0.1, 1.1, 101, dtype=np.float32)
    np.testing.assert_array_equal(t_media.to_uint8(t(ramp)).numpy(),
                                  (np.clip(ramp, 0, 1) * 255).astype(np.uint8))


@pytest.mark.parametrize("window_group", [1, 2])
def test_blended_denoise_step(window_group):
    windows, inv = j_ctx.compute_context_windows(44, 24, 4)

    def j_predict(lat, tt, w_idx, cond):
        return lat * cond + 0.001 * tt + w_idx[..., None, None, None].astype(jnp.float32)

    def t_predict(lat, tt, w_idx, cond):
        return lat * cond + 0.001 * tt + w_idx[..., None, None, None].float()

    lat = rand((44, 4, 4, 4), 5)
    n = 25
    tt = int(JDDIM().timesteps(n)[3])
    ref = j_pipe.build_blended_denoise_step(j_predict, JDDIM(), windows, inv, n, window_group)(
        jnp.asarray(lat), tt, 0.5)
    got = t_pipe.build_blended_denoise_step(t_predict, TDDIM(), windows, inv, n, window_group)(
        t(lat), tt, 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


# ------------------------------------------------------- whole pipeline

H = W = 256
L, CTX, OVL, STEPS = 12, 8, 4, 2
CROSS = 16
UNET_KW = dict(block_out_channels=(80, 160, 160, 160), layers_per_block=1, attention_head_dim=2,
               cross_attention_dim=CROSS, norm_num_groups=16, motion_num_attention_heads=2,
               motion_max_len=8)
VAE_KW = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1, norm_num_groups=4)
W2V_KW = dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2, intermediate_size=32,
              conv_dim=(8, 8), conv_kernel=(10, 3), conv_stride=(5, 2),
              num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
APROJ_KW = dict(dim=16, depth=1, dim_head=4, heads=2, num_queries=5, embedding_dim=16,
                output_dim=CROSS, max_seq_len=10)
GUIDER_KW = dict(conditioning_embedding_channels=80, block_out_channels=(4, 4, 8, 8))


def _jax_params(pipe, cfg):
    h, w = H // 8, W // 8
    f32 = np.float32
    refs = tuple(jnp.zeros((1, l, c), f32) for l, c in cfg.ref_feature_shapes(h, w))
    return {
        "vae": jax_init(pipe.vae, jnp.zeros((1, H, W, 3), f32), seed=1),
        "reference_net": jax_init(pipe.reference_net, jnp.zeros((1, h, w, 4), f32),
                                  jnp.zeros((1,), jnp.int32), jnp.zeros((1, 1, CROSS), f32), seed=2),
        "denoising_unet": jax_init(pipe.denoising_unet, jnp.zeros((1, 2, h, w, 4), f32),
                                   jnp.zeros((1,), jnp.int32), jnp.zeros((1, 2, 5, CROSS), f32),
                                   refs, jnp.zeros((1, 2, h, w, 80), f32), seed=3),
        "v_kps_guider": jax_init(pipe.v_kps_guider, jnp.zeros((1, 1, H, W, 3), f32), seed=4),
        "wav2vec2": jax_init(pipe.audio_encoder, jnp.zeros((1, 4000), f32), seed=5),
        "audio_projection": jax_init(pipe.audio_projection, jnp.zeros((1, 10, 16), f32), seed=6),
    }


def build_pipelines(device="cpu"):
    """(JAX pipeline, port pipeline on `device`) with shared fp32 weights."""
    jm = j_pipe.PipelineModels(
        unet_config=j_u3.UNetConfig(**UNET_KW), vae_config=j_vae.VAEConfig(**VAE_KW),
        wav2vec2_config=j_w.Wav2Vec2Config(**W2V_KW), audio_projection_kwargs=APROJ_KW,
        guider_kwargs=GUIDER_KW)
    jp = j_pipe.VExpressPipeline(jm, {})
    params = _jax_params(jp, jm.unet_config)
    jp.params = params
    tm = t_pipe.PipelineModels(
        unet_config=t_u3.UNetConfig(**UNET_KW), vae_config=t_vae.VAEConfig(**VAE_KW),
        wav2vec2_config=t_w.Wav2Vec2Config(**W2V_KW), audio_projection_kwargs=APROJ_KW,
        guider_kwargs=GUIDER_KW)
    tp = load_pipeline_jax_params(t_pipe.VExpressPipeline(tm, device=device), params)
    return jp, tp


def pipeline_inputs(seed=3, h=H, w=W, frames=L, ctx=CTX, ovl=OVL):
    """Seeded inputs of one call (the params of `build_pipelines` fit any size)."""
    rng = np.random.default_rng(seed)
    ref_img = rng.uniform(size=(h, w, 3)).astype(np.float32)
    kps = rng.uniform(size=(frames, h, w, 3)).astype(np.float32)
    wave = (0.1 * rng.standard_normal(frames * 16000 // 30 + 40)).astype(np.float32)
    noise = rng.standard_normal((frames, h // 8, w // 8, 4)).astype(np.float32)
    return dict(reference_image=ref_img, kps_images=kps, audio_waveform=wave, width=w, height=h,
                video_length=frames, num_inference_steps=STEPS, context_frames=ctx,
                context_overlap=ovl, latents=noise)


@pytest.fixture(scope="module")
def pipelines():
    return build_pipelines()


@pytest.mark.parametrize("guidance_scale", [2.0, 1.0])
def test_streamed_pipeline_matches_jax(pipelines, guidance_scale):
    jp, tp = pipelines
    inputs = pipeline_inputs()
    ref = np.asarray(jp(guidance_scale=guidance_scale, piecewise=False, shape_bucketing=False,
                        **inputs))
    launches.reset()
    got = tp(guidance_scale=guidance_scale, **inputs)
    assert got.shape == (L, H, W, 3) and got.dtype == np.float32
    # attn1 and attn1_5 of every first-level transformer block went through
    # the flash dispatch (its plain version on the CPU)
    assert launches.counts["flash_sdpa_reference"] > 0
    value = psnr(got, ref)
    assert value > 45.0, f"PSNR {value:.1f} dB"
    np.testing.assert_allclose(got, ref, atol=7e-3, rtol=0)


def test_pipeline_uint8_median_output(pipelines):
    _, tp = pipelines
    inputs = pipeline_inputs()
    latents = tp(guidance_scale=2.0, return_latents=True, **inputs)
    video = tp.decode_latents(torch.from_numpy(latents))
    filtered = tp.decode_latents(torch.from_numpy(latents), median_filter=True, as_uint8=True)
    assert filtered.dtype == np.uint8 and filtered.shape == (L, H, W, 3)
    expect = t_media.to_uint8(t_media.median_filter_3d(t(video))).numpy()
    np.testing.assert_array_equal(filtered, expect)


def test_decode_latents_chunked_tail_matches_jax(pipelines):
    """The tiny VAE decoded at chunk 2 over 7 frames (three whole chunks and
    a one-frame tail): the filtered float output against JAX's
    decode_latents at 1e-5, and the chunked uint8 tail bitwise equal to the
    whole-clip route on the same decoded frames."""
    jp, tp = pipelines
    latents = np.random.default_rng(11).standard_normal((7, H // 8, W // 8, 4)).astype(np.float32)
    want = jp.decode_latents(jnp.asarray(latents), chunk=2, median_filter=True)
    got = tp.decode_latents(torch.from_numpy(latents), chunk=2, median_filter=True)
    assert got.shape == (7, H, W, 3) and got.dtype == np.float32
    close(got, want, 1e-5)
    video = tp.decode_latents(torch.from_numpy(latents), chunk=2)
    packed = tp.decode_latents(torch.from_numpy(latents), chunk=2, median_filter=True,
                               as_uint8=True)
    np.testing.assert_array_equal(packed,
                                  t_media.to_uint8(t_media.median_filter_3d(t(video))).numpy())
