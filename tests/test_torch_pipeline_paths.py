"""The inference CLI's paths through the port's pipeline against vexpress_tpu's
on the CPU, with the tiny models and shared weights of
tests/test_torch_pipeline.py at 128x256 (a 16x32 latent: 512 tokens, so the
first level's attn1 and attn1_5 take the flash dispatch), 6 frames in
4-frame windows with overlap 2, CFG 2.0, shared initial noise: DPM-Solver++
(2M) with strength 1 and 0.6, save_memory, the YUV420 conversion and K2
(VEXPRESS_FLASH_LITE). One JAX compile serves every JAX run here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vexpress_torch.ops import flash, launches
from vexpress_torch.pipelines import media as t_media

from .test_torch_pipeline import build_pipelines, pipeline_inputs
from .torch_port_utils import psnr

# K2 against JAX's exact attention (K2 off there), PSNR of the decoded video:
# measured 84.04 dB; the bar is that less 3 dB
K2_PSNR_BAR = 81.0
KW = dict(guidance_scale=2.0, sampler="dpmpp_2m")


@pytest.fixture(scope="module")
def setup():
    """(JAX pipeline, port pipeline, inputs, JAX outputs by strength)."""
    jp, tp = build_pipelines()
    inputs = pipeline_inputs(h=128, w=256, frames=6, ctx=4, ovl=2)
    ref = {s: np.asarray(jp(piecewise=False, shape_bucketing=False, strength=s, **KW, **inputs))
           for s in (1.0, 0.6)}
    return jp, tp, inputs, ref


@pytest.fixture(scope="module")
def port_dpm(setup):
    _, tp, inputs, _ = setup
    return tp(**KW, **inputs)


def test_dpm_solver_matches_jax(setup, port_dpm):
    value = psnr(port_dpm, setup[3][1.0])
    assert value > 45.0, f"PSNR {value:.1f} dB"


def test_strength_matches_jax(setup):
    """strength 0.6 of 2 steps runs the last step only: the DPM grid index
    starts at 1 (JAX pipeline.py:786-789)."""
    _, tp, inputs, ref = setup
    value = psnr(tp(strength=0.6, **KW, **inputs), ref[0.6])
    assert value > 45.0, f"PSNR {value:.1f} dB"


def test_save_memory_equals_plain_run(setup, port_dpm, monkeypatch):
    """save_memory with the window groups streamed from the host at every
    step (the device cache off; chip_smoke.py's cli_full runs it on)."""
    _, tp, inputs, _ = setup
    monkeypatch.setenv("VEXPRESS_SAVEMEM_DEV_CACHE_MB", "0")
    saved = tp(save_memory=True, **KW, **inputs)
    assert tp.released == set(tp.RELEASABLE_COND_MODULES) and tp.last_released_cond_mib == 0.0
    comps = tp.components()
    for name in tp.RELEASABLE_COND_MODULES:  # on the host copies
        host = tp._host_cond[name]
        assert all(p.data_ptr() == host[n].data_ptr() for n, p in comps[name].named_parameters())
    np.testing.assert_allclose(saved, port_dpm, atol=1e-6, rtol=0)
    tp(return_latents=True, **dict(inputs, num_inference_steps=1))  # the next call restores them
    assert not tp.released


def test_yuv420_matches_jax(setup):
    jp = setup[0]
    video = np.random.default_rng(8).uniform(-0.05, 1.05, size=(3, 16, 24, 3)).astype(np.float32)
    ref = jp._to_yuv420(jnp.asarray(video))
    got = t_media.to_yuv420(torch.from_numpy(video))
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert g.dtype == torch.uint8 and tuple(g.shape) == r.shape
        assert np.abs(g.numpy().astype(int) - r.astype(int)).max() <= 1


def test_k2_pipeline_against_jax_exact(setup, monkeypatch):
    _, tp, inputs, ref = setup
    monkeypatch.setattr(flash, "FLASH_LITE", True)
    launches.reset()
    latents = tp(return_latents=True, **KW, **inputs)
    assert launches.counts["flash_lite_reference"] > 0
    assert launches.counts["flash_sdpa_reference"] == 0
    video = tp.decode_latents(torch.from_numpy(latents))
    value = psnr(video, ref[1.0])
    print(f"K2 pipeline PSNR against JAX exact: {value:.2f} dB")
    assert value > K2_PSNR_BAR, f"PSNR {value:.2f} dB"
    planes = tp.decode_latents(torch.from_numpy(latents), as_yuv420=True)
    for p, e in zip(planes, t_media.to_yuv420(torch.from_numpy(video))):
        np.testing.assert_array_equal(p, e.numpy())
