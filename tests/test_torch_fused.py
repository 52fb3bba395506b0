"""The port's fused denoise mode on the CPU, where its step is called
rather than replayed from a CUDA graph: against JAX's fused mode (DDIM, CFG
2.0, window_group 2: PSNR > 45 dB on the decoded video), bitwise against the
port's streamed mode (DDIM at eta 0 and 0.8, DPM-Solver++ 2M, strength 0.6),
the step cache against weight loads, and the graph-safe sampler steps
bitwise against the steps they replace. The tiny models and shared weights
of tests/test_torch_pipeline.py at 128x256 (a 16x32 latent: 512 tokens, so
attn1 and attn1_5 of the first level take the flash dispatch), 6 frames in
4-frame windows with overlap 2; one JAX compile, of its fused DDIM step.
"""

import copy

import numpy as np
import pytest
import torch

from vexpress_torch.cli import infer
from vexpress_torch.diffusion import DDIMScheduler, DPMSolverMultistepScheduler
from vexpress_torch.ops import launches
from vexpress_torch.pipelines.pipeline import FusedStep

from .test_torch_pipeline import build_pipelines, pipeline_inputs
from .torch_port_utils import psnr, rand, t

CASES = {
    "ddim": dict(),
    "ddim_eta": dict(eta=0.8, seed=5),
    "dpm": dict(sampler="dpmpp_2m"),
    "dpm_strength": dict(sampler="dpmpp_2m", strength=0.6),
}
KW = dict(guidance_scale=2.0, window_group=2)


@pytest.fixture(scope="module")
def setup():
    jp, tp = build_pipelines()
    return jp, tp, pipeline_inputs(h=128, w=256, frames=6, ctx=4, ovl=2)


def test_fused_matches_jax_fused(setup):
    jp, tp, inputs = setup
    ref = np.asarray(jp(mode="fused", piecewise=False, shape_bucketing=False, **KW, **inputs))
    launches.reset()
    got = tp(mode="fused", **KW, **inputs)
    assert launches.counts["flash_sdpa_reference"] > 0
    value = psnr(got, ref)
    assert value > 45.0, f"PSNR {value:.1f} dB"


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_equals_streamed_bitwise(setup, case):
    _, tp, inputs = setup
    kw = dict(KW, return_latents=True, **CASES[case], **inputs)
    streamed = tp(mode="streamed", **kw)
    launches.reset()
    fused = tp(mode="fused", **kw)
    fused_counts = dict(launches.counts)
    np.testing.assert_array_equal(fused, streamed)
    launches.reset()
    tp(mode="streamed", **kw)
    assert fused_counts == dict(launches.counts)


def test_fused_step_is_cached_by_key(setup):
    _, tp, inputs = setup
    tp._step_cache.clear()
    tp(mode="fused", return_latents=True, **KW, **inputs)
    (entry,) = tp._step_cache.values()
    tp(mode="fused", return_latents=True, **KW, **inputs)
    assert list(tp._step_cache.values()) == [entry]
    tp(mode="fused", return_latents=True, **KW, **dict(inputs, num_inference_steps=1))
    assert len(tp._step_cache) == 2 and entry in tp._step_cache.values()


def test_in_place_load_is_served_and_a_new_unet_evicts(setup):
    """As JAX's test_params_reload_evicts_stale_step_closures: an in-place
    load (load_state_dict copies into the same storages) keeps the cached
    step, which then runs the new weights; a replaced module, or a
    parameter given a new storage, evicts it."""
    _, tp, inputs = setup
    kw = dict(KW, return_latents=True, **inputs)
    unet = tp.denoising_unet
    old_state = {k: v.clone() for k, v in unet.state_dict().items()}
    tp._step_cache.clear()
    try:
        before = tp(mode="fused", **kw)
        (entry,) = tp._step_cache.values()
        unet.load_state_dict({k: v * 1.25 if v.is_floating_point() else v
                              for k, v in old_state.items()})
        after = tp(mode="fused", **kw)
        assert list(tp._step_cache.values()) == [entry]
        assert np.abs(after - before).max() > 1e-4
        np.testing.assert_array_equal(after, tp(mode="streamed", **kw))

        tp.denoising_unet = copy.deepcopy(unet)
        replaced = tp(mode="fused", **kw)
        (new_entry,) = tp._step_cache.values()
        assert new_entry is not entry and not entry.serves(tp.denoising_unet)
        np.testing.assert_array_equal(replaced, after)

        param = next(tp.denoising_unet.parameters())
        param.data = param.data.clone()
        tp(mode="fused", **kw)
        (newest,) = tp._step_cache.values()
        assert newest is not new_entry and newest.serves(tp.denoising_unet)
    finally:
        tp.denoising_unet = unet
        unet.load_state_dict(old_state)
        tp._step_cache.clear()


def test_save_memory_with_fused_raises(setup):
    _, tp, inputs = setup
    with pytest.raises(ValueError, match="save_memory requires mode='streamed' or 'sharded'"):
        tp(mode="fused", save_memory=True, **inputs)
    with pytest.raises(ValueError, match="unknown mode"):
        tp(mode="eager", **inputs)


def test_cli_generate_fused_equals_streamed(setup):
    """The CLI's generate with --mode fused (DPM-Solver++ 2 steps, YUV420
    planes) against --mode streamed on the same pipeline."""
    _, tp, inputs = setup
    cli_inputs = dict(reference_image=inputs["reference_image"],
                      kps_images=inputs["kps_images"], audio=inputs["audio_waveform"],
                      video_length=inputs["video_length"])
    planes = {}
    for mode in ("streamed", "fused"):
        args = infer.parse_args([
            "--reference_image_path", "r", "--audio_path", "a", "--device", "cpu",
            "--image_width", str(inputs["width"]), "--image_height", str(inputs["height"]),
            "--sampler", "dpmpp_2m", "--num_inference_steps", "2", "--guidance_scale", "2.0",
            "--context_frames", "4", "--context_overlap", "2", "--mode", mode])
        infer._check_ported(args)
        planes[mode] = infer.generate(tp, cli_inputs, args, output_yuv420=True)
    for a, b in zip(planes["streamed"], planes["fused"]):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------- graph-safe steps

STEPS = 12
SHAPE = (3, 8, 8, 4)


@pytest.mark.parametrize("eta", [0.0, 0.5])
@pytest.mark.parametrize("pred", ["v_prediction", "epsilon"])
def test_ddim_table_step_equals_step_bitwise(pred, eta):
    """`build_step` at every grid index, with the index on the device,
    against `step` at that timestep (its alphas uploaded at the call)."""
    sched = DDIMScheduler(prediction_type=pred)
    fn = sched.build_step(STEPS, eta=eta)
    noise = t(rand(SHAPE, 9)) if eta else None
    for i, timestep in enumerate(sched.timesteps(STEPS)):
        out, sample = t(rand(SHAPE, 2 * i)), t(rand(SHAPE, 2 * i + 1))
        want = sched.step(out, int(timestep), sample, STEPS, eta=eta, noise=noise)
        got = fn(out, torch.tensor(i), sample, noise)
        assert torch.equal(got, want), f"grid index {i}"


def _host_dpm_step(sched, n):
    """DPM-Solver++'s table step as it was before it took device indices:
    each constant uploaded from the host tables at the call, and the
    second-order branch taken on the host."""
    tables = sched.tables(n)

    def fn(model_output, idx, sample, prev_x0, has_prev):
        def c(name):
            return torch.tensor(tables[name][idx], dtype=torch.float32)

        x = sample.float()
        x0 = sched._pred_x0(model_output.float(), x, c("sqrt_a"), c("sqrt_b"))
        base = c("ratio") * x
        if has_prev and 0 < idx < n - 1:
            inv_2r = c("inv_2r")
            d = (1.0 + inv_2r) * x0 - inv_2r * prev_x0
            prev = base - c("alpha_p") * c("emh_safe") * d
        else:
            prev = base - c("alpha_p") * c("emh") * x0
        return prev.to(sample.dtype), x0, True

    return fn


@pytest.mark.parametrize("idx0", [0, 5])  # 5: the grid trimmed by strength < 1
@pytest.mark.parametrize("pred", ["v_prediction", "epsilon"])
def test_dpm_table_step_equals_host_step_bitwise(pred, idx0):
    sched = DPMSolverMultistepScheduler(prediction_type=pred)
    fn, host = sched.build_step(STEPS), _host_dpm_step(sched, STEPS)
    x = y = t(rand(SHAPE, 1))
    prev_x, prev_y = torch.zeros(SHAPE), torch.zeros(SHAPE)
    has_x, has_y = torch.tensor(False), False
    for i in range(idx0, STEPS):
        out = t(rand(SHAPE, 100 + i))
        x, prev_x, has_x = fn(out, torch.tensor(i), x, prev_x, has_x)
        y, prev_y, has_y = host(out, i, y, prev_y, has_y)
        assert torch.equal(x, y) and torch.equal(prev_x, prev_y), f"grid index {i}"
        assert has_x.dtype == torch.bool and bool(has_x)


# ------------------------------------------------------ launch accounting

def test_launch_record_replays_its_counts():
    """A capture's counts leave the counters into its record; each replay
    adds the record once."""
    launches.reset()
    launches.counts["flash_fwd"] += 2
    with launches.recording() as record:
        launches.counts["flash_fwd"] += 3
        launches.shapes[("flash_fwd", 48, 4096, 4096, 40)] += 3
        launches.counts["flash_lite_fwd"] += 1
    assert dict(launches.counts) == {"flash_fwd": 2}
    assert not launches.shapes
    assert record.counts == {"flash_fwd": 3, "flash_lite_fwd": 1}
    for _ in range(4):
        launches.replay(record)
    assert dict(launches.counts) == {"flash_fwd": 14, "flash_lite_fwd": 4}
    assert dict(launches.shapes) == {("flash_fwd", 48, 4096, 4096, 40): 12}
    launches.reset()


def test_fused_step_on_the_cpu_calls_its_body():
    """On the CPU a FusedStep calls the step over its static buffers at
    every call and captures nothing."""
    calls = []
    unet = torch.nn.Linear(2, 2)

    def step(latents, idx, cond, noise, prev_x0, has_prev):
        calls.append(int(idx))
        return latents + cond[0].sum() + cond[3], prev_x0, has_prev

    fused = FusedStep(step, unet)
    lat = torch.zeros(2, 3)
    cond = (torch.ones(2), torch.zeros(1), (torch.zeros(1),) * 2, torch.tensor(0.5),
            torch.tensor(1.0))
    fused.load(lat, cond, with_noise=False)
    out = fused(lat, 3, None, torch.zeros_like(lat), torch.tensor(False))[0]
    out = fused(out, 4, None, torch.zeros_like(lat), torch.tensor(True))[0]
    assert calls == [3, 4] and fused.graph is None and fused.replays == 0
    assert torch.equal(out, torch.full((2, 3), 5.0))
    assert fused.serves(unet) and not fused.serves(torch.nn.Linear(2, 2))
