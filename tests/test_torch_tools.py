"""The port's measurement tools (vexpress_torch/tools/) on the CPU, at the
tiny geometry (tools.common.TINY_OVERRIDES): each tool's entry point runs
with `--device cpu` and returns finite fields, and refuses to run without a
card otherwise; psnr equals the JAX package's tools/psnr.py; the FLOP
counter equals a closed-form count of the UNet's convs, linear layers and
attention products; profile_step's stage hooks name the JAX runner's stages
and change no output; bench_window_step runs the pipeline's own window
step; the convergence demo lowers the loss and writes only where it is
told; the train recipe's stage configs are configs/stage_*.yaml's; the
pipeline tools' non-finite watch flags the module that made a non-finite
output; profile_train_step's busy share is over the unprofiled split."""

import importlib
import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch
import yaml

from vexpress_torch.models.unet_3d import DenoisingUNet3D
from vexpress_torch.ops.attention import Attention
from vexpress_torch.ops import launches
from vexpress_torch.tools import bench_window_step, common, profile_step, psnr, unet_step_flops
from vexpress_torch.train import recipe
from vexpress_torch.train.step_split import PARTS, StepSplit

REPO = pathlib.Path(__file__).resolve().parent.parent
CLIP = ["--device", "cpu", "--tiny", "--frames", "12", "--window", "8", "--height", "64"]
TOOLS = {  # tool -> argv of a tiny CPU run
    "unet_step_flops": ["--device", "cpu", "--tiny", "--frames", "3", "--height", "64"],
    "profile_step": ["--device", "cpu", "--tiny", "--height", "64", "--frames", "2",
                     "--reps", "1"],
    "bench_window_step": CLIP + ["--reps", "1"],
    "bench_decode": ["--device", "cpu", "--tiny", "--height", "64", "--chunks", "1", "2",
                     "--reps", "1"],
    "bench_savemem": CLIP + ["--steps", "1"],
    "bench_savemem_overhead": CLIP + ["--steps", "2"],
    "bench_long_sampler": CLIP + ["--steps", "2"],
    "microbench_ops": ["--device", "cpu", "--tiny", "--height", "64", "--frames", "2",
                       "--reps", "1"],
    "bench_blocks": ["--device", "cpu", "--tiny", "--height", "64", "--frames", "2",
                     "--reps", "1"],
    "bench_perf_table": ["--device", "cpu", "--tiny", "--height", "64", "--frames", "2",
                         "--res", "8,4", "--reps", "1"],
    "profile_train_step": ["--device", "cpu", "--tiny", "--height", "64", "--frames", "2",
                           "--reps", "1"],
}
ON_THE_CARD = sorted(TOOLS) + ["train_convergence_demo"]


def numbers(rec):
    """Every number in a tool's returned record."""
    if isinstance(rec, dict):
        for v in rec.values():
            yield from numbers(v)
    elif isinstance(rec, (list, tuple)):
        for v in rec:
            yield from numbers(v)
    elif isinstance(rec, (int, float)) and not isinstance(rec, bool):
        yield rec


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_runs_on_the_cpu_with_finite_fields(name, capsys):
    tool = importlib.import_module(f"vexpress_torch.tools.{name}")
    launches.reset()
    rec = tool.main(TOOLS[name])
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "cpu (plain versions, host clock)"
    vals = list(numbers(rec))
    assert vals and all(math.isfinite(v) for v in vals), rec
    assert "nonfinite" not in str(rec) or "'nonfinite': []" in str(rec)
    assert not any(k.startswith("flash_") and k != "flash_sdpa_reference" and n
                   for k, n in launches.counts.items()), launches.counts


@pytest.mark.parametrize("name", ON_THE_CARD)
def test_tool_needs_the_card_unless_told_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tool = importlib.import_module(f"vexpress_torch.tools.{name}")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main(["--tiny"] if name != "train_convergence_demo" else [])


def _jax_psnr():
    spec = importlib.util.spec_from_file_location("_jax_tools_psnr", REPO / "tools" / "psnr.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_psnr_equals_the_jax_tool(tmp_path, capsys):
    jax_psnr = _jax_psnr()
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(5, 16, 16, 3)).astype(np.float32)
    b = np.clip(a + 0.01 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    for x, y in ((a, b), (a[0], b[0]), (a, a)):
        assert psnr.psnr(x, y) == jax_psnr.psnr(x, y)
    assert psnr.psnr(a, a) == float("inf")
    assert psnr.psnr(a * 255, b * 255, 255.0) == jax_psnr.psnr(a * 255, b * 255, 255.0)
    np.save(tmp_path / "a.npy", a)
    np.save(tmp_path / "b.npy", b)
    rec = psnr.main([str(tmp_path / "a.npy"), str(tmp_path / "b.npy"), "--max_frames", "3"])
    want = [jax_psnr.psnr(a[i], b[i]) for i in range(3)]
    assert rec == {"frames": 3, "mean": float(np.mean(want)), "min": float(np.min(want)),
                   "max": float(np.max(want))}
    assert "mean PSNR" in capsys.readouterr().out


def _closed_form_flops(unet, args, kwargs) -> int:
    """2 M K N of every conv and linear call and 4 B Lq Lk inner of every
    attention product that runs as a matmul (the unrolled tiny-KV path, Lk <= 8
    and Lq > 64, is elementwise work), read off the calls' shapes."""
    total = [0]

    def conv(mod, inp, out):
        n, cout, ho, wo = out.shape
        kh, kw = mod.kernel_size
        total[0] += 2 * n * cout * (mod.in_channels // mod.groups) * kh * kw * ho * wo

    def linear(mod, inp, out):
        total[0] += 2 * (inp[0].numel() // mod.in_features) * mod.in_features * mod.out_features

    def attention(mod, args_, kw, out):
        hs = args_[0]
        ehs = args_[1] if len(args_) > 1 else kw.get("encoder_hidden_states")
        inner = mod.heads * mod.dim_head
        frames = kw.get("temporal_frames")
        if frames is not None:
            total[0] += 4 * hs.shape[0] * hs.shape[1] * frames * inner
            return
        kv = hs if ehs is None else ehs
        bq, bkv = hs.shape[0], kv.shape[0]
        if kw.get("zero_kv_first_half"):
            bq, bkv = bq // 2, bkv // 2
        lq, lk = (bq // bkv) * hs.shape[1], kv.shape[1]
        if not (lk <= 8 and lq > 64):
            total[0] += 4 * bkv * lq * lk * inner

    hooks = []
    for m in unet.modules():
        if isinstance(m, torch.nn.Conv2d):
            hooks.append(m.register_forward_hook(conv))
        elif isinstance(m, torch.nn.Linear):
            hooks.append(m.register_forward_hook(linear))
        elif isinstance(m, Attention):
            hooks.append(m.register_forward_hook(attention, with_kwargs=True))
    with torch.inference_mode():
        unet(*args, **kwargs)
    for h in hooks:
        h.remove()
    return total[0]


def test_flop_counter_equals_the_closed_form_count():
    # a 16x16 latent: at 8x8 the mid block's single token makes einsum
    # contract a length-1 axis by multiplying, which no counter sees
    cfg = common.pipeline_models(True, torch.float32).unet_config
    torch.manual_seed(0)
    unet = DenoisingUNet3D(cfg).eval()
    args = unet_step_flops.window_step_inputs(cfg, 2, 3, 16, 16, torch.float32, "cpu")
    want = _closed_form_flops(unet, args, dict(ref_scale=0.95, audio_scale=3.0,
                                               zero_uncond_kv=True))
    got = unet_step_flops.window_step_flops(cfg, 3, 16, 16, torch.float32, "cpu", unet=unet)
    assert got["total"] == want and got["kernels"] == 0
    # shapes alone give the same count
    fake = unet_step_flops.window_step_flops(cfg, 3, 16, 16, torch.float32, "meta")
    assert fake["total"] == want


def test_count_flops_adds_the_kernels_launches():
    launches.shapes[("flash_bwd_dq", 9, 9, 9, 9)] += 5  # before the count: not counted
    with unet_step_flops.count_flops(heads=8) as flops:
        launches.shapes[("flash_fwd", 2, 128, 256, 40)] += 3
        launches.shapes[("flash_bwd_dkv", 2, 128, 256, 40)] += 1
        launches.shapes[("flash_bwd_dq", 2, 128, 256, 40)] += 1
    launches.reset()
    n = 2 * 8 * 128 * 256 * 40
    assert flops["kernels"] == (3 * 4 + 8 + 6) * n == flops["total"]


def test_profile_step_hooks_name_the_stages_and_change_nothing():
    pipe = common.random_pipeline(True, torch.device("cpu"))
    unet = pipe.denoising_unet
    args = unet_step_flops.window_step_inputs(pipe.m.unet_config, 2, 2, 8, 8, torch.float32,
                                              "cpu")
    with torch.inference_mode():
        plain = unet(*args, 0.95, 3.0, zero_uncond_kv=True)
        hooked = []
        stages = profile_step.split_forward(
            unet, lambda: hooked.append(unet(*args, 0.95, 3.0, zero_uncond_kv=True)),
            torch.device("cpu"))
    assert list(stages) == (["temb", "conv_in"] + [f"down_{i}" for i in range(4)] + ["mid"]
                            + [f"up_{i}" for i in range(4)] + ["conv_out"])
    assert all(v > 0 for v in stages.values())
    assert torch.equal(plain, hooked[0])
    assert not unet._forward_hooks and not unet.down_blocks[0]._forward_pre_hooks


def test_bench_window_step_runs_the_pipelines_window_step(monkeypatch):
    calls = []
    real = bench_window_step.build_blended_denoise_step

    def spy(*a, **kw):
        calls.append(kw.get("window_group"))
        return real(*a, **kw)

    monkeypatch.setattr(bench_window_step, "build_blended_denoise_step", spy)
    rec = bench_window_step.main(CLIP + ["--reps", "1", "--group", "2"])
    assert calls == [2] and rec["unet_calls_a_step"] == 1 and rec["finite"]
    from vexpress_torch.pipelines import pipeline
    assert real is pipeline.build_blended_denoise_step


def test_convergence_demo_lowers_the_loss_and_writes_only_under_out(tmp_path, monkeypatch):
    from vexpress_torch.tools import train_convergence_demo as demo

    assert demo.DEFAULT_OUT == str(pathlib.Path("chiprun_out") / "convergence")
    work = tmp_path / "cwd"
    work.mkdir()
    monkeypatch.chdir(work)
    out = tmp_path / "conv"
    rec = demo.main(["--device", "cpu", "--steps", "10", "--stages", "stage_2",
                     "--out", str(out)])
    curve = rec["curves"]["stage_2"]
    assert len(curve["losses"]) == 10 and curve["final_mean5"] < curve["initial_mean3"]
    assert not list(work.iterdir())
    names = {p.name for p in out.iterdir()}
    assert names == {"convergence_curves.json", "convergence_stage_2.jsonl",
                     "mlruns_convergence"}
    metrics = list((out / "mlruns_convergence").glob("0/*/metrics/train_loss"))
    assert len(metrics) == 1 and len(metrics[0].read_text().splitlines()) == 10


def test_stage_configs_are_the_yaml_files():
    for stage in ("stage_2", "stage_3"):
        y = yaml.safe_load((REPO / "configs" / f"{stage}.yaml").read_text())
        cfg = recipe.stage_config(stage)
        for key, val in cfg.items():
            if isinstance(val, dict):
                assert {k: y[key][k] for k in val} == val, (stage, key)
            else:
                assert y[key] == val, (stage, key)


def test_step_split_on_the_cpu():
    unet = torch.nn.Linear(2, 2)

    class Opt:
        def step(self):
            return True

    opt = Opt()
    split = StepSplit(unet, opt, "cpu")
    split.begin()
    unet(torch.ones(1, 2))
    assert opt.step() is True
    split.remove()
    (parts,) = split.splits()
    assert list(parts) == list(PARTS) and all(v >= 0 for v in parts.values())
    assert not unet._forward_hooks and opt.step() is True


def test_nonfinite_outputs_flags_only_the_module_that_made_one():
    import types

    pipe = types.SimpleNamespace(denoising_unet=torch.nn.Identity(),
                                 vae=types.SimpleNamespace(decoder=torch.nn.Identity()))
    with common.nonfinite_outputs(pipe) as read_flags:
        pipe.denoising_unet(torch.ones(2))
        pipe.vae.decoder(torch.tensor([1.0, float("nan")]))
        pipe.vae.decoder(torch.ones(2))  # a later finite call keeps the flag
        pipe.denoising_unet(torch.zeros(2))
    assert read_flags() == ["vae.decoder"]
    assert not pipe.denoising_unet._forward_hooks and not pipe.vae.decoder._forward_hooks


def test_train_step_busy_share_is_over_the_unprofiled_split():
    from vexpress_torch.tools.profile_train_step import PartProfiler

    prof = PartProfiler(torch.device("cpu"))
    prof.parts = {"backward": dict(wall_s=0.8, device_busy_ms=400.0, busy_share=None,
                                   busy_share_of_profiled_wall=None, families_ms={}),
                  "optimizer": dict(wall_s=0.1, device_busy_ms=None, busy_share=None,
                                    busy_share_of_profiled_wall=None, families_ms={})}
    prof.busy_shares({"backward": 0.625, "optimizer": 0.05})
    assert prof.parts["backward"]["busy_share"] == 0.4 / 0.625
    assert prof.parts["backward"]["busy_share_of_profiled_wall"] == 0.4 / 0.8
    assert prof.parts["optimizer"]["busy_share"] is None
