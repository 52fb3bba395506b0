"""The port's data-parallel path (vexpress_torch.parallel over torch.distributed)
against vexpress_tpu.parallel on the CPU: gloo groups of spawned ranks
(tests/torch_dist_workers.py), fp32, tiny configs.

`pad_window_set` bitwise; the 2-rank `window_parallel_step` against JAX's on a
2-device mesh at 1e-5; the 2-rank sharded pipeline against JAX's sharded mode
(latents, 1e-5) and against the port's streamed mode (1e-5) for DDIM, DDIM
with eta > 0, DPM-Solver++ and save_memory, its latents bitwise equal on both
ranks; the ZeRO-2 owner map; a world-size-1 group's step and blend bitwise
equal to the plain ones; a checkpoint written by 2 ranks resumed on 1 and on
2; the training CLI as 2 processes (tests/test_multihost.py's checks) and
its resume; the inference CLI as 2 torchrun-style processes against one.
"""

import contextlib
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vexpress_tpu.diffusion.ddim import DDIMScheduler as JDDIM
from vexpress_tpu.models import unet_3d as j_u3
from vexpress_tpu.models import vae as j_vae
from vexpress_tpu.models import wav2vec2 as j_w
from vexpress_tpu.parallel import mesh as j_mesh
from vexpress_tpu.pipelines import pipeline as j_pipe
from vexpress_torch.parallel import mesh as t_mesh
from vexpress_torch.pipelines import pipeline as t_pipe
from vexpress_torch.train import train_step as tts

from . import torch_dist_workers as workers
from .test_torch_train import (APROJ_KW, GUIDER_KW, UNET_KW, VAE_KW, W2V_KW, _jax_params,
                               port_pipeline)
from .torch_port_utils import close

REPO = pathlib.Path(__file__).resolve().parent.parent
H = W = 64
FRAMES, CTX, OVL = 16, 8, 4  # 3 windows: one pad row over 2 ranks


@pytest.mark.parametrize("n_windows,n_dev,window_group,pad_to",
                         [(3, 2, 1, 0), (2, 2, 1, 0), (5, 2, 2, 0), (7, 4, 1, 0), (3, 2, 1, 9),
                          (4, 1, 3, 0), (1, 8, 1, 0)])
def test_pad_window_set_matches_jax(n_windows, n_dev, window_group, pad_to):
    rng = np.random.default_rng(n_windows + 10 * n_dev)
    windows = rng.integers(0, 40, size=(n_windows, 6)).astype(np.int64)
    inv = rng.uniform(0.2, 1.0, size=40).astype(np.float32)
    got = t_mesh.pad_window_set(windows, inv, n_dev, window_group, pad_to)
    want = j_mesh.pad_window_set(windows, inv, n_dev, window_group, pad_to)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------------- window step, owners

OWNED = {"a": (64, 32), "b": (32,), "c": (7, 3), "d": (64, 32), "e": (), "f": (128, 4)}


@pytest.fixture(scope="module")
def window_step_run():
    lat0 = np.random.default_rng(0).normal(size=(64, 4, 4, 4)).astype(np.float32)
    return lat0, workers.run_ranks(workers.window_step_job, 2, lat0, 64, 8, 2, 3, 1, OWNED)


def test_window_parallel_step_matches_jax(window_step_run):
    """tests/test_parallel.py's toy prediction, DDIM 3 steps, 2 ranks against
    JAX's window_parallel_step on a 2-device mesh at 1e-5; both ranks end
    with bitwise-equal latents."""
    lat0, out = window_step_run
    from vexpress_tpu.pipelines.context import compute_context_windows

    windows, inv = compute_context_windows(64, 8, 2)
    sched = JDDIM()

    def predict(lat, t, w_idx, cond):
        return jnp.tanh(jnp.mean(lat, axis=1, keepdims=True) + 0.1 * lat + 0.001 * t)

    step = jax.jit(j_mesh.window_parallel_step(predict, sched, windows, inv, 3,
                                               j_mesh.create_mesh(2)))
    lat = jnp.asarray(lat0)
    for t in sched.timesteps(3):
        lat = step(lat, jnp.asarray(int(t)), None)
    np.testing.assert_array_equal(out[0]["latents"], out[1]["latents"])
    np.testing.assert_allclose(out[0]["latents"], np.asarray(lat), atol=1e-5, rtol=1e-5)


def test_zero2_owners(window_step_run):
    """Every tensor has exactly one owner, every rank computes the same map,
    and the bytes split evenly where the sizes allow."""
    _, out = window_step_run
    maps = out[0]["owners"]
    assert maps[0] == maps[1] and out[1]["owners"] == maps
    owners = maps[0]
    assert set(owners) == set(OWNED) and set(owners.values()) == {0, 1}
    loads = [sum(int(np.prod(OWNED[n])) for n, r in owners.items() if r == rank) for rank in (0, 1)]
    # largest first, each to the rank holding fewer bytes (a tie to rank 0)
    assert loads == [2048 + 512, 2048 + 32 + 21 + 1], loads


# ------------------------------------------------------------ sharded pipeline


def _models():
    return t_pipe.PipelineModels(
        unet_config=t_pipe.UNetConfig(**UNET_KW), vae_config=t_pipe.VAEConfig(**VAE_KW),
        wav2vec2_config=t_pipe.Wav2Vec2Config(**W2V_KW), audio_projection_kwargs=APROJ_KW,
        guider_kwargs=GUIDER_KW)


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    return dict(reference_image=rng.uniform(size=(H, W, 3)).astype(np.float32),
                kps_images=rng.uniform(size=(FRAMES, H, W, 3)).astype(np.float32),
                audio_waveform=(0.1 * rng.standard_normal(FRAMES * 16000 // 30 + 40)
                                ).astype(np.float32),
                width=W, height=H, video_length=FRAMES, num_inference_steps=2,
                guidance_scale=2.0, context_frames=CTX, context_overlap=OVL,
                latents=rng.standard_normal((FRAMES, H // 8, W // 8, 4)).astype(np.float32))


VARIANTS = {"ddim": {}, "ddim_eta": dict(eta=0.5), "dpmpp_2m": dict(sampler="dpmpp_2m"),
            "save_memory": dict(sampler="dpmpp_2m", save_memory=True)}


@pytest.fixture(scope="module")
def sharded_run(tmp_path_factory):
    """The JAX params, the port's streamed pipeline on them, and the 2-rank
    sharded calls of every variant."""
    jm = j_pipe.PipelineModels(
        unet_config=j_u3.UNetConfig(**UNET_KW), vae_config=j_vae.VAEConfig(**VAE_KW),
        wav2vec2_config=j_w.Wav2Vec2Config(**W2V_KW), audio_projection_kwargs=APROJ_KW,
        guider_kwargs=GUIDER_KW)
    jp = j_pipe.VExpressPipeline(jm, {})
    params = _jax_params(jp, jm.unet_config)
    jp.params = params
    tp = port_pipeline(params)
    path = tmp_path_factory.mktemp("sharded") / "state.pt"
    torch.save({n: m.state_dict() for n, m in tp.components().items()}, path)
    calls = [dict(_inputs(), **kw) for kw in VARIANTS.values()]
    out = workers.run_ranks(workers.pipeline_job, 2, _models(), str(path), calls, timeout=180)
    return jp, tp, dict(zip(VARIANTS, zip(*out)))


def test_sharded_matches_jax_sharded(sharded_run):
    """DDIM, 2 ranks against JAX's mode="sharded" on a 2-device mesh, shared
    initial noise: latents at 1e-5."""
    jp, _, by_variant = sharded_run
    ref = jp(mode="sharded", mesh=j_mesh.create_mesh(2), piecewise=False, shape_bucketing=False,
             return_latents=True, **_inputs())
    close(by_variant["ddim"][0], np.asarray(ref), 1e-5)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sharded_matches_streamed(sharded_run, variant):
    """2 ranks against the port's streamed call at 1e-5; the ranks' latents
    bitwise equal."""
    _, tp, by_variant = sharded_run
    rank0, rank1 = by_variant[variant]
    np.testing.assert_array_equal(rank0, rank1)
    streamed = tp(return_latents=True, **_inputs(), **VARIANTS[variant])
    close(rank0, streamed, 1e-5, variant)


# ------------------------------------------------------------- world size 1


@contextlib.contextmanager
def one_rank_group():
    """This process alone as a group (no port, no peer)."""
    import torch.distributed as dist

    t_mesh.initialize_distributed(backend="gloo")
    try:
        yield t_mesh.create_mesh()
    finally:
        dist.destroy_process_group()


def _tiny_pipeline():
    from vexpress_torch.io import init_pipeline_random_

    return init_pipeline_random_(t_pipe.VExpressPipeline(_models(), device="cpu"), seed=0)


def _tiny_batch(seed=0) -> dict:
    """One row of a 2-frame training batch, numpy fp32."""
    rng = np.random.default_rng(seed)
    batch = {"target_images": rng.uniform(-1, 1, (1, 2, H, W, 3)),
             "reference_image": rng.uniform(-1, 1, (1, H, W, 3)),
             "kps_images": rng.uniform(0, 1, (1, 2, H, W, 3)),
             "audio_frame_embeddings": rng.normal(size=(1, 2, 10, 16)),
             "lip_masks": rng.uniform(0, 1, (1, 2, H // 8, W // 8))}
    return {k: v.astype(np.float32) for k, v in batch.items()}


@pytest.mark.parametrize("reduce", [False, True])
def test_world_size_1_step_is_the_plain_step(reduce):
    """make_optimizer over a one-rank mesh and build_train_step's data-parallel
    path: two steps bitwise equal to the plain ones (loss and parameters),
    at stage 3 with AdamW and at stage 2 with the 8-bit Adam."""
    stage = "stage_2" if reduce else "stage_3"
    cfg = tts.TrainConfig.stage(stage, num_frames=2, learning_rate=1e-3, lip_loss_weight=2.0,
                                reduce_optimizer_memory=reduce)
    runs = []
    batch = {k: torch.from_numpy(v) for k, v in _tiny_batch().items()}
    for sharded in (False, True):
        pipe = _tiny_pipeline()
        comps = pipe.components()
        with one_rank_group() if sharded else contextlib.nullcontext() as mesh:
            optimizer, _ = tts.make_optimizer(comps, cfg, mesh)
            assert (optimizer.mesh is not None) == sharded
            step_fn, _ = tts.build_train_step(pipe, cfg, optimizer)
            state, gen, losses = tts.TrainState(comps, optimizer), torch.Generator(), []
            gen.manual_seed(1)
            for _ in range(2):
                state, metrics = step_fn(state, batch, gen)
                losses.append(metrics["loss"])
        runs.append((losses, [p.detach().clone() for p in optimizer.params]))
    (l0, p0), (l1, p1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert len(p0) == len(p1) and all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_world_size_1_sharded_call_is_streamed():
    """A one-rank sharded pipeline call bitwise equal to the streamed call."""
    pipe = _tiny_pipeline()
    kw = dict(_inputs(), return_latents=True)
    streamed = pipe(**kw)
    with one_rank_group():
        sharded = pipe(mode="sharded", **kw)
    np.testing.assert_array_equal(sharded, streamed)


# ---------------------------------------------------------------- checkpoints


def test_checkpoint_of_two_ranks_resumes_on_one_and_two(tmp_path):
    """Tiny stage-3 runs on 2 ranks, one row of a 2-row batch each
    (torch_dist_workers.CKPT_PLANS): the 8-bit Adam saving at step 2 of 3, and
    AdamW accumulating 2 mini-steps saving at mini-step 3 of 4 (its running
    mean saved as the group's). Restored into 2 ranks, the 8-bit Adam's run
    ends bitwise where the uninterrupted one ended, and AdamW's within 1e-6
    (lr 1e-3; the saved mean of the ranks' running means rounds apart from
    the mean of their sums), both ranks bitwise alike; restored into 1
    process with the whole batch, AdamW's run ends within 1e-6 of it, and
    the 8-bit Adam's state holds every tensor's moments as the checkpoint
    holds them."""
    from vexpress_torch.io.checkpoints import STATE_FILE, restore_train_state, trainable_tensors

    rows = [_tiny_batch(seed) for seed in (0, 1)]
    two = {k: np.concatenate([row[k] for row in rows]) for k in rows[0]}
    root = str(tmp_path)
    straight = workers.run_ranks(workers.ckpt_job, 2, _models(), two, root, False, timeout=240)
    resumed = workers.run_ranks(workers.ckpt_job, 2, _models(), two, root, True, timeout=240)
    for plan in workers.CKPT_PLANS:
        for rank in (0, 1):
            for run in (straight, resumed):
                assert all(torch.equal(a, b) for a, b in zip(run[rank][plan], run[0][plan]))
    assert all(torch.equal(a, b) for a, b in zip(resumed[0]["adam8bit"], straight[0]["adam8bit"]))
    for a, b in zip(resumed[0]["accumulate"], straight[0]["accumulate"]):
        close(a.numpy(), b.numpy(), 1e-6)

    _, at, until = workers.CKPT_PLANS["accumulate"]
    state, step_fn = workers.ckpt_setup(_models(), "accumulate")
    restore_train_state(os.path.join(root, "accumulate", f"checkpoint-{at}"), state)
    assert state.optimizer.acc is not None
    state = workers.ckpt_steps(state, step_fn, two, until)
    for a, b in zip(state.optimizer.params, straight[0]["accumulate"]):
        close(a.detach().numpy(), b.numpy(), 1e-6)

    _, at, _ = workers.CKPT_PLANS["adam8bit"]
    state, _ = workers.ckpt_setup(_models(), "adam8bit")
    path = os.path.join(root, "adam8bit", f"checkpoint-{at}")
    restore_train_state(path, state)
    saved = torch.load(os.path.join(path, STATE_FILE), weights_only=True)["opt_state"]["state"]
    names = {id(p): n for n, p in trainable_tensors(state.models).items()}
    assert len(saved) == len(state.optimizer.params)
    for p in state.optimizer.params:
        moments = state.optimizer.inner.state[p]
        assert moments.keys() == saved[names[id(p)]].keys() == {"mu", "nu"}
        for k, v in moments.items():
            w = saved[names[id(p)]][k]
            got, want = ((v.codes, v.scales), (w["codes"], w["scales"])) if isinstance(w, dict) \
                else ((v,), (w,))
            assert all(torch.equal(g, x) for g, x in zip(got, want)), (names[id(p)], k)


# ---------------------------------------------------------------- the CLIs

CLI_TIMEOUT = 240


def _communicate(procs):
    """Wait for every process; on a timeout or a failure kill them all and
    fail with their output."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=CLI_TIMEOUT)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rc, out, err in outs:
        assert rc == 0, f"STDOUT:\n{out[-3000:]}\nSTDERR:\n{err[-3000:]}"
    return [o[1] for o in outs]


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", **extra)
    return env


def _train_two_processes(cfg_path, max_steps):
    port = workers.free_port()
    return _communicate([subprocess.Popen(
        [sys.executable, "-m", "vexpress_torch.cli.train", "--config", cfg_path, "--device", "cpu",
         "--max_steps_override", str(max_steps), "--coordinator_address", f"127.0.0.1:{port}",
         "--num_processes", "2", "--process_id", str(r)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in (0, 1)])


def test_train_cli_two_processes_and_resume(tmp_path):
    """tests/test_multihost.py's two checks on the port's CLI: 2 processes
    over a localhost coordinator on the tiny stage-3 config with the
    cv2-made dataset (8-bit Adam), then a second 2-process run that resumes
    checkpoint-2 and continues to step 4."""
    pytest.importorskip("cv2")
    from .test_multihost import _prep_dataset, _tiny_cfg

    out_dir = str(tmp_path / "out")
    cfg = _tiny_cfg(_prep_dataset(tmp_path), out_dir)
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(json.dumps(cfg))
    out0, out1 = _train_two_processes(str(cfg_path), 2)
    assert "distributed: process 0/2" in out0 and "distributed: process 1/2" in out1
    assert "'dp': 2" in out0 and "'dp': 2" in out1
    assert "dataset shard 0/2" in out0 and "dataset shard 1/2" in out1
    assert "step 2/2" in out0 and "step 2/2" not in out1, out0[-2000:]
    assert np.isfinite(float(out0.split("loss ")[-1].split(" ")[0]))
    assert "checkpoint saved" in out0 and "checkpoint saved" not in out1
    ckpts = os.listdir(os.path.join(out_dir, "checkpoints"))
    assert "checkpoint-2" in ckpts, ckpts
    records = (pathlib.Path(out_dir) / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(r)["step"] for r in records] == [1, 2]  # rank 0's alone

    cfg["resume_from_checkpoint"] = "latest"
    cfg_path.write_text(json.dumps(cfg))
    out0, _ = _train_two_processes(str(cfg_path), 4)
    assert "resumed from" in out0 and "at step 2" in out0, out0[-2000:]
    assert "step 4/4" in out0 and "step 1/" not in out0, out0[-2000:]
    assert np.isfinite(float(out0.split("loss ")[-1].split(" ")[0]))
    assert "checkpoint-4" in os.listdir(os.path.join(out_dir, "checkpoints"))


# runs the inference CLI's main() and keeps what generate() hands to the
# encoder, since the mp4 encoder's output differs between processes
KEEP_VIDEO = """
import sys
import numpy as np
from vexpress_torch.cli import infer
real = infer.generate
def keep(pipeline, inputs, args, output_yuv420):
    video = real(pipeline, inputs, args, output_yuv420)
    if video is not None:
        np.savez(args.output_path + ".npz", *(video if output_yuv420 else (video,)))
    return video
infer.generate = keep
infer.main(sys.argv[1:])
"""


def test_infer_cli_two_processes_write_the_one_process_video(tmp_path):
    """The inference CLI with `--device cpu --do_multi_devices_inference` as 2
    processes under torchrun's variables: rank 0 writes the video one
    process writes (the frames handed to the encoder bitwise equal: the 2
    windows are one a rank, and their blend sums alike), rank 1 writes
    nothing."""
    cv2 = pytest.importorskip("cv2")
    from .test_torch_cli_infer import _cli_argv

    argv, _ = _cli_argv(tmp_path)
    argv = [sys.executable, "-c", KEEP_VIDEO] + argv[3:]  # main() of vexpress_torch.cli.infer
    one, two = str(tmp_path / "one.mp4"), str(tmp_path / "two.mp4")
    port = workers.free_port()
    procs = [subprocess.Popen(argv + ["--output_path", one], cwd=tmp_path, env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    for r in (0, 1):
        rank_env = _env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r),
                        LOCAL_RANK=str(r), WORLD_SIZE="2")
        procs.append(subprocess.Popen(argv + ["--do_multi_devices_inference", "--output_path",
                                              two], cwd=tmp_path, env=rank_env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    _, out0, out1 = _communicate(procs)
    assert "sharding context windows over 2 devices" in out0 and "rank 1" in out1
    assert "denoise step 2/2" in out0 and "denoise step" not in out1
    assert "has been saved" in out0 and "has been saved" not in out1
    a, b = np.load(one + ".npz"), np.load(two + ".npz")
    assert a.files == b.files
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    cap = cv2.VideoCapture(two)
    shape = tuple(int(cap.get(p)) for p in (cv2.CAP_PROP_FRAME_COUNT, cv2.CAP_PROP_FRAME_HEIGHT,
                                            cv2.CAP_PROP_FRAME_WIDTH))
    cap.release()
    assert shape == (7, 64, 64)
