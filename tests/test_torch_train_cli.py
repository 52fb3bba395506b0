"""The training CLI's path of the PyTorch port on the CPU, against the JAX
package where it has a counterpart: the dataset (samples and seeded, sharded,
threaded batches bitwise), checkpoints and exports (the per-module `.pth`
files key for key and value for value; train-state round trips for LoRA
with AdamW and for module training with the 8-bit Adam), telemetry (the same
files, timestamps and run ids aside), `vexpress_torch.cli.train` end to end
on `--device cpu` (LoRA, checkpoint, resume, the adapter export, then the
inference CLI with `--lora_path` on it), `prepare_dataset`'s
audio-embeddings (1e-5) and golden-check subcommands, `visualize_dataset`
(the frames it hands save_video, bitwise) and `read_video_rgb`'s
`max_frames`.
"""

import argparse
import functools
import importlib.util
import json
import os
import pathlib
import random
import re
import sys

import numpy as np
import pytest
import torch

from vexpress_tpu.io import checkpoints as j_ckpt
from vexpress_tpu.models import wav2vec2 as j_w2v
from vexpress_tpu.pipelines import media as j_media
from vexpress_tpu.pipelines import pipeline as j_pipe
from vexpress_tpu.train import dataset as j_ds
from vexpress_tpu.utils import observability as j_obs
from vexpress_torch.cli import infer as t_infer
from vexpress_torch.cli import prepare_dataset as t_prep
from vexpress_torch.cli import train as t_cli
from vexpress_torch.cli import visualize_dataset as t_vis
from vexpress_torch.io import checkpoints as t_ckpt
from vexpress_torch.io import load_pipeline
from vexpress_torch.models import wav2vec2 as t_w2v
from vexpress_torch.pipelines import media as t_media
from vexpress_torch.train import TrainConfig, TrainState, make_optimizer
from vexpress_torch.train import dataset as t_ds
from vexpress_torch.train import lora as tl
from vexpress_torch.train.adam8bit import QTensor
from vexpress_torch.utils import observability as t_obs

from .test_cli_infer import TINY_OVERRIDES, _write_wav
from .test_cli_train import _make_dataset, _tiny_cfg
from .test_dataset import fixture_meta  # noqa: F401  (the JAX dataset tests' fixture)
from .test_torch_train import _jax_params, port_pipeline
from .torch_port_utils import close

REPO = pathlib.Path(__file__).resolve().parent.parent


# ------------------------------------------------------------ dataset


def _assert_samples_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_get_sample_matches_jax(fixture_meta, seed):  # noqa: F811
    """get_sample with a seeded rng (crop, flip with the R<->G kps swap,
    reference choice, masks, audio windows): bitwise the JAX sample."""
    kw = dict(meta_paths=[fixture_meta], image_size=(64, 64), flip_rate=0.5, num_frames=4,
              reference_margin=10, seed=0)
    want = j_ds.TalkingFaceVideoDataset(**kw).get_sample(0, random.Random(seed))
    got = t_ds.TalkingFaceVideoDataset(**kw).get_sample(0, random.Random(seed))
    _assert_samples_equal(got, want)


def test_batches_match_jax(fixture_meta, tmp_path):  # noqa: F811
    """Seeded shuffle epochs over 5 entries, 2 shards, 3 worker threads: the
    first batches of each shard bitwise the JAX ones; without a process
    group the port reads the whole permutation (one shard)."""
    with open(fixture_meta) as f:
        entry = json.load(f)[0]
    meta = tmp_path / "meta5.json"
    meta.write_text(json.dumps([entry] * 5))
    kw = dict(meta_paths=[str(meta)], image_size=(64, 64), flip_rate=0.5, num_frames=2,
              reference_margin=5, seed=7)

    def collect(cls, n=3, **shard):
        it = cls(**kw).batches(batch_size=2, num_workers=3, prefetch=1, **shard)
        out = [next(it) for _ in range(n)]
        it.close()
        return out

    for shard in (dict(shard_id=0, num_shards=2), dict(shard_id=1, num_shards=2)):
        for a, b in zip(collect(t_ds.TalkingFaceVideoDataset, **shard),
                        collect(j_ds.TalkingFaceVideoDataset, **shard)):
            _assert_samples_equal(a, b)
    for a, b in zip(collect(t_ds.TalkingFaceVideoDataset, n=2),
                    collect(j_ds.TalkingFaceVideoDataset, n=2, shard_id=0, num_shards=1)):
        _assert_samples_equal(a, b)


def test_dataset_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(37, 8)).astype(np.float32)
    for n in (10, 50, 74):
        np.testing.assert_array_equal(t_ds.interpolate_rows(emb, n), j_ds.interpolate_rows(emb, n))
    ids = [0, 3, 7, 11]
    np.testing.assert_array_equal(t_ds.audio_frame_embeddings_np(emb, ids, 12, 2),
                                  j_ds.audio_frame_embeddings_np(emb, ids, 12, 2))
    path = str(tmp_path / "aud.pt")
    torch.save({"global_embeds": torch.from_numpy(rng.normal(size=(9, 1, 8)))}, path)
    np.testing.assert_array_equal(t_ds.load_audio_embeddings(path),
                                  j_ds.load_audio_embeddings(path))


def _jax_cli(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_cli_{name}", REPO / "cli" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_visualize_dataset_matches_jax(fixture_meta, tmp_path, monkeypatch):  # noqa: F811
    """The port's visualize_dataset hands save_video the same frames, file
    names, fps and options as the JAX CLI (the mp4s themselves are not
    compared: the encoder writes different files for the same frames)."""
    calls = {"jax": [], "port": []}

    def capture(side):
        def save_video(video, audio_path, output_path, fps=30.0, apply_median_filter=True):
            calls[side].append((np.array(video), audio_path, os.path.basename(output_path), fps,
                                apply_median_filter))
        return save_video

    monkeypatch.setattr(j_media, "save_video", capture("jax"))
    monkeypatch.setattr(t_media, "save_video", capture("port"))
    flags = ["--data_meta_paths", fixture_meta, "--num_samples", "2", "--num_frames", "4",
             "--image_size", "64", "--fps", "3", "--seed", "1"]
    monkeypatch.setattr(sys, "argv", ["visualize_dataset.py", *flags,
                                      "--output_dir", str(tmp_path / "jax")])
    _jax_cli("visualize_dataset").main()
    made = t_vis.main([*flags, "--output_dir", str(tmp_path / "port")])
    assert made == 2 and len(calls["jax"]) == 2 and len(calls["port"]) == 2
    for (jv, *jrest), (tv, *trest) in zip(calls["jax"], calls["port"]):
        assert tv.dtype == np.uint8 and tv.shape == jv.shape == (3 + 4, 64, 4 * 64, 3)
        np.testing.assert_array_equal(tv, jv)
        assert trest == jrest
    assert [c[2] for c in calls["port"]] == ["sample_0.mp4", "sample_1.mp4"]


def test_read_video_rgb_max_frames_matches_jax(tmp_path):
    import cv2

    path = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25, (32, 32))
    rng = np.random.default_rng(0)
    for _ in range(6):
        writer.write(rng.integers(0, 255, size=(32, 32, 3), dtype=np.uint8))
    writer.release()
    for max_frames in (None, 1, 3, 6, 10):
        got = t_media.read_video_rgb(path, max_frames=max_frames)
        want = j_media.read_video_rgb(path, max_frames=max_frames)
        assert got.shape[0] == (6 if max_frames is None else min(max_frames, 6))
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ exports and checkpoints


@pytest.fixture(scope="module")
def tiny_params():
    """The tiny JAX params of tests/test_torch_train.py (traced, not compiled)."""
    from vexpress_tpu.models import unet_3d as j_u3
    from vexpress_tpu.models import vae as j_vae

    from .test_torch_train import APROJ_KW, GUIDER_KW, UNET_KW, VAE_KW, W2V_KW

    jm = j_pipe.PipelineModels(
        unet_config=j_u3.UNetConfig(**UNET_KW), vae_config=j_vae.VAEConfig(**VAE_KW),
        wav2vec2_config=j_w2v.Wav2Vec2Config(**W2V_KW), audio_projection_kwargs=APROJ_KW,
        guider_kwargs=GUIDER_KW)
    return _jax_params(j_pipe.VExpressPipeline(jm, {}), jm.unet_config)


def test_export_modules_matches_jax_and_loads_back(tiny_params, tmp_path):
    """export_modules writes the same files as the JAX export_modules, key for
    key and value for value, and each loads back strict through load_pipeline."""
    j_ckpt.export_modules(tiny_params, str(tmp_path / "jax"), 3)
    pipe = port_pipeline(tiny_params)
    t_ckpt.export_modules(pipe.components(), str(tmp_path / "port"), 3)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == sorted(
        [f"{m}-3.pth" for m in t_ckpt.MODULE_FILES] + ["motion_module-3.pth"])
    for name in names:
        want = torch.load(tmp_path / "jax" / name)
        got = torch.load(tmp_path / "port" / name)
        assert list(got) == list(want) or set(got) == set(want), name
        assert set(got) == set(want), name
        for k in want:
            assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), (name, k)
    exp = tmp_path / "port"
    back = load_pipeline(models=pipe.m, device="cpu",
                         reference_net_path=str(exp / "reference_net-3.pth"),
                         denoising_unet_path=str(exp / "denoising_unet-3.pth"),
                         motion_module_path=str(exp / "motion_module-3.pth"),
                         v_kps_guider_path=str(exp / "v_kps_guider-3.pth"),
                         audio_projection_path=str(exp / "audio_projection-3.pth"))
    for m in t_ckpt.MODULE_FILES:
        want = dict(pipe.components()[m].named_parameters())
        for k, p in back.components()[m].named_parameters():
            assert torch.equal(p, want[k]), (m, k)


def _fake_grads(params, seed):
    g = torch.Generator().manual_seed(seed)
    for p in params:
        p.grad = torch.randn(p.shape, generator=g) * 0.1


def _opt_state(optimizer):
    out = []
    for p in optimizer.params:
        for k, v in sorted(optimizer.inner.state[p].items()):
            out += list(v) if isinstance(v, QTensor) else [v]
    return out


def test_train_state_round_trip_lora(tiny_params, tmp_path):
    """LoRA with AdamW: after two updates, save_train_state then
    restore_train_state into a fresh run (other factors, no state) gives the
    factors, both moments, the update count and the step bitwise; a second
    save at the same step replaces the first."""
    cfg = tl.LoraConfig(rank=2, alpha=4.0)
    tcfg = TrainConfig(learning_rate=1e-2, lr_scheduler="linear", lr_warmup_steps=2,
                       max_train_steps=10)

    def run(seed):
        comps = port_pipeline(tiny_params).components()
        lora = tl.init_lora(comps, cfg, seed=seed)
        tl.attach_lora(comps, lora)
        optimizer = tl.make_lora_optimizer(lora, tcfg)
        return TrainState(comps, optimizer), lora

    state, lora = run(0)
    for i in range(2):
        _fake_grads(state.optimizer.params, i)
        state.optimizer.step()
        state.step += 1
    t_ckpt.save_train_state(str(tmp_path), 2, TrainState(state.models, state.optimizer, 9))
    path = t_ckpt.save_train_state(str(tmp_path), 2, state)  # replaces the first
    fresh, fresh_lora = run(1)
    assert not all(torch.equal(a, b) for a, b in zip(tl.lora_parameters(fresh_lora),
                                                      tl.lora_parameters(lora)))
    t_ckpt.restore_train_state(path, fresh)
    assert fresh.step == 2 and fresh.optimizer.inner.count == 2
    for a, b in zip(tl.lora_parameters(fresh_lora), tl.lora_parameters(lora)):
        assert torch.equal(a, b)
    live, back = _opt_state(state.optimizer), _opt_state(fresh.optimizer)
    assert len(live) == 2 * len(state.optimizer.params)
    assert all(torch.equal(a, b) for a, b in zip(live, back))
    assert t_ckpt.latest_checkpoint(str(tmp_path)) == path


class _Leaves(torch.nn.Module):
    def __init__(self, seed):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.lat = torch.nn.Parameter(torch.randn((70, 100), generator=g) * 0.1)
        self.vec = torch.nn.Parameter(torch.randn((64,), generator=g) * 0.1)


def test_train_state_round_trip_8bit_adam(tmp_path):
    """Module training with the 8-bit Adam and gradient accumulation: the
    int8 codes, the fp32 scales, the fp32 momenta of the small tensor, the
    accumulator and the counts survive the round trip bitwise, and the next
    update from the restored state equals the live one's."""
    tcfg = TrainConfig(train_audio_projection=True, learning_rate=1e-2,
                       reduce_optimizer_memory=True, gradient_accumulation_steps=2)

    def run(seed):
        models = {"audio_projection": _Leaves(seed)}
        optimizer, _ = make_optimizer(models, tcfg)
        return TrainState(models, optimizer)

    state = run(0)
    for i in range(3):  # update, then one accumulated mini-step
        _fake_grads(state.optimizer.params, i)
        state.optimizer.step()
    state.step = 3
    assert state.optimizer.acc is not None and state.optimizer.mini_step == 1
    assert isinstance(state.optimizer.inner.state[state.models["audio_projection"].lat]["mu"],
                      QTensor)
    path = t_ckpt.save_train_state(str(tmp_path), 3, state)
    fresh = t_ckpt.restore_train_state(path, run(1))
    assert (fresh.step, fresh.optimizer.mini_step, fresh.optimizer.inner.count) == (3, 1, 1)
    assert all(torch.equal(a, b) for a, b in zip(_opt_state(fresh.optimizer),
                                                 _opt_state(state.optimizer)))
    assert all(torch.equal(a, b) for a, b in zip(fresh.optimizer.acc, state.optimizer.acc))
    for s in (state, fresh):
        _fake_grads(s.optimizer.params, 7)
        assert s.optimizer.step()
    for a, b in zip(fresh.optimizer.params, state.optimizer.params):
        assert torch.equal(a, b)


def test_latest_checkpoint_matches_jax(tmp_path):
    for step in (2, 10, 9):
        (tmp_path / f"checkpoint-{step}").mkdir()
    assert t_ckpt.latest_checkpoint(str(tmp_path)) == j_ckpt.latest_checkpoint(str(tmp_path))
    assert t_ckpt.latest_checkpoint(str(tmp_path)).endswith("checkpoint-10")
    assert t_ckpt.latest_checkpoint(str(tmp_path / "none")) is None


# ------------------------------------------------------------ telemetry

_TIMES = re.compile(r"^(artifact_location|artifact_uri|creation_time|last_update_time|end_time|"
                    r"start_time|run_id|run_uuid): .*$")


def _telemetry_files(obs, root):
    log = obs.MetricsLogger(str(root), mlflow_dir=str(root / "mlruns"), run_name="stage_2")
    log.log_param("config", "/configs/x.yaml")
    log.log(1, {"train_loss": 0.5, "it_per_s": 2.0})
    log.log(2, {"train_loss": np.float32(0.25), "it_per_s": 3})
    log.close()
    timer = obs.StepTimer()
    timer.data_done()
    timer.step_done()
    files = {}
    for f in sorted(p for p in root.rglob("*") if p.is_file()):
        rel = str(f.relative_to(root)).replace(log._mlflow.run_id, "RUN")
        text = f.read_text().splitlines()
        if f.name == "metrics.jsonl":
            text = [{k: v for k, v in json.loads(x).items() if k != "time"} for x in text]
        elif f.parent.name == "metrics":  # drop the timestamp (and the elapsed "time")
            text = [x.split(" ", 2)[2] if f.name == "time" else x.split(" ", 1)[1] for x in text]
        elif f.name == "meta.yaml":
            text = [x for x in text if not _TIMES.match(x)]
        files[rel] = text
    return files, sorted(timer.report())


def test_telemetry_writes_the_jax_files(tmp_path):
    """MetricsLogger with its MLflow FileStore writes the same file tree and
    contents as the JAX one (timestamps, run ids and absolute paths aside);
    StepTimer reports the same keys."""
    want = _telemetry_files(j_obs, tmp_path / "jax")
    got = _telemetry_files(t_obs, tmp_path / "port")
    assert got == want
    assert "mlruns/0/RUN/metrics/train_loss" in got[0]


# ------------------------------------------------------------ the CLIs


def _train_cfg(tmp_path, **extra):
    cfg = _tiny_cfg(_make_dataset(tmp_path), str(tmp_path / "out"))
    cfg["data"]["train_bs"] = 1
    cfg["solver"]["learning_rate"] = 1e-3
    cfg.update(extra)
    path = tmp_path / "train.json"
    path.write_text(json.dumps(cfg))
    return cfg, str(path)


def _infer_argv(tmp_path, *extra):
    import cv2
    import yaml

    rng = np.random.default_rng(0)
    ref_path, aud_path = str(tmp_path / "ref.png"), str(tmp_path / "aud.wav")
    cv2.imwrite(ref_path, rng.integers(0, 255, size=(64, 64, 3), dtype=np.uint8))
    _write_wav(aud_path, seconds=0.5)
    kps_path = str(tmp_path / "kps.pth")
    torch.save([rng.uniform(10, 54, (3, 2)) for _ in range(4)], kps_path)
    ov_path = str(tmp_path / "tiny_models.yaml")
    with open(ov_path, "w") as f:
        yaml.safe_dump(TINY_OVERRIDES, f)
    return ["--device", "cpu", "--dtype", "fp32", "--model_overrides_path", ov_path,
            "--reference_image_path", ref_path, "--audio_path", aud_path, "--kps_path", kps_path,
            "--retarget_strategy", "no_retarget", "--image_width", "64", "--image_height", "64",
            "--fps", "8", "--sampler", "dpmpp_2m", "--num_inference_steps", "2",
            "--context_frames", "4", "--context_overlap", "1", "--save_gpu_memory",
            "--vae_path", str(tmp_path / "missing"), *extra]


def test_train_cli_lora_checkpoint_resume_and_infer(tmp_path, capsys):
    """`vexpress_torch.cli.train --device cpu` on a JSON config with a lora
    section: 2 steps, checkpoint-2 and lora-2.pth; `resume_from_checkpoint:
    latest` then runs step 3 from the restored state; the inference CLI with
    --lora_path lora-2.pth merges exactly the adapter's weights, re-merges
    the host copies of the modules it touches, and writes the video."""
    cfg, path = _train_cfg(tmp_path, lora={"rank": 2, "alpha": 4})
    t_cli.main(["--config", path, "--device", "cpu"])
    out = capsys.readouterr().out
    out_dir = pathlib.Path(cfg["output_dir"])
    n_pairs = int(re.search(r"LoRA fine-tuning: (\d+) adapted projections", out).group(1))
    assert n_pairs > 0 and "optimizer: fp32 AdamW" in out and "step 2/2" in out, out
    assert (out_dir / "checkpoints" / "checkpoint-2" / "train_state.pt").exists()
    assert (out_dir / "metrics.jsonl").exists() and (out_dir / "mlruns").is_dir()
    adapter = torch.load(out_dir / "lora-2.pth")
    assert len(adapter) == 2 * n_pairs + 1 and float(adapter["lora_alpha"]) == 4.0
    assert any(bool(v.any()) for k, v in adapter.items() if "lora_B" in k)  # B moved

    cfg["resume_from_checkpoint"] = "latest"
    pathlib.Path(path).write_text(json.dumps(cfg))
    t_cli.main(["--config", path, "--device", "cpu", "--max_steps_override", "3"])
    out = capsys.readouterr().out
    assert "checkpoint-2 at step 2" in out and "step 3/3" in out, out
    assert "step 1/" not in out and (out_dir / "lora-3.pth").exists()
    records = [json.loads(x) for x in (out_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2, 3]

    lora_path = str(out_dir / "lora-2.pth")
    plain = t_infer.build_pipeline(t_infer.parse_args(_infer_argv(tmp_path)))
    argv = _infer_argv(tmp_path, "--lora_path", lora_path, "--output_path",
                       str(tmp_path / "video.mp4"))
    merged = t_infer.build_pipeline(t_infer.parse_args(argv))
    comps = plain.components()
    lora, _ = tl.lora_from_torch_state_dict(adapter, comps)
    base = {m: dict(mod.named_parameters()) for m, mod in comps.items()}
    want = tl.merge_lora(base, lora, 2.0)
    n_changed = 0
    for m, mod in merged.components().items():
        for k, p in mod.named_parameters():
            assert torch.equal(p, want[m][k]), (m, k)
            n_changed += not torch.equal(p, base[m][k])
    # an adapter whose B is still zero merges to its base weight exactly
    assert n_changed == sum(bool(v.any()) for k, v in adapter.items() if "lora_B" in k) > 0
    for m in merged.RELEASABLE_COND_MODULES:
        for k, v in merged._host_cond[m].items():
            assert torch.equal(v, plain._host_cond[m][k]), (m, k)  # untouched

    t_infer.main(argv)
    out = capsys.readouterr().out
    assert f"merged LoRA adapter {lora_path}" in out and "generated video" in out, out
    assert (tmp_path / "video.mp4").exists()


def test_lora_merge_re_merges_touched_host_copies(tmp_path):
    """An adapter on the reference net (a save_memory module): the merge
    changes the module on its device and its host copy alike."""
    argv = _infer_argv(tmp_path)
    pipe = t_infer.build_pipeline(t_infer.parse_args(argv))
    comps = pipe.components()
    lora = tl.init_lora(comps, tl.LoraConfig(rank=2, modules=("reference_net",),
                                             include="attn1"), seed=1)
    for f in (f for sub in lora.values() for f in sub.values()):
        f.lora_B.weight.data.normal_(0.0, 0.05)
    path = str(tmp_path / "ref_adapter.pth")
    torch.save(tl.lora_to_torch_state_dict(lora, tl.LoraConfig(rank=2)), path)
    before = {k: v.clone() for k, v in pipe._host_cond["reference_net"].items()}
    untouched = pipe._host_cond["audio_projection"]
    t_infer.merge_lora_adapter(pipe, path)
    assert pipe._host_cond["audio_projection"] is untouched
    host, changed = pipe._host_cond["reference_net"], 0
    for k, p in comps["reference_net"].named_parameters():
        assert torch.equal(host[k], p.detach()), k
        changed += not torch.equal(host[k], before[k])
    assert changed == len(lora["reference_net"])


def test_train_cli_module_training_exports(tmp_path, capsys):
    """Module training (no lora section): stage_zero_init, the 8-bit Adam
    line, and the per-module exports at the checkpoint; save_all false
    exports only what the stage trains."""
    cfg, path = _train_cfg(tmp_path, checkpointing_steps=1, save_all=False)
    t_cli.main(["--config", path, "--device", "cpu", "--max_steps_override", "1"])
    out = capsys.readouterr().out
    assert re.search(r"optimizer: blockwise int8 Adam \(\d+ int8 state tensors\)", out), out
    exports = sorted(f for f in os.listdir(cfg["output_dir"]) if f.endswith(".pth"))
    assert exports == ["denoising_unet-1.pth", "motion_module-1.pth"]


def test_train_cli_refuses_what_it_cannot_do(tmp_path, monkeypatch):
    """--device auto without a GPU raises (no silent CPU run); asked for 2
    processes, the CLI raises when no peer joins (after the group's
    timeout) or when nothing says where the group meets, and never trains
    as one process; unknown lora keys stop."""
    import datetime

    import torch.distributed as dist

    from vexpress_torch.parallel import mesh

    from .torch_dist_workers import free_port

    cfg, path = _train_cfg(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ("auto", "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_cli.train(cfg, t_cli.parse_args(["--config", path, "--device", device]), iter(()))
    monkeypatch.setattr(mesh, "TIMEOUT", datetime.timedelta(seconds=3))
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(dist.DistStoreError, match="1/2 clients joined"):
        t_cli.main(["--config", path, "--device", "cpu", "--coordinator_address",
                    f"127.0.0.1:{free_port()}", "--num_processes", "2", "--process_id", "0"])
    with pytest.raises(ValueError, match="num_processes=2 needs coordinator_address"):
        t_cli.main(["--config", path, "--device", "cpu", "--num_processes", "2"])
    assert not dist.is_initialized()
    assert not (pathlib.Path(cfg["output_dir"]) / "checkpoints").exists()
    with pytest.raises(SystemExit, match="unknown lora config keys"):
        t_cli.parse_lora({"lora": {"rank": 2, "dropout": 0.1}})
    with pytest.raises(FileNotFoundError):
        t_infer.build_pipeline(t_infer.parse_args(
            _infer_argv(tmp_path, "--lora_path", str(tmp_path / "absent.pth"))))


def test_prepare_dataset_audio_embeddings_matches_jax(tmp_path, monkeypatch):
    """audio-embeddings on a short generated WAV with a tiny HF wav2vec2
    checkpoint (both sides' Wav2Vec2Config() made tiny): the port's dump
    equals the JAX subcommand's at 1e-5; golden-check passes on the pair and
    fails on a perturbed golden."""
    from transformers import Wav2Vec2Config as HFConfig
    from transformers import Wav2Vec2Model as HFModel

    tiny = {k: tuple(v) if isinstance(v, list) else v for k, v in TINY_OVERRIDES["wav2vec2"].items()}
    torch.manual_seed(0)
    hf = HFModel(HFConfig(do_stable_layer_norm=False, feat_extract_norm="group",
                          feat_extract_activation="gelu", hidden_act="gelu", **tiny)).eval()
    weights = str(tmp_path / "w2v.bin")
    torch.save({f"wav2vec2.{k}": v for k, v in hf.state_dict().items()}, weights)
    wav = str(tmp_path / "aud.wav")
    _write_wav(wav, seconds=0.5)
    monkeypatch.setattr(j_w2v, "Wav2Vec2Config", functools.partial(j_w2v.Wav2Vec2Config, **tiny))
    monkeypatch.setattr(t_w2v, "Wav2Vec2Config", functools.partial(t_w2v.Wav2Vec2Config, **tiny))
    j_prep = _jax_cli("prepare_dataset")
    jax_out, port_out = str(tmp_path / "jax.pt"), str(tmp_path / "port.pt")
    j_prep.cmd_audio_embeddings(argparse.Namespace(input=wav, output=jax_out, weights=weights))
    t_prep.main(["audio-embeddings", "--input", wav, "--output", port_out, "--weights", weights,
                 "--device", "cpu"])
    want = torch.load(jax_out)["global_embeds"]
    got = torch.load(port_out)["global_embeds"]
    assert got.shape == want.shape and got.shape[1:] == (1, tiny["hidden_size"])
    close(got.numpy(), want.numpy(), 1e-5)

    with pytest.raises(SystemExit) as ok:
        t_prep.main(["golden-check", "--extracted", port_out, "--golden", jax_out])
    assert ok.value.code == 0
    bad = str(tmp_path / "bad.pt")
    torch.save({"global_embeds": want + 1.0}, bad)
    with pytest.raises(SystemExit) as fail:
        t_prep.main(["golden-check", "--extracted", port_out, "--golden", bad])
    assert fail.value.code == 1


def test_load_pipeline_base_model_path(tiny_params, tmp_path):
    """base_model_path (the training configs' SD prior): a diffusers-layout
    directory's unet weights load into both UNets, before the stage
    checkpoints would overlay them."""
    pipe = port_pipeline(tiny_params)
    sd = {k: v + 0.5 for k, v in pipe.reference_net.state_dict().items()}
    (tmp_path / "sd" / "unet").mkdir(parents=True)
    torch.save(sd, tmp_path / "sd" / "unet" / "diffusion_pytorch_model.bin")
    back = load_pipeline(models=pipe.m, device="cpu", base_model_path=str(tmp_path / "sd"))
    for name in ("reference_net", "denoising_unet"):
        got = back.components()[name].state_dict()
        assert all(torch.equal(got[k], v) for k, v in sd.items()), name
