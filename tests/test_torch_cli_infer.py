"""The port's checkpoint loading, CLI helpers and CLI against vexpress_tpu's
on the CPU: released-format torch checkpoints of tiny JAX modules load into
both packages' pipelines to equal tensors; strict key checking, the lineage
remap, stage_1 zeroing and the HF wav2vec2 converter agree; keypoint
rendering, retargeting and interpolation and the image loader give equal
output; a Wav2Vec2ForCTC audio checkpoint loads without its CTC head; and
`python -m vexpress_torch.cli.infer --device cpu` writes a video, and with
--profile_dir a trace.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
yaml = pytest.importorskip("yaml")

from transformers import Wav2Vec2Config as HFConfig  # noqa: E402
from transformers import Wav2Vec2Model as HFModel  # noqa: E402

from vexpress_tpu.io import loaders as j_loaders  # noqa: E402
from vexpress_tpu.io import torch_import as j_import  # noqa: E402
from vexpress_tpu.io.torch_export import export_to_torch_state_dict, save_torch_checkpoint  # noqa: E402
from vexpress_tpu.models.wav2vec2 import convert_wav2vec2_state_dict as j_convert_w2v  # noqa: E402
from vexpress_tpu.pipelines import kps as j_kps  # noqa: E402
from vexpress_tpu.pipelines import media as j_media  # noqa: E402
from vexpress_tpu.utils.misc import zero_params_matching as j_zero  # noqa: E402
from vexpress_torch.io import loaders as t_loaders  # noqa: E402
from vexpress_torch.io import torch_import as t_import  # noqa: E402
from vexpress_torch.io.torch_export import wav2vec2_torch_key  # noqa: E402
from vexpress_torch.models.wav2vec2 import Wav2Vec2Model  # noqa: E402
from vexpress_torch.models.wav2vec2 import convert_wav2vec2_state_dict as t_convert_w2v  # noqa: E402
from vexpress_torch.pipelines import kps as t_kps  # noqa: E402
from vexpress_torch.pipelines import media as t_media  # noqa: E402
from vexpress_torch.utils.misc import zero_params_matching as t_zero  # noqa: E402

from .test_cli_infer import TINY_OVERRIDES, _write_wav  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_ARGS = ("vae", "reference_net", "denoising_unet", "v_kps_guider", "audio_projection")


def _hf_wav2vec2(seed=0, **cfg):
    torch.manual_seed(seed)
    return HFModel(HFConfig(do_stable_layer_norm=False, feat_extract_norm="group",
                            feat_extract_activation="gelu", hidden_act="gelu", **cfg)).eval()


def _exported(name, params):
    sd = export_to_torch_state_dict(params)
    return {wav2vec2_torch_key(k): v for k, v in sd.items()} if name == "wav2vec2" else sd


@pytest.fixture(scope="module", autouse=True)
def jax_init_once():
    """The JAX loader traces the tiny modules' init at every call (~15 s on
    the CPU); every call here has the same models, so trace once and hand
    each call its own copy of the random tree."""
    real, cache = j_loaders._init_params, {}

    def once(pipe, models, dtype=np.float32):
        if "params" not in cache:
            cache["params"] = real(pipe, models, dtype=dtype)
        return jax.tree_util.tree_map(np.copy, cache["params"])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_loaders, "_init_params", once)
        yield


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Released-format checkpoints of tiny modules: the JAX loader's random
    params, exported (every leaf offset so no value is a plain 0 or 1), and an
    HF wav2vec2 directory with the `wav2vec2.` prefix of the CTC model."""
    d = tmp_path_factory.mktemp("ckpts")
    models = j_loaders.apply_model_overrides(j_loaders.default_pipeline_models(jnp.float32),
                                             TINY_OVERRIDES)
    params = j_loaders.load_pipeline(models=models, verbose=False).params
    rng = np.random.default_rng(0)
    paths = {}
    for name in CKPT_ARGS:
        sd = {k: v + 0.01 * rng.standard_normal(v.shape).astype(np.float32)
              for k, v in export_to_torch_state_dict(params[name]).items()}
        paths[name] = str(d / f"{name}.bin")
        save_torch_checkpoint(sd, paths[name])
    (d / "w2v").mkdir()
    hf = _hf_wav2vec2(**TINY_OVERRIDES["wav2vec2"])
    torch.save({f"wav2vec2.{k}": v for k, v in hf.state_dict().items()},
               d / "w2v" / "pytorch_model.bin")
    paths["wav2vec2"] = str(d / "w2v")
    return models, paths


def _load_kwargs(paths):
    return dict(audio_encoder_path=paths["wav2vec2"],
                **{f"{n}_path": paths[n] for n in CKPT_ARGS})


def test_checkpoints_load_to_equal_tensors(checkpoints):
    models, paths = checkpoints
    jp = j_loaders.load_pipeline(models=models, verbose=False, **_load_kwargs(paths))
    tm = t_loaders.apply_model_overrides(t_loaders.default_pipeline_models(torch.float32),
                                         TINY_OVERRIDES)
    tp = t_loaders.load_pipeline(models=tm, device="cpu", **_load_kwargs(paths))
    for name, mod in tp.components().items():
        ref = _exported(name, jax.device_get(jp.params[name]))
        got = mod.state_dict()
        assert set(got) == set(ref), (name, sorted(set(got) ^ set(ref))[:6])
        for k, v in got.items():
            # the weight-normed positional conv is derived in fp32 on each side
            tol = 1e-6 if k == "encoder.pos_conv_embed.conv.weight" else 0.0
            np.testing.assert_allclose(v.numpy(), ref[k], rtol=tol, atol=tol * 0.1,
                                       err_msg=f"{name}.{k}")
    assert all(n in tp._host_cond for n in tp.RELEASABLE_COND_MODULES)


def test_misspelled_key_raises(checkpoints, tmp_path):
    models, paths = checkpoints
    sd = torch.load(paths["v_kps_guider"], weights_only=True)
    sd["conv_in.wieght"] = sd["conv_in.weight"]
    bad = str(tmp_path / "guider.bin")
    torch.save(sd, bad)
    tm = t_loaders.apply_model_overrides(t_loaders.default_pipeline_models(torch.float32),
                                         TINY_OVERRIDES)
    with pytest.raises(ValueError, match="conv_in.wieght"):
        t_loaders.load_pipeline(models=tm, device="cpu", v_kps_guider_path=bad)
    with pytest.raises(ValueError, match="had no destination"):
        j_loaders.load_pipeline(models=models, v_kps_guider_path=bad, verbose=False)


def test_remap_lineage_matches_jax():
    sd = {"down_blocks.0.attentions.0.transformer_blocks.0.norm1.weight": np.ones(2),
          "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight": np.ones((2, 2)),
          "mid_block.attentions.0.transformer_blocks.0.attn2.to_k.weight": np.zeros((2, 2)),
          "mid_block.attentions.0.transformer_blocks.0.attn2.processor.to_k_aud.weight":
              np.full((2, 2), 3.0)}
    for kind in ("new_attn", "old_attn", "moore_pretrained"):
        got, ref = t_import.remap_lineage(sd, kind), j_import.remap_lineage(sd, kind)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
    malformed = {k: v for k, v in sd.items() if "processor" not in k}
    for remap in (t_import.remap_lineage, j_import.remap_lineage):
        with pytest.raises(KeyError, match="old_attn"):
            remap(malformed, "old_attn")


def test_stage_1_zeroing_matches_jax(checkpoints):
    models, paths = checkpoints
    tm = t_loaders.apply_model_overrides(t_loaders.default_pipeline_models(torch.float32),
                                         TINY_OVERRIDES)
    tp = t_loaders.load_pipeline(models=tm, device="cpu",
                                 denoising_unet_path=paths["denoising_unet"])
    names = t_zero(tp.denoising_unet, "temporal_transformer.proj_out", "attn2.to_out.0")
    ref = export_to_torch_state_dict(j_zero(
        j_import.convert_torch_state_dict(torch.load(paths["denoising_unet"], weights_only=True)),
        "temporal_transformer/proj_out", "attn2/to_out_0"))
    zero_ref = {k for k, v in ref.items() if not np.any(v)}
    assert names and set(names) == zero_ref
    for k, v in tp.denoising_unet.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


def test_wav2vec2_hf_converter_matches_jax():
    """The state dict of tests/test_parity_wav2vec2.py's small HF model."""
    hf = _hf_wav2vec2(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                      intermediate_size=64, conv_dim=(16, 16), conv_kernel=(10, 3),
                      conv_stride=(5, 2), num_conv_pos_embeddings=16,
                      num_conv_pos_embedding_groups=4)
    got = t_convert_w2v(hf.state_dict())
    ref = _exported("wav2vec2", j_convert_w2v(hf.state_dict()))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_kps_and_image_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    seq = rng.uniform(20, 100, size=(9, 3, 2))
    ref_kps = rng.uniform(20, 100, size=(3, 2))
    for only_offset in (True, False):
        np.testing.assert_array_equal(t_kps.retarget_kps(ref_kps, seq, only_offset),
                                      j_kps.retarget_kps(ref_kps, seq, only_offset))
    for n in (5, 9, 14):
        np.testing.assert_array_equal(t_kps.interpolate_kps_sequence(seq, n),
                                      j_kps.interpolate_kps_sequence(seq, n))
    got = t_kps.render_kps_sequence(96, 128, seq)
    assert got.dtype == np.uint8 and got.any()
    np.testing.assert_array_equal(got, j_kps.render_kps_sequence(96, 128, seq))
    path = str(tmp_path / "img.png")
    cv2.imwrite(path, rng.integers(0, 255, size=(50, 70, 3), dtype=np.uint8))
    np.testing.assert_array_equal(t_media.load_image_rgb(path, 64, 96),
                                  j_media.load_image_rgb(path, 64, 96))


def test_ctc_wav2vec2_checkpoint_loads(tmp_path):
    """The CLI's default audio encoder, wav2vec2-base-960h, is a
    Wav2Vec2ForCTC checkpoint: its `wav2vec2.*` tensors load and its CTC head
    (`lm_head.*`) is dropped, as the reference's Wav2Vec2Model.from_pretrained
    drops it. Another unknown key in that checkpoint, or `lm_head.*` in the
    UNet's, still raises."""
    tm = t_loaders.apply_model_overrides(t_loaders.default_pipeline_models(torch.float32),
                                         TINY_OVERRIDES)
    src = t_loaders.init_random_(Wav2Vec2Model(tm.wav2vec2_config), seed=3).state_dict()
    hidden = tm.wav2vec2_config.hidden_size
    ctc = {f"wav2vec2.{k}": v for k, v in src.items()}
    ctc.update({"lm_head.weight": torch.randn(32, hidden), "lm_head.bias": torch.randn(32)})

    def saved(name, sd):
        (tmp_path / name).mkdir()
        torch.save(sd, tmp_path / name / "pytorch_model.bin")
        return str(tmp_path / name)

    pipe = t_loaders.load_pipeline(models=tm, device="cpu",
                                   audio_encoder_path=saved("ctc", ctc))
    got = pipe.components()["wav2vec2"].state_dict()
    assert set(got) == set(src)
    for k, v in src.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    with pytest.raises(ValueError, match="wav2vec2.*encoder.bogus"):
        t_loaders.load_pipeline(models=tm, device="cpu", audio_encoder_path=saved(
            "bogus", dict(ctc, **{"wav2vec2.encoder.bogus": torch.zeros(2)})))
    unet = str(tmp_path / "unet.bin")
    torch.save({"conv_in.bias": torch.zeros(tm.unet_config.block_out_channels[0]),
                "lm_head.weight": torch.zeros(32, hidden)}, unet)
    with pytest.raises(ValueError, match="denoising_unet.*lm_head.weight"):
        t_loaders.load_pipeline(models=tm, device="cpu", denoising_unet_path=unet)


def _cli_argv(tmp_path):
    """A tiny `--device cpu` CLI run's flags and the subprocess environment."""
    rng = np.random.default_rng(0)
    ref_path, aud_path = str(tmp_path / "ref.png"), str(tmp_path / "aud.wav")
    cv2.imwrite(ref_path, rng.integers(0, 255, size=(64, 64, 3), dtype=np.uint8))
    _write_wav(aud_path)
    kps_path = str(tmp_path / "kps.pth")
    torch.save([rng.uniform(10, 54, (3, 2)) for _ in range(8)], kps_path)
    ov_path = str(tmp_path / "tiny_models.yaml")
    with open(ov_path, "w") as f:
        yaml.safe_dump(TINY_OVERRIDES, f)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    argv = [sys.executable, "-m", "vexpress_torch.cli.infer", "--device", "cpu", "--dtype", "fp32",
            "--model_overrides_path", ov_path, "--reference_image_path", ref_path,
            "--audio_path", aud_path, "--kps_path", kps_path, "--retarget_strategy", "no_retarget",
            "--image_width", "64", "--image_height", "64", "--fps", "8", "--seed", "0",
            "--sampler", "dpmpp_2m", "--num_inference_steps", "2", "--save_gpu_memory",
            "--context_frames", "4", "--context_overlap", "1",
            "--vae_path", str(tmp_path / "missing")]
    return argv, env


def test_cli_profile_dir_writes_trace(tmp_path):
    argv, env = _cli_argv(tmp_path)
    trace_dir = tmp_path / "trace"
    proc = subprocess.run(argv + ["--profile_dir", str(trace_dir), "--output_path",
                                  str(tmp_path / "out.mp4")],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout[-3000:]}\nSTDERR:\n{proc.stderr[-3000:]}"
    traces = sorted(trace_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1 and f"device trace written to {traces[0]}" in proc.stdout
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]


def test_cli_generates_video(tmp_path):
    argv, env = _cli_argv(tmp_path)
    out_path = str(tmp_path / "out" / "result.mp4")
    proc = subprocess.run(argv + ["--output_path", out_path], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout[-3000:]}\nSTDERR:\n{proc.stderr[-3000:]}"
    assert "denoise step 2/2" in proc.stdout and "not found — using random init" in proc.stdout
    # 1.0 s of audio at 8 fps, trimmed to whole 4-frame windows of overlap 1
    assert "video_length 7" in proc.stdout, proc.stdout[-2000:]
    cap = cv2.VideoCapture(out_path)
    shape = tuple(int(cap.get(p)) for p in (cv2.CAP_PROP_FRAME_COUNT, cv2.CAP_PROP_FRAME_HEIGHT,
                                            cv2.CAP_PROP_FRAME_WIDTH))
    cap.release()
    assert shape == (7, 64, 64)


@pytest.mark.parametrize("flag,value", [("--mode", "fused")])
def test_cli_unported_options_raise(flag, value):
    """--mode fused is ported (tests/test_torch_fused.py runs it); what the
    pipeline refuses with it, --save_gpu_memory, raises the JAX pipeline's
    error before any model is built, and so does an unknown mode."""
    from vexpress_torch.cli import infer

    args = infer.parse_args(["--reference_image_path", "r", "--audio_path", "a", flag]
                            + ([value] if value else []) + ["--save_gpu_memory"])
    with pytest.raises(ValueError, match="save_memory requires mode='streamed' or 'sharded'"):
        infer.build_pipeline(args)
    args = infer.parse_args(["--reference_image_path", "r", "--audio_path", "a", flag, "eager"])
    with pytest.raises(ValueError, match="unknown --mode"):
        infer.build_pipeline(args)


@pytest.mark.parametrize("flags", [["--do_multi_devices_inference"], ["--mode", "sharded"]])
def test_cli_multi_device_flags_take_the_sharded_mode(flags, tmp_path, monkeypatch, capsys):
    """--do_multi_devices_inference and --mode sharded (once refused) join a
    process group before the models are built: without torchrun's
    environment, this process alone. tests/test_torch_parallel.py runs the
    CLI as 2 processes."""
    import torch.distributed as dist

    from vexpress_torch.cli import infer

    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    ov_path = str(tmp_path / "tiny_models.yaml")
    with open(ov_path, "w") as f:
        yaml.safe_dump(TINY_OVERRIDES, f)
    args = infer.parse_args(["--reference_image_path", "r", "--audio_path", "a", "--device",
                             "cpu", "--dtype", "fp32", "--model_overrides_path", ov_path,
                             "--vae_path", str(tmp_path / "missing"), *flags])
    try:
        pipe = infer.build_pipeline(args)
        assert infer.denoise_mode(args) == "sharded"
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert pipe.device.type == "cpu"
    assert "sharding context windows over 1 devices" in capsys.readouterr().out
