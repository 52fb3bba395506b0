"""V-Express inference CLI of the PyTorch port. Counterpart of cli/infer.py,
with the same flags and defaults:

    python -m vexpress_torch.cli.infer \\
        --reference_image_path test_samples/AOC/ref.jpg \\
        --audio_path test_samples/AOC/aud.mp3 \\
        --kps_path test_samples/AOC/kps.pth \\
        --retarget_strategy fix_face --output_path output/AOC.mp4

`--device cpu` runs on the CPU; any other value runs on the CUDA device
`--gpu_id`. Checkpoint paths that do not exist leave their module with
seeded random weights. VEXPRESS_FLASH_LITE=1 in the environment sends the
flash-eligible attention to K2 (ops/flash_lite.py) instead of K1.

`--do_multi_devices_inference` (or `--mode sharded`) spreads the context
windows over the processes of a group, one a device: run it under torchrun
(`torchrun --nproc_per_node N -m vexpress_torch.cli.infer ...`; without
torchrun's environment the group is this process alone). Each process takes
the CUDA device of its LOCAL_RANK; rank 0 writes the video. `--mode fused`
runs each denoise step as one CUDA graph, captured at the first step and
replayed at every later one (on the CPU the same step, called).

The work is split so that it can be driven without the files: build_pipeline
(models, overrides, inference config, checkpoints, a LoRA adapter, stage_1),
prepare_inputs (image, audio, keypoints: cv2 and the media runtime) and
generate (the pipeline call with the CLI's keywords).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--vae_path", type=str, default="./model_ckpts/sd-vae-ft-mse/")
    p.add_argument("--audio_encoder_path", type=str, default="./model_ckpts/wav2vec2-base-960h/")
    p.add_argument("--insightface_model_path", type=str, default="./model_ckpts/insightface_models/")
    p.add_argument("--denoising_unet_path", type=str,
                   default="./model_ckpts/v-express/denoising_unet.bin")
    p.add_argument("--reference_net_path", type=str,
                   default="./model_ckpts/v-express/reference_net.bin")
    p.add_argument("--v_kps_guider_path", type=str,
                   default="./model_ckpts/v-express/v_kps_guider.bin")
    p.add_argument("--audio_projection_path", type=str,
                   default="./model_ckpts/v-express/audio_projection.bin")
    p.add_argument("--motion_module_path", type=str,
                   default="./model_ckpts/v-express/motion_module.bin")
    p.add_argument("--retarget_strategy", type=str, default="fix_face",
                   help="{fix_face, no_retarget, offset_retarget, naive_retarget}")
    p.add_argument("--dtype", type=str, default="bf16", help="{bf16, fp32}")
    p.add_argument("--num_pad_audio_frames", type=int, default=2)
    p.add_argument("--standard_audio_sampling_rate", type=int, default=16000)
    p.add_argument("--reference_image_path", type=str, required=True)
    p.add_argument("--audio_path", type=str, required=True)
    p.add_argument("--kps_path", type=str, default="")
    p.add_argument("--output_path", type=str, default="./output/result.mp4")
    p.add_argument("--test_stage", type=str, default="stage_3")
    p.add_argument("--image_width", type=int, default=512)
    p.add_argument("--image_height", type=int, default=512)
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num_inference_steps", type=int, default=25)
    p.add_argument("--sampler", type=str, default=None, choices=("ddim", "dpmpp_2m"),
                   help="ddim (reference parity, the default) or dpmpp_2m (DPM-Solver++ 2M: "
                        "comparable quality at about half the steps, e.g. "
                        "--num_inference_steps 12); an inference yaml's `sampler:` key sets "
                        "the default")
    p.add_argument("--lora_path", type=str, default="",
                   help="LoRA adapter checkpoint (peft layout, as the training CLI exports it), "
                        "merged into the weights after loading")
    p.add_argument("--lora_scale", type=float, default=None,
                   help="override the adapter's alpha/rank merge scale")
    p.add_argument("--guidance_scale", type=float, default=3.5)
    p.add_argument("--context_frames", type=int, default=24)
    p.add_argument("--context_overlap", type=int, default=4)
    p.add_argument("--reference_attention_weight", type=float, default=0.95)
    p.add_argument("--audio_attention_weight", type=float, default=3.0)
    p.add_argument("--window_group", type=int, default=1,
                   help="context windows per UNet call (memory/throughput knob)")
    p.add_argument("--do_multi_devices_inference", action="store_true",
                   help="shard context windows over the processes of a torchrun group, one a "
                        "device")
    p.add_argument("--mode", type=str, default="",
                   help="denoise mode {streamed, fused, sharded}; default sharded with "
                        "--do_multi_devices_inference, else streamed")
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler trace of the pipeline call (host operations "
                        "and CUDA kernels) into this directory, as a Chrome trace file for "
                        "Perfetto or chrome://tracing")
    p.add_argument("--no_median_filter", action="store_true")
    p.add_argument("--audio_embeddings_type", type=str, default="global",
                   help="{global} (the reference's only mode, inference.py:59,164-169)")
    p.add_argument("--unet_config_path", type=str, default="",
                   help="optional diffusers UNet config.json; overrides the built-in SD1.5 "
                        "geometry (reference inference.py:30)")
    p.add_argument("--inference_config_path", type=str, default="",
                   help="optional inference yaml in the reference's inference_v2.yaml format")
    p.add_argument("--model_overrides_path", type=str, default="",
                   help="optional YAML of per-module size overrides ({unet:, vae:, wav2vec2:, "
                        "audio_projection:, guider:})")
    p.add_argument("--device", type=str, default="",
                   help="'cpu' runs on the CPU; anything else on the CUDA device --gpu_id")
    p.add_argument("--gpu_id", type=int, default=0)
    p.add_argument("--save_gpu_memory", action="store_true",
                   help="keep the kps frames on the host, run the guider per window group and "
                        "move the reference net, wav2vec2 and audio projection off the card "
                        "after conditioning (the reference's --save_gpu_memory)")
    return p.parse_args(argv)


def _check_ported(args) -> None:
    """Options the pipeline would refuse raise before any model is built."""
    if args.mode not in ("", "streamed", "fused", "sharded"):
        raise ValueError(f"unknown --mode {args.mode!r} (use 'streamed', 'fused' or 'sharded')")
    if args.save_gpu_memory and denoise_mode(args) == "fused":
        # the pipeline's own error (VExpressPipeline.__call__)
        raise ValueError("save_memory requires mode='streamed' or 'sharded'")
    if args.audio_embeddings_type != "global":
        raise ValueError(f"audio_embeddings_type={args.audio_embeddings_type!r} is not "
                         "supported; only 'global' (reference inference.py:164-169)")


def denoise_mode(args) -> str:
    return args.mode or ("sharded" if args.do_multi_devices_inference else "streamed")


def build_pipeline(args):
    """The pipeline the flags describe: models (dtype, UNet config, size
    overrides), the inference yaml (its scheduler, and its sampler unless
    --sampler is given), the checkpoints, the LoRA adapter, and stage_1's
    zeroing. In sharded mode it first joins the process group (torchrun's
    environment) and builds on its rank's device."""
    from ..io import apply_model_overrides, default_pipeline_models, load_pipeline
    from ..models.unet_3d import UNetConfig
    from ..utils.misc import zero_params_matching

    _check_ported(args)
    device = "cpu" if args.device == "cpu" else torch.device("cuda", args.gpu_id)
    if denoise_mode(args) == "sharded":
        import torch.distributed as dist

        from ..parallel.mesh import initialize_distributed

        initialize_distributed(backend="gloo" if args.device == "cpu" else None)
        if args.device != "cpu":
            device = torch.device("cuda", torch.cuda.current_device())
        print(f"[vexpress] sharding context windows over {dist.get_world_size()} devices "
              f"(rank {dist.get_rank()}, {device})")
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[args.dtype]
    models = default_pipeline_models(dtype=dtype)
    if args.unet_config_path:
        models = dataclasses.replace(
            models, unet_config=UNetConfig.from_diffusers_json(args.unet_config_path))
    if args.model_overrides_path:
        import yaml

        with open(args.model_overrides_path) as fh:
            models = apply_model_overrides(models, yaml.safe_load(fh) or {})
    scheduler = None
    if args.inference_config_path:
        from ..io.inference_config import load_inference_config

        unet_overrides, scheduler, yaml_sampler = load_inference_config(
            args.inference_config_path)
        if unet_overrides:
            models = dataclasses.replace(
                models, unet_config=dataclasses.replace(models.unet_config, **unet_overrides))
        if args.sampler is None:  # an explicit --sampler wins over the yaml
            args.sampler = yaml_sampler
    pipeline = load_pipeline(
        models=models, scheduler=scheduler, vae_path=args.vae_path,
        audio_encoder_path=args.audio_encoder_path, reference_net_path=args.reference_net_path,
        denoising_unet_path=args.denoising_unet_path, motion_module_path=args.motion_module_path,
        v_kps_guider_path=args.v_kps_guider_path,
        audio_projection_path=args.audio_projection_path, param_dtype=dtype, device=device)
    if args.lora_path:
        merge_lora_adapter(pipeline, args.lora_path, args.lora_scale)
        print(f"[vexpress] merged LoRA adapter {args.lora_path}"
              + (f" (scale {args.lora_scale})" if args.lora_scale is not None else ""))
    if args.test_stage == "stage_1":
        # a stage-1 checkpoint: silence the audio cross-attention and the
        # motion modules (reference inference.py:203-214)
        zero_params_matching(pipeline.denoising_unet, "temporal_transformer.proj_out",
                             "attn2.to_out.0")
    return pipeline


@torch.no_grad()
def merge_lora_adapter(pipeline, path: str, scale=None) -> None:
    """Merge a peft-layout adapter into the pipeline's weights in place, on
    their device (`load_and_merge_lora`). The save_memory host copies of the
    modules it touches are merged again on the host, so a later release
    never copies them back from the card; untouched modules keep theirs."""
    from ..train.lora import load_and_merge_lora

    comps = pipeline.components()
    params = {name: dict(m.named_parameters()) for name, m in comps.items()}
    merged, pipeline._host_cond = load_and_merge_lora(params, path, comps, scale,
                                                      host_params=pipeline._host_cond)
    for mod, tensors in merged.items():
        for key, value in tensors.items():
            if value is not params[mod][key]:
                params[mod][key].copy_(value)


def load_kps_sequence(path: str) -> np.ndarray:
    """kps.pth is a torch-saved list of (3, 2) arrays (inference.py:269)."""
    seq = torch.load(path, map_location="cpu", weights_only=False)
    return np.asarray([np.asarray(k) for k in seq], dtype=np.float64)


def detect_reference_kps(image_path: str, height: int, width: int, insightface_root: str):
    """insightface face detection (inference.py:228-240); None when
    insightface (an optional dependency) is missing."""
    try:
        import cv2
        from insightface.app import FaceAnalysis
    except ImportError:
        return None
    app = FaceAnalysis(providers=["CPUExecutionProvider"], root=insightface_root)
    app.prepare(ctx_id=0, det_size=(height, width))
    img = cv2.resize(cv2.imread(image_path), (width, height))
    faces = app.get(img)
    if not faces:
        raise RuntimeError(f"no face detected in {image_path}")
    return np.asarray(faces[0].kps[:3])


def prepare_inputs(args) -> Dict[str, Any]:
    """Reference image, audio (decoded and resampled), the video length the
    audio and the context windows give, and the retargeted, rendered uint8
    keypoint frames."""
    from ..pipelines.context import compute_num_context, compute_video_length
    from ..pipelines.kps import interpolate_kps_sequence, render_kps_sequence, retarget_kps
    from ..pipelines.media import load_image_rgb
    from ..utils.media_native import load_audio

    h, w = args.image_height, args.image_width
    reference_image = load_image_rgb(args.reference_image_path, h, w)
    audio = load_audio(args.audio_path, args.standard_audio_sampling_rate)
    duration = len(audio) / args.standard_audio_sampling_rate
    init_video_length = int(duration * args.fps)
    video_length = compute_video_length(init_video_length, args.context_frames,
                                        args.context_overlap)
    fps = video_length / duration
    n_windows = compute_num_context(init_video_length, args.context_frames, args.context_overlap)
    print(f"[vexpress] audio {duration:.2f}s -> video_length {video_length} (fps {fps:.2f}, "
          f"{n_windows} windows)")

    kps_sequence = None
    if args.kps_path:
        kps_sequence = load_kps_sequence(args.kps_path)
        print(f"[vexpress] kps sequence length {len(kps_sequence)}")
        kps_sequence = interpolate_kps_sequence(kps_sequence, video_length)
    reference_kps = detect_reference_kps(args.reference_image_path, h, w,
                                         args.insightface_model_path)
    if reference_kps is None and kps_sequence is not None:
        # without insightface the first target frame stands in for the
        # reference face's keypoints
        reference_kps = kps_sequence[0]
        print("[vexpress] insightface unavailable; using first kps frame as reference kps")
    strategy = args.retarget_strategy
    if strategy == "fix_face":
        if reference_kps is None:
            raise SystemExit("fix_face needs reference kps: install insightface or pass --kps_path")
        kps_sequence = np.tile(np.asarray(reference_kps), (video_length, 1, 1))
    elif strategy == "no_retarget":
        if kps_sequence is None:
            raise SystemExit("no_retarget requires --kps_path")
    elif strategy in ("offset_retarget", "naive_retarget"):
        kps_sequence = retarget_kps(reference_kps, kps_sequence,
                                    only_offset=strategy == "offset_retarget")
    else:
        raise SystemExit(f"unknown retarget strategy {strategy}")
    return dict(reference_image=reference_image, audio=audio, fps=fps,
                video_length=video_length, kps_images=render_kps_sequence(h, w, kps_sequence))


def generate(pipeline, inputs: Dict[str, Any], args, output_yuv420: bool):
    """The pipeline call with the CLI's keywords: the (Y, U, V) planes when
    `output_yuv420`, else uint8 RGB frames; median-filtered unless
    --no_median_filter. With --profile_dir, the call runs under
    `device_trace`. In sharded mode every rank calls it and rank 0 alone
    gets the video (None elsewhere), prints the steps and writes the trace."""
    import torch.distributed as dist

    from ..utils.observability import device_trace

    mode = denoise_mode(args)
    is_main = mode != "sharded" or dist.get_rank() == 0

    def progress(i, t):
        if is_main:
            print(f"[vexpress] denoise step {i + 1}/{args.num_inference_steps} (t={t})",
                  flush=True)

    with device_trace(args.profile_dir if is_main else "") as trace_path:
        video = pipeline(
            reference_image=inputs["reference_image"], kps_images=inputs["kps_images"],
            audio_waveform=inputs["audio"], width=args.image_width, height=args.image_height,
            video_length=inputs["video_length"], num_inference_steps=args.num_inference_steps,
            sampler=args.sampler or "ddim", guidance_scale=args.guidance_scale,
            context_frames=args.context_frames, context_overlap=args.context_overlap,
            reference_attention_weight=args.reference_attention_weight,
            audio_attention_weight=args.audio_attention_weight,
            num_pad_audio_frames=args.num_pad_audio_frames, seed=args.seed,
            window_group=args.window_group, mode=mode, save_memory=args.save_gpu_memory,
            median_filter=not args.no_median_filter, output_yuv420=output_yuv420,
            output_uint8=not output_yuv420, progress_callback=progress)
    if trace_path:
        print(f"[vexpress] device trace written to {trace_path}")
    return video


def main(argv=None) -> None:
    from ..pipelines.media import save_video, save_video_yuv
    from ..utils.media_native import native_available

    args = parse_args(argv)
    start = time.time()
    pipeline = build_pipeline(args)
    inputs = prepare_inputs(args)
    # with the native encoder, the device converts to YUV420 and only the
    # planes come back (1.5 bytes per pixel); else uint8 RGB and cv2
    yuv = native_available()
    video = generate(pipeline, inputs, args, output_yuv420=yuv)
    if video is None:  # a sharded run's other ranks: rank 0 writes the video
        return
    if yuv:
        num_frames = video[0].shape[0]
        save_video_yuv(*video, args.audio_path, args.output_path, inputs["fps"])
    else:
        num_frames = video.shape[0]
        save_video(video, args.audio_path, args.output_path, inputs["fps"],
                   apply_median_filter=False)
    consumed = time.time() - start
    print(f"The generated video has been saved at {args.output_path}. "
          f"The generation time is {consumed:.1f} seconds. "
          f"The generation FPS is {num_frames / consumed:.2f}.")


if __name__ == "__main__":
    main()
