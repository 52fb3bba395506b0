"""V-Express training CLI of the PyTorch port. Counterpart of cli/train.py:

    python -m vexpress_torch.cli.train --config configs/stage_2.json

The config is a training YAML of the reference's format (configs/stage_*.yaml),
or the same as JSON; JSON needs no yaml parser. Runs on the CUDA device
unless `--device cpu` is given, and raises when there is none. Module
training (the stage's module_training flags, after stage_zero_init) or, with
a `lora:` section, LoRA adapters on the attention projections with the base
weights frozen. Train-state checkpoints every checkpointing_steps (resume
with `resume_from_checkpoint: latest`), per-module `.pth` exports (or the
adapter as `lora-<step>.pth`), JSONL and MLflow FileStore metrics, and with
`--profile_dir` a torch.profiler trace of steps 2-4.

Data-parallel over processes, one a device: `--coordinator_address
host:port --num_processes N --process_id r` on each process, or torchrun's
environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE) with
`--num_processes N`. train_bs is per process (the global batch is train_bs
x N), each process reads its shard of the dataset, the learning rate scales
with N where the config asks, gradients are averaged over the group, the
optimizer state is ZeRO-2-sharded (vexpress_torch.parallel), and rank 0
alone logs, writes the checkpoint and exports. A group that cannot form
raises.

`main` parses the flags and builds the dataset's batches; `train` does the
rest from a config dict and any iterator of the dataset's numpy batches.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Any, Dict, Iterator

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--max_steps_override", type=int, default=0)
    p.add_argument("--dtype", type=str, default="",
                   help="compute dtype {fp32, bf16, fp16}; default: the config's "
                        "solver.mixed_precision / weight_dtype (fp16 maps to bf16), else fp32")
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler trace of steps 2-4 into this directory")
    p.add_argument("--device", type=str, default="auto", choices=["auto", "cpu", "cuda"],
                   help="auto and cuda: the CUDA device (raises without one); cpu: the CPU")
    # multi-process launch (the accelerate --num_machines/--machine_rank analog)
    p.add_argument("--coordinator_address", type=str, default="",
                   help="host:port of process 0 for multi-process training (else "
                        "torchrun's environment)")
    p.add_argument("--num_processes", type=int, default=0)
    p.add_argument("--process_id", type=int, default=-1)
    return p.parse_args(argv)


def load_config(path: str) -> Dict[str, Any]:
    """A training config: JSON when the file parses as JSON, else YAML."""
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    try:
        import yaml
    except ImportError:
        raise SystemExit("pyyaml not available; provide a JSON config instead") from None
    return yaml.safe_load(text)


def resolve_device(name: str) -> torch.device:
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available (pass --device cpu "
                           "to train on the CPU)")
    return torch.device("cuda")


def distributed_mesh(args):
    """The data-parallel mesh: the process group the multi-process flags ask
    for (formed here, once; a group that cannot form raises), or one that
    the caller formed; None for a single process."""
    import torch.distributed as dist

    from ..parallel.mesh import create_mesh, initialize_distributed

    if not dist.is_initialized() and (args.coordinator_address or args.num_processes > 0):
        initialize_distributed(
            coordinator_address=args.coordinator_address or None,
            num_processes=args.num_processes or None,
            process_id=args.process_id if args.process_id >= 0 else None,
            backend="gloo" if args.device == "cpu" else None)
        print(f"[vexpress] distributed: process {dist.get_rank()}/{dist.get_world_size()} "
              f"({dist.get_backend()})")
    return create_mesh() if dist.is_initialized() else None


def parse_lora(cfg: Dict[str, Any]):
    """The optional `lora:` section as a LoraConfig (None without one)."""
    from ..train.lora import DEFAULT_TARGETS, LoraConfig

    raw = cfg.get("lora") or {}
    if not raw:
        return None
    unknown = set(raw) - {"rank", "alpha", "targets", "modules", "include"}
    if unknown:
        raise SystemExit(f"unknown lora config keys {sorted(unknown)}")
    rank = int(raw.get("rank", 8))
    return LoraConfig(rank=rank, alpha=float(raw.get("alpha", rank)),
                      targets=tuple(raw.get("targets", DEFAULT_TARGETS)),
                      modules=tuple(raw.get("modules", ("denoising_unet",))),
                      include=str(raw.get("include", "")))


def train_config(cfg: Dict[str, Any], world_size: int = 1):
    """The TrainConfig of a training config's dict, as cli/train.py routes it;
    the learning-rate scaling sees `world_size` processes."""
    from ..train import TrainConfig
    from ..train.config import effective_learning_rate

    data, solver, mt = cfg["data"], cfg["solver"], cfg["module_training"]
    return TrainConfig(
        train_stage=cfg["train_stage"], num_frames=data["num_frames"],
        train_denoising_unet=mt["denoising_unet"], train_reference_net=mt["reference_net"],
        train_v_kps_guider=mt["v_kps_guider"], train_audio_projection=mt["audio_projection"],
        train_motion_module=mt["motion_module"],
        learning_rate=effective_learning_rate(cfg, world_size),
        adam_beta1=float(solver["adam_beta1"]), adam_beta2=float(solver["adam_beta2"]),
        adam_weight_decay=float(solver["adam_weight_decay"]),
        adam_epsilon=float(solver["adam_epsilon"]), max_grad_norm=float(solver["max_grad_norm"]),
        gradient_accumulation_steps=int(solver.get("gradient_accumulation_steps", 1)),
        lr_scheduler=solver.get("lr_scheduler", "constant"),
        lr_warmup_steps=int(solver.get("lr_warmup_steps", 1)),
        max_train_steps=int(solver.get("max_train_steps", 40000)),
        reduce_optimizer_memory=bool(solver.get("use_8bit_adam", False)),
        prediction_type="v_prediction" if cfg.get("enable_zero_snr", True) else "epsilon",
        snr_gamma=float(cfg.get("snr_gamma", 5.0)), uncond_ratio=float(cfg.get("uncond_ratio", 0.1)),
        noise_offset=float(cfg.get("noise_offset", 0.05)),
        lip_loss_weight=float(data.get("lip_loss_weight", 1.0)),
        kps_drop_rate=float(data.get("kps_drop_rate", 0.0)),
        reference_drop_rate=float(data.get("reference_drop_rate", 0.0)))


def _optimizer_line(optimizer, lora_cfg, tcfg) -> str:
    """What optimizer state the run keeps (the reference ships use_8bit_adam:
    True in every stage config, training_configs/*.yaml:42; a routing fault
    here would silently train with 4x the state memory)."""
    from ..train.adam8bit import Adam8bit

    if lora_cfg is None and tcfg.reduce_optimizer_memory in (True, "8bit"):
        if not isinstance(optimizer.inner, Adam8bit):
            raise SystemExit("use_8bit_adam is set but the 8-bit Adam state did not materialize")
        min_quant = optimizer.inner.defaults["min_quant_size"]
        # mu and nu codes of each quantized tensor; tensors under the
        # threshold keep fp32 momenta (bnb parity)
        n_int8 = 2 * sum(1 for p in optimizer.params if p.numel() >= min_quant)
        return f"[vexpress] optimizer: blockwise int8 Adam ({n_int8} int8 state tensors)"
    return "[vexpress] optimizer: fp32 AdamW"


def train(cfg: Dict[str, Any], args: argparse.Namespace,
          batches: Iterator[Dict[str, np.ndarray]]) -> Dict[str, Any]:
    """The training run of `cfg` on `args.device`, drawing numpy batches
    from `batches` (this process's shard when data-parallel). Returns the
    pipeline, the final TrainState, the LoRA tree (None for module
    training), the losses (the global batch's) and each step's seconds."""
    from ..diffusion.ddim import DDIMScheduler
    from ..io import apply_model_overrides, default_pipeline_models, load_pipeline
    from ..io.checkpoints import (export_modules, latest_checkpoint, restore_train_state,
                                  save_train_state)
    from ..io.torch_export import save_torch_checkpoint
    from ..parallel.mesh import sync_params
    from ..train import TrainState, build_train_step, make_optimizer, stage_zero_init
    from ..train.config import check_config_keys, resolve_dtype, scheduler_kwargs, validate_config
    from ..train.lora import (build_lora_train_step, init_lora, lora_to_torch_state_dict,
                              make_lora_optimizer)
    from ..utils.observability import MetricsLogger, StepTimer, device_trace

    validate_config(cfg)
    for w in check_config_keys(cfg):
        print(f"[vexpress] WARNING: {w}", file=sys.stderr)
    data, solver, mt = cfg["data"], cfg["solver"], cfg["module_training"]
    device = resolve_device(args.device)
    mesh = distributed_mesh(args)
    world, is_main = (1, True) if mesh is None else (mesh.size, mesh.rank == 0)

    dtype_name = resolve_dtype(cfg, args.dtype)
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    if (args.dtype or solver.get("mixed_precision") or cfg.get("weight_dtype")) in ("fp16",):
        print("[vexpress] fp16 requested -> using bf16 (same exponent range as fp32, no loss "
              "scaler)")
    models = default_pipeline_models(dtype=dtype)
    if cfg.get("model_overrides"):
        models = apply_model_overrides(models, cfg["model_overrides"])
    if solver.get("denoising_unet_gradient_checkpointing", False):
        # reference train.py:448-451: per-block activation recompute
        import dataclasses

        models = dataclasses.replace(models, unet_config=dataclasses.replace(
            models.unet_config, gradient_checkpointing=True))
    pipe = load_pipeline(
        models=models, base_model_path=cfg.get("base_model_path") or None,
        vae_path=cfg.get("vae_model_path") or None,
        audio_encoder_path=cfg.get("audio_encoder_path") or None,
        reference_net_path=cfg.get("reference_net_path") or None,
        denoising_unet_path=cfg.get("denoising_unet_path") or None,
        motion_module_path=cfg.get("motion_module_path") or None,
        v_kps_guider_path=cfg.get("v_kps_guider_path") or None,
        audio_projection_path=cfg.get("audio_projection_path") or None,
        denoising_unet_state_dict_type=cfg.get("denoising_unet_state_dict_type", "new_attn"),
        device=device)
    tcfg = train_config(cfg, world)
    comps = pipe.components()
    if mesh is not None:
        sync_params(comps, mesh)  # every rank starts from rank 0's weights
    seed = int(cfg.get("seed", 0))

    # optional LoRA fine-tuning (train/lora.py): adapters on the attention
    # projections replace the module_training trainability; base weights
    # stay frozen and are not zero-initialised (adapters fine-tune the
    # loaded weights as they are)
    lora_cfg, lora = parse_lora(cfg), None
    sched = DDIMScheduler(**scheduler_kwargs(cfg, cfg.get("enable_zero_snr", True)))
    if lora_cfg is not None:
        lora = init_lora(comps, lora_cfg, seed=seed)
        optimizer = make_lora_optimizer(lora, tcfg, mesh)
        step_fn, _ = build_lora_train_step(pipe, tcfg, optimizer, lora_cfg, lora, scheduler=sched)
        n_pairs = sum(len(sub) for sub in lora.values())
        print(f"[vexpress] LoRA fine-tuning: {n_pairs} adapted projections, rank "
              f"{lora_cfg.rank}, alpha {lora_cfg.alpha}, modules {list(lora_cfg.modules)} "
              f"(module_training flags ignored; base weights frozen)")
    else:
        # stage-start zero-init of the audio/motion output projections
        # (reference train.py:363-390; skipped for stage_2_resume)
        stage_zero_init(comps, cfg["train_stage"])
        optimizer, _ = make_optimizer(comps, tcfg, mesh)
        step_fn, _ = build_train_step(pipe, tcfg, optimizer, scheduler=sched)
    print(_optimizer_line(optimizer, lora_cfg, tcfg))
    state = TrainState(comps, optimizer)

    out_dir = cfg.get("output_dir", "./exp_output")
    os.makedirs(out_dir, exist_ok=True)
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    resume = cfg.get("resume_from_checkpoint", "")
    if resume == "latest":
        resume = latest_checkpoint(ckpt_dir) or ""
    if resume:
        restore_train_state(resume, state)
        print(f"[vexpress] resumed from {resume} at step {state.step}")

    max_steps = args.max_steps_override or int(solver["max_train_steps"])
    ckpt_every = int(cfg.get("checkpointing_steps", 5000))
    start_step = state.step
    # short (smoke) runs log every step
    log_every = 10 if max_steps - start_step > 20 else 1
    generator = torch.Generator().manual_seed(seed)  # the step's draws (sample_draws)
    print(f"[vexpress] training {cfg['train_stage']} on mesh {{'dp': {world}}} ({device}): "
          f"bs={data['train_bs']}, frames={data['num_frames']}, max_steps={max_steps}")
    # JSONL + MLflow FileStore export (the reference logs train_loss to MLflow,
    # train.py:657; browse with `mlflow ui --backend-store-uri <out>/mlruns`);
    # rank 0's only, as the accelerate main-process convention has it
    mlog = MetricsLogger(out_dir, mlflow_dir=os.path.join(out_dir, "mlruns"),
                         run_name=cfg.get("train_stage", "train")) if is_main else None
    if mlog is not None:
        mlog.log_param("config", os.path.abspath(args.config))
    timer = StepTimer()
    trace = contextlib.ExitStack()
    t0 = time.time()
    losses, window, step_s = [], [], []
    for step_i in range(start_step, max_steps):
        if args.profile_dir and is_main and step_i == start_step + 1:
            trace.enter_context(device_trace(args.profile_dir))
        batch = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in next(batches).items()}
        timer.data_done()
        t_step = time.perf_counter()
        state, metrics = step_fn(state, batch, generator)
        loss = float(metrics["loss"])  # waits for the step
        step_s.append(time.perf_counter() - t_step)
        losses.append(loss)
        window.append(loss)
        timer.step_done()
        if args.profile_dir and is_main and step_i == start_step + 3:
            trace.close()
            print(f"[vexpress] device trace (steps {start_step + 2}-{start_step + 4}) written "
                  f"to {args.profile_dir}")
        if (step_i + 1) % log_every == 0:
            dt = time.time() - t0
            report = timer.report()
            if is_main:
                mlog.log(step_i + 1, {"train_loss": float(np.mean(window)),
                                      "it_per_s": log_every / dt, **report})
                print(f"[vexpress] step {step_i + 1}/{max_steps} loss {np.mean(window):.4f} "
                      f"({log_every / dt:.2f} it/s)", flush=True)
            window, t0 = [], time.time()
        if (step_i + 1) % ckpt_every == 0 or step_i + 1 == max_steps:
            path = save_train_state(ckpt_dir, step_i + 1, state)  # every rank: collective
            if not is_main:
                continue
            if lora is not None:
                # LoRA runs export the adapter only (peft layout; merged at
                # load time with --lora_path of the inference CLI)
                save_torch_checkpoint(lora_to_torch_state_dict(lora, lora_cfg),
                                      os.path.join(out_dir, f"lora-{step_i + 1}.pth"))
            elif cfg.get("save_all", True):
                export_modules(comps, out_dir, step_i + 1)
            else:
                # save_all=False (reference train.py:677-725): only the modules
                # this stage trains; the unet rides along whenever any of its
                # resident submodules train
                trained = {"denoising_unet": mt["denoising_unet"] or mt["motion_module"]
                           or mt["audio_projection"], "reference_net": mt["reference_net"],
                           "v_kps_guider": mt["v_kps_guider"],
                           "audio_projection": mt["audio_projection"]}
                export_modules({k: v for k, v in comps.items() if trained.get(k, False)},
                               out_dir, step_i + 1)
            print(f"[vexpress] checkpoint saved: {path}")
    trace.close()
    if mlog is not None:
        mlog.close()  # finalizes the MLflow run (status FINISHED + end_time)
    return dict(pipeline=pipe, state=state, lora=lora, lora_cfg=lora_cfg, losses=losses,
                step_s=step_s, out_dir=out_dir, ckpt_dir=ckpt_dir)


def main(argv=None) -> None:
    from ..train.dataset import TalkingFaceVideoDataset

    args = parse_args(argv)
    cfg = load_config(args.config)
    data = cfg["data"]
    mesh = distributed_mesh(args)
    dataset = TalkingFaceVideoDataset(
        meta_paths=data["meta_paths"], image_size=(data["train_height"], data["train_width"]),
        flip_rate=data["flip_rate"], sample_rate=data["sample_rate"],
        num_frames=data["num_frames"], reference_margin=data["reference_margin"],
        num_padding_audio_frames=data["num_padding_audio_frames"], seed=cfg.get("seed", 0))
    batches = dataset.batches(data["train_bs"])  # this rank's shard of each epoch
    if mesh is not None:
        print(f"[vexpress] dataset shard {mesh.rank}/{mesh.size}, global batch "
              f"{data['train_bs'] * mesh.size}")
    try:
        train(cfg, args, batches)
    finally:
        batches.close()  # stops the loader's threads


if __name__ == "__main__":
    main()
