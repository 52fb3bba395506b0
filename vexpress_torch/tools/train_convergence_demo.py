"""Training convergence on one fixed batch: the port of
tools/train_convergence_demo.py.

For stages 2 and 3 (`--stages`), `build_train_step` on the tiny geometry
(tools.common.TINY_OVERRIDES) overfits one seeded batch (2 clips of 2 frames
at 64x64) for `--steps` steps at `--lr`, with the draws of every step from
the same generator state (a fixed objective) and no unconditional steps.
Writes, under `--out` (by default chiprun_out/convergence, which git
ignores): each stage's losses as metrics JSONL, an MLflow FileStore run
(`mlflow ui --backend-store-uri <out>/mlruns_convergence`), and the curves
with their start and end means as convergence_curves.json.

    python -m vexpress_torch.tools.train_convergence_demo --device cpu [--steps 200]
    python -m vexpress_torch.tools.train_convergence_demo                # on the card
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import numpy as np
import torch

from ..train import TrainConfig, TrainState, build_train_step, make_optimizer, stage_zero_init
from ..train.recipe import synthetic_train_batch
from ..utils.observability import MetricsLogger
from .common import card_line, random_pipeline, tool_device

DEFAULT_OUT = os.path.join("chiprun_out", "convergence")
STAGES = ("stage_2", "stage_3")


def run_stage(stage: str, steps: int, lr: float, device: torch.device) -> List[float]:
    pipe = random_pipeline(tiny=True, device=device, dtype=torch.float32)
    cfg = TrainConfig.stage(stage, learning_rate=lr, num_frames=2, uncond_ratio=0.0)
    models = stage_zero_init(pipe.components(), stage)
    optimizer, _ = make_optimizer(models, cfg)
    step_fn, _ = build_train_step(pipe, cfg, optimizer)
    audio_dim = pipe.m.audio_projection_kwargs["embedding_dim"]
    batch = synthetic_train_batch(64, 2, audio_dim, seed=0, device=device, batch=2)
    state, losses = TrainState(models, optimizer), []
    for i in range(steps):
        gen = torch.Generator(device=device).manual_seed(7)  # the same draws every step
        state, metrics = step_fn(state, batch, gen)
        losses.append(float(metrics["loss"]))
        if i % 20 == 0:
            print(f"[{stage}] step {i}: loss {losses[-1]:.5f}", flush=True)
    return losses


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (the card, the default) or cpu")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--out", type=str, default=DEFAULT_OUT)
    p.add_argument("--stages", nargs="+", default=STAGES, choices=STAGES)
    return p.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    device = tool_device("train_convergence_demo", args.device)
    print(card_line(device), flush=True)
    os.makedirs(args.out, exist_ok=True)
    curves = {}
    for stage in args.stages:
        logger = MetricsLogger(args.out, filename=f"convergence_{stage}.jsonl",
                               mlflow_dir=os.path.join(args.out, "mlruns_convergence"),
                               run_name=f"overfit_{stage}")
        logger.log_param("stage", stage)
        logger.log_param("steps", args.steps)
        logger.log_param("learning_rate", args.lr)
        losses = run_stage(stage, args.steps, args.lr, device)
        for i, v in enumerate(losses):
            logger.log(i, {"train_loss": v})
        logger.close()
        first, last = float(np.mean(losses[:3])), float(np.mean(losses[-5:]))
        curves[stage] = {"losses": losses, "initial_mean3": first, "final_mean5": last,
                         "collapse_ratio": last / first}
        print(f"[{stage}] {first:.6f} -> {last:.6f} (x{last / first:.4f})", flush=True)
    path = os.path.join(args.out, "convergence_curves.json")
    rec = {"steps": args.steps, "lr": args.lr, "device": device.type,
           "recipe": "overfit one fixed batch, build_train_step, the same draws every step, "
                     "tiny config", "curves": curves}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {path}", flush=True)
    return rec


if __name__ == "__main__":
    main()
