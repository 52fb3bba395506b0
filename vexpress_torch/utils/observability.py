"""Training telemetry and device traces. Counterpart of
vexpress_tpu/utils/observability.py.

The reference has only a tqdm bar and MLflow train_loss logging (SURVEY.md
§5.5, train.py:657). Here: a JSONL metrics logger with an MLflow
FileStore-layout export written by hand (no mlflow package), a step timer,
and `device_trace`, torch.profiler where the JAX package has jax.profiler.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterator, Optional

import torch


class MetricsLogger:
    """Append-only JSONL metrics: {"step": i, "time": t, **metrics}.

    With `mlflow_dir` set, ALSO writes an MLflow FileStore-layout `mlruns/`
    tree (the reference logs train_loss per global step to MLflow,
    train.py:230, 515-522, 657) — readable by `mlflow ui
    --backend-store-uri <dir>` on any machine with mlflow installed, with no
    mlflow dependency here."""

    def __init__(self, log_dir: str, filename: str = "metrics.jsonl",
                 mlflow_dir: Optional[str] = None, run_name: str = "train"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._fh = open(self.path, "a", buffering=1)
        self._t0 = time.time()
        self._mlflow = MlflowFileStore(mlflow_dir, run_name) if mlflow_dir else None

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._fh.write(json.dumps(rec) + "\n")
        if self._mlflow is not None:
            self._mlflow.log_metrics(int(step), rec)

    def log_param(self, key: str, value) -> None:
        """Record a run parameter (no-op without mlflow_dir)."""
        if self._mlflow is not None:
            self._mlflow.log_param(key, value)

    def close(self) -> None:
        self._fh.close()
        if self._mlflow is not None:
            self._mlflow.finish()


class MlflowFileStore:
    """Minimal MLflow FileStore writer (format: mlruns/<exp>/<run>/metrics/
    <key> with '<ts_ms> <value> <step>' lines + meta.yaml files). Covers the
    subset `mlflow ui` needs to browse runs and plot metrics."""

    def __init__(self, root: str, run_name: str = "train", experiment: str = "0"):
        import uuid

        self.exp_dir = os.path.join(root, experiment)
        self.run_id = uuid.uuid4().hex
        self.run_dir = os.path.join(self.exp_dir, self.run_id)
        self.metrics_dir = os.path.join(self.run_dir, "metrics")
        os.makedirs(self.metrics_dir, exist_ok=True)
        os.makedirs(os.path.join(self.run_dir, "params"), exist_ok=True)
        os.makedirs(os.path.join(self.run_dir, "tags"), exist_ok=True)
        os.makedirs(os.path.join(self.run_dir, "artifacts"), exist_ok=True)
        now_ms = int(time.time() * 1000)
        exp_meta = os.path.join(self.exp_dir, "meta.yaml")
        if not os.path.exists(exp_meta):
            with open(exp_meta, "w") as f:
                f.write(
                    f"artifact_location: file://{os.path.abspath(self.exp_dir)}\n"
                    f"creation_time: {now_ms}\n"
                    f"experiment_id: '{experiment}'\n"
                    f"last_update_time: {now_ms}\n"
                    "lifecycle_stage: active\n"
                    "name: Default\n")
        self._experiment = experiment
        self._run_name = run_name
        self._start_ms = now_ms
        self._write_run_meta(status=1, end_ms=None)  # 1 = RUNNING

    def _write_run_meta(self, status: int, end_ms) -> None:
        with open(os.path.join(self.run_dir, "meta.yaml"), "w") as f:
            f.write(
                f"artifact_uri: file://{os.path.abspath(self.run_dir)}/artifacts\n"
                f"end_time: {'null' if end_ms is None else end_ms}\n"
                "entry_point_name: ''\n"
                f"experiment_id: '{self._experiment}'\n"
                "lifecycle_stage: active\n"
                f"run_id: {self.run_id}\n"
                f"run_name: {self._run_name}\n"
                f"run_uuid: {self.run_id}\n"
                "source_name: ''\n"
                "source_type: 4\n"
                "source_version: ''\n"
                f"start_time: {self._start_ms}\n"
                f"status: {status}\n"
                "user_id: ''\n")

    def finish(self) -> None:
        """Mark the run FINISHED (status 3) with an end_time — without this
        `mlflow ui` shows the run as eternally Running."""
        self._write_run_meta(status=3, end_ms=int(time.time() * 1000))

    def log_metrics(self, step: int, metrics: Dict[str, float]) -> None:
        ts = int(time.time() * 1000)
        for key, value in metrics.items():
            if key == "step":
                continue
            with open(os.path.join(self.metrics_dir, key), "a") as f:
                f.write(f"{ts} {float(value)} {step}\n")

    def log_param(self, key: str, value) -> None:
        with open(os.path.join(self.run_dir, "params", key), "w") as f:
            f.write(str(value))


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[Optional[str]]:
    """torch.profiler trace of the enclosed work: host operations and, where a
    CUDA device is present, its kernels, written on exit as one Chrome trace
    file (`*.pt.trace.json`, for Perfetto or chrome://tracing) into `log_dir`.
    Yields that file's path; with an empty `log_dir` it traces nothing and
    yields None."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"vexpress_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}"
                                 ".pt.trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


class StepTimer:
    """Rolling it/s and data-wait share, like the reference's `td` postfix
    (train.py:567-569, 660-666)."""

    def __init__(self):
        self.t_last = time.time()
        self.data_s = 0.0
        self.step_s = 0.0

    def data_done(self):
        now = time.time()
        self.data_s += now - self.t_last
        self.t_last = now

    def step_done(self):
        now = time.time()
        self.step_s += now - self.t_last
        self.t_last = now

    def report(self) -> Dict[str, float]:
        total = self.data_s + self.step_s
        out = {
            "data_s": round(self.data_s, 3),
            "step_s": round(self.step_s, 3),
            "data_frac": round(self.data_s / total, 3) if total else 0.0,
        }
        self.data_s = self.step_s = 0.0
        return out
