"""The PyTorch port stands alone: importing vexpress_torch (every submodule,
the training modules and the CLI included) or chip_smoke.py loads neither JAX
nor vexpress_tpu (nor flax or optax), nor cv2 or yaml, which the card's
machine lacks; no source file of the port names JAX in an import, entry
points refuse to fall back to the CPU silently, and chip_smoke.py prints no
result without a CUDA device or without the package beside it."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
NO_CUDA = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
PORT_SOURCES = sorted(str(f.relative_to(REPO)) for f in (REPO / "vexpress_torch").rglob("*.py"))
PORT_SOURCES.append("chip_smoke.py")
FORBIDDEN_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|vexpress_tpu|flax|optax)\b", re.M)


def _run(code: str, cwd=REPO, env=NO_CUDA):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_port_imports_no_jax():
    code = """
import importlib, pkgutil, sys
import vexpress_torch
names = [m.name for m in pkgutil.walk_packages(vexpress_torch.__path__, "vexpress_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "optax", "cv2", "yaml")
             or m.startswith(("jax.", "optax.", "vexpress_tpu", "flax")))
assert not bad, bad
assert len(names) >= 20, names
want = {"vexpress_torch.train", "vexpress_torch.train.config", "vexpress_torch.train.adam8bit",
        "vexpress_torch.train.train_step", "vexpress_torch.cli", "vexpress_torch.cli.infer",
        "vexpress_torch.io.torch_import", "vexpress_torch.io.inference_config",
        "vexpress_torch.ops.flash_lite", "vexpress_torch.diffusion.dpm_solver",
        "vexpress_torch.pipelines.kps", "vexpress_torch.utils.media_native",
        "vexpress_torch.ops.flash_variants", "vexpress_torch.ops.splash",
        "vexpress_torch.utils.observability", "vexpress_torch.tools.bench_attn_variants",
        "vexpress_torch.tools.bench_motion_variants", "vexpress_torch.tools.ptxas_report",
        "vexpress_torch.train.lora", "vexpress_torch.train.dataset", "vexpress_torch.io.checkpoints",
        "vexpress_torch.cli.train", "vexpress_torch.cli.prepare_dataset",
        "vexpress_torch.cli.visualize_dataset",
        "vexpress_torch.train.recipe", "vexpress_torch.train.step_split",
        "vexpress_torch.tools.common", "vexpress_torch.tools.unet_step_flops",
        "vexpress_torch.tools.profile_train_step", "vexpress_torch.tools.profile_step",
        "vexpress_torch.tools.bench_window_step", "vexpress_torch.tools.bench_decode",
        "vexpress_torch.tools.bench_savemem", "vexpress_torch.tools.bench_savemem_overhead",
        "vexpress_torch.tools.bench_long_sampler", "vexpress_torch.tools.psnr",
        "vexpress_torch.tools.microbench_ops", "vexpress_torch.tools.bench_blocks",
        "vexpress_torch.tools.bench_perf_table", "vexpress_torch.tools.train_convergence_demo"}
assert want <= set(names), sorted(want - set(names))
print("OK", len(names))
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_pipeline_without_device_raises_when_cuda_is_absent():
    code = """
import torch
from vexpress_torch.pipelines import PipelineModels, VExpressPipeline
assert not torch.cuda.is_available()
try:
    VExpressPipeline(PipelineModels())
except RuntimeError as e:
    assert "device='cpu'" in str(e), e
    print("RAISED")
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "RAISED" in proc.stdout


def test_chip_smoke_without_cuda_prints_no_result():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=NO_CUDA,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_prints_no_result(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("path", PORT_SOURCES)
def test_port_source_imports_no_jax(path):
    """No source of the port (nor chip_smoke.py) imports JAX, flax, optax or
    the JAX package, even lazily inside a function."""
    found = FORBIDDEN_IMPORT.findall((REPO / path).read_text())
    assert not found, (path, found)
