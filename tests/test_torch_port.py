"""Port hygiene: ``nuzero_tpu_torch`` imports without JAX (the CUDA wrapper
included, without nvcc), and ``chip_smoke.py`` refuses to run without a
CUDA card instead of falling back to the CPU."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "nuzero_tpu_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "nuzero_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import torch
import nuzero_tpu_torch
names = [m.name for m in pkgutil.walk_packages(nuzero_tpu_torch.__path__, "nuzero_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert "nuzero_tpu_torch.ops.cuda.hexconv_kernel" in names, names
from nuzero_tpu_torch.ops import hexconv
from nuzero_tpu_torch.ops.cuda import hexconv_kernel
x = torch.randn(2, 5, 5, 4)
w = torch.randn(7, 4, 3)
hexconv.hex_conv(x, w)
assert sum(hexconv_kernel.launch_count.values()) == 0
print("imported", len(names))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_imports_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("imported")


def test_port_sources_never_name_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|nuzero_tpu)\b(?!_torch)", re.M)
    offenders = [
        str(p.relative_to(REPO))
        for p in [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]
        if pattern.search(p.read_text())
    ]
    assert offenders == []


def _run_smoke(cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=_env(),
        capture_output=True, text=True, timeout=120,
    )


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
