"""The port's import boundary and device rules.

pilosa_tpu_torch imports torch and numpy, never jax and nothing of
pilosa_tpu; its entry points run on cuda unless asked for the CPU, and
raise without a GPU instead of falling back.
"""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.storage import Holder

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "pilosa_tpu_torch"


def _module_names() -> list[str]:
    out = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        out.append(".".join(parts))
    return out


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "pilosa_tpu")


def test_importing_every_module_adds_no_jax_or_reference():
    code = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {_module_names()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    added = json.loads(res.stdout.strip().splitlines()[-1])
    assert "pilosa_tpu_torch.kernels" in added
    assert [m for m in added if _forbidden(m)] == []


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) +
                         [REPO / "chip_smoke.py"], ids=lambda p: p.name)
def test_sources_import_no_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
    assert bad == []


def test_boundary_covers_the_integrity_subpackages():
    """The rules above walk every module, the subpackages of the
    integrity plane (the scrubber and the disk fault plane) included."""
    names = _module_names()
    for name in ("pilosa_tpu_torch.parallel.scrub",
                 "pilosa_tpu_torch.parallel.pacer",
                 "pilosa_tpu_torch.testing.faults",
                 "pilosa_tpu_torch.roaring.kernels"):
        assert name in names
    sources = {p.relative_to(PKG).parts[0] for p in PKG.rglob("*.py")}
    assert {"parallel", "testing"} <= sources


def test_boundary_covers_the_serving_plane():
    """The rules above walk the multi-process serving modules too; the
    ones a serving worker imports load neither torch nor numpy."""
    names = _module_names()
    worker_side = ("pilosa_tpu_torch.serving.shmring",
                   "pilosa_tpu_torch.serving.mpserve",
                   "pilosa_tpu_torch.serving.worker",
                   "pilosa_tpu_torch.parallel.connpool",
                   "pilosa_tpu_torch.testing.faults")
    for name in worker_side + ("pilosa_tpu_torch.testing.chaos",):
        assert name in names
    code = (
        "import importlib, json, sys\n"
        f"for m in {list(worker_side)!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('torch', 'numpy'))))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_entry_points_need_cuda_unless_asked_for_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_mod.resolve(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        Holder(str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Server(str(tmp_path / "b"), port=0)
    holder = Holder(str(tmp_path / "c"), device="cpu").open()
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            Executor(holder)
        assert Executor(holder, device="cpu").device.type == "cpu"
    finally:
        holder.close()
    with pytest.raises(ValueError):
        device_mod.resolve("mps")


def test_cli_server_without_gpu_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the server would start")
    res = subprocess.run(
        [sys.executable, "-m", "pilosa_tpu_torch", "server", "-d",
         str(tmp_path / "d"), "--port", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "CUDA" in res.stderr


def test_chip_smoke_refuses_without_gpu_or_repo(tmp_path):
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", lone / "chip_smoke.py")
    runs = [subprocess.run([sys.executable, "chip_smoke.py"], cwd=lone,
                           capture_output=True, text=True, timeout=120)]
    if not torch.cuda.is_available():
        runs.append(subprocess.run([sys.executable, "chip_smoke.py"],
                                   cwd=REPO, capture_output=True, text=True,
                                   timeout=120))
    for res in runs:
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
