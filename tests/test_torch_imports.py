"""Import rules and device defaults of the PyTorch port.

``src/repro_torch/`` and ``chip_smoke.py`` import neither ``jax`` nor the
``repro`` package (checked in a subprocess where both are unimportable,
and by an AST scan), read no wall clock, and their entry points default to
the CUDA device -- raising, not falling back, where there is no card.
"""

import ast
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import formats
from repro_torch.core.engine import AzulEngine
from repro_torch.core.stencil import lap2d_stencil
from repro_torch.data.matrices import laplacian_2d
from repro_torch.device import resolve_device
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import solve as solve_cli
from repro_torch.serve import SolveService

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]

_IMPORT_ALL = r"""
import importlib, importlib.abc, pkgutil, sys
import torch
torch.set_num_threads(1)

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print(" ".join(names), len(names))
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.split()[-1]) >= 30      # every module was imported
    for name in ("repro_torch.core.stencil", "repro_torch.kernels.bcsr_spmm",
                 "repro_torch.kernels.autotune", "repro_torch.convert",
                 "repro_torch.core.partition", "repro_torch.obs.clock",
                 "repro_torch.obs.metrics", "repro_torch.obs.trace",
                 "repro_torch.obs.export", "repro_torch.ft",
                 "repro_torch.ft.straggler", "repro_torch.serve",
                 "repro_torch.serve.service", "repro_torch.serve.loadgen",
                 "repro_torch.serve.solve_server",
                 "repro_torch.launch.serve"):
        assert name in r.stdout.split(), name


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", node.lineno


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_or_repro_import_in_source(path):
    for mod, line in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}:{line} imports {mod}"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_wall_clock_reads(path):
    """Timing goes through repro_torch.obs.clock (time.perf_counter)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr == "time" and \
                isinstance(node.value, ast.Name) and node.value.id == "time":
            pytest.fail(f"{path}:{node.lineno} calls time.time()")


def test_entry_points_default_to_cuda():
    for fn in (AzulEngine.__init__, AzulEngine.from_state,
               convert.engine_state_from_numpy, convert.format_from_numpy,
               formats.ell_from_csr, formats.sell_from_csr,
               formats.hyb_from_csr, formats.bcsr_from_csr, resolve_device,
               SolveService.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    m = laplacian_2d(4)
    if torch.cuda.is_available():
        assert AzulEngine(m).device.type == "cuda"
        return
    # no card: the CUDA default raises instead of falling back to the CPU
    with pytest.raises(RuntimeError, match="cuda"):
        AzulEngine(m)
    with pytest.raises(RuntimeError, match="cuda"):
        AzulEngine(lap2d_stencil(4))
    for build in (formats.ell_from_csr, formats.sell_from_csr,
                  formats.hyb_from_csr, formats.bcsr_from_csr):
        with pytest.raises(RuntimeError, match="cuda"):
            build(m)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.engine_state_from_numpy(np.zeros((8, 1), np.int32),
                                        np.zeros((8, 1)), np.ones(8), 8, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        solve_cli.main(["--matrix", "lap2d_32"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve_cli.main(["--solver", "--matrix", "lap2d_32"])
    with pytest.raises(RuntimeError, match="cuda"):
        SolveService()
    assert AzulEngine(m, device="cpu").device.type == "cpu"
