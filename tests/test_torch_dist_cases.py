"""Shared cases of the tile-grid tests (``tests/test_torch_dist.py``,
``tests/test_torch_dist_serve.py``); no tests of its own.  The JAX
package's side of each runs in a subprocess with forced host devices, the
port's in process on ``device="cpu"``, on the same numpy inputs.

An engine case is (matrix, mesh, mode, precond, layout, reorder, balance);
a solve case an engine name and ``SolveSpec`` fields."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]

# builder name in both packages' data.matrices, and its arguments
MATS = {
    "lap16": ("laplacian_2d", (16,)),
    "band300": ("banded_spd", (300, 3, 0)),
    "rspd192": ("random_spd", (192, 0.03, 1)),
    "lap2d_32": ("laplacian_2d", (32,)),
    "banded_1k": ("banded_spd", (1000,)),
}

# shape, axes, row_axes, col_axes
MESHES = {
    "2x2": ((2, 2), ("data", "model"), ("data",), ("model",)),
    "4x1": ((4, 1), ("data", "model"), ("data",), ("model",)),
    "2x4": ((2, 4), ("data", "model"), ("data",), ("model",)),
    "4x2": ((4, 2), ("data", "model"), ("data",), ("model",)),
    "mp": ((2, 2, 2), ("pod", "data", "model"), ("pod", "data"), ("model",)),
}


def eng_case(mat, mesh, mode="2d", precond="jacobi", layout="auto",
             reorder="none", balance="nnz"):
    return dict(mat=mat, mesh=mesh, mode=mode, precond=precond, layout=layout,
                reorder=reorder, balance=balance)


def matrix(pkg, name: str):
    """``MATS[name]`` built by ``pkg``'s ``data.matrices``."""
    fn, args = MATS[name]
    return getattr(pkg, fn)(*args)


def rhs(n: int, k: int | None = None, seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n if k is None else (k, n))


def run_jax(script: str, cases: dict, out: Path, timeout: int = 600) -> dict:
    """Run the JAX half ``script`` in a subprocess with 8 forced host
    devices and x64 (``tests/test_engine_dist.py``'s environment, with
    XLA's CPU threads cut to one);
    ``cases`` goes in as JSON, the script writes ``out`` (an .npz with a
    ``json`` entry) and this returns its arrays and its JSON."""
    env = dict(os.environ)
    # one thread for each host device's work: the subprocess shares the
    # machine with the other test workers
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1")
    env["OMP_NUM_THREADS"] = "1"
    env["JAX_ENABLE_X64"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([str(REPO / "src"), str(REPO),
                                         str(REPO / "tests")])
    cfile = out.with_suffix(".json")
    cfile.write_text(json.dumps(cases))
    r = subprocess.run([sys.executable, "-c", script, str(cfile), str(out)],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=timeout)
    assert r.returncode == 0, f"stdout={r.stdout[-2000:]}\nstderr={r.stderr[-4000:]}"
    z = np.load(out, allow_pickle=False)
    arrays = {k: z[k] for k in z.files if k != "json"}
    return arrays, json.loads(str(z["json"]))
