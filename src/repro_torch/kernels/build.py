"""Build and load the port's CUDA kernels (nvcc + ctypes).

The sources under ``kernels/csrc`` compile with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into one shared library with a
plain C interface, which :func:`library` loads with ``ctypes``.  Each
``.cu`` file compiles in its own ``nvcc`` process, all started together,
and one more ``nvcc`` links the objects.

The build happens on first use, into ``build/repro_torch/<key>/`` at the
repository root (``.gitignore`` lists ``build/``).  ``<key>`` hashes the
sources and the flags, so an edited source rebuilds and an unchanged
checkout reuses its library.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ["CSRC", "BUILD_ROOT", "NVCC_FLAGS", "library", "build_key",
           "check", "entry", "require_cuda", "device_scalar", "device_lanes",
           "stream_handle"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64

# C signature of every exported function: (argtypes) -> int (cudaError_t)
_SIGNATURES = {
    "repro_ell_spmv": (_P, _P, _P, _P, _I64, _I32, _I32, _P),
    "repro_ell_spmv_pfold_dot": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I64, _I32, _I32, _I64, _P),
    "repro_cg_update": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I64, _I64, _P),
    "repro_ell_spmm": (_P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32, _P),
    "repro_ell_spmm_pfold_dot": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I64, _I32, _I32, _I64, _I32, _P),
    "repro_cg_update_batched": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I64, _I64, _I32, _P),
    "repro_sptrsv_solve_dot": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I32, _I32, _I32, _P),
    "repro_sptrsv_coresident": (),     # -> blocks, or minus the CUDA error
    "repro_bcsr_spmm": (_P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32,
                        _I64, _I64, _I64, _I64, _I64, _P),
}

_LIB = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build_key() -> str:
    """Hash of every source file and the compiler flags."""
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _compile(out_dir: Path) -> Path:
    """Compile every .cu in parallel, link one library; returns its path.
    The compiler's output (``-Xptxas -v``: registers, spills) goes to
    ``build.log`` beside the library."""
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=out_dir.parent))
    log = []
    try:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed) + "\n"
                               + "\n".join(log))
        lib = tmp / LIB_NAME
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", str(lib), *(str(obj) for _, obj, _ in procs)]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        log.append(f"== link\n{res.stdout}")
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + "\n".join(log))
        (tmp / "build.log").write_text("\n".join(log))
        if out_dir.exists():            # a concurrent build got there first
            shutil.rmtree(tmp)
        else:
            os.replace(tmp, out_dir)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return out_dir / LIB_NAME


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this checkout has none."""
    global _LIB
    if _LIB is not None:
        return _LIB
    out_dir = BUILD_ROOT / build_key()
    path = out_dir / LIB_NAME
    if not path.exists():
        out_dir.parent.mkdir(parents=True, exist_ok=True)
        path = _compile(out_dir)
    lib = ctypes.CDLL(str(path))
    for base, argtypes in _SIGNATURES.items():
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, base + suffix)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}


def entry(base: str, dtype: torch.dtype):
    """The C entry point ``base`` for a float32/float64 ``dtype``."""
    if dtype not in _SUFFIX:
        raise TypeError(f"{base}: dtype must be float32 or float64, got {dtype}")
    return getattr(library(), base + _SUFFIX[dtype])


def require_cuda(name: str, dtype: torch.dtype, device: torch.device,
                 **tensors: torch.Tensor) -> None:
    """Check that every tensor lies on ``device`` (a CUDA device), is
    contiguous and has ``dtype`` (int32 for names starting with 'cols' or
    'level')."""
    if device.type != "cuda":
        raise ValueError(f"{name} launches a CUDA kernel; got tensors on "
                         f"{device} (ops.{name} runs the plain version on "
                         "the CPU)")
    for arg, t in tensors.items():
        want = torch.int32 if arg.startswith(("cols", "level")) else dtype
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        if t.dtype != want:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def device_scalar(v, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A 0-d tensor for a scalar argument a kernel reads through a pointer:
    a tensor is reshaped in place (the solver's alpha and beta never leave
    the card), a number is copied to ``device`` once."""
    if isinstance(v, torch.Tensor):
        if v.numel() != 1:
            raise ValueError(f"expected a scalar tensor, got shape {tuple(v.shape)}")
        return v.reshape(())
    return torch.full((), v, dtype=dtype, device=device)


def device_lanes(v, k: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """A (k,) tensor for a per-lane argument of a batched kernel: a tensor
    of k values (the solver's (k, 1) alpha and beta) is reshaped in place,
    a number is copied to ``device`` for every lane."""
    if isinstance(v, torch.Tensor):
        if v.numel() != k:
            raise ValueError(f"expected {k} per-lane values, got shape "
                             f"{tuple(v.shape)}")
        return v.reshape(k)
    return torch.full((k,), v, dtype=dtype, device=device)


def stream_handle(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
