"""Kernel-variant autotuner and per-matrix storage-format choice, with a
persistent JSON cache (port of ``repro.kernels.autotune``).

The timing half: :func:`autotune` times candidate launch settings of an
op at a concrete shape and records the winner keyed by ``(op, shape,
dtype, backend)`` (:func:`make_key`; the backend is ``cuda`` where the
card is, else ``cpu``); :func:`lookup` reads it back, :func:`record`
writes it, :func:`tile_candidates` lists an axis's tile sizes.  The port's
kernels take no tile sizes: a candidate is a dict of the keyword arguments
a wrapper takes, which are its forced variants -- ``variant=`` of
``ell_spmv``/``ell_spmm`` and the ``spmv_dot`` wrappers (``rows`` or
``group``, ``ell_spmv.pick_variant``) and of ``bcsr_spmm`` (``smem`` or
``first``, at the block widths ``bcsr_spmm.COMPILED_BN``).  A record keeps
the JAX entry's format, ``{"tiles": {...}, "us": float}``: a variant's
name is stored as its string, every other entry as an int.

The format half: ``row_stats``, ``modeled_format_words``, ``choose_format``
and the cache entries it reads and records (``lookup_format``,
``record_format``; backend ``host``).

Cache location: ``$REPRO_TORCH_AUTOTUNE_CACHE`` if set, else
``~/.cache/repro_torch/autotune.json`` -- the port's own file, never the
JAX package's.  The path is read at each call, never at import.  Writes
are crash- and concurrency-safe: a record re-reads the file under an
advisory lock, merges, writes a fresh temp file in the same directory,
fsyncs it and lands it with an atomic ``os.replace``, so two processes
lose at most a same-key race and a reader never sees a torn file.  A
corrupted or hand-edited file reads as empty.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, Iterable

import numpy as np
import torch

from ..obs import clock

__all__ = ["FORMAT_HYSTERESIS", "cache_path", "clear_memo", "make_key",
           "lookup", "record", "tile_candidates", "autotune",
           "default_backend", "row_stats", "modeled_format_words",
           "lookup_format", "record_format", "choose_format"]

_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
_AUTO_FORMATS = ("ell", "sell", "hyb")
_memo: dict | None = None
_memo_path: str | None = None


def cache_path() -> str:
    return os.environ.get(_ENV, os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "autotune.json"))


def _load() -> dict:
    global _memo, _memo_path
    path = cache_path()
    if _memo is not None and _memo_path == path:
        return _memo
    _memo = _read_disk(path)
    _memo_path = path
    return _memo


def clear_memo() -> None:
    """Drop the in-process cache memo (tests; after external edits)."""
    global _memo, _memo_path
    _memo, _memo_path = None, None


def _read_disk(path: str) -> dict:
    """Parse the on-disk cache; a missing or corrupted file is empty."""
    try:
        with open(path) as f:
            out = json.load(f)
        return out if isinstance(out, dict) else {}
    except (OSError, ValueError):
        return {}


def _save(cache: dict) -> None:
    """Atomic, durable write: temp file in the destination directory,
    fsync, then ``os.replace``."""
    path = cache_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(cache, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def default_backend() -> str:
    """``cuda`` where a card is visible, else ``cpu``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name   # np.dtype / numpy scalar types / strs


def make_key(op: str, shape: Iterable[int], dtype,
             backend: str | None = None) -> str:
    backend = backend or default_backend()
    return f"{op}|{'x'.join(str(int(s)) for s in shape)}|{_dtype_name(dtype)}|{backend}"


def lookup(op: str, shape: Iterable[int], dtype,
           backend: str | None = None) -> dict | None:
    """Cached candidate dict for this op/shape/dtype/backend, or None."""
    ent = _load().get(make_key(op, shape, dtype, backend))
    if not isinstance(ent, dict) or "tiles" not in ent:
        # format entries (and hand-edited junk) share the file but carry
        # no candidate dict
        return None
    return dict(ent["tiles"])


class _cache_lock:
    """Advisory cross-process lock for read-merge-replace (``flock`` on a
    sidecar file; lock-free, still atomic-rename safe, without fcntl)."""

    def __init__(self, path: str):
        self._path = path + ".lock"
        self._fd = None

    def __enter__(self):
        try:
            import fcntl
        except ImportError:
            return self
        os.makedirs(os.path.dirname(self._path) or ".", exist_ok=True)
        self._fd = os.open(self._path, os.O_CREAT | os.O_RDWR)
        fcntl.flock(self._fd, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        if self._fd is not None:
            import fcntl
            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
        return False


def record(op: str, shape, dtype, tiles: dict, us: float,
           backend: str | None = None) -> None:
    """Persist one winner (locked read-merge-replace against the disk
    state).  A variant name stays a string; every other entry is cast to
    int, as the JAX package casts its tiles."""
    global _memo, _memo_path
    path = cache_path()
    with _cache_lock(path):
        cache = dict(_load())            # entries this process knows...
        cache.update(_read_disk(path))   # ...but the disk state is newer
        cache[make_key(op, shape, dtype, backend)] = {
            "tiles": {k: v if isinstance(v, str) else int(v)
                      for k, v in tiles.items()},
            "us": round(float(us), 3),
        }
        _memo, _memo_path = cache, path
        _save(cache)


def tile_candidates(total: int, quantum: int = 8, cap: int = 512) -> list[int]:
    """Divisors of ``total`` that are multiples of ``quantum`` (plus
    ``total`` itself if none) -- the valid tile sizes for one axis."""
    out = [d for d in range(quantum, min(total, cap) + 1, quantum) if total % d == 0]
    if not out:
        out = [total]
    return out


def _timed_us(f, reps: int, cuda: bool) -> float:
    """µs a call of ``f`` after a warm call: CUDA events around ``reps``
    calls on the card, ``obs.clock`` on the CPU."""
    if cuda:
        torch.cuda.synchronize()
        f()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            f()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / reps * 1e3
    f()
    t0 = clock.now()
    for _ in range(reps):
        f()
    return (clock.now() - t0) / reps * 1e6


def autotune(
    op: str,
    shape: Iterable[int],
    dtype,
    candidates: Iterable[dict],
    build: Callable[..., Callable[[], object]],
    reps: int = 5,
    backend: str | None = None,
    timings: list | None = None,
) -> dict | None:
    """Time each candidate and persist the winner.

    ``build(**candidate)`` returns a zero-arg callable running the op with
    that candidate (a forced variant); candidates that fail to build or
    run (a variant the operands do not admit) are skipped.  On ``cuda``
    each is timed by CUDA events over ``reps`` calls after a warm call, on
    ``cpu`` by ``obs.clock`` (``time.perf_counter``).  Returns the winning dict (also
    recorded in the cache) or None if nothing ran.  A ``timings`` list
    gets (candidate, µs) for each, µs None where it failed."""
    backend = backend or default_backend()
    best, best_us = None, float("inf")
    timings = [] if timings is None else timings
    for cand in candidates:
        try:
            us = _timed_us(build(**cand), reps, backend == "cuda")
        except Exception:
            timings.append((cand, None))
            continue
        timings.append((cand, us))
        if us < best_us:
            best, best_us = cand, us
    if best is not None:
        record(op, shape, dtype, best, best_us, backend=backend)
    return best


# a compact format must save at least 1 - FORMAT_HYSTERESIS of the padded
# ELL words to replace it
FORMAT_HYSTERESIS = 0.8


def _pad_up(x: int, q: int) -> int:
    return -(-max(int(x), 1) // q) * q


def row_stats(csr) -> dict:
    """Row-length fingerprint of a CSR-like matrix (anything with
    ``shape``, ``nnz`` and ``row_nnz()``)."""
    rn = np.asarray(csr.row_nnz(), dtype=np.int64)
    n_rows, n_cols = (int(s) for s in csr.shape)
    w_max = int(rn.max()) if rn.size else 0
    w_mean = float(rn.mean()) if rn.size else 0.0
    std = float(rn.std()) if rn.size else 0.0
    return {
        "n_rows": n_rows,
        "n_cols": n_cols,
        "nnz": int(csr.nnz),
        "w_max": w_max,
        "w_mean": round(w_mean, 3),
        "row_cv": round(std / w_mean, 4) if w_mean else 0.0,
    }


def modeled_format_words(csr, slice_height: int = 8, row_pad: int = 8) -> dict:
    """Modeled matrix-stream words per matvec (col, val pairs streamed):

    - ``ell``:  2 * rows_padded * w_max
    - ``sell``: 2 * sum over slices of slice_height * slice width
    - ``hyb``:  2 * rows_padded * w_core + 3 * spilled entries, at the
      storage-optimal core width
    """
    rn = np.asarray(csr.row_nnz(), dtype=np.int64)
    n_rows = int(csr.shape[0])
    rp = _pad_up(_pad_up(n_rows, row_pad), slice_height)
    w_max = int(rn.max()) if rn.size else 0

    rn_pad = np.zeros((rp,), dtype=np.int64)
    rn_pad[:n_rows] = rn
    widths = rn_pad.reshape(-1, slice_height).max(axis=1)
    e_sell = int(np.maximum(widths, 1).sum()) * slice_height

    best_w, best_words = max(w_max, 1), None
    for w in sorted(set(np.unique(rn).tolist()) | {1}):
        spill = int(np.maximum(rn - w, 0).sum())
        words = 2 * rp * w + 3 * spill
        if best_words is None or words < best_words:
            best_w, best_words = w, words

    return {
        "ell": 2 * rp * max(w_max, 1),
        "sell": 2 * e_sell,
        "hyb": int(best_words if best_words is not None else 2 * rp),
        "hyb_core_width": best_w,
    }


def _format_key(stats: dict, dtype) -> str:
    shape = (stats["n_rows"], stats["n_cols"], stats["nnz"], stats["w_max"])
    return make_key("format", shape, dtype, backend="host")


def lookup_format(csr, dtype=np.float32) -> str | None:
    """Cached format decision for this matrix fingerprint, or None."""
    ent = _load().get(_format_key(row_stats(csr), dtype))
    fmt = ent.get("format") if isinstance(ent, dict) else None
    return fmt if fmt in _AUTO_FORMATS else None


def record_format(csr, fmt: str, words: dict, dtype=np.float32) -> None:
    """Persist one format decision (locked read-merge-replace)."""
    global _memo, _memo_path
    path = cache_path()
    stats = row_stats(csr)
    with _cache_lock(path):
        cache = dict(_load())            # entries this process knows...
        cache.update(_read_disk(path))   # ...but the disk state is newer
        cache[_format_key(stats, dtype)] = {
            "format": fmt,
            "words": {k: int(v) for k, v in words.items()},
            "stats": stats,
        }
        _memo, _memo_path = cache, path
        _save(cache)


def choose_format(csr, dtype=np.float32, slice_height: int = 8,
                  row_pad: int = 8, use_cache: bool = True) -> tuple[str, dict]:
    """``(format, words)``: padded ELL unless sell or hyb saves at least
    ``1 - FORMAT_HYSTERESIS`` of its modeled words (ties prefer sell).
    Deterministic per matrix fingerprint; with ``use_cache`` a cached
    decision is returned and a new one recorded."""
    words = modeled_format_words(csr, slice_height=slice_height, row_pad=row_pad)
    if use_cache:
        cached = lookup_format(csr, dtype)
        if cached is not None:
            return cached, words
    fmt = "ell"
    best = min(("sell", "hyb"), key=lambda f: (words[f], f != "sell"))
    if words[best] < FORMAT_HYSTERESIS * words["ell"]:
        fmt = best
    if use_cache:
        record_format(csr, fmt, {k: v for k, v in words.items()
                                 if k in _AUTO_FORMATS}, dtype)
    return fmt, words
