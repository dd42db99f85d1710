"""The timing half of the port's autotuner (``repro_torch.kernels.autotune``:
``autotune``, ``lookup``, ``record``, ``tile_candidates``) held to the JAX
package's (``repro.kernels.autotune``) on the CPU.

``tile_candidates`` and the cache key are JAX's; one record writes the
same entry and the same file as JAX's (``{"tiles": {...}, "us": ...}``,
tiles cast to int, a variant's name kept as a string); the read-merge-
replace keeps concurrent writers' entries, across processes; ``autotune``
times each candidate, skips one that raises, records the winner.  Every
cache lives in ``tmp_path``.
"""

import json
import multiprocessing
import os

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jat
from repro_torch.kernels import autotune as at
from repro_torch.obs import clock
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def caches(tmp_path, monkeypatch):
    port, jax_ = tmp_path / "port" / "autotune.json", tmp_path / "jax" / "autotune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(port))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(jax_))
    at.clear_memo()
    jat.clear_memo()
    yield port, jax_
    at.clear_memo()
    jat.clear_memo()


@pytest.mark.parametrize("quantum,cap", [(8, 512), (1, 64), (16, 256), (128, 1024)])
def test_tile_candidates_equal_jax(quantum, cap):
    for total in list(range(1, 300)) + [1024, 4096, 12800, 49155, 2**20]:
        assert at.tile_candidates(total, quantum, cap) == \
            jat.tile_candidates(total, quantum, cap)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, "float32", np.int32,
                                   np.dtype("bfloat16") if hasattr(np, "bfloat16")
                                   else np.float16])
@pytest.mark.parametrize("backend", ["cpu", "cuda", "host"])
def test_cache_key_equals_jax(dtype, backend):
    shape = (1048576, 12)
    assert at.make_key("ell_spmv", shape, dtype, backend) == \
        jat.make_key("ell_spmv", shape, dtype, backend)


def test_torch_dtypes_and_the_default_backend():
    assert at.make_key("op", (4, 8), torch.float64, "cuda") == \
        jat.make_key("op", (4, 8), np.float64, "cuda") == "op|4x8|float64|cuda"
    assert at.default_backend() == ("cuda" if torch.cuda.is_available() else "cpu")
    assert at.make_key("op", (4,), np.float32).endswith("|" + at.default_backend())


def test_record_writes_jax_s_entry_and_file(caches):
    port, jax_ = caches
    for mod in (at, jat):
        mod.record("bcsr_spmm", (131072, 8, 8, 8), np.float64,
                   {"bm": 8.0, "bn": np.int64(8)}, 12.34567, backend="cpu")
        mod.record("ell_spmv", (64, 8), np.float32, {"tm": 8}, 3.0, backend="cpu")
    assert port.read_text() == jax_.read_text()
    disk = json.loads(port.read_text())
    assert disk["bcsr_spmm|131072x8x8x8|float64|cpu"] == {
        "tiles": {"bm": 8, "bn": 8}, "us": 12.346}
    at.clear_memo()
    assert at.lookup("bcsr_spmm", (131072, 8, 8, 8), np.float64, "cpu") == \
        jat.lookup("bcsr_spmm", (131072, 8, 8, 8), np.float64, "cpu") == \
        {"bm": 8, "bn": 8}
    assert at.lookup("bcsr_spmm", (131072, 8, 8, 8), np.float32, "cpu") is None


def test_variant_names_stay_strings(caches):
    port, _ = caches
    at.record("ell_spmv", (1048576, 12), torch.float64,
              {"variant": "rows"}, 41.5, backend="cuda")
    at.clear_memo()
    assert at.lookup("ell_spmv", (1048576, 12), np.float64, "cuda") == {"variant": "rows"}
    assert json.loads(port.read_text())["ell_spmv|1048576x12|float64|cuda"] == {
        "tiles": {"variant": "rows"}, "us": 41.5}


def test_format_entries_are_not_tiles_and_a_torn_file_is_empty(caches):
    port, _ = caches
    from repro_torch.data.matrices import laplacian_2d

    at.choose_format(laplacian_2d(8))
    key = next(iter(json.loads(port.read_text())))
    assert key.endswith("|host")
    op, shape, dt, backend = key.split("|")
    assert at.lookup(op, [int(s) for s in shape.split("x")], dt, backend) is None
    port.write_text('{"op_a|64x8|float32|cpu": {"tiles": {"tm"')
    at.clear_memo()
    assert at.lookup("op_a", (64, 8), np.float32, "cpu") is None
    at.record("op_b", (32, 8), np.float64, {"tl": 16}, 3.0, backend="cpu")
    assert json.loads(port.read_text())["op_b|32x8|float64|cpu"]["tiles"] == {"tl": 16}


def test_record_merges_with_a_concurrent_writer(caches):
    port, _ = caches
    at.record("op_a", (64, 8), np.float32, {"tm": 8}, 1.0, backend="cpu")
    disk = json.loads(port.read_text())
    disk["op_other|128x8|float32|cpu"] = {"tiles": {"tm": 16}, "us": 2.0}
    port.write_text(json.dumps(disk))
    at.record("op_b", (32, 8), np.float32, {"variant": "group"}, 3.0, backend="cpu")
    assert set(json.loads(port.read_text())) == {
        "op_a|64x8|float32|cpu", "op_b|32x8|float32|cpu",
        "op_other|128x8|float32|cpu"}


def _hammer(args):
    path, idx = args
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = path
    from repro_torch.kernels import autotune as a
    a.clear_memo()
    for j in range(10):
        a.record(f"op_{idx}_{j}", (8 * (j + 1), 8), np.float32,
                 {"variant": "rows"}, float(j), backend="cpu")
    return True


def test_parallel_writers_never_corrupt(caches):
    """3 processes x 10 records each under the lock: the file parses and
    holds every process's entries."""
    port, _ = caches
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(3) as pool:
        assert all(pool.map(_hammer, [(str(port), i) for i in range(3)]))
    disk = json.loads(port.read_text())
    assert {f"op_{i}_{j}|{8 * (j + 1)}x8|float32|cpu"
            for i in range(3) for j in range(10)} <= set(disk)


def test_autotune_times_skips_failures_and_records(caches):
    port, _ = caches
    calls = {"a": 0, "b": 0}

    def build(variant):
        if variant == "bad":
            raise ValueError("this variant does not take these operands")

        def run():
            calls[variant] += 1
            clock.sleep({"a": 0.002, "b": 0.001}[variant])
        return run

    timings = []
    with clock.override(clock.FakeClock()):
        best = at.autotune("op", (16, 4), np.float64,
                           [{"variant": "a"}, {"variant": "bad"}, {"variant": "b"}],
                           build, reps=3, backend="cpu", timings=timings)
    assert best == {"variant": "b"}
    assert calls == {"a": 4, "b": 4}              # a warm call, then 3 timed
    assert [t[0]["variant"] for t in timings] == ["a", "bad", "b"]
    assert timings[1][1] is None
    assert timings[0][1] == pytest.approx(2000.0) and timings[2][1] == pytest.approx(1000.0)
    at.clear_memo()
    assert at.lookup("op", (16, 4), np.float64, "cpu") == {"variant": "b"}
    assert json.loads(port.read_text())["op|16x4|float64|cpu"]["us"] == 1000.0


def test_autotune_with_nothing_that_runs_records_nothing(caches):
    port, _ = caches

    def build(**kw):
        raise RuntimeError("no")
    assert at.autotune("op", (4,), np.float32, [{"x": 1}, {"x": 2}], build,
                       backend="cpu") is None
    assert jat.autotune("op", (4,), np.float32, [{"x": 1}], build,
                        backend="cpu") is None
    assert not port.exists()


def test_autotune_real_ops_on_the_cpu(caches):
    """Two ways to compute one matvec, timed on the real clock: a winner
    among them, recorded under the ``cpu`` backend by default."""
    a = torch.randn(256, 256, dtype=torch.float64)
    x = torch.randn(256, dtype=torch.float64)
    ways = {"mv": lambda: a @ x, "sum": lambda: (a * x).sum(1)}
    best = at.autotune("matvec", (256, 256), torch.float64,
                       [{"way": "mv"}, {"way": "sum"}], lambda way: ways[way])
    assert best in ({"way": "mv"}, {"way": "sum"})
    assert at.lookup("matvec", (256, 256), np.float64) == best


@pytest.mark.parametrize("name,k", [("ell_spmv", None), ("ell_spmm", 8),
                                    ("ell_spmv_pfold_dot", None),
                                    ("ell_spmm_pfold_dot", 8)])
def test_rows_or_group_wrappers_take_a_recorded_winner(caches, name, k):
    """``ell_spmv.pick_variant`` takes the winner recorded at (rows, W[, k])
    where the operands admit it: "group" over the rule's "rows" (the card's
    winner at W = 12 and 16, one RHS); a recorded "rows" on operands the
    rows kernel cannot take, junk, or another shape, dtype or k fall back
    to the rule; a forced variant wins over the cache."""
    from repro_torch.kernels import ell_spmv

    cols = torch.zeros(64, 12, dtype=torch.int32)
    vals = torch.zeros(64, 12, dtype=torch.float64)
    moved = torch.zeros(64 * 12 + 1, dtype=torch.float64)[1:].view(64, 12)
    shape = (64, 12) if k is None else (64, 12, k)
    pick = lambda v=vals, variant=None, kk=k: ell_spmv.pick_variant(
        name, cols, v, variant, kk)
    assert pick() == "rows"                        # the rule, nothing recorded
    at.record(name, shape, torch.float64, {"variant": "group"}, 1.0)
    assert pick() == "group"
    assert pick(variant="rows") == "rows"
    assert ell_spmv.pick_variant(name, cols, vals.float(), None, k) == "rows"
    if k is not None:
        assert pick(kk=4) == "rows"
    at.record(name, shape, torch.float64, {"variant": "rows"}, 1.0)
    assert pick(moved) == "group"                  # rows cannot take it
    at.record(name, shape, torch.float64, {"variant": "bulk"}, 1.0)
    assert pick() == "rows"
    at.record(name, shape, torch.float64, {"variant": "group"}, 1.0,
              backend="cuda" if at.default_backend() == "cpu" else "cpu")
    at.record(name, shape, torch.float64, {"variant": "rows"}, 1.0)
    assert pick() == "rows"                        # this backend's entry
