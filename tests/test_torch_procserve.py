"""The solve service on a process grid (``SolveService`` over a 2x2
``launch.mesh.ProcessMesh``, 4 gloo ranks on the CPU) held to the
one-process ``TileMesh`` grid's service and the JAX package's 2x2-mesh
service.

One module fixture spawns two groups of 4 ranks once, side by side
(``launch.procs``; the rank side is ``tests/procserve_cases.py``), while
a JAX subprocess with 8 forced host devices runs
``chip_smoke.SERVICE_PARITY``'s lap2d_32 script on the JAX service
(``test_torch_dist_cases.run_jax``).

* The parity script in the dense and halo layouts: per-request
  iterations and statuses equal to the JAX 2x2-mesh service's (the
  constants ``chip_smoke.py`` holds the card to) and the one-process
  grid's, x within 1e-10 of the one-process grid's, every rank's
  outcomes and stats bitwise rank 0's; a tick costs one broadcast and a
  chunk one gather of the clock.
* Clocks that disagree (each rank a fake clock of its own offset and
  rate): priorities with aging, a deadline-0 request and a chunk slow on
  one rank alone give the same outcomes and stats on every rank, and the
  one-process run's under rank 0's clock.
* Two operators under a memory budget: the grid's bytes charged, the
  evictions and reloads of the one-process grid.
* The ``SolveServer`` shim's ``step`` and deadline path on the ranks.
* ``launch.serve --solver --processes`` under a faked torchrun
  environment (in the ranks), drained and under ``--load-gen closed``,
  and spawned, drained: rank 0's JSON is the one-process grid's with
  ``processes`` added; ``run_load``'s open loop answers every request, the ranks'
  outcomes bitwise rank 0's.
* A rank that raises before a tick fails the run at once, not at the
  deadline, while the others wait in the tick's broadcast.
* On a card (``gpu``): the parity script on 4 gloo ranks sharing it.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import procserve_cases as C
from repro_torch.launch import procs
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import make_mesh
from test_torch_dist_cases import REPO, run_jax
from torch_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, str(REPO))
import chip_smoke as CHIP  # noqa: E402

DEADLINE_S = 300.0
X_RTOL = 1e-10
# the JSON keys that are wall times (each run's own)
TIMES = ("wall_s", "solves_per_s", "throughput_rps", "p50_ms", "p99_ms",
         "mean_ms")

_JAX = r"""
import json, sys
import numpy as np
from repro.data.matrices import suite
from repro.launch.mesh import make_mesh
from repro.serve import SolveService
import chip_smoke as CHIP

script = CHIP.SERVICE_PARITY["lap2d_32"]
m = suite("small")["lap2d_32"]
js, res = {}, {}
for lay in json.load(open(sys.argv[1]))["layouts"]:
    svc = SolveService(max_batch=script["max_batch"], chunk=script["chunk"])
    svc.register_operator("lap2d_32", m, layout=lay,
                          mesh=make_mesh((2, 2), ("data", "model")),
                          **CHIP.SERVICE_OPERATOR)
    outs = CHIP.service_script(svc, m, script)
    js[lay] = [[int(o.iters) for o in outs], [o.status for o in outs]]
    res[lay] = np.concatenate([np.asarray(o.x) for o in outs])
np.savez(sys.argv[2], json=json.dumps(js), **res)
print("JAX_PROCSERVE_DONE")
"""


def _spawned_cli() -> tuple:
    """``python -m repro_torch.launch.serve`` drained with ``--processes``
    (it spawns its ranks): (exit code, the JSON it printed)."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        *C.CLI_ARGV["drain"], "--processes", "--dist-backend",
                        "gloo"], capture_output=True, text=True, env=env,
                       cwd=REPO, timeout=DEADLINE_S)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.returncode, json.loads(r.stdout[r.stdout.index("{"):])


def _failed_run() -> tuple:
    """A run whose rank 1 raises before a tick: (the error, seconds)."""
    t0 = time.time()
    try:
        procs.run(C.rank_raises, 2, (), backend="gloo", device="cpu",
                  timeout_s=DEADLINE_S)
    except Exception as e:          # held by the test
        return e, time.time() - t0
    return None, time.time() - t0


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(JAX's x by layout, JAX's JSON, the ranks' results, {"spawned": the
    spawned CLI's (code, JSON), "failed": the failing run's (error,
    seconds)}); each rank's dict holds both layouts' parity.  The second
    layout's parity runs in a second group of 4 ranks, beside the first,
    the spawned CLI and the failing run: a 2x2 step is mostly gloo's
    latency, so the groups overlap."""
    tmp = tmp_path_factory.mktemp("procserve")
    first, second = C.LAYOUTS
    with ThreadPoolExecutor(4) as ex:
        jax_run = ex.submit(run_jax, _JAX, {"layouts": list(C.LAYOUTS)},
                            tmp / "jax.npz")
        other = ex.submit(procs.run, C.rank_parity, 4, (second,),
                          backend="gloo", device="cpu", timeout_s=DEADLINE_S)
        spawned, failed = ex.submit(_spawned_cli), ex.submit(_failed_run)
        ranks = procs.run(C.rank_main, 4, (first,), backend="gloo",
                          device="cpu", timeout_s=DEADLINE_S)
        for r, o in zip(ranks, other.result()):
            r["parity"] = {first: r["parity"], second: o["parity"]}
        arrays, meta = jax_run.result()
        side = {"spawned": spawned.result(), "failed": failed.result()}
    return arrays, meta, ranks, side


_TILE: dict = {}


def tile_mesh():
    if "mesh" not in _TILE:
        _TILE["mesh"] = make_mesh(C.GRID, C.AXES, device="cpu")
    return _TILE["mesh"]


def _same_ranks(ranks, get) -> None:
    """Every rank's value bitwise rank 0's."""
    want = get(ranks[0])
    for r in ranks[1:]:
        got = get(r)
        if isinstance(want, np.ndarray):
            assert got.tobytes() == want.tobytes(), r["rank"]
        else:
            assert got == want, r["rank"]


def _same_outcomes(ranks, case: str) -> None:
    for key in ("iters", "status", "x", "stats"):
        _same_ranks(ranks, lambda r: r[case][key])


def _close(got, want) -> None:
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= X_RTOL, rel


# -- parity ----------------------------------------------------------------------


@pytest.mark.parametrize("layout", C.LAYOUTS)
def test_parity_constants_equal_jax_2x2_service(sides, layout):
    _, meta, _, _ = sides
    script = CHIP.SERVICE_PARITY[C.PARITY]
    assert meta[layout] == [list(script["iters"]), list(script["status"])]


@pytest.mark.parametrize("layout", C.LAYOUTS)
def test_parity_equals_one_process_grid_and_jax(sides, layout):
    arrays, meta, ranks, _ = sides
    one = C.parity(tile_mesh(), layout)
    got = ranks[0]["parity"][layout]
    assert [got["iters"], got["status"]] == [one["iters"], one["status"]] \
        == meta[layout]
    _close(got["x"], one["x"])
    assert np.allclose(got["x"], arrays[layout], rtol=0, atol=1e-9)
    for key in ("ticks", "chunks", "admitted", "completed", "rebuckets",
                "padded_lanes", "queue_peak", "plans", "degraded_batches"):
        assert got["stats"][key] == one["stats"][key], key
    for key in ("iters", "status", "x", "stats", "clock_calls"):
        _same_ranks(ranks, lambda r: r["parity"][layout][key])


def test_a_tick_broadcasts_once_and_a_chunk_gathers_once(sides):
    _, _, ranks, _ = sides
    for layout in C.LAYOUTS:
        got = ranks[0]["parity"][layout]
        assert got["clock_calls"] == [got["stats"]["ticks"],
                                      got["stats"]["chunks"]]


# -- decisions on rank 0's clock ------------------------------------------------


def test_disagreeing_clocks_decide_as_rank_0(sides):
    _, _, ranks, _ = sides
    one = C.clocks(tile_mesh(), 0)
    got = ranks[0]["clocks"]
    # aging admits the old low-priority request before the new
    # high-priority one; the deadline-0 request expires after one chunk;
    # the chunk slow on one rank is flagged everywhere
    assert got["finish"] == one["finish"] == [0, 1, 2, 3]
    assert got["status"] == one["status"] == ["converged"] * 3 + [
        "deadline_exceeded"]
    assert got["iters"] == one["iters"] and got["iters"][3] == C.CLOCK_CHUNK
    assert got["stats"] == one["stats"]
    assert got["stats"]["straggler_chunks"] == [C.SLOW_CHUNK]
    assert got["stats"]["deadline_exceeded"] == 1
    _close(got["x"], one["x"])
    _same_outcomes(ranks, "clocks")
    _same_ranks(ranks, lambda r: r["clocks"]["finish"])


def test_latency_metric_reads_each_ranks_own_clock(sides):
    """A request's latency is stamped and read on one clock, the rank's:
    every one of the 4 lies within the rank's own span of the run, on
    clocks that sit 1000 s apart and run at 0.25 to 3 times rank 0's."""
    _, _, ranks, _ = sides
    for r in ranks:
        count, total, span = r["clocks"]["latency"]
        assert count == 4, r["rank"]
        assert 0.0 < total <= count * span, (r["rank"], total, span)


def test_memory_budget_evicts_and_reloads_as_one_process_grid(sides):
    _, _, ranks, _ = sides
    one = C.evictions(tile_mesh())
    got = ranks[0]["evictions"]
    assert got["bytes"] == one["bytes"]
    assert got["resident"] == one["resident"] == {"big": False,
                                                  "small": True}
    for key in ("evictions", "reloads"):
        assert got["stats"][key] == one["stats"][key]
    assert [got["stats"]["evictions"], got["stats"]["reloads"]] == [3, 2]
    assert got["iters"] == one["iters"] and got["status"] == one["status"]
    _close(got["x"], one["x"])
    _same_outcomes(ranks, "evictions")
    _same_ranks(ranks, lambda r: r["evictions"]["bytes"])


def test_solve_server_shim_steps_and_expires_as_rank_0(sides):
    _, _, ranks, _ = sides
    one = C.shim(tile_mesh(), 0)
    got = ranks[0]["shim"]
    assert got["status"] == one["status"]
    assert got["status"][3] == "deadline_exceeded"
    assert got["iters"] == one["iters"]
    assert got["iters"][3] == 2 * C.CLOCK_CHUNK      # two chunks, then late
    assert got["stats"] == one["stats"]
    assert got["stats"]["deadline_batches"] == 1
    _close(got["x"], one["x"])
    _same_outcomes(ranks, "shim")


# -- the CLI and the load generator ----------------------------------------------


_ONE: dict = {}


def _run_json(argv, capsys) -> dict:
    assert serve_cli.main(argv) == 0
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"):])


def _one_process_json(kind: str, capsys) -> dict:
    """The one-process grid's JSON of ``CLI_ARGV[kind]`` (run once)."""
    if kind not in _ONE:
        _ONE[kind] = _run_json(C.CLI_ARGV[kind], capsys)
    return dict(_ONE[kind])


def _same_json(many: dict, one: dict) -> None:
    """Two runs' JSON: the same keys and values, but the wall times and
    the true errors (x within X_RTOL, not bitwise)."""
    assert set(many) == set(one)
    for k, v in one.items():
        if k in ("verify_maxerr", "verify_rel_residual"):
            assert many[k] == pytest.approx(v, rel=1e-6), k
        elif k not in TIMES:
            assert many[k] == v, k


@pytest.mark.parametrize("kind", list(C.CLI_ARGV))
def test_serve_cli_processes_under_torchrun_equals_one_process(sides, kind,
                                                               capsys):
    _, _, ranks, _ = sides
    one = _one_process_json(kind, capsys)
    code, many = ranks[0]["cli"][kind]
    assert code == 0
    assert many.pop("processes") == 4
    _same_json(many, one)
    for r in ranks[1:]:
        assert r["cli"][kind] == (0, None)          # rank 0 prints


def test_serve_cli_processes_spawned_equals_one_process(sides, capsys):
    """Spawned, drained (the ranks' runs above cover ``--load-gen closed``
    under torchrun's environment)."""
    one = _one_process_json("drain", capsys)
    code, many = sides[3]["spawned"]
    assert code == 0 and many.pop("processes") == 4
    _same_json(many, one)


def test_open_loop_answers_every_request_alike_on_every_rank(sides):
    _, _, ranks, _ = sides
    got = ranks[0]["open"]
    assert got["ids"] == list(range(C.OPEN["requests"]))
    assert got["completed"] == C.OPEN["requests"] and got["rejected"] == 0
    assert got["status"] == ["converged"] * C.OPEN["requests"]
    for key in ("ids", "iters", "status", "x", "completed", "statuses"):
        _same_ranks(ranks, lambda r: r["open"][key])


def test_a_rank_that_raises_fails_the_run_on_every_rank(sides):
    """A rank that raises before a tick ends the run with its traceback
    while the other waits in the tick's broadcast: the parent kills it,
    long before its deadline."""
    err, seconds = sides[3]["failed"]
    assert isinstance(err, RuntimeError)
    assert "rank 1 fails before its tick" in str(err)
    assert seconds < DEADLINE_S / 2


# -- on a card -------------------------------------------------------------------


def _card_parity(rank) -> dict:
    return C.parity(rank.mesh(C.GRID, C.AXES), "halo")


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
def test_parity_on_ranks_sharing_a_card():
    """chip_smoke phase 14a's parity case: 4 gloo ranks on the card against
    the one-process grid on the card and the JAX package's counts."""
    script = CHIP.SERVICE_PARITY[C.PARITY]
    ranks = procs.run(_card_parity, 4, (), backend="gloo", device="cuda",
                      timeout_s=DEADLINE_S)
    mesh = make_mesh(C.GRID, C.AXES, device="cuda")
    from repro_torch.serve import SolveService
    from repro_torch.data import matrices as tmat

    m = tmat.suite("small")[C.PARITY]
    svc = SolveService(max_batch=script["max_batch"], chunk=script["chunk"])
    svc.register_operator(C.PARITY, m, layout="halo", mesh=mesh, **C.OPERATOR)
    one = C.outcomes(CHIP.service_script(svc, m, script))
    got = ranks[0]
    assert tuple(got["iters"]) == tuple(one["iters"]) == script["iters"]
    assert tuple(got["status"]) == tuple(one["status"]) == script["status"]
    _close(got["x"], one["x"])
    for key in ("iters", "status", "x", "stats"):
        _same_ranks(ranks, lambda r: r[key])
