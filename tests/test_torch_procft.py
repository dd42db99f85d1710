"""Fault tolerance on a process grid (``launch.mesh.ProcessMesh``, 4 gloo
ranks on the CPU) held to the one-process ``TileMesh`` grid, the
one-process training loop and the JAX package.

One module fixture spawns the 4 ranks once (``launch.procs``; the rank
side is ``tests/procft_cases.py``), while a JAX subprocess with 8 forced
host devices runs the grid solves and ``repro.launch.solve --mesh-shape
2x2 --inject`` (``test_torch_dist_cases.run_jax``); the JAX package's
training side runs in process.

* ``ft.SolveRestartManager`` on the grid: chip_smoke.PROC_FT's scenarios
  (tests/test_torch_dist_serve.py's FT_SCENARIOS on the 1d 4x1 grid, nan
  and bitflip on the 2d 2x2 grid) report as the JAX package does and as
  the one-process grid does, x within 1e-10 of the one-process grid's,
  the ranks' reports and x bitwise equal; the constants equal JAX's;
* ``ft.FaultInjector``: the ranks' corrupted tiles, stacked in rank
  order, bit for bit the one-process grid's corrupted operand, every
  value kind on both grids;
* checkpoints: a solve that gives up and a fresh manager that resumes on
  the grid (only rank 0 writes), a grid checkpoint resuming a one-process
  solve and the other way round;
* ``launch.solve --processes --inject KIND`` (every kind; under a faked
  torchrun environment in the ranks, and spawned): rank 0's JSON is the
  one-process grid's with ``processes`` added, and JAX's;
* ``ft.RestartManager`` on a placed state (``train_on_mesh(ckpt_dir=)``
  with a failure injected, then resumed; a NaN forced once): counts equal
  to the one-process port's and JAX's ``repro.ft.RestartManager``'s,
  losses within rtol 1e-5, ranks bitwise; the donating step's raise on
  every rank;
* a placed state's save is the one-process save's files byte for byte
  (f32 and bf16); a grid checkpoint restores in ``repro.checkpoint`` and a
  JAX checkpoint onto the grid;
* ``launch.train --mesh single --ckpt-dir`` reaches the manager under a
  stubbed world of 256 ranks.
"""

import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import procft_cases as C
from repro import checkpoint as JC
from repro import configs as jconfigs
from repro import train as JT
from repro.data import TokenPipeline as JPipe
from repro.ft import RestartManager as JRestartManager
from repro_torch import convert, ft
from repro_torch import train as T
from repro_torch.checkpoint import manager as ckpt
from repro_torch.launch import procs
from repro_torch.launch import solve as solve_cli
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_mesh
from repro_torch.obs import clock
from test_torch_dist_cases import MESHES, REPO, run_jax
from torch_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, str(REPO))
import chip_smoke as CHIP  # noqa: E402

pytestmark = pytest.mark.faults

DEADLINE_S = 300.0
X_RTOL = CHIP.PROC_RTOL
LOSS_RTOL = 1e-5

_JAX = r"""
import contextlib, io, json, sys
import numpy as np
import scipy.sparse as sp
from repro import ft
from repro.core.engine import AzulEngine
from repro.core.plan import SolveSpec
from repro.data.matrices import laplacian_2d
from repro.launch import solve as solve_cli
from repro.launch.mesh import make_mesh
from repro.obs import clock
import chip_smoke as CHIP
from test_torch_dist_cases import MESHES

A = json.load(open(sys.argv[1]))
js = {}


def run(case, ckdir=None, fault=True):
    m = laplacian_2d(case["grid"])
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    b = a @ np.random.default_rng(case["x_seed"]).standard_normal(m.shape[0])
    shape, axes, ra, ca = MESHES[case["mesh"]]
    eng = AzulEngine(m, mesh=make_mesh(tuple(shape), tuple(axes)),
                     mode=case["mode"], row_axes=tuple(ra), col_axes=tuple(ca),
                     dtype=np.float64)
    mgr = ft.SolveRestartManager(
        eng, SolveSpec(method=case["method"], tol=CHIP.PROC_FT_TOL,
                       max_iters=CHIP.PROC_FT_BUDGET),
        chunk=case["chunk"], max_restarts=case.get("max_restarts", 3),
        checkpoint_dir=ckdir)
    inj = (ft.FaultInjector(eng, ft.FaultSpec(**case["fault"]))
           if fault and case["fault"] is not None else None)
    rep = mgr.solve(b, injector=inj)
    return [[rep.status, rep.iterations, rep.chunks, rep.restarts,
             [[f["label"], f["global_iter"], f["bad_iter"]]
              for f in rep.faults]], rep.resumed_from]


js["ft"] = [run(case) for case, _ in CHIP.PROC_FT]
case = CHIP.PROC_FT_CKPT[0]
js["ckpt"] = [run(case, A["ckpt"]), run(case, A["ckpt"], fault=False)]
js["cli"] = {}
for kind, argv in A["cli"].items():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), clock.override(clock.FakeClock()):
        code = solve_cli.main(argv)
    js["cli"][kind] = [code, json.loads(buf.getvalue())]
np.savez(sys.argv[2], json=json.dumps(js))
print("JAX_PROCFT_DONE")
"""


_TILE: dict = {}


def tile_engine(case: dict):
    """The one-process grid's engine of a case (built once)."""
    key = (case["grid"], case["mesh"], case["mode"])
    if key not in _TILE:
        shape, axes, _, _ = MESHES[case["mesh"]]
        _TILE[key] = C.engine(make_mesh(shape, axes, device="cpu"), case)
    return _TILE[key]


def _jax_cfg():
    return jconfigs.get_smoke(C.ARCH).replace(param_dtype="float32",
                                              compute_dtype="float32")


def _jax_opt():
    return JT.adamw(JT.warmup_cosine(C.LR, min(20, C.STEPS // 5 + 1), C.STEPS))


def jax_seed_state():
    """The port's seed-0 state (``launch.train``'s) as a JAX TrainState."""
    got = convert.train_state_to_numpy(C.seed_state(C.cfg_of()))
    params = jax.tree.map(jnp.asarray, got["params"])
    return JT.init_train_state(params, _jax_opt())


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(JAX's JSON, the ranks' results, the directories).  Before the
    spawn: a one-process grid's solve that gives up leaves its checkpoint,
    and the JAX package writes its first state."""
    tmp = tmp_path_factory.mktemp("procft")
    dirs = {k: str(tmp / k) for k in (
        "solve_grid", "solve_grid_gave_up", "solve_tile", "train_grid",
        "jax_init", "train_nan", "train_raise", "save", "jax_ckpt")}
    case = CHIP.PROC_FT_CKPT[0]
    C.ft_solve(tile_engine(case), case, dirs["solve_tile"])
    JC.save(jax_seed_state(), dirs["jax_init"], 0)
    args = {"ckpt": dirs["jax_ckpt"],
            "cli": {k: C.CLI_ARGV + ["--inject", k] for k in C.CLI_KINDS}}
    with ThreadPoolExecutor(1) as ex:
        jax_run = ex.submit(run_jax, _JAX, args, tmp / "jax.npz")
        ranks = procs.run(C.rank_main, 4, (dirs,), backend="gloo",
                          device="cpu", timeout_s=DEADLINE_S)
        _, meta = jax_run.result()
    return meta, ranks, dirs


def _same_ranks(ranks, get) -> None:
    """Every rank's value bitwise rank 0's."""
    want = get(ranks[0])
    for r in ranks[1:]:
        got = get(r)
        if isinstance(want, np.ndarray):
            assert got.tobytes() == want.tobytes(), r["rank"]
        else:
            assert got == want, r["rank"]


def _report(want) -> list:
    """A chip_smoke report constant as procft_cases.summary's lists."""
    return [want[0], want[1], want[2], want[3], [list(f) for f in want[4]]]


# -- the solves ------------------------------------------------------------------


@pytest.mark.parametrize("i", range(len(CHIP.PROC_FT) + 2))
def test_proc_ft_constants_equal_jax(sides, i):
    meta = sides[0]
    if i < len(CHIP.PROC_FT):
        assert meta["ft"][i] == [_report(CHIP.PROC_FT[i][1]), None]
    elif i == len(CHIP.PROC_FT):
        assert meta["ckpt"][0] == [_report(CHIP.PROC_FT_CKPT[1]), None]
    else:
        report, resumed = CHIP.PROC_FT_CKPT[2]
        assert meta["ckpt"][1] == [_report(report), resumed]


def test_proc_ft_cases_are_the_dist_serve_scenarios():
    """PROC_FT's 1d cases are tests/test_torch_dist_serve.py's
    FT_SCENARIOS on its lap16 4x1 engine and b."""
    from test_torch_dist_serve import FT_SCENARIOS

    got = [dict(method=c["method"], chunk=c["chunk"], fault=c["fault"])
           for c, _ in CHIP.PROC_FT if c["mesh"] == "4x1"]
    assert got == [dict(s) for s in FT_SCENARIOS]
    assert CHIP._L16["grid"] == 16 and CHIP._L16["x_seed"] == 1
    assert CHIP._L16["mode"] == "1d"


@pytest.mark.parametrize("i", range(len(CHIP.PROC_FT)))
def test_ft_solve_equals_jax_and_one_process_grid(sides, i):
    _, ranks, _ = sides
    case, want = CHIP.PROC_FT[i]
    tile = C.ft_solve(tile_engine(case), case)
    got = ranks[0]["solve"]["ft"][i]
    assert got["report"] == tile["report"] == _report(want)
    assert got["fired"] == tile["fired"]
    assert got["stragglers"] == tile["stragglers"] == []
    rel = np.abs(got["x"] - tile["x"]).max() / np.abs(tile["x"]).max()
    assert rel <= X_RTOL, rel
    for key in ("x", "report", "stragglers", "fired"):
        _same_ranks(ranks, lambda r: r["solve"]["ft"][i][key])


@pytest.mark.parametrize("mname", list(C.CORRUPT_GRIDS))
@pytest.mark.parametrize("kind", C.CORRUPT_KINDS)
def test_corrupted_tiles_stack_to_the_one_process_operand(sides, mname, kind):
    _, ranks, _ = sides
    eng = tile_engine(C.CORRUPT_GRIDS[mname])
    want = C.corrupted(eng, kind)
    got = np.concatenate([r["solve"]["corrupt"][mname][kind] for r in ranks])
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() != eng.vals_template().tobytes()


def test_checkpointed_solve_resumes_on_the_grid(sides):
    _, ranks, _ = sides
    _, gave_up, (resumed, at) = CHIP.PROC_FT_CKPT
    got = ranks[0]["solve"]["ckpt"]
    assert got[0]["report"] == _report(gave_up)
    assert got[0]["resumed_from"] is None
    assert got[1]["report"] == _report(resumed)
    assert got[1]["resumed_from"] == at
    for j in range(2):
        _same_ranks(ranks, lambda r: r["solve"]["ckpt"][j]["x"])
        _same_ranks(ranks, lambda r: r["solve"]["ckpt"][j]["report"])
    # only rank 0 writes: every chunk's save of both runs
    assert ranks[0]["solve"]["writes"][:2] == [25, 50]
    assert all(r["solve"]["writes"] == [] for r in ranks[1:])


def test_grid_checkpoint_resumes_a_one_process_solve(sides):
    _, _, dirs = sides
    case, _, (resumed, at) = CHIP.PROC_FT_CKPT
    got = C.ft_solve(tile_engine(case), case, dirs["solve_grid_gave_up"],
                     fault=False)
    assert got["report"] == _report(resumed) and got["resumed_from"] == at


def test_one_process_checkpoint_resumes_on_the_grid(sides):
    _, ranks, _ = sides
    case, _, (resumed, at) = CHIP.PROC_FT_CKPT
    tile = C.ft_solve(tile_engine(case), case, None, fault=False)
    got = ranks[0]["solve"]["ckpt_from_tile"]
    assert got["report"] == _report(resumed) and got["resumed_from"] == at
    assert np.abs(got["x"] - tile["x"]).max() <= 1e-6
    _same_ranks(ranks, lambda r: r["solve"]["ckpt_from_tile"]["x"])


def _same_json(out, jout):
    """tests/test_torch_faults.py's comparison of two --inject JSONs."""
    assert set(out) == set(jout)
    for k, v in jout.items():
        if k in ("rel_residual", "rel_error"):
            np.testing.assert_allclose(out[k], v, rtol=1e-6)
        elif k == "faults":
            assert [{f: d[f] for f in d if f != "rel_true"} for d in out[k]] == \
                [{f: d[f] for f in d if f != "rel_true"} for d in v]
            np.testing.assert_allclose([d["rel_true"] for d in out[k]],
                                       [d["rel_true"] for d in v], rtol=1e-6)
        else:
            assert out[k] == v, k


def _one_process_cli(kind, capsys) -> tuple:
    with clock.override(clock.FakeClock()):
        code = solve_cli.main(C.cli_argv(kind))
    return code, json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("kind", C.CLI_KINDS)
def test_solve_cli_processes_inject_equals_one_process_and_jax(sides, kind,
                                                               capsys):
    meta, ranks, _ = sides
    code, one = _one_process_cli(kind, capsys)
    jcode, jout = meta["cli"][kind]
    rcode, many = ranks[0]["solve"]["cli"][kind]
    assert code == jcode == rcode == 0
    assert many.pop("processes") == 4
    _same_json(many, one)
    assert one.pop("device") == "cpu"
    _same_json(one, jout)
    for r in ranks[1:]:
        assert r["solve"]["cli"][kind] == (rcode, None)   # rank 0 prints


def test_solve_cli_processes_inject_spawned(capsys, tmp_path):
    """``--processes --inject`` spawns its ranks and resumes from its
    ``--checkpoint-dir``.  The spawned ranks time their chunks on the real
    clock, so ``straggler_chunks`` depends on the machine's load; the
    ranks' own CLI runs hold it under a fake clock."""
    argv = C.cli_argv("nan") + ["--checkpoint-dir", str(tmp_path)]
    code, one = _one_process_cli("nan", capsys)
    for run in range(2):
        assert solve_cli.main(argv + ["--processes"]) == 0
        many = json.loads(capsys.readouterr().out)
        assert many.pop("processes") == 4
        assert isinstance(many.pop("straggler_chunks"), list)
        if run == 0:
            want = {k: v for k, v in one.items() if k != "straggler_chunks"}
            _same_json(many, want)
        else:
            assert many["resumed_from"] == one["iterations"]
            assert many["status"] == "converged"


# -- training -------------------------------------------------------------------


def _one_process_runs(tmp):
    """The port's one-process manager from the seed state: the resume
    and the NaN scenarios."""
    cfg = C.cfg_of()
    step = T.build_train_step(cfg, C.optimizer(), donate=True)
    rm = ft.RestartManager(str(tmp / "resume"), save_every=C.SAVE_EVERY)
    with pytest.raises(RuntimeError, match="injected failure"):
        rm.run(C.seed_state(cfg), step, C.pipe(cfg), C.STEPS,
               inject_failure_at=C.FAIL_AT)
    resume = rm.run(C.seed_state(cfg), step, C.pipe(cfg), C.STEPS)
    rm = ft.RestartManager(str(tmp / "nan"), save_every=C.SAVE_EVERY)
    nan = rm.run(C.seed_state(cfg), C.nan_once(step, C.NAN_AT, C.pipe(cfg)),
                 C.pipe(cfg), C.STEPS)
    return resume, nan


def _jax_runs(tmp):
    """JAX's ``RestartManager`` from the same state: the two scenarios."""
    cfg = _jax_cfg()
    step = jax.jit(JT.build_train_step(cfg, _jax_opt()))
    pipe = JPipe(cfg.vocab_size, batch=C.BATCH, seq_len=C.SEQ, seed=0)
    rm = JRestartManager(str(tmp / "jresume"), save_every=C.SAVE_EVERY)
    with pytest.raises(RuntimeError):
        rm.run(jax_seed_state(), step, pipe, C.STEPS,
               inject_failure_at=C.FAIL_AT)
    resume = rm.run(jax_seed_state(), step, pipe, C.STEPS)
    rm = JRestartManager(str(tmp / "jnan"), save_every=C.SAVE_EVERY)
    bad = pipe.batch_at(C.NAN_AT)["tokens"]
    seen = []

    def nan_step(state, batch):
        new, m = step(state, batch)
        if not seen and np.array_equal(np.asarray(batch["tokens"]), bad):
            seen.append(1)
            rm.mgr.wait()              # a save in flight lands first
            m = dict(m, loss=m["loss"] * float("nan"))
        return new, m

    nan = rm.run(jax_seed_state(), nan_step, pipe, C.STEPS)
    return resume, nan


@pytest.fixture(scope="module")
def train_refs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("procft_train")
    return _one_process_runs(tmp), _jax_runs(tmp)


def test_grid_restart_resumes_like_one_process_and_jax(sides, train_refs):
    _, ranks, _ = sides
    (one, _), (jone, _) = train_refs
    got = ranks[0]["train"]["resume"]
    want = [one.resumed_from, int(one.state.step), len(one.losses),
            one.nan_rollbacks]
    assert want == C.counts(jone) == [C.FAIL_AT - C.FAIL_AT % C.SAVE_EVERY,
                                      C.STEPS, 4, 0]
    assert [got["resumed_from"], got["step"], len(got["losses"]),
            got["nan_rollbacks"]] == want
    np.testing.assert_allclose(got["losses"], one.losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["losses"], jone.losses, rtol=LOSS_RTOL)
    for r in ranks:
        assert r["train"]["raised"] == f"injected failure at step {C.FAIL_AT}"
    _same_ranks(ranks, lambda r: r["train"]["resume"]["losses"])


def test_grid_nan_rollback_like_one_process_and_jax(sides, train_refs):
    _, ranks, _ = sides
    (_, one), (_, jone) = train_refs
    got = ranks[0]["train"]["nan"]
    assert got["counts"] == C.counts(one) == C.counts(jone)
    assert got["counts"][3] == 1
    np.testing.assert_allclose(got["losses"], one.losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["losses"], jone.losses, rtol=LOSS_RTOL)
    _same_ranks(ranks, lambda r: r["train"]["nan"]["losses"])
    _same_ranks(ranks, lambda r: r["train"]["nan"]["counts"])


def test_donating_step_raises_on_every_rank_with_no_checkpoint(sides):
    _, ranks, _ = sides
    for r in ranks:
        assert "no checkpoint to roll back to" in r["train"]["donate_raise"]


def _files(d: Path) -> dict:
    return {p.relative_to(d).as_posix(): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("dtype", C.SAVE_DTYPES)
def test_placed_save_is_the_one_process_save(sides, dtype, tmp_path):
    _, ranks, dirs = sides
    whole = C.seed_state(C.cfg_of(dtype))
    ckpt.save(whole, str(tmp_path), 1)
    got, want = _files(Path(dirs["save"]) / dtype), _files(tmp_path)
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    if dtype == "bfloat16":
        man = json.loads(want["step_00000001/manifest.json"])
        assert "bfloat16" in {v["dtype"] for v in man["leaves"].values()}
        # rank 0 held the host copies of the whole state, the others none
        stats = [r["train"]["save_stats"] for r in ranks]
        total = sum(v.nbytes for v in ckpt._host_tree(whole).values())
        assert stats[0]["host_bytes"] == total
        assert all(s["host_bytes"] == 0 for s in stats[1:])


def test_grid_checkpoint_restores_in_jax(sides):
    _, _, dirs = sides
    state = C.seed_state(C.cfg_of())
    jstate, used = JC.restore(jax_seed_state(), os.path.join(dirs["save"],
                                                            "float32"))
    assert used == 1
    want = convert.train_state_to_numpy(state)
    for field in ("params", "opt_state"):
        for a, b in zip(jax.tree.leaves(getattr(jstate, field)),
                        jax.tree.leaves(want[field])):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def test_jax_checkpoint_restores_onto_the_grid(sides):
    _, ranks, _ = sides
    whole = {k: np.asarray(v) for k, v in ckpt._host_tree(
        C.seed_state(C.cfg_of())).items()}
    for r in ranks:
        got = r["train"]["jax_restored"]
        assert got["step"] == 0 and set(got["held"]) == set(whole)
        for key, arr in whole.items():
            sl = tuple(slice(a, b) for a, b in got["index"][key])
            assert np.array_equal(got["held"][key], arr[sl]), key


def test_train_cli_mesh_ckpt_dir_reaches_the_manager(monkeypatch, capsys,
                                                     tmp_path):
    """``--mesh single --ckpt-dir`` no longer exits 2: under a world of the
    mesh's 256 ranks ``_mesh_main`` hands the directory and ``--save-every``
    to ``train_on_mesh``; rank 0's JSON adds ``resumed_from`` and
    ``nan_rollbacks``."""
    from repro_torch.launch import mesh as mesh_mod

    calls = []

    class Rank0:
        rank = 0

    def fake_train(mesh, cfg, **kw):
        calls.append(kw)
        return {"losses": [1.0, 0.5], "step_ms": [10.0, 9.0],
                "split_kinds": {}, "resumed_from": 4, "nan_rollbacks": 1}

    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "256")
    monkeypatch.setattr(mesh_mod, "make_process_mesh",
                        lambda *a, **k: Rank0())
    monkeypatch.setattr(train_cli, "train_on_mesh", fake_train)
    code = train_cli.main(["--arch", "granite-3-8b", "--smoke", "--mesh",
                           "single", "--device", "cpu", "--steps", "2",
                           "--ckpt-dir", str(tmp_path), "--save-every", "3"])
    assert code == 0
    assert calls[0]["ckpt_dir"] == str(tmp_path) and calls[0]["save_every"] == 3
    out = json.loads(capsys.readouterr().out)
    assert out["resumed_from"] == 4 and out["nan_rollbacks"] == 1
    assert out["processes"] == 256 and out["losses"] == [1.0, 0.5]


@pytest.mark.parametrize("shape", [(0,), (7,), (8192,), (8193,), (300, 333),
                                   (2, 1024, 600), (1, 2_000_003)])
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16", "int32"])
def test_manifest_sum_is_numpys(shape, dtype):
    """The manifest's content sum, taken a block at a time on threads
    (``checkpoint.manager._f64_sum``), is the JAX package's
    ``np.sum(arr.astype(np.float64))`` bit for bit."""
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape) * 10.0 ** rng.uniform(-6, 6, shape)
    if dtype == "bfloat16":
        arr = (x.astype(np.float32).view(np.uint32) >> 16).astype(
            np.uint16).view(ckpt._BF16)
        want = ckpt._f64(arr)
    else:
        arr = x.astype(dtype)
        want = arr.astype(np.float64)
    assert ckpt._f64_sum(arr) == (float(np.sum(want)) if arr.size else 0.0)
