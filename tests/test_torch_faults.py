"""Fault injection and fault-tolerant solves of the port, held to the JAX
package on the same numpy inputs (CPU, float64 unless stated).

* Templates and corruption: ``vals_template`` / ``cols_template`` bitwise
  the JAX engine's; ``corrupt_vals`` bitwise JAX's for every kind, at f64
  and f32, over several seeds and counts; ``FaultSpec`` validation and the
  injector's schedule (transient, persistent, restart) as in JAX.
* Injectable plans (the scenarios of ``tests/test_guards.py``, extended to
  every method, 1-D and k = 4, Jacobi and block-IC(0)): a clean call is
  bitwise the non-injectable plan's; a NaN word, an indefinite entry and
  an exponent bit-flip each give the JAX package's iters, status and
  bad_iter; a clean call after a corrupted one is bitwise the clean result
  again; one build (``traces == 1``) over clean, corrupt, clean; the
  engine's own values and ``engine.spmv`` unchanged; the refusals (pinned
  format, stencil, a plan that is not injectable, a wrong shape) raise as
  in JAX.
* ``SolveRestartManager`` (the scenarios of ``tests/test_faults.py`` and
  ``chip_smoke.FT_PARITY``, which these tests hold to the JAX package):
  status, iterations, chunks, restarts, resumed_from and each fault's
  label / global_iter / bad_iter equal to JAX's, x and rel_residual within
  1e-9 / rtol 1e-6 (summation order only); the audit's labels, silent
  corruption included; a delay lands in the straggler report; a
  checkpointed solve recovers, and a fresh manager resumes; the
  ``repro_ft_*`` counters and the ``ft_chunk`` span.
* ``python -m repro_torch.launch.solve --inject ...``: the JSON of the
  JAX module's own example, and of a ``--checkpoint-dir`` run and its
  resumed rerun, equal to ``repro.launch.solve``'s.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

import repro.ft as jft
from repro.obs import clock as jax_clock
from repro.core import AzulEngine as JaxEngine
from repro.core import SolveSpec as JaxSpec
from repro.data.matrices import laplacian_2d as jax_lap2d
from repro.launch import solve as jax_solve_cli
from repro_torch import ft
from repro_torch.core import AzulEngine, SolveSpec
from repro_torch.core.stencil import lap2d_stencil
from repro_torch.data.matrices import laplacian_2d
from repro_torch.launch import solve as solve_cli
from repro_torch.obs import clock
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.faults

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-8
K = 4
METHODS = ("pcg", "pcg_tol", "cg", "pcg_pipelined_tol", "jacobi")
FAULT_LABELS = ("breakdown", "diverged", "stagnated", "silent_corruption",
                "nonfinite_x")


@pytest.fixture(autouse=True)
def _format_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "port.json"))


def _engines(n, precond="jacobi", dtype=np.float64):
    m = laplacian_2d(n)
    eng = AzulEngine(m, precond=precond, dtype=dtype, device="cpu")
    jeng = JaxEngine(jax_lap2d(n), precond=precond, dtype=dtype)
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    return eng, jeng, a


def _rhs(a, batch=None, seed=0):
    rng = np.random.default_rng(seed)
    if batch is None:
        return a @ rng.standard_normal(a.shape[0])
    return rng.standard_normal((batch, a.shape[0])) @ a.T


# -- templates and corruption --------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_templates_equal_jax(dtype):
    eng, jeng, _ = _engines(16, dtype=dtype)
    v, jv = eng.vals_template(), jeng.vals_template()
    assert v.dtype == jv.dtype and v.tobytes() == jv.tobytes()
    c, jc = eng.cols_template(), jeng.cols_template()
    assert c.dtype == jc.dtype and np.array_equal(c, jc)
    v[0, 0] = 123.0                        # a copy: the engine stays clean
    assert eng.vals_template().tobytes() == jv.tobytes()
    for e in (eng, jeng):
        with pytest.raises(ValueError, match="halo faults need a distributed"):
            e.halo_entry_mask()
    st = AzulEngine(lap2d_stencil(8), dtype=np.float64, device="cpu")
    for fn in (st.vals_template, st.cols_template, st.vals_operand):
        with pytest.raises(ValueError, match="stencil engines store no"):
            fn()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ft.inject.FAULT_KINDS)
def test_corrupt_vals_bitwise_jax(kind, dtype):
    eng, jeng, _ = _engines(16, dtype=dtype)
    clean = eng.vals_template()
    # the halo kinds take a mask; a local engine has none, so both packages
    # get the same made-up one (every stored entry right of the diagonal)
    mask = (eng.cols_template() > np.arange(clean.shape[0])[:, None]) & (clean != 0)
    for seed in (0, 1, 7):
        for count in (1, 3):
            kw = dict(kind=kind, seed=seed, count=count, bit=52 + seed)
            got = ft.corrupt_vals(clean, ft.FaultSpec(**kw), mask)
            want = jft.corrupt_vals(clean, jft.FaultSpec(**kw), mask)
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
            if kind == "delay":
                assert got is clean
            else:
                assert got is not clean
    if kind in ("halo_drop", "halo_perturb"):
        with pytest.raises(ValueError, match="halo"):
            ft.corrupt_vals(clean, ft.FaultSpec(kind=kind))
        with pytest.raises(ValueError, match="halo"):
            ft.FaultInjector(eng, ft.FaultSpec(kind=kind))
    assert clean.tobytes() == jeng.vals_template().tobytes()


def test_fault_spec_validation_and_schedule_equal_jax():
    for bad, match in ((dict(kind="gamma_ray"), "unknown fault kind"),
                       (dict(count=0), "count"), (dict(iteration=-1), "iteration")):
        with pytest.raises(ValueError, match=match):
            ft.FaultSpec(**bad)
        with pytest.raises(ValueError, match=match):
            jft.FaultSpec(**bad)
    eng, jeng, _ = _engines(8)
    windows = [(0, 25), (25, 50), (50, 75), (30, 31), (31, 40)]
    for transient in (True, False):
        spec = dict(kind="nan", iteration=30, transient=transient)
        inj, jinj = ft.FaultInjector(eng, ft.FaultSpec(**spec)), \
            jft.FaultInjector(jeng, jft.FaultSpec(**spec))
        for _ in range(2):
            for lo, hi in windows:
                assert inj.fires_in(lo, hi) == jinj.fires_in(lo, hi)
                got, want = inj.vals_for(lo, hi), jinj.vals_for(lo, hi)
                assert (got is None) == (want is None)
                if got is not None:
                    assert got.tobytes() == want.tobytes()
            assert inj.fired == jinj.fired
            inj.restart()
            jinj.restart()


# -- injectable plans ------------------------------------------------------------


def _corruptions(eng):
    """A NaN word (a breakdown before the loop), an indefinite entry (a
    breakdown mid-run) and an exponent bit-flip of two words."""
    clean = eng.vals_template()
    nan = ft.corrupt_vals(clean, ft.FaultSpec(kind="nan", seed=1))
    indef = clean.copy()
    slot = np.flatnonzero(eng.cols_template()[1] == 1)[0]
    indef[1, slot] *= -1000.0
    flip = ft.corrupt_vals(clean, ft.FaultSpec(kind="bitflip", seed=3, count=2))
    return {"nan": nan, "indefinite": indef, "bitflip": flip}


def _spec_kw(method):
    if method.endswith("_tol"):
        return dict(tol=TOL, max_iters=60)
    return dict(iters=40)


INJECTABLE_CASES = ([(m, "jacobi") for m in METHODS]
                    + [(m, "block_ic0") for m in ("pcg_tol", "pcg_pipelined_tol")])


@pytest.mark.parametrize("batch", [None, K])
@pytest.mark.parametrize("method,precond", INJECTABLE_CASES)
def test_injectable_plan_equals_jax(method, precond, batch):
    eng, jeng, a = _engines(10, precond)
    b = _rhs(a, batch)
    kw = dict(method=method, batch=batch, **_spec_kw(method))
    plain = eng.plan(SolveSpec(**kw))
    plan = eng.plan(SolveSpec(injectable=True, **kw))
    jplan = jeng.plan(JaxSpec(injectable=True, **kw))
    assert plan is not plain and plan.spec.injectable and plan.spec.format == "ell"
    assert plan.info["substrate"] == plain.info["substrate"]
    vals0 = eng.ell.vals.clone()
    xs = np.random.default_rng(5).standard_normal(eng.n)
    y0 = eng.spmv(xs)

    x_ref, n_ref = plain(b)
    x, nrm = plan(b)
    assert np.array_equal(x, x_ref) and np.array_equal(nrm, n_ref, equal_nan=True)
    for label, bad in _corruptions(eng).items():
        xb, _ = plan(b, vals=bad)
        jplan(b, vals=bad)
        for got, want in ((plan.last_iters, jplan.last_iters),
                          (plan.last_status, jplan.last_status),
                          (plan.last_bad_iter, jplan.last_bad_iter)):
            assert np.array_equal(np.asarray(got), np.asarray(want)), label
        if method != "jacobi" and label != "bitflip":   # the guards froze it
            assert "breakdown" in np.atleast_1d(plan.last_status_names), label
        x2, n2 = plan(b)                        # clean again, same program
        assert np.array_equal(x2, x_ref), label
        assert np.array_equal(n2, n_ref, equal_nan=True), label
    assert plan.traces == 1 and plan.executions == 7
    plan.assert_steady()
    assert bool((eng.ell.vals == vals0).all())
    assert np.array_equal(eng.spmv(xs), y0)


def test_injectable_plan_skips_the_copy_when_clean(monkeypatch):
    eng, _, a = _engines(8)
    b = _rhs(a)
    plan = eng.plan(SolveSpec(method="pcg_tol", tol=TOL, injectable=True))
    assert plan.vals is not eng.ell.vals
    assert plan.vals.data_ptr() != eng.ell.vals.data_ptr()
    calls = []
    real = type(plan.vals).copy_
    def copy_(self, src, *a, **k):
        if self is plan.vals:
            calls.append(src.device)
        return real(self, src, *a, **k)

    monkeypatch.setattr(type(plan.vals), "copy_", copy_)
    plan(b)                                     # clean at build: no copy
    plan(b, vals=eng.vals_template())           # an upload
    plan(b)                                     # back to clean: one copy
    plan(b)                                     # clean already: none
    assert len(calls) == 2


def test_injectable_hlo_summary_equals_jax():
    eng, jeng, _ = _engines(8)
    plan = eng.plan(SolveSpec(method="pcg_tol", injectable=True))
    jplan = jeng.plan(JaxSpec(method="pcg_tol", injectable=True))
    assert plan.hlo_summary() == jplan.hlo_summary()
    assert plan.traces == jplan.traces == 0


def test_injectable_refusals_equal_jax():
    eng, jeng, a = _engines(8)
    b = _rhs(a)
    for e, Spec in ((eng, SolveSpec), (jeng, JaxSpec)):
        for fmt in ("bcsr", "sell", "hyb"):
            with pytest.raises(ValueError, match="conflicts with injectable"):
                e.plan(Spec(method="pcg_tol", injectable=True, format=fmt))
        with pytest.raises(ValueError, match="injectable must be True or False"):
            e.plan(Spec(method="pcg_tol", injectable="yes"))
        plain = e.plan(Spec(method="pcg_tol", tol=TOL))
        with pytest.raises(ValueError, match="injectable=True to pass vals"):
            plain(b, vals=e.vals_template())
        plan = e.plan(Spec(method="pcg_tol", tol=TOL, injectable=True))
        with pytest.raises(ValueError, match="packed value-buffer shape"):
            plan(b, vals=e.vals_template()[:-1])
    # an engine's format knob yields to an injectable plan
    for fmt in ("bcsr", "hyb"):
        pe = AzulEngine(laplacian_2d(8), dtype=np.float64, format=fmt, device="cpu")
        je = JaxEngine(jax_lap2d(8), dtype=np.float64, format=fmt)
        ps = pe.plan(SolveSpec(method="pcg_tol", injectable=True)).spec
        js = je.plan(JaxSpec(method="pcg_tol", injectable=True)).spec
        assert ps.format == js.format == "ell"
    st = AzulEngine(lap2d_stencil(8), dtype=np.float64, device="cpu")
    with pytest.raises(ValueError, match="needs stored matrix values"):
        st.plan(SolveSpec(method="pcg_tol", injectable=True))


# -- SolveRestartManager ----------------------------------------------------------


def _same_report(rep, jrep):
    for f in ("status", "iterations", "chunks", "restarts", "resumed_from",
              "straggler_chunks"):
        assert getattr(rep, f) == getattr(jrep, f), f
    assert len(rep.faults) == len(jrep.faults)
    for got, want in zip(rep.faults, jrep.faults):
        for f in ("chunk", "global_iter", "label", "bad_iter"):
            assert got[f] == want[f], f
    np.testing.assert_allclose(rep.x, jrep.x, rtol=0, atol=1e-9)
    np.testing.assert_allclose(rep.rel_residual, jrep.rel_residual, rtol=1e-6)


def _managers(eng, jeng, method="pcg_tol", max_iters=400, **kw):
    return (ft.SolveRestartManager(eng, SolveSpec(method=method, tol=TOL,
                                                  max_iters=max_iters), **kw),
            jft.SolveRestartManager(jeng, JaxSpec(method=method, tol=TOL,
                                                  max_iters=max_iters), **kw))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP = _chip_smoke()


@pytest.fixture(scope="module")
def lap16():
    """lap2d_16 engines of both packages, Jacobi and block-IC(0), and the
    right-hand side of chip_smoke's FT_PARITY."""
    m = laplacian_2d(16)
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    x_true = np.random.default_rng(0).standard_normal(m.shape[0])
    port, jax = {}, {}
    for pre in ("jacobi", "block_ic0"):
        port[pre] = (AzulEngine(m, precond=pre, dtype=np.float64, format="ell",
                                device="cpu"), ft, SolveSpec)
        jax[pre] = (JaxEngine(jax_lap2d(16), precond=pre, dtype=np.float64,
                              format="ell"), jft, JaxSpec)
    return port, jax, a @ x_true, x_true


@pytest.mark.parametrize("case,want", CHIP.FT_PARITY,
                         ids=[str(i) for i in range(len(CHIP.FT_PARITY))])
def test_ft_scenarios_equal_jax_and_chip_smoke(lap16, case, want):
    """The scenarios of tests/test_faults.py and a few more (a silent
    corruption caught by the audit, a low bit flip that is no fault, a
    stuck-at NaN): both packages' reports equal each other and
    chip_smoke.FT_PARITY, which holds the card to them."""
    port, jax, b, x_true = lap16
    rep = CHIP.ft_scenario(port, case, b)
    jrep = CHIP.ft_scenario(jax, case, b)
    _same_report(rep, jrep)
    assert CHIP.ft_summary(jrep) == want
    assert CHIP.ft_summary(rep) == want
    assert isinstance(rep, ft.FTSolveReport)
    if rep.status == "converged":
        assert rep.rel_residual <= ft.SolveRestartManager.TRUE_RESIDUAL_SLACK * TOL
        assert np.allclose(rep.x, x_true, atol=1e-5)
    else:
        assert rep.status in FAULT_LABELS


@pytest.mark.parametrize("status,x,claimed,true", [
    ("stagnated", 1.0, 1e-3, 1e-3), ("converged", np.nan, 1e-9, 1e-9),
    ("converged", 1.0, 1e-9, 2e-6), ("converged", 1.0, 1e-9, 5e-7),
    ("maxiter", 1.0, 1e-3, 0.2), ("maxiter", 1.0, 1e-3, 0.05)])
def test_audit_labels_equal_jax(status, x, claimed, true):
    """The audit's layers, silent corruption included: a chunk whose true
    residual is more than 100 x max(claimed, tol)."""
    eng, jeng, _ = _engines(8)
    mgr, jmgr = _managers(eng, jeng)
    xs = np.full(eng.n, x)
    assert mgr._audit(xs, status, claimed, true) == \
        jmgr._audit(xs, status, claimed, true)


def test_restart_manager_refusals_equal_jax():
    eng, jeng, _ = _engines(8)
    with pytest.raises(ValueError, match="tolerance"):
        ft.SolveRestartManager(eng, SolveSpec(method="pcg", iters=50))
    with pytest.raises(ValueError, match="tolerance"):
        jft.SolveRestartManager(jeng, JaxSpec(method="pcg", iters=50))
    with pytest.raises(TypeError, match="SolveSpec"):
        ft.SolveRestartManager(eng, JaxSpec(method="pcg_tol"))
    with pytest.raises(ValueError, match="chunk"):
        ft.SolveRestartManager(eng, SolveSpec(method="pcg_tol"), chunk=0)


def test_a_failing_chunk_raises():
    """Only a guard status or the audit starts a restart: a chunk whose
    plan raises (a kernel failure on the card) propagates, as in JAX."""
    eng, jeng, a = _engines(8)
    b = _rhs(a)
    calls = []

    def boom(b, x0=None, vals=None):
        calls.append(vals)
        raise RuntimeError("kernel failure")

    for m in _managers(eng, jeng, chunk=10):
        m._plan = boom
        with pytest.raises(RuntimeError, match="kernel failure"):
            m.solve(b)
    assert calls == [None, None]


def test_checkpointed_solve_resumes_and_recovers(tmp_path):
    eng, jeng, a = _engines(16)
    x_true = np.random.default_rng(0).standard_normal(a.shape[0])
    b = a @ x_true
    ck, jck = str(tmp_path / "port"), str(tmp_path / "jax")
    mgr, _ = _managers(eng, jeng, chunk=20, checkpoint_dir=ck)
    _, jmgr = _managers(eng, jeng, chunk=20, checkpoint_dir=jck)
    spec = dict(kind="nan", iteration=45, seed=2)
    rep = mgr.solve(b, injector=ft.FaultInjector(eng, ft.FaultSpec(**spec)))
    jrep = jmgr.solve(b, injector=jft.FaultInjector(jeng, jft.FaultSpec(**spec)))
    _same_report(rep, jrep)
    assert rep.status == "converged" and rep.restarts >= 1
    assert np.allclose(rep.x, x_true, atol=1e-5)
    # a fresh manager on the same directory resumes from the checkpoint
    mgr2, _ = _managers(eng, jeng, chunk=20, checkpoint_dir=ck)
    _, jmgr2 = _managers(eng, jeng, chunk=20, checkpoint_dir=jck)
    rep2, jrep2 = mgr2.solve(b), jmgr2.solve(b)
    _same_report(rep2, jrep2)
    assert rep2.resumed_from is not None and rep2.resumed_from > 0
    assert rep2.status == "converged" and rep2.iterations <= rep.iterations


def test_delay_fault_lands_in_straggler_report():
    eng, jeng, a = _engines(16)
    b = _rhs(a)
    mgr, jmgr = _managers(eng, jeng, chunk=5)
    mgr.timer = ft.StepTimer(deadline_factor=2.0)
    jmgr.timer = jft.StepTimer(deadline_factor=2.0)
    spec = dict(kind="delay", iteration=40, delay_s=0.4)
    inj, jinj = ft.FaultInjector(eng, ft.FaultSpec(**spec)), \
        jft.FaultInjector(jeng, jft.FaultSpec(**spec))
    rep, jrep = mgr.solve(b, injector=inj), jmgr.solve(b, injector=jinj)
    for r in (rep, jrep):
        assert r.status == "converged" and r.restarts == 0
        assert len(r.straggler_chunks) >= 1
    assert inj.fired == jinj.fired == 1
    assert (rep.iterations, rep.chunks) == (jrep.iterations, jrep.chunks)
    # the flagged chunk is the one the sleep landed in
    assert (40 // 5 + 1) in rep.straggler_chunks


def test_fault_metrics_and_span():
    from repro_torch import obs

    eng, _, a = _engines(8)
    b = _rhs(a)
    faults = obs.REGISTRY.get("repro_ft_faults_total")
    restarts = obs.REGISTRY.get("repro_ft_restarts_total")
    f0, r0 = faults.value(label="breakdown"), restarts.value()
    obs.TRACER.clear()
    mgr = ft.SolveRestartManager(eng, SolveSpec(method="pcg_tol", tol=TOL),
                                 chunk=10)
    rep = mgr.solve(b, injector=ft.FaultInjector(
        eng, ft.FaultSpec(kind="nan", iteration=12)))
    assert rep.restarts == 1
    assert faults.value(label="breakdown") == f0 + 1
    assert restarts.value() == r0 + 1
    spans = [s for s in obs.TRACER.spans() if s.name == "ft_chunk"]
    assert len(spans) == rep.chunks
    assert spans[0].attrs["global_iter"] == 0


# -- the CLI ------------------------------------------------------------------------


def _cli_json(main, argv, capsys):
    """(exit code, JSON) of a CLI run under both packages' fake clocks: the
    FT loops time their chunks with ``clock.now()``, so ``straggler_chunks``
    does not depend on the machine's load (a ``delay`` fault's
    ``time.sleep`` is not seen; ``test_delay_fault_lands_in_straggler_report``
    holds that on the real clock)."""
    with clock.override(clock.FakeClock()), \
            jax_clock.override(jax_clock.FakeClock()):
        rc = main(argv)
    return rc, json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("extra", [[], ["--inject", "delay", "--inject-at", "30"]])
def test_inject_cli_equals_jax(capsys, extra):
    args = ["--matrix", "lap2d_32", "--method", "pcg_tol", "--max-iters", "400",
            "--inject", "nan", "--inject-at", "15", "--ft-chunk", "20", *extra]
    jrc, jout = _cli_json(jax_solve_cli.main, args, capsys)
    rc, out = _cli_json(solve_cli.main, ["--device", "cpu", *args], capsys)
    assert rc == jrc == 0
    assert out.pop("device") == "cpu"
    _same_json(out, jout)
    assert out["status"] == "converged"
    if not extra:
        assert out["restarts"] >= 1


def _same_json(out, jout):
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


def test_inject_cli_checkpoint_dir_equals_jax(capsys, tmp_path):
    args = ["--matrix", "lap2d_32", "--method", "pcg_tol", "--max-iters", "400",
            "--inject", "bitflip", "--inject-at", "30", "--ft-chunk", "20"]
    for run in range(2):                      # the second run resumes
        jrc, jout = _cli_json(jax_solve_cli.main, [
            *args, "--checkpoint-dir", str(tmp_path / "jax")], capsys)
        rc, out = _cli_json(solve_cli.main, [
            "--device", "cpu", *args, "--checkpoint-dir", str(tmp_path / "port")],
            capsys)
        assert rc == jrc
        out.pop("device")
        _same_json(out, jout)
        assert (out["resumed_from"] is not None) == (run == 1)
    with pytest.raises(ValueError, match="halo"):
        solve_cli.main(["--device", "cpu", *args[:-4], "--inject", "halo_drop"])
