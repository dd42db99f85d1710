"""The port's SolveService held to the JAX package's, on the CPU.

Every non-distributed test of ``tests/test_service.py`` has a counterpart
here: the same matrices, right-hand sides and scripts go through
``repro.serve.SolveService`` and ``repro_torch.serve.SolveService(...,
device="cpu")``.  Per request the iterations and statuses are equal, and
``x`` and ``res_norms`` agree within ``max|d| <= 1e-9 * max|ref|`` (and
``rel_residual`` within that over ``||b||``).  The
port's own contracts hold bit for bit: a request that joins a running
cohort equals its solo solve (across the buckets k_pad 1, 2 and 4), the
shim equals a direct plan call, and no pool plan builds twice over 100
requests.  Eviction drops an operator's plans (their captured graphs and
pools on the card), and a reload builds each plan once again.
``chip_smoke.py``'s ``SERVICE_PARITY`` constants are the JAX service's.
"""

import gc
import importlib.util
import warnings
import weakref
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.core.plan import _reset_deprecation_warnings as jax_reset_warnings
from repro.data.matrices import laplacian_2d as jax_lap2d
from repro.data.matrices import suite as jax_suite
from repro.obs import clock as jax_clock
from repro.serve import SolveService as JaxService
from repro.serve import run_load as jax_run_load
from repro_torch import obs
from repro_torch.core import AzulEngine, SolveSpec
from repro_torch.core.plan import _reset_deprecation_warnings
from repro_torch.data.matrices import laplacian_2d
from repro_torch.data.matrices import suite as torch_suite
from repro_torch.obs.clock import FakeClock
from repro_torch.serve import (
    SolveRequestError,
    SolveServer,
    SolveService,
    run_load,
)
from repro_torch.serve.service import _Pending
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-8
REL = 1e-9
REPO = Path(__file__).resolve().parents[1]


def _csr(m):
    return sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)


def _rhs(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


def _pair(grid=8, chunk=8, max_batch=4, tol=TOL, name="lap", **kw):
    """The same operator registered on a JAX service and a port service."""
    out = []
    for svc_cls, lap, extra in ((JaxService, jax_lap2d, {}),
                                (SolveService, laplacian_2d,
                                 {"device": "cpu"})):
        svc = svc_cls(max_batch=max_batch, chunk=chunk, **kw, **extra)
        svc.register_operator(name, lap(grid), method="pcg_tol", tol=tol,
                              iters=400, precond="jacobi", dtype=np.float64)
        out.append(svc)
    return out[0], out[1], laplacian_2d(grid)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= REL * float(np.abs(want).max())


def _same(t, j):
    """A port outcome against the JAX service's outcome of the request."""
    assert t.iters == j.iters
    assert t.status == j.status
    assert t.batch_size == j.batch_size and t.requests == j.requests
    _close(t.x, j.x)
    _close(t.res_norms, j.res_norms)
    # rel_residual = trace[iters] / ||b||: the trace's tolerance over ||b||
    # (trace[0] = ||b||, x0 = 0)
    assert abs(t.rel_residual - j.rel_residual) <= REL * float(
        np.abs(j.res_norms).max() / j.res_norms[0])


def _counters(stats):
    """The stats dict less ``straggler_chunks``, which reads wall time."""
    return {k: v for k, v in stats.items() if k != "straggler_chunks"}


def _all_pool_plans(svc):
    for op in svc._operators.values():
        for pool in op.pools.values():
            yield from pool.values()


# -- continuous batching: the bitwise mid-stream join invariant --------------


def test_midstream_join_bitwise_identical_to_solo():
    jsolo, solo, m = _pair(8)
    n = m.shape[0]
    b_a, b_b = _rhs(n, 1), _rhs(n, 2)
    rid = solo.submit(b_b)
    ref = solo.drain()[rid]
    jrid = jsolo.submit(b_b)
    jref = jsolo.drain()[jrid]
    assert ref.status == "converged"
    _same(ref, jref)

    jsvc, svc, _ = _pair(8)
    ra = svc.submit(b_a)
    ja = jsvc.submit(b_a)
    for s in (svc, jsvc):
        s.tick()
        s.tick()
    assert svc.active() == 1
    rb = svc.submit(b_b)
    jb = jsvc.submit(b_b)
    done, jdone = svc.drain(), jsvc.drain()
    assert done[ra].status == "converged"
    got = done[rb]
    assert got.status == "converged" and got.iters == ref.iters
    assert np.array_equal(got.x, ref.x)                    # bitwise
    assert np.array_equal(got.res_norms, ref.res_norms)    # bitwise
    assert svc.stats["rebuckets"] >= 1
    _same(done[ra], jdone[ja])
    _same(got, jdone[jb])
    assert _counters(svc.stats) == _counters(jsvc.stats)


def test_join_bitwise_across_buckets_1_2_4():
    """A request that joins while the cohort's bucket moves 1 -> 2 -> 4
    ends with its solo solve's bits."""
    _, solo, m = _pair(8, max_batch=8)
    n = m.shape[0]
    bs = [_rhs(n, 30 + i) for i in range(4)]
    rid = solo.submit(bs[1])
    ref = solo.drain()[rid]
    _, svc, _ = _pair(8, max_batch=8)
    ids = [svc.submit(bs[0])]
    svc.tick()                            # k_pad 1
    ids.append(svc.submit(bs[1]))
    svc.tick()                            # k_pad 2
    ids += [svc.submit(bs[2]), svc.submit(bs[3])]
    done = svc.drain()                    # k_pad 4
    assert set(svc._operators["lap"].pools["cb"]) == {1, 2, 4}
    got = done[ids[1]]
    assert got.iters == ref.iters and got.status == ref.status
    assert np.array_equal(got.x, ref.x)
    assert np.array_equal(got.res_norms, ref.res_norms)


def test_midstream_join_bitwise_multi_operator_and_zero_retraces():
    outs = []
    for svc_cls, lap, extra in ((JaxService, jax_lap2d, {}),
                                (SolveService, laplacian_2d,
                                 {"device": "cpu"})):
        ma, mb = lap(8), lap(9)
        b_a, b_b = _rhs(ma.shape[0], 3), _rhs(mb.shape[0], 4)
        solo = svc_cls(max_batch=4, chunk=8, **extra)
        solo.register_operator("B", mb, method="pcg_tol", tol=TOL, iters=400)
        rid = solo.submit(b_b, "B")
        ref = solo.drain()[rid]
        svc = svc_cls(max_batch=4, chunk=8, **extra)
        svc.register_operator("A", ma, method="pcg_tol", tol=TOL, iters=400)
        svc.register_operator("B", mb, method="pcg_tol", tol=TOL, iters=400)
        ra = svc.submit(b_a, "A")
        svc.tick()
        rb = svc.submit(b_b, "B")
        done = svc.drain()
        assert done[ra].operator == "A" and done[rb].operator == "B"
        assert np.array_equal(done[rb].x, ref.x)
        assert np.array_equal(done[rb].res_norms, ref.res_norms)
        for plan in _all_pool_plans(svc):
            assert plan.traces == 1
        outs.append((done[ra], done[rb]))
    for j, t in zip(*outs):
        _same(t, j)


def test_steady_state_100_requests_zero_retraces():
    jsvc, svc, m = _pair(8, chunk=25, max_batch=8, tol=1e-6, queue_max=None)
    n = m.shape[0]
    rhs = np.random.default_rng(5).standard_normal((16, n))
    ids = [svc.submit(rhs[i % 16]) for i in range(100)]
    jids = [jsvc.submit(rhs[i % 16]) for i in range(100)]
    done, jdone = svc.drain(), jsvc.drain()
    assert len(done) == 100
    assert all(done[r].status == "converged" for r in ids)
    plans = list(_all_pool_plans(svc))
    assert plans
    for plan in plans:
        assert plan.traces == 1
        plan.assert_steady()
    assert svc.stats["plans"] <= 4
    assert svc.stats["chunks"] > len(plans)
    for r, jr in zip(ids, jids):
        _same(done[r], jdone[jr])
    assert _counters(svc.stats) == _counters(jsvc.stats)
    a = _csr(m)
    for i, rid in enumerate(ids[:5]):
        r = np.linalg.norm(rhs[i % 16] - a @ done[rid].x)
        assert r <= 1e-6 * np.linalg.norm(rhs[i % 16]) * 10


# -- admission control / backpressure ----------------------------------------


def test_structured_rejects():
    jsvc, svc, m = _pair(8, queue_max=2)
    n = m.shape[0]
    bad = _rhs(n)
    bad[3] = np.nan
    cases = [((_rhs(n), "nope"), {}, "operator_unknown"),
             ((_rhs(n + 1),), {}, "rhs_shape"),
             ((bad,), {}, "rhs_nonfinite"),
             ((_rhs(n),), {"tol": -1.0}, "tol"),
             ((_rhs(n),), {"max_iters": 0}, "max_iters"),
             ((_rhs(n),), {"deadline": -0.5}, "deadline"),
             ((np.array(["a"] * n, dtype=object),), {}, "rhs_not_array"),
             ((np.ones(n, complex),), {}, "rhs_dtype"),
             ((_rhs(n),), {"priority": "high"}, "priority")]
    for s in (svc, jsvc):
        for args, kw, reason in cases:
            with pytest.raises(SolveRequestError if s is svc else ValueError
                               ) as ei:
                s.submit(*args, **kw)
            assert ei.value.reason == reason
        s.submit(_rhs(n))
        s.submit(_rhs(n))
        with pytest.raises(ValueError) as ei:
            s.submit(_rhs(n))
        assert ei.value.reason == "queue_full"
        assert s.pending() == 2
        assert s.stats["rejected"] == 10
        assert s.stats["rejects"]["queue_full"] == 1
    assert svc.stats["rejects"] == jsvc.stats["rejects"]
    out, jout = svc.drain(), jsvc.drain()
    for r in out:
        _same(out[r], jout[r])


def test_admission_order_ages_old_low_priority_work():
    def mk(rid, pr, t, dl=None):
        return _Pending(rid=rid, op="o", b=None, tol=None, max_iters=None,
                        deadline=dl, priority=pr, t_submit=t)

    old_low = mk(0, 0.0, 0.0)
    new_high = mk(1, 5.0, 9.5)
    new_deadline = mk(2, 0.0, 9.5, dl=1.0)
    order = SolveService._admission_order(
        [new_deadline, new_high, old_low], now=10.0, aging=1.0)
    assert [p.rid for p in order] == [0, 1, 2]
    order = SolveService._admission_order(
        [old_low, new_high, new_deadline], now=10.0, aging=None)
    assert [p.rid for p in order] == [1, 2, 0]


def test_aging_admits_old_work_first_under_a_fake_clock():
    """Aging end to end: with one lane, an old low-priority request is
    admitted before a newer high-priority one, on both packages."""
    orders = []
    for svc_cls, lap, clk, extra in (
            (JaxService, jax_lap2d, jax_clock, {}),
            (SolveService, laplacian_2d, obs.clock, {"device": "cpu"})):
        with clk.override(clk.FakeClock()) as fake:
            svc = svc_cls(max_batch=1, chunk=8, aging=1.0, **extra)
            svc.register_operator("lap", lap(6), method="pcg_tol", tol=TOL,
                                  iters=400)
            n = 36
            busy = svc.submit(_rhs(n, 40))
            svc.tick()                        # the one lane is taken
            old = svc.submit(_rhs(n, 41), priority=0.0)
            fake.advance(10.0)
            new = svc.submit(_rhs(n, 42), priority=5.0)
            done = {}
            finish = []
            while svc.pending() or svc.active():
                got = svc.tick()
                done.update(got)
                finish += sorted(got)
            orders.append([busy, old, new] == finish)
    assert orders == [True, True]


def test_per_request_tol_and_max_iters_never_add_plans():
    jsvc, svc, m = _pair(8, chunk=8)
    n = m.shape[0]
    for s in (svc, jsvc):
        r1 = s.submit(_rhs(n, 7), tol=1e-3)
        s.loose = s.drain()[r1]
        s.plans_after = s.stats["plans"]
        r2 = s.submit(_rhs(n, 7), tol=1e-11)
        s.tight = s.drain()[r2]
        assert s.stats["plans"] == s.plans_after
        r3 = s.submit(_rhs(n, 7), tol=0.0, max_iters=5)
        s.capped = s.drain()[r3]
        assert s.stats["plans"] == s.plans_after
    assert svc.loose.status == svc.tight.status == "converged"
    assert svc.loose.iters < svc.tight.iters
    assert svc.loose.rel_residual <= 1e-3
    assert svc.tight.rel_residual <= 1e-11
    assert svc.capped.status == "maxiter" and svc.capped.iters >= 5
    for attr in ("loose", "tight", "capped"):
        _same(getattr(svc, attr), getattr(jsvc, attr))


def test_deadline_on_the_continuous_path():
    jsvc, svc, m = _pair(8, chunk=8)
    for s in (svc, jsvc):
        rid = s.submit(_rhs(m.shape[0]), tol=1e-20, deadline=0.0)
        s.out = s.drain()[rid]
        assert s.out.status == "deadline_exceeded"
        assert s.out.iters >= s.chunk
        assert s.stats["deadline_exceeded"] == 1
    _same(svc.out, jsvc.out)


def test_deadline_under_a_fake_clock_is_exact():
    """Deterministic deadlines: a chunk that takes no fake time never
    expires a request; the first chunk boundary after the clock passes
    the deadline retires it, with the work done so far."""
    with obs.clock.override(FakeClock()) as fake:
        _, svc, m = _pair(8, chunk=8)
        rid = svc.submit(_rhs(m.shape[0]), tol=1e-20, deadline=1.0)
        svc.tick()
        svc.tick()
        assert svc.active() == 1
        fake.advance(1.5)
        out = svc.tick()[rid]
    assert out.status == "deadline_exceeded"
    assert out.iters == 3 * svc.chunk


# -- operator registry: memory accounting, LRU eviction, reload --------------


def test_lru_eviction_and_lazy_reload():
    outs = []
    for svc_cls, lap, extra in ((JaxService, jax_lap2d, {}),
                                (SolveService, laplacian_2d,
                                 {"device": "cpu"})):
        big, small = lap(10), lap(6)
        svc = svc_cls(max_batch=2, chunk=8, **extra)
        i_big = svc.register_operator("big", big, method="pcg_tol", tol=TOL,
                                      iters=400)
        svc.memory_limit = i_big.bytes
        svc.register_operator("small", small, method="pcg_tol", tol=TOL,
                              iters=400)
        snap = svc.operators()
        assert not snap["big"].resident and snap["small"].resident
        assert snap["big"].evictable
        assert svc.stats["evictions"] == 1
        assert svc.resident_bytes() <= svc.memory_limit
        rid = svc.submit(_rhs(big.shape[0], 9), "big")
        out = svc.drain()[rid]
        assert out.status == "converged"
        assert svc.stats["reloads"] == 1
        assert svc.operators()["big"].resident
        outs.append((out, dict(svc.stats), svc.operators()))
    (jout, jstats, jops), (tout, tstats, tops) = outs
    _same(tout, jout)
    assert _counters(tstats) == _counters(jstats)
    assert {k: v.bytes for k, v in tops.items()} == {
        k: v.bytes for k, v in jops.items()}


def test_eviction_frees_the_plans_and_reload_builds_each_once():
    """An evicted operator's engine and plans are dropped (nothing keeps a
    plan, and with it a captured graph and its pool, alive); a reload
    builds each plan once again."""
    svc = SolveService(max_batch=2, chunk=8, device="cpu")
    big, small = laplacian_2d(10), laplacian_2d(6)
    svc.register_operator("big", big, method="pcg_tol", tol=TOL, iters=400)
    svc.register_operator("small", small, method="pcg_tol", tol=TOL,
                          iters=400)
    b = _rhs(big.shape[0], 9)
    rid = svc.submit(b, "big")
    first = svc.drain()[rid]
    op = svc._operators["big"]
    plans = [weakref.ref(p) for p in _all_pool_plans(svc)
             if p.engine is op.engine]
    engine = weakref.ref(op.engine)
    assert plans
    svc.memory_limit = svc.resident_bytes()
    svc.submit(_rhs(36, 1), "small")
    svc.drain()
    svc._fit_memory(svc._operators["big"].bytes, keep="small")
    assert not svc.operators()["big"].resident
    gc.collect()
    assert engine() is None
    assert all(p() is None for p in plans)
    rid = svc.submit(b, "big")
    again = svc.drain()[rid]
    assert svc.stats["reloads"] == 1
    assert np.array_equal(again.x, first.x)
    for plan in _all_pool_plans(svc):
        assert plan.traces == 1


def test_over_memory_reject_when_nothing_evictable():
    for engine_cls, svc_cls, lap, extra in (
            (None, JaxService, jax_lap2d, {}),
            (AzulEngine, SolveService, laplacian_2d, {"device": "cpu"})):
        if engine_cls is None:
            from repro.core import AzulEngine as engine_cls
            from repro.core import SolveSpec as spec_cls
        else:
            spec_cls = SolveSpec
        eng = engine_cls(lap(8), precond="jacobi", dtype=np.float64, **extra)
        svc = svc_cls(max_batch=2, chunk=8,
                      memory_limit=int(eng.device_bytes()), **extra)
        svc.register_operator("pinned", engine=eng,
                              spec=spec_cls(method="pcg_tol", tol=TOL,
                                            iters=400))
        assert not svc.operators()["pinned"].evictable
        with pytest.raises(ValueError) as ei:
            svc.register_operator("more", lap(6), method="pcg_tol",
                                  tol=TOL, iters=400)
        assert ei.value.reason == "over_memory"
        assert "more" not in svc.operators()


def test_unregister_refuses_busy_operator():
    _, svc, m = _pair(8)
    svc.submit(_rhs(m.shape[0]))
    svc.tick()
    assert svc.active() == 1
    with pytest.raises(ValueError, match="busy"):
        svc.unregister_operator("lap")
    svc.drain()
    svc.unregister_operator("lap")
    assert svc.operators() == {}


# -- degradation and fixed-iteration methods on the continuous path ----------


class _BoomPlan:
    """Fused-plan double that explodes on execution (traces stays 1)."""

    info = {"fused": True}
    traces = 1

    def __init__(self):
        self.calls = 0

    def __call__(self, batch, x0=None):
        self.calls += 1
        raise RuntimeError("injected fused-kernel failure")


def test_degrades_to_reference_chunks_on_fused_failure():
    jsvc, svc, m = _pair(8, chunk=8)
    for s in (svc, jsvc):
        rid = s.submit(_rhs(m.shape[0], 11))
        s.boom = _BoomPlan()
        s._operators["lap"].pools["cb"][1] = s.boom
        s.out = s.drain()[rid]
        assert s.out.status == "converged"
        assert s.boom.calls >= 1
        assert s.stats["degraded_batches"] == s.boom.calls
    _same(svc.out, jsvc.out)
    b = _rhs(m.shape[0], 11)
    assert np.linalg.norm(b - _csr(m) @ svc.out.x) <= (
        TOL * np.linalg.norm(b) * 10)


def test_no_degradation_off_the_cpu():
    """On a card engine the reference substrate is the plain PyTorch
    version, so a fused chunk that fails raises to the caller: no retry,
    no reference plan built, ``degraded_batches`` stays 0.  Shown here on
    an engine whose device reads as the card (the injected plan never
    touches it)."""
    _, svc, m = _pair(8, chunk=8)
    op = svc._operators["lap"]
    op.engine.device = torch.device("cuda")
    boom = _BoomPlan()
    op.pools["cb"][1] = boom
    svc.submit(_rhs(m.shape[0], 11))
    with pytest.raises(RuntimeError, match="injected"):
        svc.tick()
    assert boom.calls == 1 and svc.stats["degraded_batches"] == 0
    assert not op.pools["cb_ref"] and not op.pools["ref"]


def test_fixed_iteration_method_serves_in_chunks():
    outs = []
    for svc_cls, lap, extra in ((JaxService, jax_lap2d, {}),
                                (SolveService, laplacian_2d,
                                 {"device": "cpu"})):
        svc = svc_cls(max_batch=2, chunk=10, **extra)
        svc.register_operator("lap", lap(8), method="pcg", iters=30,
                              precond="jacobi", dtype=np.float64)
        b = _rhs(64, 13)
        rid = svc.submit(b)
        out = svc.drain()[rid]
        assert out.status == "maxiter" and out.iters == -1
        assert np.all(np.isfinite(out.x))
        assert out.res_norms.shape[0] == 31
        assert np.linalg.norm(b - _csr(laplacian_2d(8)) @ out.x) < (
            1e-3 * np.linalg.norm(b))
        outs.append(out)
    _same(outs[1], outs[0])


# -- the load generator --------------------------------------------------------


@pytest.mark.parametrize("mode", ["open", "closed"])
def test_run_load_matches_jax_under_fake_clocks(mode):
    """run_load's open (Poisson arrivals, fake time) and closed loops end
    with the JAX harness's completions, statuses and retraces."""
    res = []
    for svc_cls, lap, clk, runner, extra in (
            (JaxService, jax_lap2d, jax_clock, jax_run_load, {}),
            (SolveService, laplacian_2d, obs.clock, run_load,
             {"device": "cpu"})):
        rhs = np.random.default_rng(3).standard_normal((6, 64))
        with clk.override(clk.FakeClock()):
            svc = svc_cls(max_batch=4, chunk=8, **extra)
            svc.register_operator("lap", lap(8), method="pcg_tol", tol=TOL,
                                  iters=400)
            out = runner(svc, lambda i: rhs[i % 6], mode=mode, requests=10,
                         rate=50.0, concurrency=3, seed=1)
        res.append(out)
    jout, tout = res
    for key in ("mode", "requests", "completed", "rejected", "statuses",
                "retraces"):
        assert tout[key] == jout[key], key
    assert set(tout) == set(jout)
    assert tout["completed"] == 10 and tout["retraces"] == 0


# -- the deprecated SolveServer shim -----------------------------------------


def test_solve_server_shim_warns_and_stays_on_the_plan_surface():
    m = laplacian_2d(8)
    eng = AzulEngine(m, precond="jacobi", dtype=np.float64, device="cpu")
    spec = SolveSpec(method="pcg_tol", tol=TOL, max_iters=200)
    _reset_deprecation_warnings()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        srv = SolveServer(eng, spec=spec)
    assert any(issubclass(w.category, DeprecationWarning)
               and "SolveService" in str(w.message) for w in rec)
    b = _rhs(m.shape[0], 17)
    rid = srv.submit(b)
    out = srv.step()[rid]
    plan = eng.plan(replace(srv._op.cspec, batch=1))
    x, norms = plan(b[None])
    assert np.array_equal(out.x, np.asarray(x)[0])
    assert out.status == "converged"

    from repro.core import AzulEngine as JaxEngine
    from repro.core import SolveSpec as JaxSpec
    from repro.serve import SolveServer as JaxServer

    jax_reset_warnings()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsrv = JaxServer(JaxEngine(jax_lap2d(8), precond="jacobi",
                                   dtype=np.float64),
                         spec=JaxSpec(method="pcg_tol", tol=TOL,
                                      max_iters=200))
    jrid = jsrv.submit(b)
    jout = jsrv.step()[jrid]
    _same(out, jout)
    # the legacy deadline path: real-tolerance chunks
    rid = srv.submit(b, deadline=100.0)
    jrid = jsrv.submit(b, deadline=100.0)
    _same(srv.drain()[rid], jsrv.drain()[jrid])
    assert _counters(srv.stats) == _counters(jsrv.stats)


# -- stats: the legacy dict shape, now a write-through registry view ---------


def test_stats_is_the_exact_legacy_dict_shape():
    _, svc, m = _pair(8)
    legacy = {
        "requests": 0, "batches": 0, "padded_rhs": 0, "plans": 0,
        "rejected": 0, "degraded_batches": 0, "deadline_batches": 0,
        "deadline_exceeded": 0, "straggler_chunks": [],
        "ticks": 0, "chunks": 0, "admitted": 0, "completed": 0,
        "rebuckets": 0, "padded_lanes": 0, "queue_peak": 0,
        "evictions": 0, "reloads": 0, "rejects": {},
    }
    assert dict(svc.stats) == legacy
    assert isinstance(svc.stats, dict)
    assert isinstance(svc.stats["rejects"], dict)

    rid = svc.submit(_rhs(m.shape[0], 23))
    out = svc.drain()[rid]
    assert out.status == "converged"
    assert svc.stats["requests"] == 1
    assert svc.stats["completed"] == 1
    assert svc.stats["ticks"] >= 1

    ev = obs.REGISTRY.get("repro_serve_events_total")
    label = svc._obs_label
    for key in ("requests", "completed", "ticks", "chunks"):
        assert ev.value(service=label, event=key) == svc.stats[key], key
    with pytest.raises(SolveRequestError):
        svc.submit(np.ones(3))
    assert svc.stats["rejected"] == 1
    reason = next(iter(svc.stats["rejects"]))
    rj = obs.REGISTRY.get("repro_serve_rejects_total")
    assert rj.value(service=label, reason=reason) == 1
    assert (obs.REGISTRY.get("repro_serve_resident_bytes")
            .value(service=label)) == svc.resident_bytes()
    assert (obs.REGISTRY.get("repro_serve_queue_peak")
            .value(service=label)) == svc.stats["queue_peak"]
    lat = obs.REGISTRY.get("repro_serve_request_seconds")
    assert lat.labels(service=label).count == 1
    chunks = obs.REGISTRY.get("repro_serve_chunk_seconds")
    assert chunks.labels(service=label).count == svc.stats["chunks"]
    outcomes = obs.REGISTRY.get("repro_serve_outcomes_total")
    assert outcomes.value(service=label, status="converged") == 1


def test_service_spans_and_straggler_watchdog_under_a_fake_clock():
    """tick and chunk spans land in the ring, and a chunk ten times the
    median is flagged by the StepTimer (stats and its counter)."""
    obs.TRACER.clear()
    with obs.clock.override(FakeClock()) as fake:
        _, svc, m = _pair(8, chunk=4)
        svc.submit(_rhs(m.shape[0], 2), tol=0.0, max_iters=40)
        plan = svc.plan_for("lap", 1, "cb")

        class Slow:
            info, traces = plan.info, 1
            last_iters, last_status_names = None, None

            def __call__(self, batch, x0=None):
                out = plan(batch, x0=x0)
                Slow.last_iters = plan.last_iters
                Slow.last_status_names = plan.last_status_names
                fake.advance(1.0 if svc.stats["chunks"] == 6 else 0.1)
                return out

        svc._operators["lap"].pools["cb"][1] = Slow()
        svc.drain()
    assert svc.stats["straggler_chunks"] == [7]
    assert (obs.REGISTRY.get("repro_serve_straggler_chunks_total")
            .value(service=svc._obs_label)) == 1
    chunks = [s for s in obs.TRACER.spans("chunk")
              if s.attrs.get("service") == svc._obs_label]
    ticks = [s for s in obs.TRACER.spans("tick")
             if s.attrs.get("service") == svc._obs_label]
    assert len(chunks) == svc.stats["chunks"] == 10
    assert len(ticks) == svc.stats["ticks"]
    assert [round(s.duration, 9) for s in chunks][5:8] == [0.1, 1.0, 0.1]


# -- chip_smoke.py's service parity constants --------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_service_parity_constants_match_jax():
    """chip_smoke.py holds the card's service to these per-request counts
    and statuses: they are the JAX service's, and the port's on the CPU
    equal them."""
    cs = _chip_smoke()
    assert set(cs.SERVICE_PARITY) == {"lap2d_32", "banded_1k", "lap3d_22"}
    jmats = jax_suite("small") | jax_suite("large")
    tmats = torch_suite("small") | torch_suite("large")
    for name, script in cs.SERVICE_PARITY.items():
        got = []
        for svc_cls, mats, extra in ((JaxService, jmats, {}),
                                     (SolveService, tmats, {"device": "cpu"})):
            svc = svc_cls(max_batch=script["max_batch"], chunk=script["chunk"],
                          **extra)
            svc.register_operator(name, mats[name], **cs.SERVICE_OPERATOR)
            outs = cs.service_script(svc, mats[name], script)
            got.append(outs)
            assert tuple(o.iters for o in outs) == script["iters"], name
            assert tuple(o.status for o in outs) == script["status"], name
            assert svc.stats["degraded_batches"] == 0
            assert svc.stats["rebuckets"] >= 1
        for t, j in zip(got[1], got[0]):
            _same(t, j)
