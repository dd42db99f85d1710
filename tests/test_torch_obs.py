"""``repro_torch.obs`` held to ``repro.obs``, on the CPU.

The counterparts of ``tests/test_obs.py``'s non-distributed tests, each
run through both packages where both have the piece:

1. **Exposition.**  The Prometheus text of the same registry operations
   is the golden text, byte for byte, from both packages; the snapshot,
   the registry's idempotence and the histogram quantiles agree.
2. **Bitwise identity.**  An instrumented solve returns exactly the bits
   of a bare one (``obs.disabled()``), single-RHS and batched, and agrees
   with the JAX package's solve within 1e-9 of max |x|.
3. **Deterministic time.**  A ``FakeClock`` makes spans, histograms, the
   straggler watchdog and the Chrome export exact.
4. **Bridges.**  ``set_torch_bridge`` opens a ``record_function`` per
   span (seen by ``torch.profiler``); no NVTX call is made where CUDA was
   never initialized.  The metrics server serves its three endpoints.

Tests that set a clock, a bridge or start a server restore it.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import repro.obs as jax_obs
from repro.core import AzulEngine as JaxEngine
from repro.core import SolveSpec as JaxSpec
from repro.data.matrices import laplacian_2d as jax_lap2d
from repro_torch import obs
from repro_torch.core import AzulEngine, SolveSpec
from repro_torch.data.matrices import laplacian_2d
from repro_torch.ft.straggler import StepTimer
from repro_torch.obs.clock import FakeClock
from torch_threads import one_torch_thread  # noqa: F401

GOLDEN = "\n".join([
    "# HELP depth current queue depth",
    "# TYPE depth gauge",
    "depth 2.5",
    "# HELP jobs_total jobs processed",
    "# TYPE jobs_total counter",
    'jobs_total{queue="fast"} 3',
    'jobs_total{queue="we\\"ird"} 1',
    "# HELP lat_seconds latency",
    "# TYPE lat_seconds histogram",
    'lat_seconds_bucket{le="0.01"} 1',
    'lat_seconds_bucket{le="0.1"} 1',
    'lat_seconds_bucket{le="1"} 2',
    'lat_seconds_bucket{le="+Inf"} 3',
    "lat_seconds_sum 50.505",
    "lat_seconds_count 3",
]) + "\n"


@pytest.fixture
def bridge():
    prev = obs.set_torch_bridge(True)
    try:
        yield
    finally:
        obs.set_torch_bridge(prev)


def _fill(mod):
    reg = mod.Registry()
    c = reg.counter("jobs_total", "jobs processed", ("queue",))
    c.inc(3, queue="fast")
    c.inc(queue='we"ird')
    reg.gauge("depth", "current queue depth").set(2.5)
    h = reg.histogram("lat_seconds", "latency", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.5, 50.0):
        h.observe(v)
    return reg


# -- exposition golden --------------------------------------------------------


def test_prometheus_golden_exact_text():
    assert obs.render_prometheus(_fill(obs)) == GOLDEN
    assert jax_obs.render_prometheus(_fill(jax_obs)) == GOLDEN


def test_snapshot_roundtrips_the_same_registry():
    snaps = []
    for mod in (obs, jax_obs):
        reg = mod.Registry()
        reg.counter("a_total", "a").inc(2)
        reg.histogram("h", "h", buckets=(1.0,)).observe(3.0)
        snaps.append(mod.snapshot(reg))
    snap = snaps[0]
    assert snap["a_total"]["samples"][0]["value"] == 2
    assert snap["h"]["samples"][0] == {
        "labels": {}, "sum": 3.0, "count": 1,
        "buckets": {"1": 0}, "overflow": 1}
    assert snaps[0] == snaps[1]
    assert obs.snapshot(_fill(obs)) == jax_obs.snapshot(_fill(jax_obs))


def test_registry_idempotent_and_mismatch_raises():
    reg = obs.Registry()
    a = reg.counter("x_total", "x", ("k",))
    assert reg.counter("x_total", "x", ("k",)) is a
    with pytest.raises(ValueError):
        reg.gauge("x_total", "x", ("k",))
    with pytest.raises(ValueError):
        reg.counter("x_total", "x", ("other",))
    with pytest.raises(ValueError):
        a.inc(-1, k="v")


def test_histogram_quantile_and_disabled_noop():
    hs = [m.Registry().histogram("q", "q", buckets=(0.1, 1.0, 10.0))
          for m in (obs, jax_obs)]
    for h in hs:
        for v in (0.05, 0.5, 0.5, 5.0):
            h.observe(v)
    for q in (0.0, 0.25, 0.5, 0.99, 1.0):
        assert hs[0].quantile(q) == hs[1].quantile(q)
    h = hs[0]
    assert h.quantile(0.5) == 1.0
    assert h.quantile(0.99) == 10.0
    with obs.disabled():
        h.observe(100.0)
        assert not obs.enabled()
    assert obs.enabled()
    assert h._default().count == 4
    assert obs.log_buckets(1e-3, 1.0, 2) == jax_obs.log_buckets(1e-3, 1.0, 2)
    assert obs.DEFAULT_LATENCY_BUCKETS == jax_obs.DEFAULT_LATENCY_BUCKETS


# -- bitwise identity ---------------------------------------------------------


def _solve_pair(spec_kwargs, b):
    """(instrumented bits, bare bits) from the SAME warm plan, and the JAX
    package's x on the same input."""
    eng = AzulEngine(laplacian_2d(16), precond="jacobi", dtype=np.float64,
                     device="cpu")
    plan = eng.plan(SolveSpec(**spec_kwargs))
    plan(b)
    x_on = plan(b)[0]
    with obs.disabled():
        x_off = plan(b)[0]
    jeng = JaxEngine(jax_lap2d(16), precond="jacobi", dtype=np.float64)
    x_jax = np.asarray(jeng.plan(JaxSpec(**spec_kwargs))(b)[0])
    return x_on, x_off, x_jax


@pytest.mark.parametrize("batch", [None, 3])
def test_instrumented_solve_bitwise_identical(batch):
    rng = np.random.default_rng(0 if batch is None else 1)
    n = laplacian_2d(16).shape[0]
    b = rng.standard_normal(n if batch is None else (batch, n))
    x_on, x_off, x_jax = _solve_pair(dict(method="pcg", iters=40,
                                          batch=batch), b)
    assert np.array_equal(x_on, x_off)
    assert np.abs(x_on - x_jax).max() <= 1e-9 * np.abs(x_jax).max()


def test_solve_instrumentation_records_metrics_and_spans():
    execs = obs.REGISTRY.counter("repro_solve_executions_total", "",
                                 ("method",))
    before = execs.value(method="pcg")
    solve_s = obs.REGISTRY.get("repro_solve_seconds").labels(method="pcg")
    compile_s = obs.REGISTRY.get("repro_plan_compile_seconds").labels(
        method="pcg")
    warm0, cold0 = solve_s.count, compile_s.count
    misses0 = obs.REGISTRY.get("repro_plan_cache_misses_total").value()
    hits0 = obs.REGISTRY.get("repro_plan_cache_hits_total").value()
    obs.TRACER.clear()
    eng = AzulEngine(laplacian_2d(8), precond="jacobi", dtype=np.float64,
                     device="cpu")
    plan = eng.plan(SolveSpec(method="pcg", iters=10))
    assert eng.plan(SolveSpec(method="pcg", iters=10)) is plan
    plan(np.ones(eng.n))
    plan(np.ones(eng.n))
    assert execs.value(method="pcg") - before == 2
    assert compile_s.count - cold0 == 1          # the call that built
    assert solve_s.count - warm0 == 1            # the warm call
    assert obs.REGISTRY.get("repro_plan_cache_misses_total").value() \
        - misses0 == 1
    assert obs.REGISTRY.get("repro_plan_cache_hits_total").value() \
        - hits0 == 1
    fmt = obs.REGISTRY.get("repro_plan_format_total")
    assert fmt.value(format="ell") >= 1
    assert obs.REGISTRY.get("repro_engine_device_bytes").value() == \
        eng.device_bytes()
    counts = obs.TRACER.counts()
    assert counts.get("solve", 0) >= 2
    assert counts.get("plan_build", 0) >= 1
    tr = plan.traces
    assert plan.hlo_summary() == {"count_by_op": {}, "total_count": 0.0}
    assert plan.traces == tr
    plan.assert_steady()
    retraces = obs.REGISTRY.get("repro_plan_retraces_total")
    r0 = retraces.value()
    plan.fn(eng.to_device_vec(np.ones((2, eng.n))),
            eng.to_device_vec(np.zeros((2, eng.n))))   # a new signature
    plan(np.ones(eng.n))
    assert retraces.value() == r0                # built outside a call
    with pytest.raises(RuntimeError, match="retraced"):
        plan.assert_steady()


# -- deterministic time (FakeClock) -------------------------------------------


def test_fake_clock_makes_spans_and_histograms_exact():
    tracer = obs.Tracer(capacity=8)
    h = obs.Registry().histogram("t", "t", buckets=(0.1, 1.0))
    with obs.clock.override(FakeClock()) as fake:
        with tracer.span("work", kind="chunk") as s:
            fake.advance(0.25)
        h.observe(obs.clock.now() - s.start)
    assert s.duration == 0.25
    assert h.quantile(0.5) == 1.0
    tracer.clear()
    with obs.clock.override(FakeClock()):
        for i in range(9):
            with tracer.span(f"s{i}", kind="x"):
                pass
    assert len(tracer.spans()) == 8 and tracer.dropped == 1
    assert tracer.counts() == {"x": 8}
    assert obs.clock.get_clock().__class__ is obs.clock.Clock


def test_fake_clock_sleep_advances_instead_of_blocking():
    with obs.clock.override(FakeClock(start=100.0)) as fake:
        t0 = obs.clock.now()
        obs.clock.sleep(5.0)
        assert obs.clock.now() - t0 == 5.0
        assert fake.now() == 105.0
    prev = obs.clock.set_clock(FakeClock(start=1.0))
    try:
        assert obs.clock.now() == 1.0
    finally:
        obs.clock.set_clock(prev)


def test_step_timer_straggler_detection_deterministic():
    from repro.ft.straggler import StepTimer as JaxTimer

    reports = []
    for timer_cls, clk in ((StepTimer, obs.clock), (JaxTimer, jax_obs.clock)):
        timer = timer_cls(window=50, deadline_factor=2.0)
        flags = obs.REGISTRY.get("repro_ft_straggler_flags_total")
        f0 = flags.value()
        with clk.override(clk.FakeClock()) as fake:
            for i in range(6):
                with timer.timing(i):
                    fake.advance(0.1)
            assert timer.last_report.is_straggler is False
            with timer.timing(6):
                fake.advance(1.0)
        rep = timer.last_report
        assert rep.is_straggler is True
        assert rep.duration == 1.0 and rep.median == 0.1
        assert rep.shed_advice == 1
        if timer_cls is StepTimer:
            assert flags.value() - f0 == 1
        reports.append(tuple(rep.__dict__.values()))
    assert reports[0] == reports[1]


def test_chrome_trace_export(tmp_path):
    tracer = obs.Tracer()
    with obs.clock.override(FakeClock(start=1.0)) as fake:
        with tracer.span("solve", kind="solve", matrix="lap2d_16"):
            fake.advance(0.5)
    path = tmp_path / "trace.json"
    assert tracer.export_chrome(str(path)) == 1
    ev = json.loads(path.read_text())["traceEvents"][0]
    assert ev == {"name": "solve", "cat": "solve", "ph": "X",
                  "ts": 1.0e6, "dur": 0.5e6, "pid": 0, "tid": 0,
                  "args": {"matrix": "lap2d_16"}}


# -- profiler bridges ----------------------------------------------------------


def test_torch_bridge_opens_record_function(bridge):
    tracer = obs.Tracer()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracer.span("chunk_under_test", kind="chunk"):
            torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert "chunk_under_test" in names
    assert obs.set_torch_bridge(True) is True     # the fixture's state


def test_no_nvtx_call_without_cuda(monkeypatch):
    def boom(*_):
        raise AssertionError("NVTX called on a CPU-only run")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", boom)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", boom)
    with obs.Tracer().span("x"):
        pass
    with obs.disabled(), obs.Tracer().span("y") as s:
        assert s is None


# -- HTTP exposition ----------------------------------------------------------


def test_metrics_server_serves_all_three_endpoints():
    reg = obs.Registry()
    reg.counter("up_total", "u").inc(7)
    tracer = obs.Tracer()
    with tracer.span("s", kind="tick"):
        pass
    with obs.start_metrics_server(port=0, registry=reg,
                                  tracer=tracer) as srv:
        base = f"http://{srv.host}:{srv.port}"
        assert srv.url == f"{base}/metrics"
        with urllib.request.urlopen(f"{base}/metrics") as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            assert b"up_total 7" in r.read()
        with urllib.request.urlopen(f"{base}/metrics.json") as r:
            assert json.load(r)["up_total"]["samples"][0]["value"] == 7
        with urllib.request.urlopen(f"{base}/trace.json") as r:
            assert len(json.load(r)["traceEvents"]) == 1
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/nope")
        assert ei.value.code == 404
