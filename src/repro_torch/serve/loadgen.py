"""Load generator for :class:`repro_torch.serve.SolveService` (port of
``repro.serve.loadgen``).

Drives the service's tick loop under a synthetic arrival process and
records per-request latency percentiles plus throughput;
``launch/serve.py --load-gen`` and ``chip_smoke.py``'s service phase run
through here.

Two arrival modes, the standard pair for latency/throughput curves:

* **open loop** (``mode="open"``): requests arrive on a schedule drawn
  from a seeded Poisson process at ``rate`` requests/second, independent
  of completions -- offered load is a free variable, so queueing delay
  (admission backpressure) shows up in the latency tail when the service
  cannot keep up.
* **closed loop** (``mode="closed"``): a fixed population of
  ``concurrency`` clients, each submitting its next request the moment
  the previous one completes -- latency here is (batched) service time,
  with no queueing inflation.

The harness is synchronous single-threaded (the service is ticked
inline); latency for an open-loop request is measured from its
*scheduled* arrival time, so a backlog correctly charges queue wait to
the requests that suffered it.

On a process grid (a service whose operators run on a
``launch.mesh.ProcessMesh``) every rank runs the harness: before each
tick rank 0's clock decides which open-loop arrivals are due
(``service.agree``) and every rank submits those, so the ranks' services
stay one program.  Latencies and throughput are each rank's own clock's.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ..obs import clock as _clock
from .service import SolveRequestError, SolveService

__all__ = ["run_load"]


def _percentiles(lat_s: list[float]) -> dict:
    if not lat_s:
        return {"p50_ms": -1.0, "p99_ms": -1.0, "mean_ms": -1.0}
    a = np.asarray(lat_s) * 1e3
    return {"p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)),
            "mean_ms": float(a.mean())}


def run_load(service: SolveService, make_rhs: Callable[[int], np.ndarray],
             *, operator: str | None = None, mode: str = "open",
             requests: int = 50, rate: float = 50.0, concurrency: int = 4,
             seed: int = 0, tol: float | None = None,
             max_iters: int | None = None) -> dict:
    """Run one load-generation experiment against ``service``.

    ``make_rhs(i)`` supplies the i-th request's (n,) RHS (deterministic in
    ``i`` for reproducible runs).  Returns a flat dict of results:
    arrival parameters, completed/rejected counts, latency percentiles
    (ms), throughput (completed requests per second of wall time), and
    the retrace count across every plan the service holds (0 is the
    steady-state contract).

    Open loop: arrivals at ``rate`` req/s (seeded exponential gaps),
    latency from scheduled arrival to completion.  Closed loop:
    ``concurrency`` clients back to back, latency from submit to
    completion.  Rejected submissions (admission control) are counted,
    not retried.
    """
    if mode not in ("open", "closed"):
        raise ValueError(f"mode must be 'open' or 'closed', got {mode!r}")
    rng = np.random.default_rng(seed)
    lat: list[float] = []
    statuses: dict[str, int] = {}
    rejected = 0
    submit_t: dict[int, float] = {}           # rid -> latency clock start

    def _submit(i: int, t_sched: float):
        nonlocal rejected
        try:
            rid = service.submit(make_rhs(i), operator, tol=tol,
                                 max_iters=max_iters)
        except SolveRequestError:
            rejected += 1
            return None
        submit_t[rid] = t_sched
        return rid

    t0 = _clock.now()
    if mode == "open":
        gaps = rng.exponential(1.0 / rate, size=requests)
        arrivals = np.cumsum(gaps)            # scheduled offsets from t0
        nxt = 0
        while nxt < requests or service.pending() or service.active():
            now = _clock.now() - t0
            due = nxt
            while due < requests and arrivals[due] <= now:
                due += 1
            # on a process grid rank 0's clock says what is due
            due = service.agree(due, "serve_arrivals")
            while nxt < due:
                _submit(nxt, t0 + arrivals[nxt])
                nxt += 1
            if nxt < requests and not service.pending() \
                    and not service.active():
                # idle before the next scheduled arrival: sleep up to it
                _clock.sleep(max(0.0, arrivals[nxt] - (_clock.now() - t0)))
                continue
            for rid, o in service.tick().items():
                if rid in submit_t:
                    lat.append(_clock.now() - submit_t.pop(rid))
                    statuses[o.status] = statuses.get(o.status, 0) + 1
    else:
        inflight = 0
        issued = 0
        while issued < requests and inflight < concurrency:
            if _submit(issued, _clock.now()) is not None:
                inflight += 1
            issued += 1
        while inflight > 0:
            for rid, o in service.tick().items():
                if rid not in submit_t:
                    continue
                lat.append(_clock.now() - submit_t.pop(rid))
                statuses[o.status] = statuses.get(o.status, 0) + 1
                inflight -= 1
                while issued < requests:
                    ok = _submit(issued, _clock.now()) is not None
                    issued += 1
                    if ok:
                        inflight += 1
                        break
    span = _clock.now() - t0
    retraces = sum(
        max(0, plan.traces - 1)
        for op in service._operators.values()
        for pool in op.pools.values()
        for plan in pool.values())
    out = {"mode": mode, "requests": int(requests),
           "completed": len(lat), "rejected": int(rejected),
           "statuses": statuses, "retraces": int(retraces),
           "throughput_rps": float(len(lat) / span) if span > 0 else -1.0,
           "wall_s": float(span)}
    if mode == "open":
        out["offered_rps"] = float(rate)
    else:
        out["concurrency"] = int(concurrency)
    out.update(_percentiles(lat))
    return out
