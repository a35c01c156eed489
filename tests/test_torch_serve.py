"""repro_torch.serve against the JAX package's service, on the CPU.

- The dispatcher's contract, on a jax-free `StubBackend` and a
  `ManualClock` (no wall-clock sleeps; every `result()` and join takes a
  timeout): flush timing, shape buckets, coalescing, padding,
  backpressure with its retry-after jitter, deadlines, cancel, drain,
  poisoned-batch and NaN isolation, random interleavings — the cases of
  tests/test_serve.py.
- The port's service against the JAX service on the same requests, for
  flowsim_fast and m4 (gate widths, weights carried across by
  `repro_torch.weights`): FCTs at rtol 1e-5 (m4 with one float32 ulp of
  the completion time, ROADMAP Queue 3), bitwise against the port's own
  `run_many` of the padded batch, and the counters of the metrics
  snapshots (submitted, completed, hits, coalesced, batches, padding,
  isolations, compiles) exactly.
- m4's link-degree axis: two flushes of one bucket at two padded degrees
  compile twice; the second breaks `no_retrace(allowed=0)` and is
  isolated, in both packages alike.
- HTTP across packages, both ways: the JAX `ServeClient` against the
  port's server and the port's client against the JAX server; error
  codes; the CLI's `--smoke --device cpu`; the CLI's copy of the
  benchmark's settings.
"""
import json
import os
import subprocess
import sys
import threading
from concurrent.futures import CancelledError

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import model as jm  # noqa: E402
from repro.core import simulate as jsim  # noqa: E402
from repro.scenarios import ScenarioSpec as JaxSpec  # noqa: E402
from repro.serve import ManualClock as JaxClock  # noqa: E402
from repro.serve import ServeClient as JaxClient  # noqa: E402
from repro.serve import ServeConfig as JaxConfig  # noqa: E402
from repro.serve import SimService as JaxService  # noqa: E402
from repro.serve import start_http_server as jax_http  # noqa: E402
from repro.sim import get_backend as jax_backend  # noqa: E402
from repro_torch.core import compiled  # noqa: E402
from repro_torch.core.model import M4Config  # noqa: E402
from repro_torch.runtime.guards import NonFiniteError  # noqa: E402
from repro_torch.scenarios import ScenarioSpec  # noqa: E402
from repro_torch.serve import (ManualClock, RequestTimeout,  # noqa: E402
                               ServeClient, ServeConfig, ServiceClosed,
                               ServiceOverloaded, SimService,
                               request_from_wire, start_http_server)
from repro_torch.serve.service import retry_after_jitter  # noqa: E402
from repro_torch.sim import Backend, SimResult, get_backend  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

WAIT = 120          # future.result / join backstop (never reached healthy)
FCT_RTOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE = dict(hidden=16, gnn_dim=16, mlp_hidden=16, gnn_layers=2,
            snap_flows=16, snap_links=32)
COUNTS = ("submitted", "completed", "failed", "rejected", "timed_out",
          "cancelled", "cache_hits", "coalesced", "batches",
          "batched_requests", "padded_requests", "isolated_retries",
          "compiles")


class StubBackend(Backend):
    """Deterministic backend for the dispatcher's tests: run_many raises
    when the batch holds a seed of `fail_batch_seeds` (and `run` for that
    request alone); a seed of `nan_seeds` comes back all-NaN."""

    name = "stub"

    def __init__(self, fail_batch_seeds=(), nan_seeds=()):
        self.fail_batch_seeds = set(fail_batch_seeds)
        self.nan_seeds = set(nan_seeds)
        self.run_many_calls = []
        self.run_calls = 0
        self.lock = threading.Lock()

    def run(self, request):
        with self.lock:
            self.run_calls += 1
        if request.seed in self.fail_batch_seeds:
            raise RuntimeError(f"poisoned request seed={request.seed}")
        n = request.num_flows
        fill = np.nan if request.seed in self.nan_seeds else float(n)
        return SimResult(fcts=np.full(n, fill + request.seed),
                         slowdowns=np.full(n, fill), wall_time=0.0,
                         backend=self.name)

    def run_many(self, requests):
        with self.lock:
            self.run_many_calls.append(len(requests))
        if any(r.seed in self.fail_batch_seeds for r in requests):
            raise RuntimeError("batch poisoned")
        return [self.run(r) for r in requests]

    def fingerprint(self):
        return "stub-v1"


def stub_request(seed, num_flows=4):
    return ScenarioSpec(topo="ft-4x2x2", num_flows=num_flows, seed=seed,
                        max_load=0.4).to_request(seed=seed)


def spec_kw(seed, num_flows=10):
    return dict(topo="ft-4x2x2", num_flows=num_flows, seed=seed,
                max_load=0.4)


@pytest.fixture()
def manual_service():
    clock = ManualClock()
    backend = StubBackend()
    service = SimService(backend, clock=clock,
                         config=ServeConfig(batch_size=4,
                                            flush_interval_s=0.05,
                                            max_queue=32))
    yield service, backend, clock
    service.close(drain=False, timeout=WAIT)


def wait_idle(service, name="stub", timeout=10.0):
    """Block until the lane's dispatcher has evaluated the current queue
    and gone back to waiting (one forced fresh pass)."""
    lane = service._lanes[name]
    with lane.cond:
        w0 = lane.waits
        lane.cond.notify_all()
        assert lane.cond.wait_for(lambda: lane.idle and lane.waits > w0,
                                  timeout), "dispatcher never settled"


# --------------------------------------------------------------- the basics
def test_single_request_roundtrip_and_lanes():
    backend = get_backend("flowsim")
    with SimService(backend) as service:
        req = ScenarioSpec(**spec_kw(0, 8)).to_request()
        res = service.submit(req).result(timeout=WAIT)
        np.testing.assert_array_equal(res.fcts, backend.run(req).fcts)
        m = service.metrics()
        assert m["submitted"] == m["completed"] == 1
        with pytest.raises(KeyError, match="unknown backend"):
            service.submit(req, backend="m4")
    a, b = StubBackend(), StubBackend()
    with SimService({"a": a, "b": b},
                    config=ServeConfig(batch_size=1)) as service:
        with pytest.raises(ValueError, match="pass backend="):
            service.submit(stub_request(0))
        fa = service.submit(stub_request(0), backend="a")
        fb = service.submit(stub_request(1), backend="b")
        fa.result(timeout=WAIT), fb.result(timeout=WAIT)
        assert a.run_many_calls and b.run_many_calls
        assert service.metrics(backend="a")["completed"] == 1
        assert service.metrics()["completed"] == 2


def test_lanes_take_their_own_config():
    """A mapping of lane -> ServeConfig (an addition of the port): lane a
    flushes at 1, lane b at the default 8 on its deadline."""
    a, b, clock = StubBackend(), StubBackend(), ManualClock()
    with pytest.raises(KeyError, match="unknown lanes"):
        SimService({"a": a}, config={"c": ServeConfig()})
    service = SimService({"a": a, "b": b}, clock=clock,
                         config={"a": ServeConfig(batch_size=1)})
    try:
        assert service.submit(stub_request(0), backend="a").result(
            timeout=WAIT) is not None
        fb = service.submit(stub_request(1), backend="b")
        wait_idle(service, "b")
        assert not fb.done()
        clock.advance(0.06)
        assert fb.result(timeout=WAIT) is not None
        assert a.run_many_calls == [1] and b.run_many_calls == [8]
    finally:
        service.close(drain=False, timeout=WAIT)


@pytest.mark.parametrize("kw,match", [
    ({"batch_size": 0}, "batch_size"), ({"max_queue": 0}, "max_queue"),
    ({"flush_interval_s": -1.0}, "flush_interval_s")])
def test_serve_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        ServeConfig(**kw)
    with pytest.raises(ValueError, match="at least one backend"):
        SimService({})


def test_duplicate_inflight_requests_coalesce(manual_service):
    service, backend, clock = manual_service
    req = stub_request(3)
    f1, f2 = service.submit(req), service.submit(req)
    for _ in range(3):
        service.submit(req)
    assert service._lanes["stub"].queued == 1
    assert service.metrics()["coalesced"] == 4
    clock.advance(0.06)
    np.testing.assert_array_equal(f1.result(timeout=WAIT).fcts,
                                  f2.result(timeout=WAIT).fcts)
    assert backend.run_many_calls == [4]            # one padded flush
    assert backend.run_calls == 4                   # 1 live + 3 pads


# --------------------------------------------- deadline flush (manual clock)
def test_deadline_flush_fires_at_interval_not_before(manual_service):
    service, backend, clock = manual_service
    fut = service.submit(stub_request(0))
    wait_idle(service)
    assert not fut.done() and backend.run_many_calls == []
    clock.advance(0.04)
    wait_idle(service)
    assert not fut.done() and backend.run_many_calls == []
    clock.advance(0.02)
    assert fut.result(timeout=WAIT).backend == "stub"
    assert backend.run_many_calls == [4]


def test_full_bucket_flushes_without_clock(manual_service):
    service, backend, _ = manual_service
    for f in [service.submit(stub_request(s)) for s in range(4)]:
        assert f.result(timeout=WAIT) is not None
    assert backend.run_many_calls == [4]


def test_shape_buckets_flush_independently(manual_service):
    service, backend, clock = manual_service
    small = [service.submit(stub_request(s, num_flows=4)) for s in range(4)]
    big = service.submit(stub_request(9, num_flows=6))
    for f in small:
        f.result(timeout=WAIT)
    wait_idle(service)
    assert not big.done()
    clock.advance(0.06)
    assert len(big.result(timeout=WAIT).fcts) == 6
    assert backend.run_many_calls == [4, 4]


def test_oversize_burst_drains_in_capacity_chunks(manual_service):
    service, backend, clock = manual_service
    futs = [service.submit(stub_request(s)) for s in range(9)]
    for f in futs[:8]:
        f.result(timeout=WAIT)
    wait_idle(service)
    assert not futs[8].done()
    clock.advance(0.06)
    futs[8].result(timeout=WAIT)
    assert sorted(backend.run_many_calls) == [4, 4, 4]


def test_batch_padding_can_be_disabled():
    backend, clock = StubBackend(), ManualClock()
    service = SimService(backend, clock=clock,
                         config=ServeConfig(batch_size=4,
                                            flush_interval_s=0.05,
                                            pad_batches=False,
                                            guard_retrace=False))
    try:
        fut = service.submit(stub_request(0))
        clock.advance(0.06)
        fut.result(timeout=WAIT)
        assert backend.run_many_calls == [1]
    finally:
        service.close(drain=False, timeout=WAIT)


# ------------------------------------------------------- deadlines / cancel
def test_request_timeout_expires_in_queue(manual_service):
    service, backend, clock = manual_service
    hasty = service.submit(stub_request(0), timeout=0.01)
    patient = service.submit(stub_request(1))
    clock.advance(0.02)
    with pytest.raises(RequestTimeout):
        hasty.result(timeout=WAIT)
    wait_idle(service)
    assert not patient.done()
    clock.advance(0.04)
    assert patient.result(timeout=WAIT) is not None
    m = service.metrics()
    assert m["timed_out"] == 1 and m["completed"] == 1
    assert backend.run_many_calls == [4]


@pytest.mark.parametrize("coalesced", [False, True])
def test_cancelled_future_is_skipped(manual_service, coalesced):
    service, backend, clock = manual_service
    doomed = service.submit(stub_request(0))
    kept = service.submit(stub_request(0 if coalesced else 1))
    assert doomed.cancel()
    clock.advance(0.06)
    assert kept.result(timeout=WAIT) is not None
    with pytest.raises(CancelledError):
        doomed.result(timeout=WAIT)
    assert backend.run_many_calls == [4]
    if not coalesced:
        assert service.metrics()["cancelled"] >= 1


# ---------------------------------------------------- backpressure / limits
def test_full_queue_rejects_with_backpressure():
    clock, backend = ManualClock(), StubBackend()
    service = SimService(backend, clock=clock,
                         config=ServeConfig(batch_size=99, max_queue=2,
                                            flush_interval_s=0.05))
    try:
        f1 = service.submit(stub_request(0))
        f2 = service.submit(stub_request(1))
        with pytest.raises(ServiceOverloaded) as e1:
            service.submit(stub_request(2))
        assert 0.05 <= e1.value.retry_after_s < 0.10
        with pytest.raises(ServiceOverloaded) as e2:
            service.submit(stub_request(2))
        assert e2.value.retry_after_s == e1.value.retry_after_s
        with pytest.raises(ServiceOverloaded) as e3:
            service.submit(stub_request(3))
        assert e3.value.retry_after_s != e1.value.retry_after_s
        assert service.metrics()["rejected"] == 3
        clock.advance(0.06)
        f1.result(timeout=WAIT), f2.result(timeout=WAIT)
        f3 = service.submit(stub_request(2))
        clock.advance(0.06)
        assert f3.result(timeout=WAIT) is not None
    finally:
        service.close(drain=False, timeout=WAIT)


def test_coalesced_duplicates_bypass_admission():
    clock, backend = ManualClock(), StubBackend()
    service = SimService(backend, clock=clock,
                         config=ServeConfig(batch_size=99, max_queue=1,
                                            flush_interval_s=0.05))
    try:
        req = stub_request(0)
        f1, f2 = service.submit(req), service.submit(req)
        with pytest.raises(ServiceOverloaded):
            service.submit(stub_request(1))
        clock.advance(0.06)
        assert f1.result(timeout=WAIT) and f2.result(timeout=WAIT)
    finally:
        service.close(drain=False, timeout=WAIT)


def test_retry_after_jitter_matches_jax():
    from repro.serve.service import retry_after_jitter as jax_jitter
    hints = [retry_after_jitter(0.05, f"key-{i}") for i in range(32)]
    assert all(0.05 <= h < 0.10 for h in hints)
    assert len(set(hints)) == len(hints)
    assert hints == [jax_jitter(0.05, f"key-{i}") for i in range(32)]


# ----------------------------------------------------------- fault injection
def test_batch_failure_isolates_poisoned_request():
    backend = StubBackend(fail_batch_seeds={2})
    service = SimService(backend, clock=ManualClock(),
                         config=ServeConfig(batch_size=4,
                                            flush_interval_s=0.05))
    try:
        futs = [service.submit(stub_request(s)) for s in range(4)]
        for s, f in enumerate(futs):
            if s == 2:
                with pytest.raises(RuntimeError, match="seed=2"):
                    f.result(timeout=WAIT)
            else:
                assert f.result(timeout=WAIT).fcts[0] == 4.0 + s
        m = service.metrics()
        assert m["failed"] == 1 and m["completed"] == 3
        assert m["isolated_retries"] == 4
    finally:
        service.close(drain=False, timeout=WAIT)


@pytest.mark.parametrize("checks", ["1", ""])
def test_nan_result_fails_only_its_future_when_checked(monkeypatch, checks):
    monkeypatch.setenv("REPRO_CHECK_FINITE", checks)
    backend = StubBackend(nan_seeds={1})
    service = SimService(backend, clock=ManualClock(),
                         config=ServeConfig(batch_size=4,
                                            flush_interval_s=0.05))
    try:
        futs = [service.submit(stub_request(s)) for s in range(4)]
        for s, f in enumerate(futs):
            if s == 1 and checks:
                with pytest.raises(NonFiniteError, match="all-NaN"):
                    f.result(timeout=WAIT)
            elif s == 1:
                assert np.isnan(f.result(timeout=WAIT).fcts).all()
            else:
                assert np.isfinite(f.result(timeout=WAIT).fcts).all()
        assert service.metrics()["failed"] == (1 if checks else 0)
    finally:
        service.close(drain=False, timeout=WAIT)


# ------------------------------------------------------------------ shutdown
@pytest.mark.parametrize("drain", [True, False])
def test_close_drains_or_fails_pending(manual_service, drain):
    service, backend, _ = manual_service
    futs = [service.submit(stub_request(s)) for s in range(3)]
    service.close(drain=drain, timeout=WAIT)
    for f in futs:
        if drain:
            assert f.result(timeout=WAIT) is not None
        else:
            with pytest.raises(ServiceClosed):
                f.result(timeout=WAIT)
    with pytest.raises(ServiceClosed):
        service.submit(stub_request(9))
    assert not any(l.thread.is_alive() for l in service._lanes.values())
    if not drain:
        assert backend.run_many_calls == []
        assert service.metrics()["failed"] == 3
    service.close(drain=False, timeout=WAIT)       # idempotent


def test_shutdown_during_inflight_batch_drains():
    release, entered = threading.Event(), threading.Event()

    class SlowBackend(StubBackend):
        def run_many(self, requests):
            entered.set()
            assert release.wait(WAIT)
            return super().run_many(requests)

    service = SimService(SlowBackend(), config=ServeConfig(
        batch_size=2, flush_interval_s=0.01))
    f1 = service.submit(stub_request(0))
    f2 = service.submit(stub_request(1))
    assert entered.wait(WAIT)
    f3 = service.submit(stub_request(7))
    closer = threading.Thread(target=service.close,
                              kwargs={"timeout": WAIT})
    closer.start()
    release.set()
    closer.join(WAIT)
    assert not closer.is_alive()
    for f in (f1, f2, f3):
        assert f.result(timeout=WAIT) is not None
    with pytest.raises(ServiceClosed):
        service.submit(stub_request(9))


@pytest.mark.parametrize("seed", [0, 3, 17, 1234, 5000, 9999])
def test_random_interleavings_never_wedge_or_drop(seed):
    import random
    rng = random.Random(seed)
    clock = ManualClock()
    service = SimService(StubBackend(fail_batch_seeds={13}, nan_seeds={7}),
                         clock=clock, config=ServeConfig(
                             batch_size=rng.choice([1, 2, 4]),
                             flush_interval_s=0.05,
                             max_queue=rng.choice([2, 8])))
    futures = []
    requests = [stub_request(s, num_flows=rng.choice([3, 5]))
                for s in (0, 3, 7, 13)]
    try:
        for _ in range(rng.randint(3, 12)):
            op = rng.random()
            if op < 0.55:
                try:
                    futures.append(service.submit(rng.choice(requests)))
                except ServiceOverloaded:
                    pass
            elif op < 0.7 and futures:
                rng.choice(futures).cancel()
            else:
                clock.advance(rng.choice([0.01, 0.06]))
    finally:
        service.close(drain=rng.random() < 0.7, timeout=WAIT)
    for f in futures:
        assert f.done(), "future dropped by the service"
        if not f.cancelled():
            f.exception(timeout=0)
    assert not any(l.thread.is_alive() for l in service._lanes.values())


# ------------------------------------------------- the port vs JAX services
@pytest.fixture(scope="module")
def m4_models():
    jcfg = jsim.canonicalize_cfg(jm.M4Config(**GATE))
    jp = jm.init_m4(jax.random.PRNGKey(0), jcfg)
    return (jax_backend("m4", params=jp, cfg=jcfg),
            get_backend("m4", params=params_from_jax(jax.device_get(jp),
                                                     "cpu"),
                        cfg=M4Config(**GATE), device="cpu"))


def _backends(name, m4_models):
    if name == "m4":
        return m4_models
    return jax_backend(name), get_backend(name, device="cpu")


def _fcts_close(name, got, want, req):
    """FCTs at rtol 1e-5; m4's at rtol 1e-5 up to one float32 ulp of the
    completion time (its clock is float32, an FCT the difference of two
    of its readings)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    slack = 0.0
    if name == "m4":
        arr = np.array([f.t_arrival for f in req.flows])
        slack = np.spacing((arr + want).astype(np.float32)).astype(
            np.float64)
    assert (np.abs(got - want) <= FCT_RTOL * np.abs(want) + slack).all()


def _drive(service_cls, config_cls, clock_cls, spec_cls, backend, waves,
           cache_dir):
    """Submit `waves` (lists of spec kwargs) one wave at a time on a
    manual clock, each wave then flushed by the clock and awaited; then
    the first wave again (cache hits). Returns results and counters."""
    clock = clock_cls()
    service = service_cls(backend, clock=clock, cache_dir=cache_dir,
                          config=config_cls(batch_size=4,
                                            flush_interval_s=0.05))
    out = []
    try:
        for wave in waves + waves[:1]:
            futs = [service.submit(spec_cls(**kw).to_request())
                    for kw in wave]
            clock.advance(0.06)
            out.append([f.result(timeout=WAIT) for f in futs])
        m = service.metrics()
    finally:
        service.close(timeout=WAIT)
    return out, {k: m[k] for k in COUNTS}


@pytest.mark.parametrize("name", ["flowsim_fast", "m4"])
def test_service_matches_jax_service(name, m4_models, tmp_path):
    jb, tb = _backends(name, m4_models)
    # a full bucket, a padded one with a duplicate, a second shape
    waves = [[spec_kw(s) for s in (0, 1, 2, 3)],
             [spec_kw(s) for s in (4, 5, 5)],
             [spec_kw(s, 12) for s in (6,)]]
    jax.clear_caches()
    compiled.clear_compiled()
    want, jm_ = _drive(JaxService, JaxConfig, JaxClock, JaxSpec, jb, waves,
                       str(tmp_path / "jax"))
    got, tm = _drive(SimService, ServeConfig, ManualClock, ScenarioSpec, tb,
                     waves, str(tmp_path / "port"))
    assert tm == jm_
    assert tm["cache_hits"] == 4 and tm["coalesced"] == 1
    assert tm["batches"] == 3 and tm["padded_requests"] == 1 + 1 + 3
    for gw, ww, wave in zip(got, want, waves + waves[:1]):
        reqs = [ScenarioSpec(**kw).to_request() for kw in wave]
        for g, w, r in zip(gw, ww, reqs):
            _fcts_close(name, g.fcts, w.fcts, r)
    # bitwise against the port's own run_many of the padded batch
    reqs = [ScenarioSpec(**kw).to_request() for kw in waves[1]]
    direct = tb.run_many(reqs[:2] + [reqs[0]] * 2)
    for g, d in zip(got[1], [direct[0], direct[1], direct[1]]):
        assert np.asarray(g.fcts).tobytes() == np.asarray(d.fcts).tobytes()


def test_m4_bucket_at_two_link_degrees_isolates_as_jax(m4_models):
    """One m4 bucket, two flushes whose padded link degree K differs (3,
    then 4): the second compiles anew inside no_retrace(allowed=0), which
    raises, so the flush is isolated and each request runs alone — the
    JAX service's behaviour, and the port's."""
    jb, tb = m4_models
    waves = [[spec_kw(s) for s in (2, 4)], [spec_kw(s) for s in (0, 1)]]
    assert [max(jsim.max_link_degree(JaxSpec(**kw).to_request().flows, 8)
                for kw in w) for w in waves] == [3, 4]
    runs = []
    for svc, cfg, clk, spec, b in (
            (JaxService, JaxConfig, JaxClock, JaxSpec, jb),
            (SimService, ServeConfig, ManualClock, ScenarioSpec, tb)):
        jax.clear_caches()
        compiled.clear_compiled()
        service = svc(b, clock=clk(), config=cfg(batch_size=2))
        try:
            res = []
            for wave in waves:
                futs = [service.submit(spec(**kw).to_request())
                        for kw in wave]
                res.append([f.result(timeout=WAIT) for f in futs])
            m = service.metrics()
        finally:
            service.close(timeout=WAIT)
        runs.append((res, {k: m[k] for k in COUNTS}))
    (want, jm_), (got, tm) = runs
    assert tm == jm_
    assert tm["batches"] == 1 and tm["isolated_retries"] == 2
    assert tm["completed"] == 4 and tm["failed"] == 0
    for gw, ww, wave in zip(got, want, waves):
        for g, w, kw in zip(gw, ww, wave):
            _fcts_close("m4", g.fcts, w.fcts,
                        ScenarioSpec(**kw).to_request())


# ------------------------------------------------------------ HTTP front-end
SPEC = {"topo": "ft-4x2x2", "num_flows": 8, "max_load": 0.4, "seed": 0}


@pytest.fixture(scope="module")
def http_pair():
    """The port's and the JAX package's flowsim services behind real
    ephemeral-port servers (one pair for the module: a server's shutdown
    waits out its poll interval)."""
    made = []
    for svc, cfg, start, backend in (
            (SimService, ServeConfig, start_http_server,
             get_backend("flowsim")),
            (JaxService, JaxConfig, jax_http, jax_backend("flowsim"))):
        service = svc(backend, config=cfg(batch_size=4,
                                          flush_interval_s=0.01))
        server = start(service, port=0)
        made.append((service, server,
                     f"http://127.0.0.1:{server.server_address[1]}"))
    yield made
    for service, server, _ in made:
        server.shutdown()
        server.server_close()
        service.close(drain=False, timeout=WAIT)


@pytest.mark.parametrize("client_cls,server_at", [
    (JaxClient, 0), (ServeClient, 1), (ServeClient, 0)])
def test_http_roundtrip_across_packages(http_pair, client_cls, server_at):
    service, server, url = http_pair[server_at]
    client = client_cls(url, timeout_s=WAIT)
    reply = client.simulate(SPEC, backend="flowsim")
    want = get_backend("flowsim").run(ScenarioSpec(**SPEC).to_request())
    np.testing.assert_array_equal(np.asarray(reply["fcts"]), want.fcts)
    np.testing.assert_array_equal(np.asarray(reply["slowdowns"]),
                                  want.slowdowns)
    assert reply["backend"] == "flowsim"
    m = client.metrics()
    assert m["submitted"] >= 1 and "flowsim" in m["lanes"]
    assert client.health() == {"ok": True, "status": "ok",
                               "backends": ["flowsim"], "dead_lanes": []}
    prom = client.metrics_prometheus()
    assert 'repro_serve_completed_total{lane="flowsim"}' in prom


def _status(url, method, path, body=None):
    from urllib.error import HTTPError
    from urllib.request import Request, urlopen
    data = None if method == "GET" else json.dumps(body or {}).encode()
    try:
        with urlopen(Request(url + path, data=data, headers={
                "Content-Type": "application/json"}), timeout=WAIT) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except HTTPError as exc:
        return exc.code, json.loads(exc.read() or b"{}"), dict(exc.headers)


@pytest.mark.parametrize("method,path,body,code,text", [
    ("GET", "/nope", None, 404, "no route"),
    ("POST", "/nope", {"spec": SPEC}, 404, "no route"),
    ("POST", "/simulate", {}, 400, '"spec"'),
    ("POST", "/simulate", {"spec": {"no_such_field": 1}}, 400, "bad spec"),
    ("POST", "/simulate", {"spec": SPEC, "options": {"record_events": 1}},
     400, "unsupported options"),
    ("POST", "/simulate", {"spec": SPEC, "backend": "m4"}, 400,
     "unknown backend")])
def test_http_errors_as_jax(http_pair, method, path, body, code, text):
    got = _status(http_pair[0][2], method, path, body)
    want = _status(http_pair[1][2], method, path, body)
    assert got[0] == want[0] == code
    assert text in got[1]["error"] and got[1] == want[1]


def test_http_504_503_and_closed():
    clock = ManualClock()
    service = SimService(StubBackend(), clock=clock,
                         config=ServeConfig(batch_size=99, max_queue=1,
                                            flush_interval_s=0.05))
    server = start_http_server(service, port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        code, body, _ = _status(url, "POST", "/simulate", {
            "spec": dict(SPEC, num_flows=4), "backend": "stub",
            "timeout": 0.0})
        assert code == 504 and "deadline" in body["error"]
        service.submit(stub_request(0))          # fill the only slot
        code, body, headers = _status(url, "POST", "/simulate", {
            "spec": dict(SPEC, seed=99, num_flows=4), "backend": "stub"})
        assert code == 503 and 0.05 <= body["retry_after_s"] < 0.10
        assert float(headers["Retry-After"]) == pytest.approx(
            body["retry_after_s"], abs=1e-3)
        service.close(drain=False, timeout=WAIT)
        code, body, _ = _status(url, "POST", "/simulate", {"spec": SPEC})
        assert code == 503 and "closed" in body["error"]
        code, body, _ = _status(url, "GET", "/healthz")
        assert code == 503 and body["status"] == "closed"
    finally:
        server.shutdown()
        server.server_close()
        service.close(drain=False, timeout=WAIT)


def test_health_reports_dead_dispatcher_lane():
    service = SimService(StubBackend(), clock=ManualClock())
    try:
        assert service.health()["status"] == "ok"
        dead = threading.Thread(target=lambda: None)
        dead.start()
        dead.join(WAIT)
        service._lanes["stub"].thread = dead
        assert service.health() == {"ok": False, "status": "degraded",
                                    "backends": ["stub"],
                                    "dead_lanes": ["stub"]}
    finally:
        service.close(drain=False, timeout=WAIT)


def test_request_from_wire_matches_jax():
    from repro.serve import request_from_wire as jax_wire
    body = {"spec": dict(SPEC, net=[["dctcp_k", 25000]]),
            "options": {"seed": 3}}
    got, want = request_from_wire(body), jax_wire(body)
    assert got.content_hash() == want.content_hash()
    assert got.seed == want.seed == 3


# --------------------------------------------------------------- the CLI
def test_cli_smoke_passes_on_the_cpu():
    env = dict(os.environ, PYTHONPATH="src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve", "--smoke", "--device",
         "cpu", "--flush-ms", "10"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ok   cache hits >= 1" in proc.stdout
    assert "FAIL" not in proc.stdout


def test_cli_copies_the_benchmark_settings():
    import benchmarks.common as bench
    from repro_torch.serve import __main__ as cli
    want = bench.BENCH_M4
    assert cli.BENCH_M4 == {k: getattr(want, k) for k in cli.BENCH_M4}
    assert M4Config(**cli.BENCH_M4) == M4Config(**{
        k: getattr(want, k) for k in ("hidden", "gnn_dim", "mlp_hidden",
                                      "gnn_layers", "snap_flows",
                                      "snap_links", "max_path", "cfg_dim",
                                      "dense_sldn")})
    for k, v in cli.BENCH_TC.items():
        assert getattr(bench.BENCH_TC, k) == v
    assert [s for s in cli.train_suite_spec()] == [
        ScenarioSpec(**vars(s)) for s in bench.train_suite_spec()]


def test_cli_m4_loads_a_finished_checkpoint(tmp_path):
    """--backend m4 restores a finished checkpoint at the benchmark's
    width and trains nothing."""
    from repro_torch.serve import __main__ as cli
    from repro_torch.train import TrainConfig, init_state
    from repro_torch.runtime import checkpoint as ckpt
    cfg = M4Config(**cli.BENCH_M4)
    state = init_state(cfg, 3, "cpu")
    ckpt.save(str(tmp_path), TrainConfig(**cli.BENCH_TC).epochs,
              state.tree())
    logs = []
    params, got_cfg = cli.trained_m4(str(tmp_path), str(tmp_path / "data"),
                                     "cpu", log=logs.append)
    assert got_cfg == cfg and "from" in logs[0]
    assert torch.equal(params["gru1"]["wh"], state.params["gru1"]["wh"])
    assert not (tmp_path / "data").exists()
