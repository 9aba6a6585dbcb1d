"""Serving QoS against the reference: the deadline, the admission gate,
the hedge policy and the breakers, the SLO engine and the pipeline's
gather latch, each driven through the same steps in both packages; and
over HTTP a reference API server beside a port Server on copies of one
4-shard dir.

Covered: the 429 of a full gate and of a tenant at its quota (body and
``Retry-After`` equal), the 504 of a deadline that expired before the
dispatch (its body equal once the milliseconds past are masked: they
are a clock reading), the 400 of a malformed ``X-Pilosa-Deadline-Ms``,
the server default deadline reaching edge requests only, the ``qos_*``
families and ``/debug/vars`` block, SLO specs and their errors, burn
rates for the same events under one fake clock, ``/debug/slo`` and the
``slo_*`` families, and a shed request feeding no SLO event.
"""

import json
import re
import threading
import time

import pytest

import pilosa_tpu.qos as jqos
import pilosa_tpu.qos.slo as jslo
import pilosa_tpu.server.pipeline as jpipeline
import pilosa_tpu.utils.stats as jstats
import pilosa_tpu_torch.qos as pqos
import pilosa_tpu_torch.qos.slo as pslo
import pilosa_tpu_torch.server.pipeline as ppipeline
import pilosa_tpu_torch.utils.stats as pstats
from torch_serving_helpers import Pair, Plug, fresh_planes, seed_dir

QOS = {"jax": jqos, "port": pqos}
STATS = {"jax": jstats, "port": pstats}


@pytest.fixture(scope="module")
def seed(tmp_path_factory):
    root = tmp_path_factory.mktemp("qos") / "seed"
    return root, seed_dir(root)


@pytest.fixture
def pair(seed, tmp_path):
    with fresh_planes():
        p = Pair(seed[0], tmp_path)
        try:
            yield p
        finally:
            p.close()


# ------------------------------------------------------------------ units


def _deadline_steps(q) -> list:
    out = []
    d = q.Deadline.after(30.0)
    out.append((d.expired, 0 < d.remaining() <= 30.0, d.to_millis() > 29000))
    d.check("unit")
    gone = q.Deadline.after(-1)
    out.append((gone.expired, gone.to_millis()))
    with pytest.raises(q.DeadlineExceeded) as e:
        gone.check("unit")
    out.append(re.sub(r"\d+ms", "Nms", str(e.value)))
    out.append(abs(q.Deadline.from_millis(500).remaining() - 0.5) < 0.1)
    out.append((q.DEADLINE_HEADER, q.TENANT_HEADER))
    return out


def _admission_steps(q) -> list:
    out = []
    gate = q.AdmissionController(max_inflight=2, retry_after=3.0)
    s1, s2 = gate.admit("a"), gate.admit("b")
    try:
        gate.admit("c")
    except q.AdmissionError as e:
        out.append((str(e), e.retry_after, e.tenant))
    out.append(gate.metrics())
    s1.release()
    s1.release()  # idempotent
    gate.admit("c").release()
    s2.release()
    out.append((gate.inflight, gate.metrics()))
    gate = q.AdmissionController(max_inflight=4, tenant_max=2)
    gate.admit("hot")
    gate.admit("hot")
    try:
        gate.admit("hot")
    except q.AdmissionError as e:
        out.append(str(e))
    gate.admit("cold")
    out.append(gate.metrics())
    slots = [q.AdmissionController().admit("t") for _ in range(3)]
    out.append(len(slots))
    return out


def _hedge_steps(q) -> list:
    out = []
    pol = q.HedgePolicy(initial_delay=0.25, budget_fraction=0.1)
    out.append(pol.delay())
    for i in range(30):
        pol.record(0.001 * (i + 1))
        pol.note_primary()
    out.append(pol.delay())
    out.append([pol.try_hedge() for _ in range(6)])
    pol.note_win()
    out.append(pol.metrics())
    zero = q.HedgePolicy(budget_fraction=0.0)
    out.append((zero.try_hedge(), zero.metrics()))
    br = q.CircuitBreaker(threshold=2, cooldown=0.0)
    out.append((br.allow(), br.state))
    br.record_failure()
    br.record_failure()
    out.append(br.state)
    out.append((br.allow(), br.state, br.allow()))  # half-open, one probe
    br.record_inconclusive()
    out.append((br.allow(), br.state))
    br.record_success()
    out.append((br.state, br.opened_total))
    br.record_failure()
    br.record_failure()
    br.record_success()  # a stale success cannot close an open breaker
    out.append(br.state)
    sq = q.ServingQos(max_inflight=1, hedge_delay=0.1, hedge_budget=0.2,
                      breaker_threshold=1, breaker_cooldown=9.0)
    sq.breaker("n1").record_failure()
    sq.note_deadline_expired()
    out.append(sq.metrics())
    return out


@pytest.mark.parametrize("steps", [_deadline_steps, _admission_steps,
                                   _hedge_steps],
                         ids=["deadline", "admission", "hedge_breaker"])
def test_qos_units_match_reference(steps):
    assert steps(pqos) == steps(jqos)


@pytest.mark.parametrize("mod", [jpipeline, ppipeline], ids=["jax", "port"])
def test_gather_latch(mod):
    """A lone fast client does not latch the window open; a burst's
    backlog reopens it within one wave (the reference's latch breaker),
    with the reference's constants."""
    assert (mod.QueryPipeline.GATHER_WINDOW_S, mod.QueryPipeline.PRESSURE_GAP_S,
            mod.QueryPipeline.GATHER_CAP) == (0.002, 0.004, 16)
    pipe = mod.QueryPipeline(api=None)
    pipe._recent_gap = 0.001  # looks like pressure
    pipe._last_wave_size = 1  # but the last wave was alone
    pipe._q.put(0)
    wave = [pipe._q.get()]
    pipe._gather(wave)
    assert wave == [0] and pipe._last_wave_size == 1
    for i in range(3):
        pipe._q.put(i + 1)
    pipe._q.put(-1)
    wave = [pipe._q.get()]
    pipe._gather(wave)
    assert len(wave) == 4 and pipe._last_wave_size == 4


# -------------------------------------------------------------------- SLO


def test_slo_specs_and_errors_match_reference():
    good = ["reads:latency:100ms:0.99", "avail:errors:0.999",
            "p:latency:1.5s:0.5"]
    for spec in good:
        assert (pslo.SLOObjective.parse(spec).to_json()
                == jslo.SLOObjective.parse(spec).to_json())
    for spec in ("x:latency:0.99", "x:bogus:1:0.9", "x:errors:1.5",
                 "x:latency:0ms:0.9", "x:latency:soon:0.9"):
        with pytest.raises(ValueError) as je:
            jslo.SLOObjective.parse(spec)
        with pytest.raises(ValueError) as pe:
            pslo.SLOObjective.parse(spec)
        assert str(pe.value) == str(je.value), spec
    for windows in (["0s"], ["-5s"]):
        with pytest.raises(ValueError) as je:
            jslo.SLOEngine.from_config(good, windows)
        with pytest.raises(ValueError) as pe:
            pslo.SLOEngine.from_config(good, windows)
        assert str(pe.value) == str(je.value)


def test_slo_burn_rates_match_reference(monkeypatch):
    """The same events at the same fake times: equal rows, breach flags,
    /debug/vars summary and Prometheus lines."""
    now = [1_000_000.0]

    class Clock:
        @staticmethod
        def time():
            return now[0]

    monkeypatch.setattr(jslo, "time", Clock)
    monkeypatch.setattr(pslo, "time", Clock)
    specs = ["reads:latency:100ms:0.9", "avail:errors:0.99"]
    engines = [m.SLOEngine.from_config(specs, ["10s", "60s"])
               for m in (jslo, pslo)]
    events = ([(0.01, False)] * 20 + [(0.5, False)] * 5 + [(0.02, True)] * 2)
    for step, (lat, err) in enumerate(events):
        now[0] += 1.5 if step % 3 else 0.0
        for eng in engines:
            eng.record(lat, err)
        if step % 9 == 8:
            assert engines[1].to_json() == engines[0].to_json()
    j, p = engines
    assert p.to_json() == j.to_json()
    assert p.metrics() == j.metrics()
    assert p.prometheus_lines("pilosa_tpu") == j.prometheus_lines(
        "pilosa_tpu")
    assert any(r["windows"]["10s"]["burnRate"] > 1 for r in p.burn_rates())
    now[0] += 120  # everything aged out
    assert p.to_json() == j.to_json()


# ----------------------------------------------------------------- HTTP


def _set_qos(pair, **kw):
    """The same gate on both, counting sheds into each package's stats
    registry, as each Server wires it."""
    for pkg, api in pair.apis().items():
        api.qos = QOS[pkg].ServingQos(stats=STATS[pkg].global_stats(), **kw)


def _held(pair, pkg, fn):
    """Run ``fn`` while one pipelined Count of tenant "a" holds its
    admission slot (the dispatcher held in its submit); the held
    request's answer is checked after."""
    api = pair.apis()[pkg]
    with Plug(api, 0) as plug:
        first = []
        t = threading.Thread(target=lambda: first.append(pair.get(
            pkg, "POST", "/index/i/query", b"Count(Row(f=1))",
            {"X-Pilosa-Tenant": "a"})))
        t.start()
        try:
            assert plug.entered.wait(30)
            return fn()
        finally:
            plug.release.set()
            t.join(60)
            assert first and first[0][0] == 200


def test_full_gate_sheds_429_with_retry_after(pair):
    _set_qos(pair, max_inflight=1, retry_after=2.0)
    got = {}
    for pkg in ("jax", "port"):
        got[pkg] = _held(pair, pkg, lambda pkg=pkg: pair.get(
            pkg, "POST", "/index/i/query", b"Count(Row(g=7))"))
    j, p = got["jax"], got["port"]
    assert (p[0], p[1].get("Retry-After"), p[2]) == (
        j[0], j[1].get("Retry-After"), j[2])
    assert p[0] == 429 and p[1]["Retry-After"] == "2"
    assert json.loads(p[2])["error"].startswith("server at admission limit")
    for api in pair.apis().values():
        assert api.qos.metrics()["shed_total"] == 1
        assert api.slo.events_total == 0  # a shed is no SLO event
    # the gate released: both answer again
    pair.same("POST", "/index/i/query", b"Count(Row(g=7))")


def test_tenant_quota_sheds_the_hot_tenant_only(pair):
    _set_qos(pair, tenant_max=1)
    got = {}
    for pkg in ("jax", "port"):
        def burst(pkg=pkg):
            hot = pair.get(pkg, "POST", "/index/i/query", b"Count(Row(g=7))",
                           {"X-Pilosa-Tenant": "a"})
            # a read that does not pipeline runs on its own thread
            cold = pair.get(pkg, "POST", "/index/i/query", b"Rows(f)",
                            {"X-Pilosa-Tenant": "b"})
            return hot, cold

        got[pkg] = _held(pair, pkg, burst)
    for (jh, jc), (ph, pc) in [(got["jax"], got["port"])]:
        assert (ph[0], ph[1].get("Retry-After"), ph[2]) == (
            jh[0], jh[1].get("Retry-After"), jh[2])
        assert ph[0] == 429 and b"tenant 'a'" in ph[2]
        assert (pc[0], pc[2]) == (jc[0], jc[2]) and pc[0] == 200
    fams = {}
    for pkg in ("jax", "port"):
        page = pair.get(pkg, "GET", "/metrics")[2].decode()
        fams[pkg] = sorted(line for line in page.splitlines()
                           if "qos_" in line)
    assert fams["port"] == fams["jax"]
    assert 'pilosa_tpu_qos_shed_total{tenant="a"} 1' in fams["port"]
    assert (pair.json("port", "/debug/vars")["qos"]
            == pair.json("jax", "/debug/vars")["qos"])


def _mask_ms(body: bytes) -> bytes:
    return re.sub(rb"\d+ms past", b"Nms past", body)


def test_expired_deadline_is_504_before_dispatch(pair):
    """A 1 ms budget that runs out while the dispatcher is held: the
    executor refuses it at the dispatch boundary."""
    got = {}
    for pkg in ("jax", "port"):
        api = pair.apis()[pkg]
        with Plug(api, 1) as plug:
            out = []
            t = threading.Thread(target=lambda: out.append(pair.get(
                pkg, "POST", "/index/i/query", b"Count(Row(f=1))")))
            t.start()
            try:
                assert plug.entered.wait(30)

                def late():
                    return pair.get(pkg, "POST", "/index/i/query",
                                    b"Count(Row(f=2))",
                                    {"X-Pilosa-Deadline-Ms": "1"})

                res = []
                waiter = threading.Thread(target=lambda: res.append(late()))
                waiter.start()
                pipe = api._pipeline
                while pipe._q.qsize() < 1:
                    time.sleep(0.001)
                t0 = time.monotonic()
                while time.monotonic() - t0 < 0.002:  # past the 1 ms
                    time.sleep(0.001)
                plug.release.set()
                waiter.join(60)
            finally:
                plug.release.set()
                t.join(60)
        got[pkg] = res[0]
        assert api.qos.metrics()["deadline_expired_total"] == 1
    j, p = got["jax"], got["port"]
    assert p[0] == j[0] == 504
    assert _mask_ms(p[2]) == _mask_ms(j[2])
    assert b"local submit" in p[2]
    for bad in ("nope", "0", "-5"):
        pair.same("POST", "/index/i/query", b"Count(Row(f=1))",
                  {"X-Pilosa-Deadline-Ms": bad})
    st, _, body = pair.get("port", "POST", "/index/i/query",
                           b"Count(Row(f=1))", {"X-Pilosa-Deadline-Ms": "x"})
    assert st == 400 and b"positive integer of milliseconds" in body


def test_default_deadline_reaches_edge_requests_only(pair):
    seen = {}
    for pkg, api in pair.apis().items():
        api.default_deadline_s = 2.0
        orig = api.query_json_bytes

        def capture(*args, pkg=pkg, orig=orig, **kwargs):
            key = "remote" if kwargs.get("remote") else "edge"
            seen[(pkg, key)] = kwargs.get("deadline")
            return orig(*args, **kwargs)

        api.query_json_bytes = capture
    pair.same("POST", "/index/i/query?remote=true&shards=0",
              b"Count(Row(f=1))")
    pair.same("POST", "/index/i/query", b"Count(Row(f=1))")
    for pkg in ("jax", "port"):
        assert seen[(pkg, "remote")] is None
        assert 0 < seen[(pkg, "edge")].remaining() <= 2.0


def test_slo_over_http_matches_reference(pair, seed, tmp_path):
    specs = ["reads:latency:10s:0.9", "avail:errors:0.99"]
    pair.japi.slo = jslo.SLOEngine.from_config(specs, ["30s", "5m"])
    pair.papi.slo = pslo.SLOEngine.from_config(specs, ["30s", "5m"])
    for q in (b"Count(Row(f=1))", b"Row(g=7)", b"Count(Row(nosuch=1))",
              b"Count(Row(f=1)"):
        pair.same("POST", "/index/i/query", q)
    j, p = pair.json("jax", "/debug/slo"), pair.json("port", "/debug/slo")
    assert p == j
    assert p["eventsTotal"] == 4
    pages = {}
    for pkg in ("jax", "port"):
        page = pair.get(pkg, "GET", "/metrics")[2].decode()
        pages[pkg] = [line for line in page.splitlines()
                      if re.match(r"(# \w+ )?pilosa_tpu_slo_", line)]
    assert pages["port"] == pages["jax"] and len(pages["port"]) > 8
