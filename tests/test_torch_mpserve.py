"""Multi-process serving in the port (``pilosa_tpu_torch/serving/``):
``SO_REUSEPORT`` worker processes in front of one device owner over
pickle-free shared-memory rings, on the CPU (``device="cpu"``, 2
workers, small rings, 4 shards).

What crosses the rings is held to what one process answers: every
``__graft_entry__.DRYRUN_QUERY_SHAPES`` query through a worker is byte
for byte the owner's own handler's answer and a ``pilosa_tpu`` server's
on a copy of the same data dir; errors keep their status; a full ring
sheds 429; a SIGKILLed worker is respawned; workers handshake again
after the owner restarts; storage-degraded writes are shed in the
worker; identical reads dedupe into one execution; without
``SO_REUSEPORT`` the server serves from one process; every write a
worker acknowledged survives a SIGKILL of the owner (``python -m
pilosa_tpu_torch server --device cpu``); one kill-a-worker chaos
schedule; and a worker loads no torch, jax or ``pilosa_tpu`` module.
Every server, process and thread is closed in a ``finally``, every
subprocess wait bounded."""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from __graft_entry__ import DRYRUN_QUERY_SHAPES
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.server.server import ServerConfig
from pilosa_tpu_torch.serving import mpserve
from torch_serving_helpers import Pair, fresh_planes, seed_dir

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    not hasattr(socket, "SO_REUSEPORT"),
    reason="multi-process serving needs SO_REUSEPORT")

REPO = Path(__file__).resolve().parents[1]
RINGS = {"ring_slots": 8, "ring_slot_bytes": 8192}


def _req(port, method, path, body=None, headers=None, timeout=30):
    """(status, body); an HTTP error status is returned, not raised."""
    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                               method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(r, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _query(port, pql, headers=None, timeout=30):
    return _req(port, "POST", "/index/i/query", pql.encode(),
                headers=headers, timeout=timeout)


def _poll(fn, seconds: float = 10.0):
    """``fn()`` until it returns something truthy; that value or None."""
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        got = fn()
        if got:
            return got
        time.sleep(0.05)
    return None


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    root = tmp_path_factory.mktemp("mpseed")
    probe = seed_dir(root)
    return root, probe


@pytest.fixture(scope="module")
def mp(seeded, tmp_path_factory):
    """A reference API server beside a port Server with 2 workers on
    copies of the seeded dir, every request sampled."""
    root, probe = seeded
    with fresh_planes(sample_rate=1.0):
        pair = Pair(root, tmp_path_factory.mktemp("mp"), serving_workers=2,
                    trace_sample_rate=1.0, **RINGS)
        try:
            assert pair.server._mpserve is not None
            pair.probe = probe
            yield pair
        finally:
            pair.close()


def _ports(pair):
    return {"worker": pair.server.port,
            "owner": pair.server._mpserve.owner_port,
            "reference": int(pair.bases["jax"].rsplit(":", 1)[1])}


@pytest.mark.parametrize("shape", DRYRUN_QUERY_SHAPES)
def test_answers_through_a_worker_match_owner_and_reference(mp, shape):
    pql = shape.format(probe=mp.probe)
    ring0 = mp.server._mpserve.metrics()["serving_ring_queries_total"]
    got = {name: _query(port, pql) for name, port in _ports(mp).items()}
    assert got["worker"][0] == 200, got["worker"]
    assert got["worker"] == got["owner"] == got["reference"], pql
    # the worker's answer crossed the ring, not the proxy
    assert mp.server._mpserve.metrics()["serving_ring_queries_total"] \
        == ring0 + 1


@pytest.mark.parametrize("path,body,status", [
    ("/index/nope/query", b"Count(Row(f=1))", 400),   # the owner's error
    ("/index/i/query", b"NotAQuery(((", 400),         # the worker's parse
    ("/index/i/query", b"Count(Row(nope=1))", 400),   # an unknown field
])
def test_errors_cross_the_ring_with_their_status(mp, path, body, status):
    ring0 = mp.server._mpserve.metrics()["serving_ring_queries_total"]
    got = {name: _req(port, "POST", path, body)
           for name, port in _ports(mp).items()}
    assert got["worker"][0] == status
    assert got["worker"] == got["owner"] == got["reference"]
    crossed = mp.server._mpserve.metrics()["serving_ring_queries_total"] \
        - ring0
    # a parse error is answered by the worker and never crosses
    assert crossed == (0 if b"(((" in body else 1)


def test_proxied_and_worker_local_routes(mp):
    import http.client

    # one keep-alive connection: one worker answers both requests
    conn = http.client.HTTPConnection("127.0.0.1", mp.server.port,
                                      timeout=30)
    try:
        conn.request("GET", "/schema")
        resp = conn.getresponse()
        st, body = resp.status, resp.read()
        conn.request("GET", "/debug/worker")
        resp = conn.getresponse()
        stats = json.loads(resp.read())
    finally:
        conn.close()
    assert (st, body) == _req(_ports(mp)["owner"], "GET", "/schema")
    assert [i["name"] for i in json.loads(body)["indexes"]] == ["i"]
    assert resp.status == 200 and stats["worker"] in (0, 1)
    assert stats["requests"] >= 2 and stats["proxied"] >= 1


def test_observability_surfaces_and_workers_load_no_torch(mp):
    port = mp.server.port
    table = json.loads(_req(port, "GET", "/debug/workers")[1])
    assert table["enabled"] and table["port"] == port
    assert table["ownerPort"] == _ports(mp)["owner"]
    assert len(table["workers"]) == 2
    assert all(w["alive"] for w in table["workers"])
    assert len(json.loads(_req(port, "GET", "/status")[1])[
        "servingWorkers"]) == 2
    text = _req(port, "GET", "/metrics")[1].decode()
    for family in mp.server.api.mp_metrics():
        assert f"# TYPE pilosa_tpu_{family} " in text, family
    assert "pilosa_tpu_serving_workers 2" in text
    assert json.loads(_req(port, "GET", "/debug/vars")[1])[
        "serving_mp"]["serving_workers"] == 2
    for w in table["workers"]:  # the live workers' mapped libraries
        maps = Path(f"/proc/{w['pid']}/maps")
        if maps.exists():
            assert "libtorch" not in maps.read_text(), w["pid"]


def test_tenant_and_a_stitched_trace_survive_the_hop(mp):
    """The owner bills the worker's request to its tenant (egress too),
    and its /debug/traces shows one tree: the worker's edge root with
    the owner's rpc.query subtree under it."""
    port = mp.server.port
    st, _ = _query(port, "Count(Row(f=2))",
                   headers={"X-Pilosa-Tenant": "acct-7"})
    assert st == 200

    def tenant_row():
        rows = json.loads(_req(port, "GET", "/debug/tenants")[1])["tenants"]
        return next((r for r in rows if r["tenant"] == "acct-7"), None)

    row = _poll(tenant_row)
    assert row is not None and row["queries"] >= 1
    assert row["egress_bytes"] > 0

    def stitched():
        for t in json.loads(_req(port, "GET", "/debug/traces")[1])[
                "traces"]:
            if (t["name"] == "http.query" and t["tags"].get("worker")
                    and t["tags"].get("tenant") == "acct-7"):
                kids = [c for c in t["children"] if c["name"] == "rpc.query"]
                if kids and kids[0]["parentId"] == t["spanId"]:
                    return t
        return None

    tree = _poll(stitched)
    assert tree is not None, "no stitched tree reached the owner's tracer"
    assert tree["children"][0]["traceId"] == tree["traceId"]


def test_a_full_ring_sheds_429(mp):
    """With the owner's pool saturated its drains stop, the rings fill,
    and the workers shed 429 with Retry-After; everything not shed
    completes once capacity returns."""
    rt = mp.server._mpserve
    permits = 0
    while rt._capacity.acquire(blocking=False):
        permits += 1
    assert permits > 0
    codes, lock = [], threading.Lock()

    def probe():
        r = urllib.request.Request(f"http://127.0.0.1:{mp.server.port}"
                                   "/index/i/query", data=b"Row(f=1)",
                                   method="POST")
        try:
            with urllib.request.urlopen(r, timeout=60) as resp:
                st = resp.status
                resp.read()
        except urllib.error.HTTPError as e:
            st = e.code
            assert st != 429 or e.headers.get("Retry-After") == "1"
            e.read()
        with lock:
            codes.append(st)

    threads = [threading.Thread(target=probe) for _ in range(40)]
    try:
        for t in threads:
            t.start()
        assert _poll(lambda: 429 in codes, 20), "no request was shed"
    finally:
        for _ in range(permits):
            rt._capacity.release()
        for t in threads:
            t.join(60)
    assert len(codes) == 40 and set(codes) <= {200, 429}
    assert rt.metrics()["serving_ring_full_total"] >= codes.count(429) > 0


# --- lifecycle drills last: they bump worker generations and pids ---


def test_a_sigkilled_worker_is_respawned(mp):
    port = mp.server.port
    rt = mp.server._mpserve
    before = rt.metrics()
    pids = sorted(w["pid"] for w in rt.workers_json())
    os.kill(pids[0], signal.SIGKILL)
    served = 0
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and served < 5:
        try:
            st, body = _query(port, "Count(Row(f=1))", timeout=5)
            if st == 200:
                assert body == _query(_ports(mp)["owner"],
                                      "Count(Row(f=1))")[1]
                served += 1
        except OSError:
            time.sleep(0.05)  # a connection the dead worker held
    assert served >= 5, "the owner wedged after a worker's SIGKILL"
    assert rt.wait_workers(2, timeout=30), "the dead worker was not respawned"
    m = rt.metrics()
    assert m["serving_worker_respawns_total"] == \
        before["serving_worker_respawns_total"] + 1
    assert m["serving_workers_reaped_total"] >= \
        before["serving_workers_reaped_total"] + 1
    assert m["serving_workers"] == 2
    assert pids[0] not in {w["pid"] for w in rt.workers_json()}


def test_workers_handshake_again_after_the_owner_restarts(mp):
    rt = mp.server._mpserve
    gens = [w["gen"] for w in rt.workers_json()]
    rt.simulate_restart()
    assert rt.wait_workers(2, timeout=30), "no handshake after the restart"
    assert min(w["gen"] for w in rt.workers_json() if w["alive"]) > min(gens)
    want = _query(_ports(mp)["owner"], "Count(Row(f=1))")

    def answered():
        try:
            return _query(mp.server.port, "Count(Row(f=1))", timeout=5) \
                == want
        except OSError:
            return False

    assert _poll(answered, 20), "serving did not recover after the restart"


# --------------------------------------------------- servers of their own


def _own_server(tmp_path, seeded, n_workers=2, **kw):
    import shutil

    shutil.copytree(seeded[0], tmp_path / "d")
    return Server(str(tmp_path / "d"), port=0, device="cpu",
                  serving_workers=n_workers, **RINGS, **kw).open()


def test_dedupe_followers_share_one_execution(tmp_path, seeded):
    """Identical untraced reads that land while a leader's wave is not
    yet submitted join it in the owner: one execution, byte-equal
    answers, each follower billed. The leader is held until the owner's
    intake has taken all six frames, so the followers join it however
    slowly the clients reach the owner."""
    with fresh_planes():
        server = _own_server(tmp_path, seeded)
        try:
            rt = server._mpserve
            real = server.api.query_json_bytes
            want = _query(server.port, "Count(Row(f=2))")
            taken = rt.batched_requests  # frames the intake has taken
            release = threading.Event()

            def held(*a, **kw):
                release.wait(30)  # hold the leader past the burst
                return real(*a, **kw)

            server.api.query_json_bytes = held
            results, lock = [], threading.Lock()

            def one():
                r = _query(server.port, "Count(Row(f=2))")
                with lock:
                    results.append(r)

            threads = [threading.Thread(target=one) for _ in range(6)]
            try:
                for t in threads:
                    t.start()
                assert _poll(lambda: rt.batched_requests >= taken + 6, 30), \
                    "the owner's intake did not take the six frames"
            finally:
                release.set()
                for t in threads:
                    t.join(30)
                server.api.query_json_bytes = real
            assert results == [want] * 6
            assert rt.deduped > 0
            assert rt.queries_served == 7
            row = {r["tenant"]: r for r in server.api.cost.snapshot()}
            assert row["default"]["queries"] >= 7
        finally:
            server.close()


def test_storage_degraded_writes_are_shed_in_the_worker(tmp_path, seeded):
    """While the disk is sick a write is shed 503 by the worker from the
    control block, without a ring round trip; reads serve on; after the
    fault goes the probe clears the latch and writes resume."""
    from pilosa_tpu_torch.testing import faults

    with fresh_planes():
        server = _own_server(tmp_path, seeded, n_workers=1)
        plane = faults.install_disk()
        try:
            port = server.port
            assert _query(port, "Set(1, f=1)")[0] == 200
            health = server.holder.health
            health.PROBE_INTERVAL_S = 0.2
            rule = plane.add("fsync", path=str(tmp_path), errno_=28)
            health.trip("test: disk full")

            def ring_total():
                return server._mpserve.metrics()["serving_ring_queries_total"]

            def shed_in_worker():
                before = ring_total()
                st, body = _query(port, "Set(2, f=1)", timeout=5)
                return body if st == 503 and ring_total() == before else None

            body = _poll(shed_in_worker)
            assert body is not None, "no write was shed in the worker"
            assert json.loads(body)["error"].startswith(
                "storage degraded (test: disk full)")
            assert _query(port, "Count(Row(f=1))")[0] == 200
            plane.remove(rule.id)
            assert _poll(lambda: _query(port, "Set(3, f=1)")[0] == 200, 15), \
                "writes did not resume after the fault went"
        finally:
            faults.clear_disk()
            server.close()


def test_no_reuseport_falls_back_to_one_process(tmp_path, seeded,
                                                monkeypatch, caplog):
    monkeypatch.delattr(socket, "SO_REUSEPORT")
    with fresh_planes():
        server = _own_server(tmp_path, seeded)
        try:
            assert server._mpserve is None
            assert "multi-process serving disabled" in caplog.text
            assert json.loads(_req(server.port, "GET", "/debug/workers")[1]) \
                == {"enabled": False, "workers": []}
            text = _req(server.port, "GET", "/metrics")[1].decode()
            assert "pilosa_tpu_serving_workers 0" in text
            assert _query(server.port, "Count(Row(f=1))")[0] == 200
        finally:
            server.close()


def test_tls_is_single_process_only(tmp_path):
    cfg = ServerConfig(data_dir=str(tmp_path), serving_workers=2,
                       tls_certificate="/c", tls_key="/k")
    assert "TLS" in mpserve.mp_unsupported_reason(cfg)
    assert mpserve.mp_unsupported_reason(ServerConfig()) is None


@pytest.mark.parametrize("kw", [
    {"serving_workers": -1}, {"serving_workers": 1000},
    {"ring_slots": 1}, {"ring_slot_bytes": 16},
])
def test_config_validation(tmp_path, kw):
    with pytest.raises(ValueError):
        ServerConfig(data_dir=str(tmp_path), **kw)
    with pytest.raises(ValueError):
        Server(str(tmp_path / "d"), device="cpu", **kw)


def test_a_kill_a_worker_chaos_schedule(tmp_path):
    """One seeded schedule: zero lost acknowledged writes, an owner that
    never wedges, the fleet respawned after each kill."""
    from pilosa_tpu_torch.testing.chaos import MpServingChaos

    with fresh_planes():
        harness = MpServingChaos(str(tmp_path), n_workers=2, seed=7,
                                 n_kills=2, kill_gap_s=0.5, device="cpu")
        try:
            harness.boot()
            record = harness.run_schedule()
        finally:
            harness.close()
    assert record["acked_writes"] > 0
    assert record["lost_acked_writes"] == 0, record["lost_sample"]
    assert record["owner_wedges"] == []
    assert record["respawns"] == 2
    assert record["ok"]


# ------------------------------------------------- the worker's imports


def test_a_worker_loads_no_torch_jax_or_reference():
    code = (
        "import json, sys\n"
        "import pilosa_tpu_torch.serving.worker\n"
        "import pilosa_tpu_torch.serving.mpserve\n"
        "import pilosa_tpu_torch.parallel.connpool\n"
        "import pilosa_tpu_torch.testing.faults\n"
        "import pilosa_tpu_torch.utils.cost\n"
        "from pilosa_tpu_torch.__main__ import main\n"
        "try:\n"
        "    main(['serve-worker', '--help'])\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'pilosa_tpu',\n"
        "                           'numpy'))))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "--listen-fd" in res.stdout
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


# ------------------------------------------ the WAL oracle, in processes


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_mp(data_dir: Path, port: int, workers: int = 2):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PILOSA_TPU_")}
    env.update({
        "PILOSA_TPU_SERVING_WORKERS": str(workers),
        "PILOSA_TPU_RING_SLOTS": "64",
        "PILOSA_TPU_RING_SLOT_BYTES": "8192",
        "PILOSA_TPU_DURABILITY_MODE": "group",
        # orphaned workers give up fast, so the restarted owner's
        # workers own the port's reuseport group
        "PILOSA_TPU_MP_REHANDSHAKE_S": "2",
        "OMP_NUM_THREADS": "1",
    })
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch", "server", "-d",
         str(data_dir), "--bind", "127.0.0.1", "--port", str(port),
         "--device", "cpu"],
        env=env, cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        for _ in range(480):
            if proc.poll() is not None:
                raise AssertionError(f"server exited rc={proc.returncode}")
            try:
                if _req(port, "GET", "/status", timeout=5)[0] == 200:
                    return proc
            except OSError:
                pass
            time.sleep(0.25)
        raise AssertionError("the mp server never served /status")
    except BaseException:
        proc.kill()
        proc.wait(15)
        raise


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def test_wal_ack_barrier_survives_an_owner_sigkill(tmp_path):
    """Every write a client saw acknowledged through a worker is in the
    fsynced WAL: SIGKILL the owner mid-burst (its workers orphaned, no
    clean shutdown anywhere), restart on the same port, and every one
    reads back."""
    port = _free_port()
    data_dir = tmp_path / "owner"
    proc = _spawn_mp(data_dir, port)
    workers: list[int] = []
    stop = threading.Event()
    threads: list[threading.Thread] = []
    try:
        assert _req(port, "POST", "/index/i", b"{}")[0] == 200
        assert _req(port, "POST", "/index/i/field/f", b"{}")[0] == 200
        acked: set[int] = set()
        lock = threading.Lock()

        def writer(tid):
            k = 0
            while not stop.is_set():
                col = tid + 4 * k
                k += 1
                try:
                    st, body = _query(
                        port, f"Set({col}, f=1)",
                        headers={"X-Pilosa-Tenant": "writer"}, timeout=10)
                except OSError:
                    return  # the kill landed mid-request: not acked
                if st == 200 and json.loads(body) == {"results": [True]}:
                    with lock:
                        acked.add(col)

        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        assert _poll(lambda: len(acked) >= 40, 60), "the burst stalled"
        tenants = {r["tenant"]: r for r in json.loads(_req(
            port, "GET", "/debug/tenants")[1])["tenants"]}
        assert tenants["writer"]["queries"] >= 1
        workers = [w["pid"] for w in json.loads(_req(
            port, "GET", "/debug/workers")[1])["workers"] if w["pid"]]
        assert len(workers) == 2
        proc.kill()
        proc.wait(15)
        stop.set()
        for t in threads:
            t.join(15)
        with lock:
            acked_now = set(acked)
        # orphaned workers give up and exit once their window passes
        assert _poll(lambda: not any(_pid_alive(p) for p in workers), 20), \
            "orphaned workers outlived their owner"
        proc = _spawn_mp(data_dir, port)

        def columns():
            try:
                st, body = _query(port, "Row(f=1)", timeout=10)
            except OSError:
                return None
            got = set(json.loads(body)["results"][0]["columns"])
            return got if acked_now <= got else None

        got = _poll(columns, 30)
        missing = acked_now - (got or set())
        assert not missing, f"lost {len(missing)} acknowledged writes"
        assert _query(port, "Set(999999, f=2)")[0] == 200
    finally:
        stop.set()
        for t in threads:
            t.join(15)
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(15)
        for p in workers:
            if _pid_alive(p):
                os.kill(p, signal.SIGKILL)
