"""The port's CLI verbs against the reference's: the same arguments (the
port's in-process verbs add ``--device cpu``), the same stdout and exit
codes. ``import`` in-process (``-d``) and over HTTP (``--host``, batches
clamped to the server's limit, ``--concurrency``, ``--values``,
``--clear``, ``--create``), ``export`` both ways, ``inspect``,
``config``, ``generate-config`` and ``version``; ``server`` refuses a set
knob of a plane the port does not have (cluster, CDC, autopilot, TLS)
and takes the serving envelope's, the mesh's and multi-process serving's
knobs; ``serve-worker`` parses and starts a worker as the reference's.
"""

import logging
import os
import signal
import threading

import numpy as np
import pytest
import torch

import pilosa_tpu.storage as jstorage
from pilosa_tpu import cli as jcli
from pilosa_tpu.server.api import API as JAPI
from pilosa_tpu.server.http import serve_in_thread as j_serve_in_thread
from pilosa_tpu_torch import __main__ as pcli
from pilosa_tpu_torch.server import Server

torch.set_num_threads(1)

SW = 1 << 20


def _run(capsys, main, argv):
    capsys.readouterr()
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out


def _same(capsys, argv, port_extra=()):
    want = _run(capsys, jcli.main, argv)
    got = _run(capsys, pcli.main, list(argv) + list(port_extra))
    assert got == want, argv
    return got


@pytest.fixture
def csvs(tmp_path):
    rng = np.random.default_rng(9)
    bits = tmp_path / "bits.csv"
    rows = rng.integers(0, 4, 700)
    cols = rng.integers(0, 3 * SW, 700)
    bits.write_text("# row,col\n" + "".join(
        f"{r},{c}\n" for r, c in zip(rows.tolist(), cols.tolist())) + "\n")
    vals = tmp_path / "vals.csv"
    vcols = rng.choice(3 * SW, 300, replace=False)
    vvals = rng.integers(0, 1000, 300)
    vals.write_text("".join(f"{c},{v}\n" for c, v in
                            zip(vcols.tolist(), vvals.tolist())))
    clear = tmp_path / "clear.csv"
    clear.write_text("".join(f"{r},{c}\n" for r, c in
                             zip(rows[:40].tolist(), cols[:40].tolist())))
    return bits, vals, clear


def test_version_generate_config_and_config(capsys, tmp_path, monkeypatch):
    for k in [k for k in os.environ if k.startswith("PILOSA_TPU_")]:
        monkeypatch.delenv(k)
    assert _same(capsys, ["version"])[0] == 0
    rc, out = _same(capsys, ["generate-config"])
    assert rc == 0 and "durability-mode" in out
    gen = tmp_path / "gen.toml"
    gen.write_text(out)
    toml = tmp_path / "node.toml"
    toml.write_text(
        'data-dir = "/srv/p"\nport = 9999\nscrub-interval = "1m30s"\n'
        'seeds = ["http://a:1", "http://b:2"]\nheartbeat-timeout = "500ms"\n'
        'cdc-poll-interval = "20ms"\nuse-mesh = true\n'
        'residency_host_tier_bytes = 4096\n[tls]\ncertificate = "c.crt"\n')
    for argv in (["config"], ["config", "-c", str(gen)],
                 ["config", "-c", str(toml)]):
        assert _same(capsys, argv)[0] == 0
    monkeypatch.setenv("PILOSA_TPU_MAX_WRITES_PER_REQUEST", "77")
    monkeypatch.setenv("PILOSA_TPU_DURABILITY_MODE", "per-op")
    assert _same(capsys, ["config", "-c", str(toml)])[0] == 0


def test_in_process_import_export_inspect(capsys, tmp_path, csvs):
    bits, vals, clear = csvs
    for pkg in ("jax", "port"):
        (tmp_path / pkg).mkdir()
    extra = ("--device", "cpu")

    def same(argv_of):
        want = _run(capsys, jcli.main, argv_of(tmp_path / "jax"))
        got = _run(capsys, pcli.main, argv_of(tmp_path / "port")
                   + list(extra))
        assert got == want
        return got

    rc, out = same(lambda d: ["import", "-d", str(d), "-i", "i", "-f", "f",
                              "--create", str(bits)])
    assert rc == 0 and out.startswith("imported: ")
    same(lambda d: ["import", "-d", str(d), "-i", "i", "-f", "f",
                    "--clear", str(clear)])
    same(lambda d: ["import", "-d", str(d), "-i", "i", "-f", "v",
                    "--values", "--create", "--max", "1000",
                    "--batch-size", "64", str(vals)])
    rc, out = same(lambda d: ["export", "-d", str(d), "-i", "i", "-f", "f"])
    assert rc == 0 and out.count("\n") > 600
    same(lambda d: ["export", "-d", str(d), "-i", "i", "-f", "v"])
    rc, out = same(lambda d: ["inspect", "-d", str(d)])
    assert "i/f/standard/0: bits=" in out
    # each package's inspect of the other's dir
    assert _run(capsys, pcli.main, ["inspect", "-d", str(tmp_path / "jax"),
                                    "--device", "cpu"]) == \
        _run(capsys, jcli.main, ["inspect", "-d", str(tmp_path / "port")])


@pytest.fixture
def two_servers(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jh = jstorage.Holder(str(tmp_path / "jax")).open()
    japi = JAPI(jh)
    japi.max_writes_per_request = 100
    jserver, jport, _ = j_serve_in_thread(japi)
    port = Server(str(tmp_path / "port"), port=0, device="cpu",
                  max_writes_per_request=100).open()
    try:
        yield f"http://localhost:{jport}", f"http://localhost:{port.port}"
    finally:
        jserver.shutdown()
        jserver.server_close()
        jh.close()
        port.close()


def test_http_import_and_export(capsys, two_servers, csvs):
    jbase, pbase = two_servers
    bits, vals, clear = csvs

    def same(args):
        want = _run(capsys, jcli.main, args(jbase))
        got = _run(capsys, pcli.main, args(pbase))
        assert got == want
        return got

    # --batch-size past the servers' limit of 100: clamped, not a 413
    rc, out = same(lambda h: ["import", "--host", h, "-i", "i", "-f", "f",
                              "--create", "--batch-size", "500",
                              "--concurrency", "3", str(bits)])
    assert rc == 0 and out.startswith("imported: ")
    same(lambda h: ["import", "--host", h, "-i", "i", "-f", "f", "--clear",
                    str(clear)])
    same(lambda h: ["import", "--host", h, "-i", "i", "-f", "v", "--values",
                    "--create", "--max", "1000", str(vals)])
    rc, out = same(lambda h: ["export", "--host", h, "-i", "i", "-f", "f"])
    assert rc == 0 and out.count("\n") > 600
    same(lambda h: ["export", "--host", h, "-i", "i", "-f", "v"])
    # an unknown field fails the same way
    rc, out = same(lambda h: ["import", "--host", h, "-i", "i", "-f",
                              "nope", str(bits)])
    assert (rc, out) == (1, "")


# The serving envelope's knobs, each set away from its default, as a
# config file writes them.
SERVING_TOML = (
    'qos-max-inflight = 8\nqos-tenant-inflight = 2\n'
    'qos-default-deadline = "250ms"\nqos-hedge-delay = "100ms"\n'
    'qos-hedge-budget = 0.1\nqos-breaker-threshold = 3\n'
    'qos-breaker-cooldown = "2s"\n'
    'slo-objectives = ["reads:latency:100ms:0.99", "avail:errors:0.999"]\n'
    'slo-windows = ["30s", "5m"]\ntracing = true\n'
    'trace-sample-rate = 0.5\ntrace-log-dir = "/tmp/traces"\n'
    'long-query-time = "20ms"\nslow-query-ring = 7\n'
    'result-cache-bytes = 1048576\ningest-workers = 4\n'
    'heat-half-life = "90s"\n')

# The refused planes' knobs: the cluster, CDC, the autopilot and TLS.
REFUSED_TOML = (
    'seeds = ["http://a:1"]\nreplica-n = 2\ncdc-enabled = true\n'
    'autopilot-enabled = true\n'
    'tls-certificate = "c.crt"\ntls-key = "c.key"\n')

# Multi-process serving's knobs, served since multi-process serving.
MP_TOML = 'serving-workers = 2\nring-slots = 64\nring-slot-bytes = 4096\n'

# The mesh's knobs, served since the single-process mesh.
MESH_TOML = ('use-mesh = true\nmesh-groups = 2\n'
             'topn-quantized-ranking = true\n')


def test_server_refuses_a_knob_of_an_unported_plane(capsys, tmp_path,
                                                    monkeypatch):
    toml = tmp_path / "node.toml"
    toml.write_text(REFUSED_TOML + SERVING_TOML + MESH_TOML + MP_TOML
                    + 'scrub-interval = "1m"\n')
    rc = pcli.main(["server", "-d", str(tmp_path / "d"), "-c", str(toml),
                    "--device", "cpu"])
    err = capsys.readouterr().err
    assert rc == 1
    for knob in ("seeds", "replica-n", "cdc-enabled", "autopilot-enabled",
                 "tls-certificate", "tls-key"):
        assert knob in err, knob
    for line in (SERVING_TOML.splitlines() + MESH_TOML.splitlines()
                 + MP_TOML.splitlines() + ['scrub-interval = "1m"']):
        knob = line.split(" = ")[0]
        assert knob not in err, knob
    monkeypatch.setenv("PILOSA_TPU_CDC_ENABLED", "true")
    rc = pcli.main(["server", "-d", str(tmp_path / "d"), "--device", "cpu"])
    assert rc == 1 and "cdc-enabled" in capsys.readouterr().err
    assert not (tmp_path / "d").exists()  # refused before opening


def test_server_takes_the_serving_knobs(capsys, tmp_path, monkeypatch):
    """Each serving-envelope knob of a config file (or its environment
    variable) reaches the Server as the reference's ServerConfig parses
    it, and the reference's ``config`` output for that file is the
    port's."""
    from pilosa_tpu.server import ServerConfig as JConfig
    from pilosa_tpu_torch.server import server as pserver

    for k in [k for k in os.environ if k.startswith("PILOSA_TPU_")]:
        monkeypatch.delenv(k)
    toml = tmp_path / "node.toml"
    toml.write_text(SERVING_TOML)
    assert _same(capsys, ["config", "-c", str(toml)])[0] == 0
    seen = {}

    class Opened:
        port = 0
        holder = type("H", (), {"device": "cpu"})()

        def close(self):
            seen["closed"] = True

    class FakeServer:
        def __init__(self, data_dir, **kwargs):
            seen.update(kwargs)

        def open(self):
            # the verb serves until SIGTERM: send it once it waits
            threading.Timer(0.2, os.kill,
                            (os.getpid(), signal.SIGTERM)).start()
            return Opened()

    monkeypatch.setattr("pilosa_tpu_torch.server.Server", FakeServer)
    monkeypatch.setenv("PILOSA_TPU_INGEST_WORKERS", "3")
    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT,
                                                  signal.SIGTERM)}
    # the verb gives the package's logger a handler on this test's
    # captured stderr: a later test's log line must not reach it
    log = logging.getLogger("pilosa_tpu_torch")
    log_handlers, log_level = list(log.handlers), log.level
    try:
        rc = pcli.main(["server", "-d", str(tmp_path / "d"), "-c",
                        str(toml), "--device", "cpu"])
    finally:
        for sig, h in handlers.items():
            signal.signal(sig, h)
        log.handlers[:] = log_handlers
        log.setLevel(log_level)
    assert rc == 0 and seen.pop("closed")
    import tomllib

    raw = tomllib.loads(SERVING_TOML)
    raw["ingest-workers"] = "3"
    want = JConfig.from_dict(raw).to_dict()
    for name in pserver.SERVING_KNOBS:
        assert seen[name.replace("-", "_")] == want[name], name
    # and the Server applies them at open
    from pilosa_tpu_torch.serving.rescache import global_result_cache
    from pilosa_tpu_torch.storage.heat import global_heat

    half_lives = (global_result_cache().half_life_s,
                  global_heat().half_life_s)
    srv = Server(str(tmp_path / "s"), port=0, device="cpu", **{
        name.replace("-", "_"): want[name]
        for name in pserver.SERVING_KNOBS}).open()
    try:
        api = srv.api
        assert (api.qos.admission.max_inflight,
                api.qos.admission.tenant_max) == (8, 2)
        assert api.default_deadline_s == 0.25
        assert api.qos.hedge.initial_delay == 0.1
        assert api.qos.breaker("x").threshold == 3
        assert [o.name for o in api.slo.objectives] == ["reads", "avail"]
        assert api.slo.windows_s == (30.0, 300.0)
        assert (api.long_query_time, api.long_queries.maxlen) == (0.02, 7)
        assert (api.ingest_workers, api.trace_log_dir) == (3, "/tmp/traces")
        from pilosa_tpu_torch.utils.tracing import global_tracer

        assert global_result_cache().budget_bytes == 1 << 20
        assert global_result_cache().half_life_s == 90.0
        assert global_heat().half_life_s == 90.0
        assert global_tracer().sample_rate == 0.5
    finally:
        srv.close()
        global_result_cache().configure(0, half_life_s=half_lives[0])
        global_heat().half_life_s = half_lives[1]
        global_tracer().sample_rate = 0.0


def test_server_takes_the_mesh_knobs(capsys, tmp_path, monkeypatch):
    """``use-mesh``, ``mesh-groups`` and ``topn-quantized-ranking`` in a
    config file (and ``PILOSA_TPU_MESH_GROUPS``) reach the Server as the
    reference's ServerConfig parses them, ``config`` prints them as the
    reference's does, and the Server builds its DistExecutor from them
    (a CPU server: one member, so one group)."""
    from pilosa_tpu.server import ServerConfig as JConfig
    from pilosa_tpu_torch.parallel import DistExecutor, mesh_groups

    for k in [k for k in os.environ if k.startswith("PILOSA_TPU_")]:
        monkeypatch.delenv(k)
    toml = tmp_path / "node.toml"
    toml.write_text(MESH_TOML)
    assert _same(capsys, ["config", "-c", str(toml)])[0] == 0
    monkeypatch.setenv("PILOSA_TPU_MESH_GROUPS", "1")
    assert _same(capsys, ["config", "-c", str(toml)])[0] == 0
    seen = {}

    class Opened:
        port = 0
        holder = type("H", (), {"device": "cpu"})()

        def close(self):
            seen["closed"] = True

    class FakeServer:
        def __init__(self, data_dir, **kwargs):
            seen.update(kwargs)

        def open(self):
            threading.Timer(0.2, os.kill,
                            (os.getpid(), signal.SIGTERM)).start()
            return Opened()

    monkeypatch.setattr("pilosa_tpu_torch.server.Server", FakeServer)
    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT,
                                                  signal.SIGTERM)}
    log = logging.getLogger("pilosa_tpu_torch")
    log_handlers, log_level = list(log.handlers), log.level
    try:
        rc = pcli.main(["server", "-d", str(tmp_path / "d"), "-c",
                        str(toml), "--device", "cpu"])
    finally:
        for sig, h in handlers.items():
            signal.signal(sig, h)
        log.handlers[:] = log_handlers
        log.setLevel(log_level)
    assert rc == 0 and seen.pop("closed")
    import tomllib

    raw = tomllib.loads(MESH_TOML)
    raw["mesh-groups"] = "1"
    want = JConfig.from_dict(raw).to_dict()
    for name in ("use-mesh", "mesh-groups", "topn-quantized-ranking"):
        assert seen[name.replace("-", "_")] == want[name], name
    srv = Server(str(tmp_path / "s"), port=0, device="cpu", **{
        name.replace("-", "_"): want[name]
        for name in ("use-mesh", "mesh-groups", "topn-quantized-ranking")
    }).open()
    try:
        ex = srv.executor
        assert type(ex) is DistExecutor and ex.quantized_ranking
        assert ex.mesh.size == 1 and mesh_groups(ex.mesh) is None
        assert srv.config()["use-mesh"] is True
    finally:
        srv.close()


def test_heat_half_life_reaches_both_planes_as_the_reference(tmp_path,
                                                            monkeypatch):
    """``heat-half-life``, the same config file for a reference Server and
    a port Server: ``/debug/rescache`` reports the same ``halfLifeS``,
    and the heat maps decay alike (one fake clock for both)."""
    import json
    import tomllib
    import urllib.request

    import pilosa_tpu.storage.heat as jheat
    import pilosa_tpu_torch.storage.heat as pheat
    from pilosa_tpu.server import Server as JServer
    from pilosa_tpu.server import ServerConfig as JConfig
    from pilosa_tpu_torch.server.server import config_from_toml
    from torch_serving_helpers import fresh_planes

    for k in [k for k in os.environ if k.startswith("PILOSA_TPU_")]:
        monkeypatch.delenv(k)
    now = [1000.0]

    class FakeTime:
        @staticmethod
        def monotonic():
            return now[0]

    monkeypatch.setattr(jheat, "time", FakeTime)
    monkeypatch.setattr(pheat, "time", FakeTime)
    toml = tmp_path / "node.toml"
    toml.write_text('heat-half-life = "90s"\nresult-cache-bytes = 1048576\n')
    raw = tomllib.loads(toml.read_text())
    with fresh_planes():
        jsrv = JServer(JConfig.from_dict({
            **raw, "data-dir": str(tmp_path / "j"), "bind": "localhost",
            "port": 0})).open()
        psrv = Server(str(tmp_path / "p"), port=0, device="cpu",
                      **config_from_toml(str(toml))).open()
        try:
            pages = []
            for port in (jsrv.port, psrv.port):
                with urllib.request.urlopen(
                        f"http://localhost:{port}/debug/rescache",
                        timeout=30) as r:
                    pages.append(json.loads(r.read()))
            assert pages[1]["halfLifeS"] == pages[0]["halfLifeS"] == 90.0
            heats = (jheat.global_heat(), pheat.global_heat())
            assert heats[1].half_life_s == heats[0].half_life_s == 90.0
            for h in heats:
                h.record_access("i", "f", [0], n=8.0)
            now[0] += 180.0  # two half-lives
            rows = [h.hottest(1) for h in heats]
            assert rows[1] == rows[0] and rows[1][0]["access"] == 2.0
        finally:
            psrv.close()
            jsrv.close()


def test_server_takes_the_multi_process_knobs(capsys, tmp_path, monkeypatch):
    """``serving-workers``, ``ring-slots`` and ``ring-slot-bytes`` in a
    config file (and ``PILOSA_TPU_SERVING_WORKERS``) reach the Server as
    the reference's ServerConfig parses them, and ``config`` prints them
    as the reference's does."""
    import tomllib

    from pilosa_tpu.server import ServerConfig as JConfig
    from pilosa_tpu_torch.server.server import MP_KNOBS

    for k in [k for k in os.environ if k.startswith("PILOSA_TPU_")]:
        monkeypatch.delenv(k)
    toml = tmp_path / "node.toml"
    toml.write_text(MP_TOML)
    assert _same(capsys, ["config", "-c", str(toml)])[0] == 0
    monkeypatch.setenv("PILOSA_TPU_SERVING_WORKERS", "3")
    assert _same(capsys, ["config", "-c", str(toml)])[0] == 0
    seen = {}

    class Opened:
        port = 0
        holder = type("H", (), {"device": "cpu"})()

        def close(self):
            seen["closed"] = True

    class FakeServer:
        def __init__(self, data_dir, **kwargs):
            seen.update(kwargs)

        def open(self):
            threading.Timer(0.2, os.kill,
                            (os.getpid(), signal.SIGTERM)).start()
            return Opened()

    monkeypatch.setattr("pilosa_tpu_torch.server.Server", FakeServer)
    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT,
                                                  signal.SIGTERM)}
    log = logging.getLogger("pilosa_tpu_torch")
    log_handlers, log_level = list(log.handlers), log.level
    try:
        rc = pcli.main(["server", "-d", str(tmp_path / "d"), "-c",
                        str(toml), "--device", "cpu"])
    finally:
        for sig, h in handlers.items():
            signal.signal(sig, h)
        log.handlers[:] = log_handlers
        log.setLevel(log_level)
    assert rc == 0 and seen.pop("closed")
    raw = tomllib.loads(MP_TOML)
    raw["serving-workers"] = "3"
    want = JConfig.from_dict(raw).to_dict()
    assert (want["serving-workers"], want["ring-slots"],
            want["ring-slot-bytes"]) == (3, 64, 4096)
    for name in MP_KNOBS:
        assert seen[name.replace("-", "_")] == want[name], name


@pytest.mark.parametrize("argv,want", [
    ([], SystemExit(2)),                        # its arguments are required
    (["--help"], SystemExit(0)),
    (["--handshake-sock", "{missing}", "--listen-fd", "0", "--worker-id",
      "0"], FileNotFoundError()),               # no owner listens there
], ids=["no-arguments", "help", "no-owner"])
def test_serve_worker_verb_as_the_reference(capsys, tmp_path, argv, want):
    """The hidden ``serve-worker`` verb: the same arguments as the
    reference's, and a worker whose owner's handshake socket is missing
    fails as the reference's does, before touching its listening
    socket."""
    argv = ["serve-worker"] + [a.format(missing=tmp_path / "no.sock")
                               for a in argv]
    outcomes = []
    for main in (jcli.main, pcli.main):
        capsys.readouterr()
        with pytest.raises(type(want)) as e:
            main(list(argv))
        out = capsys.readouterr()
        outcomes.append((getattr(e.value, "code", None),
                         "--handshake-sock" in out.out + out.err,
                         "--listen-fd" in out.out + out.err))
    assert outcomes[1] == outcomes[0]
    if isinstance(want, SystemExit):
        assert outcomes[1] == (want.code, True, True)
