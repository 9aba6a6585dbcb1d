"""The port's CLI verbs against the reference's: the same arguments (the
port's in-process verbs add ``--device cpu``), the same stdout and exit
codes. ``import`` in-process (``-d``) and over HTTP (``--host``, batches
clamped to the server's limit, ``--concurrency``, ``--values``,
``--clear``, ``--create``), ``export`` both ways, ``inspect``,
``config``, ``generate-config`` and ``version``; ``server`` refuses a set
knob of a plane the port does not have.
"""

import os

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


def test_server_refuses_a_knob_of_an_unported_plane(capsys, tmp_path,
                                                    monkeypatch):
    toml = tmp_path / "node.toml"
    toml.write_text('seeds = ["http://a:1"]\nqos-max-inflight = 8\n'
                    'scrub-interval = "1m"\n')
    rc = pcli.main(["server", "-d", str(tmp_path / "d"), "-c", str(toml),
                    "--device", "cpu"])
    err = capsys.readouterr().err
    assert rc == 1
    assert "seeds" in err and "qos-max-inflight" in err
    assert "scrub-interval" not in err
    monkeypatch.setenv("PILOSA_TPU_CDC_ENABLED", "true")
    rc = pcli.main(["server", "-d", str(tmp_path / "d"), "--device", "cpu"])
    assert rc == 1 and "cdc-enabled" in capsys.readouterr().err
    assert not (tmp_path / "d").exists()  # refused before opening
