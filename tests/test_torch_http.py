"""One HTTP server per package on copies of one data directory: the same
requests get byte-identical response bodies (the port runs on the CPU)."""

import shutil
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import pilosa_tpu.storage as jstorage
from pilosa_tpu.server.api import API as JAPI
from pilosa_tpu.server.http import serve_in_thread as j_serve_in_thread
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.storage import Holder, load_from_dense

torch.set_num_threads(1)

W = 32768
SHARDS = 2


def _words(rng, density: float) -> np.ndarray:
    bits = rng.random(SHARDS * W * 32) < density
    return np.packbits(bits, bitorder="little").view("<u4")


def _request(base: str, method: str, path: str, body: bytes | None):
    r = urllib.request.Request(base + path, data=body, method=method)
    if body is not None:
        r.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture
def servers(tmp_path):
    rng = np.random.default_rng(7)
    h = Holder(str(tmp_path / "seed"), device="cpu").open()
    load_from_dense(h, {"stargazer": {1: _words(rng, 0.002),
                                      2: _words(rng, 0.004)},
                        "language": {5: _words(rng, 0.003)}},
                    index="repository")
    h.close()
    shutil.copytree(tmp_path / "seed", tmp_path / "jax")
    shutil.copytree(tmp_path / "seed", tmp_path / "port")
    jh = jstorage.Holder(str(tmp_path / "jax")).open()
    jserver, jport, _ = j_serve_in_thread(JAPI(jh))
    port = Server(str(tmp_path / "port"), port=0, device="cpu").open()
    yield f"http://localhost:{jport}", f"http://localhost:{port.port}"
    jserver.shutdown()
    jserver.server_close()
    jh.close()
    port.close()


REQUESTS = [
    ("GET", "/status", None),
    ("POST", "/index/repository/query",
     b"Count(Intersect(Row(stargazer=1), Row(language=5)))"),
    ("POST", "/index/repository/query",
     b"Union(Row(stargazer=1), Row(language=5))"),
    ("POST", "/index/repository/query",
     b"Count(Xor(Row(stargazer=2), Row(language=5))) "
     b"Count(Difference(Row(stargazer=1), Row(stargazer=2)))"),
    ("POST", "/index/repository/field/stars", b"{}"),
    ("POST", "/index/repository/field/stars/import",
     b'{"rows": [3, 3, 3, 4], "columns": [1, 1048577, 77, 77]}'),
    ("POST", "/index/repository/query",
     b"Row(stars=3) Intersect(Row(stars=3), Row(stars=4))"),
    ("POST", "/index/repository/query",
     b"Set(10, stargazer=1) Set(10, stargazer=1) Clear(11, language=5)"),
    ("POST", "/index/repository/query",
     b"Count(Intersect(Row(stargazer=1), Row(language=5))) Row(stars=3)"),
    ("POST", "/index/stars2", b'{"options": {"trackExistence": true}}'),
    ("POST", "/index/repository/field/stars", b"{}"),            # 409
    ("POST", "/index/repository/query", b"Count(Row(nope=1))"),  # 400
    ("POST", "/index/missing/query", b"Count(Row(stars=3))"),    # 400
    ("POST", "/index/repository/query", b"Count(Row(stars=3)"),  # parse
    ("POST", "/index/repository/field/nope/import",
     b'{"rows": [1], "columns": [1]}'),                          # 404
    ("POST", "/index/repository/field/stars/import",
     b'{"rows": [1, 2], "columns": [1]}'),                       # 400
    ("GET", "/nope", None),                                      # 404
]


def test_http_bodies_match_reference(servers):
    jbase, pbase = servers
    for method, path, body in REQUESTS:
        want = _request(jbase, method, path, body)
        got = _request(pbase, method, path, body)
        assert got == want, (method, path, body)


SURFACE_REQUESTS = [
    ("GET", "/index/repository", None),
    ("GET", "/schema", None),
    ("GET", "/internal/schema", None),
    ("GET", "/version", None),
    ("GET", "/internal/shards/max", None),
    ("GET", "/export?index=repository&field=language", None),
    ("POST", "/index/repository/field/stars", b"{}"),
    ("POST", "/index/repository/field/stars/import",
     b'{"rows": [3, 4], "columns": [1, 1048577]}'),
    ("GET", "/export?index=repository&field=stars", None),
    ("POST", "/index/repository/query?shards=1",
     b"Row(stars=4) Count(Row(stargazer=1))"),
    ("DELETE", "/index/repository/field/stars", None),
    ("DELETE", "/index/repository/field/stars", None),   # 404
    ("GET", "/export?index=repository&field=stars", None),  # 404
    ("POST", "/index/repository/query", b"Row(stars=4)"),  # 400
    ("POST", "/index/other", b"{}"),
    ("DELETE", "/index/other", None),
    ("GET", "/index/other", None),                        # 404
    ("DELETE", "/nope", None),                            # 404
    ("GET", "/schema", None),
]


def test_surface_routes_match_reference(servers):
    jbase, pbase = servers
    for method, path, body in SURFACE_REQUESTS:
        want = _request(jbase, method, path, body)
        got = _request(pbase, method, path, body)
        assert got == want, (method, path, body)


def test_keep_alive_survives_deletes_and_protobuf_errors(servers):
    """One connection: a DELETE with a stray body, a protobuf error
    answer and a good query stay aligned, as on the reference."""
    import http.client

    for base in servers:
        host, port = base.rsplit(":", 1)
        conn = http.client.HTTPConnection(host[len("http://"):], int(port),
                                          timeout=60)
        try:
            out = []
            for method, path, body, headers in (
                    ("DELETE", "/index/repository/field/nope", b"junk", {}),
                    ("POST", "/index/repository/query", b"Row(nope=1)",
                     {"Accept": "application/x-protobuf"}),
                    ("POST", "/index/repository/query",
                     b"Count(Row(stargazer=1))", {})):
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                out.append((resp.status, resp.read()))
        finally:
            conn.close()
        assert [s for s, _ in out] == [404, 400, 200]
        if base == servers[0]:
            want = out
    assert out == want
