"""Shared fixtures of the serving-envelope parity tests
(``tests/test_torch_serving.py``, ``test_torch_qos.py``,
``test_torch_cost.py``, ``test_torch_tracing.py``): a small data dir, a
reference API server beside a port ``Server`` on copies of it, both
packages' process-wide serving state made fresh for a test and restored
after, and a request helper.

Everything runs on the CPU at 4 shards with ``torch.set_num_threads(1)``
and at most 8 client threads; no wait is longer than the pipeline's
gather window except the joins, and every thread and server is closed
in a ``finally``.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import threading
import urllib.error
import urllib.request

import numpy as np
import torch

import pilosa_tpu.serving.rescache as jrescache
import pilosa_tpu.storage as jstorage
import pilosa_tpu.storage.heat as jheat
import pilosa_tpu.storage.residency as jres
import pilosa_tpu.utils.stats as jstats
import pilosa_tpu.utils.tracing as jtracing
from pilosa_tpu.server.api import API as JAPI
from pilosa_tpu.server.http import serve_in_thread as j_serve_in_thread
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.server.api import API
from pilosa_tpu_torch.serving import rescache as prescache
from pilosa_tpu_torch.storage import FieldOptions, Holder
from pilosa_tpu_torch.storage import heat as pheat
from pilosa_tpu_torch.utils import stats as pstats
from pilosa_tpu_torch.utils import tracing as ptracing

torch.set_num_threads(1)

SW = 1 << 20
SHARDS = 4
BUDGET = 64 << 20


def seed_dir(root) -> int:
    """Fields f (rows 1-3), g (row 7), int fare (0..100) and keyed tag
    on index i over 4 shards, one row's attrs. Returns a column of f row
    1 (the IncludesColumn probe)."""
    rng = np.random.default_rng(15)
    h = Holder(str(root), device="cpu").open()
    api = API(h)
    try:
        idx = h.create_index("i")
        f = idx.create_field("f")
        g = idx.create_field("g")
        fare = idx.create_field("fare", FieldOptions(type="int", min=0,
                                                     max=100))
        for s in range(SHARDS):
            for fld, rows in ((f, (1, 2, 3)), (g, (7,))):
                for r in rows:
                    pos = np.unique(rng.integers(0, SW, 30 * r + 20))
                    fld.view("standard", create=True).fragment(
                        s, create=True).bulk_import(
                            np.full(pos.size, r, np.uint64),
                            pos.astype(np.uint64))
                    idx.mark_columns_exist(pos.astype(np.uint64)
                                           + np.uint64(s * SW))
        cols = np.unique(rng.integers(0, SHARDS * SW, 200)).astype(np.uint64)
        fare.import_values(cols, rng.integers(0, 101, cols.size))
        idx.mark_columns_exist(cols)
        probe = int(f.view("standard").fragment(0).row_columns(1)[0])
        api.create_field("i", "tag", {"keys": True})
        api.query_raw("i", 'Set(3, tag="apple") Set(5, tag="avocado") '
                      'Set(7, tag="banana") SetRowAttrs(f, 1, name="one")')
    finally:
        h.close()
    return probe


@contextlib.contextmanager
def fresh_planes(sample_rate: float = 0.0, cache_bytes: int = 0):
    """Both packages' process-wide serving state fresh for one test: the
    tracers (at ``sample_rate``), query trackers, stats registries, heat
    maps and result caches (``cache_bytes``), and the reference's row
    cache; the old ones restored after."""
    saved = (jtracing._global_tracer, ptracing._global_tracer,
             jtracing._global_query_tracker, ptracing._global_query_tracker,
             jstats._global, pstats._global, jheat._global_heat,
             pheat._global_heat, jrescache._global_cache,
             prescache._global_cache, jres.global_row_cache())
    jtracing.set_global_tracer(jtracing.Tracer(sample_rate=sample_rate))
    ptracing.set_global_tracer(ptracing.Tracer(sample_rate=sample_rate))
    jtracing._global_query_tracker = jtracing.QueryTracker()
    ptracing._global_query_tracker = ptracing.QueryTracker()
    jstats.set_global_stats(jstats.StatsClient())
    pstats.set_global_stats(pstats.StatsClient())
    jheat.set_global_heat(jheat.HeatMap())
    pheat.set_global_heat(pheat.HeatMap())
    jrescache.set_global_result_cache(jrescache.ResultCache(cache_bytes))
    prescache.set_global_result_cache(prescache.ResultCache(cache_bytes))
    jres.set_global_row_cache(jres.DeviceRowCache(BUDGET))
    try:
        yield
    finally:
        (jtracing._global_tracer, ptracing._global_tracer,
         jtracing._global_query_tracker, ptracing._global_query_tracker,
         jstats._global, pstats._global, jheat._global_heat,
         pheat._global_heat, jrescache._global_cache,
         prescache._global_cache) = saved[:10]
        jres.set_global_row_cache(saved[10])


def request(base: str, method: str, path: str, body: bytes | None = None,
            headers: dict | None = None):
    """(status, headers, body bytes) of one request."""
    r = urllib.request.Request(base + path, data=body, method=method)
    for k, v in (headers or {}).items():
        r.add_header(k, v)
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


class Pair:
    """A reference API server and a port ``Server`` (CPU) on copies of
    one seeded dir. ``port_kwargs`` go to the port's Server; the tests
    set the same planes on the reference's API (``japi``)."""

    def __init__(self, seed_root, tmp_path, **port_kwargs):
        jdir, pdir = tmp_path / "jax", tmp_path / "port"
        shutil.copytree(seed_root, jdir)
        shutil.copytree(seed_root, pdir)
        self.roots = {"jax": str(jdir), "port": str(pdir)}
        self.jh = jstorage.Holder(str(jdir)).open()
        self.japi = JAPI(self.jh)
        self.jserver, jport, _ = j_serve_in_thread(self.japi)
        self.server = None
        try:
            self.server = Server(str(pdir), port=0, device="cpu",
                                 budget_bytes=BUDGET, **port_kwargs).open()
        except BaseException:
            self.close()
            raise
        self.papi = self.server.api
        self.bases = {"jax": f"http://localhost:{jport}",
                      "port": f"http://localhost:{self.server.port}"}

    def apis(self):
        return {"jax": self.japi, "port": self.papi}

    def get(self, pkg, method, path, body=None, headers=None):
        return request(self.bases[pkg], method, path, body, headers)

    def both(self, method, path, body=None, headers=None):
        """The same request to the reference, then the port: both
        answers, (status, headers, body) each."""
        return (self.get("jax", method, path, body, headers),
                self.get("port", method, path, body, headers))

    def same(self, method, path, body=None, headers=None) -> bytes:
        """``both``, asserting equal statuses and bodies; the body."""
        j, p = self.both(method, path, body, headers)
        assert (p[0], p[2]) == (j[0], j[2]), (method, path, body)
        return p[2]

    def json(self, pkg, path):
        status, _, body = self.get(pkg, "GET", path)
        assert status == 200, (pkg, path, body)
        return json.loads(body)

    def close(self):
        self.jserver.shutdown()
        self.jserver.server_close()
        self.jh.close()
        if self.server is not None:
            self.server.close()


def run_threads(fns) -> list:
    """Run each thunk on its own thread, started together; their
    results (or exceptions) in order. Every thread is joined."""
    out: list = [None] * len(fns)
    gate = threading.Event()

    def run(k, fn):
        gate.wait(10)
        try:
            out[k] = fn()
        except BaseException as e:  # reported to the caller
            out[k] = e

    threads = [threading.Thread(target=run, args=(k, fn))
               for k, fn in enumerate(fns)]
    try:
        for t in threads:
            t.start()
        gate.set()
    finally:
        for t in threads:
            t.join(60)
    return out


class Plug:
    """Hold an API's pipeline dispatcher inside its first ``submit``
    until ``n`` more requests are queued behind it, so they form one
    wave; the executor is restored on exit."""

    def __init__(self, api, n: int):
        self.api = api
        self.n = n
        self.real = api.executor
        self.entered = threading.Event()
        self.release = threading.Event()
        self.submits = 0
        plug = self

        class Held:
            def __getattr__(self, name):
                return getattr(plug.real, name)

            def submit(self, index, query, **kwargs):
                plug.submits += 1
                if not plug.entered.is_set():
                    plug.entered.set()
                    assert plug.release.wait(30)
                return plug.real.submit(index, query, **kwargs)

        self.held = Held()

    def __enter__(self):
        self.api.executor = self.held
        return self

    def wait_queued(self) -> None:
        """Block until the dispatcher holds the plug and ``n`` requests
        wait in its queue, then let it go."""
        assert self.entered.wait(30)
        pipe = self.api._pipeline
        for _ in range(30000):
            if pipe._q.qsize() >= self.n:
                break
            threading.Event().wait(0.001)
        assert pipe._q.qsize() >= self.n
        self.release.set()

    def __exit__(self, *exc):
        self.release.set()
        self.api.executor = self.real
        return False
