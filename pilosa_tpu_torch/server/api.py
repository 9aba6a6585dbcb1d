"""The API layer between HTTP and the holder/executor (reference api.go).

The port's thin copy of ``pilosa_tpu.server.api``: schema writes, PQL
queries answered as pre-serialized JSON bytes, bulk bit imports (a mutex
or bool field's through ``Fragment.import_mutex``, a time field's
timestamped bits also into each quantum view, one bulk import a view)
and int fields' value imports, with the reference's validation and
error texts so both packages answer the same bytes. A write is acknowledged only
once durable (``_ack_durable``): in ``group`` mode the request waits for
the WAL group holding its records to be fsynced, in ``per-op`` mode every
record was fsynced inline, and ``flush-only`` promises nothing. Before
that, the request's patches of resident leaves launch together
(``DeviceRowCache.batch_writes``: one K3 launch a request), and in the
fsyncing modes the key translation log is fsynced before the WAL's
barrier. A query may ask for the request-level result options
``columnAttrs``, ``excludeColumns`` and ``excludeRowAttrs``. A query
runs as a served request (``storage/heat.py``: its operand assemblies
and PQL writes record heat), and each import records the write heat of
its shards. While the holder's ``StorageHealth`` latch is tripped (a
failed WAL fsync, snapshot or ``.meta`` write), every write is shed with a
503 and ``retry_after`` before the executor sees it, so no patch reaches
the card; reads go on, ``status()`` reports the latch, and
``integrity_metrics()`` the integrity counters. ``scrub_now()`` runs one
scrubber pass (``parallel/scrub.py``). ``import_roaring`` unions one
shard's roaring bitmap (either layout) in one locked pass; the deletes
purge the residency cache and the heat map of what they remove;
``schema``, ``info``, ``version``, ``max_shards`` and ``export_csv``
answer the read routes, and ``tiering_metrics`` and
``durability_metrics`` feed ``/metrics`` beside the cache's and the
integrity plane's blocks. Cluster, QoS, tracing, the cost plane, the
result cache and multi-process serving are not ported yet.
"""

from __future__ import annotations

import numpy as np

from pilosa_tpu_torch import __version__
from pilosa_tpu_torch.executor.executor import (
    Executor,
    PQLError,
    column_attr_sets,
    parse_time,
    strip_columns,
)
from pilosa_tpu_torch.executor.result import RowResult, results_json_bytes
from pilosa_tpu_torch.parallel.scrub import Scrubber
from pilosa_tpu_torch.pql import ParseError, parse
from pilosa_tpu_torch.roaring.format import load_any
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, SHARD_WIDTH_EXP, \
    shard_groups
from pilosa_tpu_torch.storage import heat
from pilosa_tpu_torch.storage.field import (
    TYPE_BOOL,
    TYPE_INT,
    TYPE_MUTEX,
    TYPE_TIME,
    FieldOptions,
)
from pilosa_tpu_torch.storage.integrity import global_integrity
from pilosa_tpu_torch.storage.view import VIEW_STANDARD, views_for_time
from pilosa_tpu_torch.storage.wal import MODE_FLUSH_ONLY

# The reference's max-writes-per-request default: the most Set/Clear
# calls in one query, and the most bits in one import body.
MAX_WRITES_PER_REQUEST = 5000


def _ascii_digits(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(uint8[n, width] ASCII digits of each value, left-aligned, its
    digit count); past a value's digits the row holds filler."""
    values = values.astype(np.uint64)
    width = len(str(int(values.max())))
    n_dig = np.ones(values.size, np.int64)
    for k in range(1, width):
        n_dig += values >= np.uint64(10 ** k)
    digits = np.empty((values.size, width), np.uint8)
    rest = values.copy()
    for k in range(width - 1, -1, -1):  # right-aligned, leading zeros
        digits[:, k] = rest % np.uint64(10)
        rest //= np.uint64(10)
    lead = (width - n_dig)[:, None]
    at = np.minimum(np.arange(width)[None, :] + lead, width - 1)
    return np.take_along_axis(digits, at, 1) + ord("0"), n_dig


def csv_lines(rows: np.ndarray, cols: np.ndarray) -> bytes:
    """A ``row,col`` line for each pair, each ended by a newline: one byte
    matrix a line (the row's digits, a comma, the column's digits, the
    newline), with each line's filler masked out."""
    rd, rn = _ascii_digits(rows)
    cd, cn = _ascii_digits(cols)
    n, wr, wc = rd.shape[0], rd.shape[1], cd.shape[1]
    line = np.concatenate([rd, np.full((n, 1), ord(","), np.uint8), cd,
                           np.full((n, 1), ord("\n"), np.uint8)], axis=1)
    j = np.arange(line.shape[1])[None, :]
    keep = ((j < rn[:, None]) | (j == wr)
            | ((j > wr) & (j <= wr + cn[:, None])) | (j == wr + 1 + wc))
    return line[keep].tobytes()


class ApiError(Exception):
    """An error with its HTTP status; ``retry_after`` (seconds) becomes a
    ``Retry-After`` header."""

    def __init__(self, message: str, status: int = 400,
                 retry_after: float | None = None):
        super().__init__(message)
        self.status = status
        self.retry_after = retry_after


class API:
    def __init__(self, holder):
        self.holder = holder
        self.executor = Executor(holder, device=holder.device)
        self.max_writes_per_request = MAX_WRITES_PER_REQUEST
        self.tierer = None  # the server's ResidencyTierer, when one runs
        # the integrity scrubber: the server's ticker, or the one that
        # on-demand passes create
        self.scrubber = None

    # ----------------------------------------------------------------- query

    def query_raw(self, index: str, pql: str, shards=None,
                  remote: bool = False, opts: dict | None = None) -> list:
        """Execute and return the raw result objects, with the request's
        result options ``opts`` applied; ``shards`` restricts the calls
        to those shards (``?shards=``, ``QueryRequest.shards``). Reads
        submit every call before resolving any, so concurrent requests
        share micro-batched launches. ``remote`` marks a peer's
        sub-query: on one node it only skips the storage-degraded shed of
        writes, as the reference's does."""
        results = self._query_raw(index, pql, shards, remote)
        if opts:
            results = self._apply_request_opts(index, results, opts)
        return results

    def _query_raw(self, index: str, pql: str, shards, remote: bool
                   ) -> list:
        try:
            query = parse(pql)
            writes = len(query.write_calls())
            if 0 < self.max_writes_per_request < writes:
                raise ApiError(
                    f"too many writes in request: {writes} > "
                    f"max-writes-per-request {self.max_writes_per_request}"
                )
            if writes and not remote:
                self._check_not_storage_degraded()
            with heat.serving():  # a served request: its heat records
                if writes:
                    with self.holder.cache.batch_writes():
                        results = self.executor.execute(index, query,
                                                        shards=shards)
                    self._ack_durable()
                    return results
                return [d.result() for d in self.executor.submit(
                    index, query, shards=shards)]
        except (ParseError, PQLError) as e:
            raise ApiError(str(e)) from e

    def _check_not_storage_degraded(self) -> None:
        """503 with Retry-After while the disk is sick (the holder's
        StorageHealth latch); it clears when a probe write succeeds."""
        health = self.holder.health
        if not health.degraded:
            return
        raise ApiError(
            f"storage degraded ({health.reason}): writes are shed on "
            "this node until a probe write succeeds; reads still serve",
            503, retry_after=5.0)

    def _ack_durable(self) -> None:
        """The ACK gate: a 200 on a write means its op records are
        fsynced (group mode waits for their group; per-op fsynced inline;
        flush-only promises nothing). The key translation log is fsynced
        first: a keyed write's bit must not outlive its key→id record,
        or it would come back under another key."""
        wal = self.holder.wal
        if wal.mode != MODE_FLUSH_ONLY:
            self.holder.translate.sync()
            wal.barrier()

    def _apply_request_opts(self, index: str, results: list,
                            opts: dict) -> list:
        """The request-level result options on every row result:
        ``columnAttrs`` attaches the columns' attrs, ``excludeRowAttrs``
        drops the row's, ``excludeColumns`` the columns."""
        idx = self.holder.index(index)
        out = []
        for res in results:
            if isinstance(res, RowResult):
                if opts.get("columnAttrs") and idx is not None:
                    res.column_attrs = column_attr_sets(idx, res)
                if opts.get("excludeRowAttrs"):
                    res.attrs = {}
                if opts.get("excludeColumns"):
                    res = strip_columns(res)
            out.append(res)
        return out

    def query_json_bytes(self, index: str, pql: str, shards=None,
                         remote: bool = False,
                         opts: dict | None = None) -> bytes:
        """The whole ``{"results": [...]}`` response envelope as bytes."""
        return results_json_bytes(self.query_raw(index, pql, shards=shards,
                                                 remote=remote, opts=opts))

    # ---------------------------------------------------------------- schema

    def create_index(self, name: str, keys: bool = False,
                     track_existence: bool = True) -> dict:
        self._check_not_storage_degraded()  # schema writes hit .meta
        try:
            idx = self.holder.create_index(name, keys=keys,
                                           track_existence=track_existence)
        except ValueError as e:
            status = 409 if "already exists" in str(e) else 400
            raise ApiError(str(e), status) from e
        return idx.schema()

    def create_field(self, index: str, name: str,
                     options: dict | None = None) -> dict:
        self._check_not_storage_degraded()  # schema writes hit .meta
        idx = self._index(index)
        try:
            field = idx.create_field(name, FieldOptions.from_dict(options or {}))
        except ValueError as e:
            status = 409 if "already exists" in str(e) else 400
            raise ApiError(str(e), status) from e
        return {"name": field.name, "options": field.options.to_dict()}

    def delete_index(self, name: str) -> None:
        """Delete an index: its files, its WAL ops (a durable tombstone)
        and every residency entry and heat record of it."""
        idx = self.holder.index(name)
        try:
            self.holder.delete_index(name)
        except KeyError as e:
            raise ApiError(str(e), 404) from e
        heat.global_heat().forget(idx.scope, name)

    def delete_field(self, index: str, name: str) -> None:
        idx = self._index(index)
        try:
            idx.delete_field(name)
        except KeyError as e:
            raise ApiError(str(e), 404) from e
        heat.global_heat().forget(idx.scope, index, name)

    def schema(self) -> dict:
        return {"indexes": self.holder.schema()}

    # ---------------------------------------------------------------- import

    def import_bits(self, index: str, field: str, rows, columns,
                    timestamps=None, clear: bool = False,
                    remote: bool = False) -> int:
        """Bulk bit import (reference api.Import / fragment.bulkImport),
        grouped by shard and written fragment-wise: a mutex or bool field
        clears each column's previous row in the same pass, and a time
        field's timestamped bits also go into each quantum view, one bulk
        import a view and shard. Returns the bits changed in the standard
        view. ``remote`` (a peer's slice) skips the storage-degraded
        shed."""
        idx = self._index(index)
        fld = self._field(idx, field)
        if not remote:
            self._check_not_storage_degraded()
        try:
            rows_i = np.asarray(rows, dtype=np.int64)
            columns_i = np.asarray(columns, dtype=np.int64)
        except OverflowError as e:
            raise ApiError(f"row/column id out of range: {e}") from e
        if rows_i.shape != columns_i.shape:
            raise ApiError("rows and columns must be the same length")
        if rows_i.size and (rows_i.min() < 0 or columns_i.min() < 0):
            raise ApiError("rows and columns must be non-negative")
        if timestamps is not None and len(timestamps) != rows_i.size:
            raise ApiError("timestamps must match rows length")
        if (fld.options.type == TYPE_BOOL and rows_i.size
                and rows_i.max() > 1):
            raise ApiError("bool field rows must be 0 (false) or 1 (true)")
        rows = rows_i.astype(np.uint64)
        columns = columns_i.astype(np.uint64)
        if rows.size == 0:
            return 0
        order, bounds, shards_sorted = shard_groups(columns)
        rows, columns = rows[order], columns[order]
        stamps = ([timestamps[i] for i in order]
                  if timestamps is not None and fld.options.type == TYPE_TIME
                  else None)
        mutex = fld.options.type in (TYPE_MUTEX, TYPE_BOOL)
        changed = 0
        with self.holder.cache.batch_writes():
            for i in range(bounds.size - 1):
                lo, hi = int(bounds[i]), int(bounds[i + 1])
                if clear:
                    for r, c in zip(rows[lo:hi].tolist(),
                                    columns[lo:hi].tolist()):
                        changed += fld.clear_bit(int(r), int(c))
                    continue
                shard = int(shards_sorted[lo])
                pos = columns[lo:hi] & np.uint64(SHARD_WIDTH - 1)
                idx.mark_columns_exist(columns[lo:hi])
                frag = fld.view(VIEW_STANDARD, create=True).fragment(
                    shard, create=True)
                if mutex:
                    changed += frag.import_mutex(rows[lo:hi], pos)
                else:
                    changed += frag.bulk_import(rows[lo:hi], pos)
                if stamps is not None:
                    self._import_time_views(fld, shard, rows[lo:hi], pos,
                                            stamps[lo:hi])
        # write heat: one record a shard group, weighted by its bits
        record = heat.global_heat().record_write
        for i in range(bounds.size - 1):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            record(index, field, int(shards_sorted[lo]), n=float(hi - lo),
                   scope=idx.scope)
        self._ack_durable()
        return int(changed)

    @staticmethod
    def _import_time_views(fld, shard: int, rows, pos, stamps) -> None:
        """One shard's timestamped bits into the quantum views of their
        timestamps, one bulk import a view (a bit without a timestamp
        stays in the standard view alone)."""
        by_view: dict[str, list] = {}
        for j, ts in enumerate(stamps):
            if not ts:
                continue
            for vname in views_for_time(VIEW_STANDARD,
                                        fld.options.time_quantum,
                                        parse_time(ts)):
                by_view.setdefault(vname, []).append(j)
        for vname, sel in by_view.items():
            sel = np.asarray(sel, np.int64)
            fld.view(vname, create=True).fragment(
                shard, create=True).bulk_import(rows[sel], pos[sel])

    def import_values(self, index: str, field: str, columns, values,
                      clear: bool = False, remote: bool = False) -> int:
        """Batched BSI value import (reference api.ImportValue), single
        node: duplicate columns keep the last value; imported columns are
        marked existing. ``clear`` clears the columns' values instead."""
        idx = self._index(index)
        fld = self._field(idx, field)
        if not remote:
            self._check_not_storage_degraded()
        if fld.options.type != TYPE_INT:
            raise ApiError(f"field {field!r} is not an int field")
        if len(columns) != len(values):
            raise ApiError("columns and values must be the same length")
        try:
            cols_i = np.asarray(columns, dtype=np.int64)
        except OverflowError as e:  # ids beyond int64: a 400, not a 500
            raise ApiError(f"column id out of range: {e}") from e
        if cols_i.size and cols_i.min() < 0:
            raise ApiError(f"column {int(cols_i.min())} is negative")
        changed = 0
        with self.holder.cache.batch_writes():
            try:
                if clear:
                    for col in cols_i.tolist():
                        changed += fld.clear_value(int(col))
                else:
                    changed = fld.import_values(cols_i.astype(np.uint64),
                                                values)
                    idx.mark_columns_exist(cols_i)
            except (ValueError, OverflowError) as e:
                raise ApiError(str(e)) from e
        # write heat: one record a shard, weighted by its columns
        shards_u, counts_u = np.unique(cols_i >> SHARD_WIDTH_EXP,
                                       return_counts=True)
        for shard, n in zip(shards_u.tolist(), counts_u.tolist()):
            heat.global_heat().record_write(index, field, int(shard),
                                            n=float(n), scope=idx.scope)
        self._ack_durable()
        return int(changed)

    def import_roaring(self, index: str, field: str, shard: int,
                       data: bytes, remote: bool = False) -> int:
        """One shard's bits as a roaring bitmap of ``row << 20 | position``
        ids, in the port's layout or upstream pilosa's (``load_any``
        sniffs the cookie), unioned into the standard view's fragment in
        one locked pass: one op record, and one K3 launch for every
        resident leaf the rows touch. A malformed body is a 400, more
        bits than max-writes-per-request a 413 (``remote``, a peer's
        slice, skips that limit and the storage-degraded shed). Returns
        the bits changed."""
        idx = self._index(index)
        fld = self._field(idx, field)
        if not remote:
            self._check_not_storage_degraded()
        frag = fld.view(VIEW_STANDARD, create=True).fragment(shard,
                                                             create=True)
        try:
            bitmap, _ = load_any(data)
            ids = bitmap.to_ids()
        except ValueError as e:
            raise ApiError(str(e)) from e
        limit = self.max_writes_per_request
        if not remote and 0 < limit < int(ids.size):
            raise ApiError(
                f"import-roaring body of {int(ids.size)} bits exceeds "
                f"max-writes-per-request {limit}; split the bitmap", 413)
        positions = np.unique(ids & np.uint64(SHARD_WIDTH - 1))
        with self.holder.cache.batch_writes():
            try:
                changed = frag.add_ids(ids)
            except ValueError as e:
                raise ApiError(str(e)) from e
            idx.mark_columns_exist(
                (shard << SHARD_WIDTH_EXP) + positions.astype(np.int64))
        heat.global_heat().record_write(index, field, shard,
                                        n=float(ids.size), scope=idx.scope)
        self._ack_durable()
        return changed

    # ---------------------------------------------------------------- export

    def export_csv_bytes(self, index: str, field: str) -> bytes:
        """``row,column`` lines of the standard view in shard, row and
        column order, a newline after each (reference api.ExportCSV),
        formatted by numpy from each fragment's sorted bit ids."""
        idx = self._index(index)
        fld = self._field(idx, field)
        view = fld.view(VIEW_STANDARD)
        rows, cols = [], []
        if view is not None:
            for shard in sorted(view.fragments):
                ids = view.fragment(shard).bitmap.to_ids()
                rows.append(ids >> np.uint64(SHARD_WIDTH_EXP))
                cols.append((ids & np.uint64(SHARD_WIDTH - 1))
                            + np.uint64(shard << SHARD_WIDTH_EXP))
        if not rows:
            return b""
        return csv_lines(np.concatenate(rows), np.concatenate(cols))

    def export_csv(self, index: str, field: str) -> str:
        return self.export_csv_bytes(index, field).decode()

    def recalculate_caches(self) -> None:
        """Recount and save every fragment's row-count cache (reference
        ``POST /recalculate-caches``), before returning."""
        for idx in list(self.holder.indexes.values()):
            for field in list(idx.fields.values()):
                for view in list(field.views.values()):
                    for frag in list(view.fragments.values()):
                        frag.recalculate_cache()

    # ---------------------------------------------------------------- status

    def status(self) -> dict:
        health = self.holder.health
        return {
            "state": "NORMAL",
            "nodes": [{"id": "local", "uri": "localhost",
                       "isCoordinator": True, "state": "NORMAL"}],
            "localID": "local",
            "maxWritesPerRequest": self.max_writes_per_request,
            "epoch": 0,
            "clusterDegraded": False,
            "storageDegraded": bool(health.degraded),
            "storageDegradedReason": health.reason,
        }

    def info(self) -> dict:
        """The reference's ``/info``, but for ``devices``: the port lists
        its torch device, ``{"id": 0, "platform": "gpu", "kind": <the
        card's name>}`` on a GPU and platform "cpu" under
        ``device="cpu"``, where the reference lists its JAX devices."""
        dev = self.holder.device
        if dev.type == "cuda":
            import torch

            index = dev.index if dev.index is not None else 0
            devices = [{"id": index, "platform": "gpu",
                        "kind": torch.cuda.get_device_name(index)}]
        else:
            devices = [{"id": 0, "platform": "cpu", "kind": "cpu"}]
        return {"shardWidth": SHARD_WIDTH, "cpuPhysicalCores": 0,
                "version": __version__, "devices": devices}

    def version(self) -> dict:
        return {"version": __version__}

    def max_shards(self) -> dict:
        return {"standard": {name: (idx.available_shards() or [0])[-1]
                             for name, idx in self.holder.indexes.items()}}

    def tiering_metrics(self) -> dict:
        """The tierer's ``residency_tier_*`` pass counters, zeros with no
        tierer."""
        if self.tierer is not None:
            return self.tierer.metrics()
        return {
            "residency_tier_passes_total": 0,
            "residency_tier_pass_promotions_total": 0,
            "residency_tier_pass_demotions_total": 0,
            "residency_tier_promoted_bytes_total": 0,
            "residency_tier_demoted_bytes_total": 0,
            "residency_tier_paced_sleep_seconds_total": 0.0,
            "residency_tier_last_pass_seconds": 0.0,
        }

    def durability_metrics(self) -> dict:
        """The WAL's series of the reference's ``wal`` block (its CDC
        series come with the CDC plane)."""
        out = self.holder.wal.metrics()
        del out["retained_bytes"]  # the reference's cdc_retained_bytes
        return out

    def integrity_metrics(self) -> dict:
        """The storage-integrity series: the degraded latch, the
        verified-load and quarantine counters and the scrubber's, every
        key present from the first read."""
        out = {
            "scrub_passes_total": 0,
            "scrub_fragments_scanned_total": 0,
            "scrub_bytes_total": 0,
            "scrub_corruptions_detected_total": 0,
            "scrub_read_repairs_total": 0,
            "scrub_self_heals_total": 0,
            "scrub_unrepaired_total": 0,
            "scrub_last_pass_seconds": 0.0,
            "scrub_paced_sleep_seconds": 0.0,
        }
        out.update(global_integrity().metrics())
        out.update(self.holder.health.metrics())
        if self.scrubber is not None:
            out.update(self.scrubber.metrics())
        return out

    def scrub_now(self) -> dict:
        """One scrub pass (``POST /internal/scrub``, ``check --host``):
        the server's scrubber when one runs (its pacing budget shared),
        else an unpaced one kept so that passes add up in the counters."""
        if self.scrubber is None:
            self.scrubber = Scrubber(self.holder)
        return self.scrubber.scrub_pass()

    def _index(self, name: str):
        idx = self.holder.index(name)
        if idx is None:
            raise ApiError(f"index {name!r} not found", 404)
        return idx

    @staticmethod
    def _field(idx, name: str):
        fld = idx.field(name)
        if fld is None:
            raise ApiError(f"field {name!r} not found", 404)
        return fld
