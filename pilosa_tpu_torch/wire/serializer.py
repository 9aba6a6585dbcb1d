"""Serializer between executor results and protobuf wire messages (the
port's copy of ``pilosa_tpu.wire.serializer``: the query, result, error,
import and import-value messages; the batch and sync messages come with
the cluster planes).

The JSON path (result_to_json) stays canonical; this maps the same result
objects to QueryResponse protos for clients negotiating
application/x-protobuf, byte for byte as the reference does.
"""

from __future__ import annotations

import json

import numpy as np

from pilosa_tpu_torch.executor.result import (
    GroupCount,
    Pair,
    RowResult,
    ValCount,
)
from pilosa_tpu_torch.utils import as_int_list
from pilosa_tpu_torch.wire import pb2

RESULT_NIL = 0
RESULT_ROW = 1
RESULT_PAIRS = 2
RESULT_COUNT = 3
RESULT_CHANGED = 4
RESULT_VALCOUNT = 5
RESULT_GROUPS = 6
RESULT_ROW_IDS = 7
RESULT_ROW_KEYS = 8


def _attrs_to_proto(m, attrs: dict) -> None:
    for k, v in sorted(attrs.items()):
        a = m.add()
        a.key = k
        if isinstance(v, bool):
            a.type, a.bool_value = 3, v
        elif isinstance(v, int):
            a.type, a.int_value = 2, v
        elif isinstance(v, float):
            a.type, a.float_value = 4, v
        else:
            a.type, a.string_value = 1, str(v)


def attrs_from_proto(attrs) -> dict:
    out = {}
    for a in attrs:
        out[a.key] = {
            1: a.string_value, 2: a.int_value, 3: a.bool_value, 4: a.float_value,
        }.get(a.type, a.string_value)
    return out


def encode_results(results, trace: dict | None = None) -> bytes:
    """``trace``: the finished span subtree of a traced sub-query
    (``X-Pilosa-Trace``), carried back as ``QueryResponse.trace_json``."""
    p = pb2()
    resp = p.QueryResponse()
    for res in results:
        qr = resp.results.add()
        _encode_result(qr, res)
    if trace is not None:
        resp.trace_json = json.dumps(trace, separators=(",", ":"))
    return resp.SerializeToString()


def _encode_result(qr, res) -> None:
    if res is None:
        qr.type = RESULT_NIL
    elif isinstance(res, RowResult):
        qr.type = RESULT_ROW
        if res.keys is not None:
            qr.row.keys.extend(res.keys)
        else:
            qr.row.columns.extend(int(c) for c in res.columns().tolist())
        _attrs_to_proto(qr.row.attrs, res.attrs)
        if res.column_attrs:
            for entry in res.column_attrs:
                cs = qr.column_attrs.add()
                cs.id = int(entry["id"])
                _attrs_to_proto(cs.attrs, entry["attrs"])
    elif isinstance(res, bool):
        qr.type = RESULT_CHANGED
        qr.changed = res
    elif isinstance(res, int):
        qr.type = RESULT_COUNT
        qr.n = res
    elif isinstance(res, ValCount):
        qr.type = RESULT_VALCOUNT
        qr.val_count.value = res.value
        qr.val_count.count = res.count
    elif isinstance(res, list) and res and isinstance(res[0], Pair):
        qr.type = RESULT_PAIRS
        for pair in res:
            pp = qr.pairs.add()
            pp.id = pair.id
            pp.count = pair.count
            if pair.key is not None:
                pp.key = pair.key
    elif isinstance(res, list) and res and isinstance(res[0], GroupCount):
        qr.type = RESULT_GROUPS
        for g in res:
            gg = qr.groups.add()
            gg.count = g.count
            if g.sum is not None:
                gg.has_sum = True
                gg.sum = g.sum
            for entry in g.group:
                fr = gg.group.add()
                fr.field = entry["field"]
                if "rowKey" in entry:
                    fr.row_key = entry["rowKey"]
                else:
                    fr.row_id = entry["rowID"]
    elif isinstance(res, list) and res and isinstance(res[0], str):
        qr.type = RESULT_ROW_KEYS
        qr.row_keys.extend(res)
    elif isinstance(res, list):
        qr.type = RESULT_ROW_IDS
        qr.row_ids.extend(int(r) for r in res)
    else:
        qr.type = RESULT_NIL


def encode_error(message: str) -> bytes:
    p = pb2()
    resp = p.QueryResponse()
    resp.err = message
    return resp.SerializeToString()


def decode_query_request(data: bytes):
    """Returns (pql, shards, remote, opts) — opts holds the true
    request-level result options under their URL-param names."""
    p = pb2()
    req = p.QueryRequest()
    req.ParseFromString(data)
    opts = {}
    if req.column_attrs:
        opts["columnAttrs"] = True
    if req.exclude_columns:
        opts["excludeColumns"] = True
    if req.exclude_row_attrs:
        opts["excludeRowAttrs"] = True
    return (
        req.query,
        list(req.shards) if req.shards else None,
        req.remote,
        opts,
    )


def decode_import_request(data: bytes):
    p = pb2()
    req = p.ImportRequest()
    req.ParseFromString(data)
    # numpy straight from the repeated fields: the import path converts
    # to arrays anyway, and round-tripping 50k-element Python int lists
    # costs more than the protobuf parse itself
    n = len(req.row_ids)
    return (
        np.fromiter(req.row_ids, np.uint64, count=n),
        np.fromiter(req.column_ids, np.uint64, count=len(req.column_ids)),
        list(req.timestamps) or None,
        req.clear,
    )


def decode_import_value_request(data: bytes):
    p = pb2()
    req = p.ImportValueRequest()
    req.ParseFromString(data)
    return (
        np.fromiter(req.column_ids, np.uint64,
                    count=len(req.column_ids)),
        np.fromiter(req.values, np.int64, count=len(req.values)),
        req.clear,
    )


# ------------------------------------------------------- request encoders
#
# The client's side of the negotiated wire: varint-packed id lists are
# ~2-5x smaller than JSON int lists; bulk set-bit imports go smaller still
# through the roaring route (import-roaring).


def encode_import_request(index: str, field: str, rows, columns,
                          timestamps=None, clear: bool = False) -> bytes:
    p = pb2()
    req = p.ImportRequest()
    req.index, req.field, req.clear = index, field, clear
    req.row_ids.extend(as_int_list(rows))
    req.column_ids.extend(as_int_list(columns))
    if timestamps is not None:
        req.timestamps.extend("" if t is None else str(t) for t in timestamps)
    return req.SerializeToString()


def encode_import_value_request(index: str, field: str, columns, values,
                                clear: bool = False) -> bytes:
    p = pb2()
    req = p.ImportValueRequest()
    req.index, req.field, req.clear = index, field, clear
    req.column_ids.extend(as_int_list(columns))
    req.values.extend(as_int_list(values))
    return req.SerializeToString()


def decode_results_json(data: bytes) -> dict:
    """Parse a QueryResponse into the SAME dict shapes the JSON surface
    emits (executor/result.py to_json), whichever encoding a client
    negotiated."""
    p = pb2()
    resp = p.QueryResponse()
    resp.ParseFromString(data)
    if resp.err:
        return {"error": resp.err}
    return _response_results_json(resp)


def _response_results_json(resp) -> dict:
    """The result-decoding body of a response."""
    import json as _json

    trace = None
    raw_trace = getattr(resp, "trace_json", "")
    if raw_trace:
        try:
            trace = _json.loads(raw_trace)
        except ValueError:
            trace = None  # malformed subtree degrades to untraced
    out = []
    for qr in resp.results:
        t = qr.type
        if t == RESULT_ROW:
            row: dict = {"attrs": attrs_from_proto(qr.row.attrs)}
            if qr.row.keys:
                row["keys"] = list(qr.row.keys)
            else:
                row["columns"] = list(qr.row.columns)
            if qr.column_attrs:
                row["columnAttrs"] = [
                    {"id": cs.id, "attrs": attrs_from_proto(cs.attrs)}
                    for cs in qr.column_attrs
                ]
            out.append(row)
        elif t == RESULT_PAIRS:
            out.append([
                {"id": pp.id, "count": pp.count, **({"key": pp.key} if pp.key else {})}
                for pp in qr.pairs
            ])
        elif t == RESULT_COUNT:
            out.append(int(qr.n))
        elif t == RESULT_CHANGED:
            out.append(bool(qr.changed))
        elif t == RESULT_VALCOUNT:
            out.append({"value": qr.val_count.value, "count": qr.val_count.count})
        elif t == RESULT_GROUPS:
            groups = []
            for gg in qr.groups:
                g: dict = {
                    "group": [
                        {"field": fr.field, "rowKey": fr.row_key}
                        if fr.row_key else {"field": fr.field, "rowID": fr.row_id}
                        for fr in gg.group
                    ],
                    "count": gg.count,
                }
                if gg.has_sum:
                    g["sum"] = gg.sum
                groups.append(g)
            out.append(groups)
        elif t == RESULT_ROW_IDS:
            out.append(list(qr.row_ids))
        elif t == RESULT_ROW_KEYS:
            out.append(list(qr.row_keys))
        else:
            out.append(None)
    envelope = {"results": out}
    if trace is not None:
        envelope["trace"] = trace
    return envelope
