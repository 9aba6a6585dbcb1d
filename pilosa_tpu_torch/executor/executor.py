"""The query executor: compile, dispatch, micro-batch, reduce.

The port's copy of ``pilosa_tpu.executor.executor`` for these slices:
Row, Union, Intersect, Difference, Xor, Not, All, Shift and Range over
set fields and int (BSI) fields, Count of any such tree, Sum/Min/Max
with or without a filter, TopN, Rows, GroupBy (aggregate=Sum, having=),
IncludesColumn, Options (shards=, excludeColumns=), time windows
(``Row(f=r, from=, to=)`` ORs the quantum views that cover the window
into one leaf), and the Set/Clear (timestamped, mutex and int fields
included), ClearRow and Store writes, with string keys on keyed
indexes (columns) and fields (rows) through the holder's translate log,
and the attribute calls (SetRowAttrs, SetColumnAttrs, TopN(attrName=),
Options(columnAttrs=)). A call compiles to a structure
(``expr``) over stacked leaves and query-time scalars; shift and
BSI-comparison nodes run first, each through its own kernel (K4, K5),
then a Count runs K1 over the rest and a row call K2, and pipelined
Counts of one shape share one K1 launch per micro-batch; Sum runs K6 and
Min/Max K7 (one launch per query). TopN recounts its candidates with K8
over stacked candidate matrices, GroupBy runs K9 once per level (past 16
dimensions the surviving prefix groups fold into one temporary matrix).
A tree over the kernels' 16 operands or 16 stack slots runs part by
part as K2 'tree' steps. Store takes its child's row through K2 and
writes each shard's words.

The serving hooks are the reference's: ``execute`` and ``submit`` take
a ``deadline`` checked before any launch, ``instrument_calls`` wraps a
query's calls in their spans, stats and PROFILE nodes, every launch
runs in ``dispatch`` (a ``device.dispatch`` span and the cost context's
``note_dispatch``, enqueue time only), and ``pipeline_coalescable``
says which queries the serving pipeline takes.

The reference's mesh hooks (``_make_block``, the ``_launch_*`` methods,
``_note_reduce``, ``_row_host``, ``_quant_ranking_active``) are the
single-device forms here; ``parallel.dist.DistExecutor`` runs them over
a mesh's members, and turns on TopN's quantized ranking pass and
GroupBy's quantized pruning levels.
"""

from __future__ import annotations

import collections
import datetime as dt
import math
import re
import threading
import time
import weakref

import numpy as np
import torch

from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch import kernels
from pilosa_tpu_torch.executor import batch, expr
from pilosa_tpu_torch.executor.result import (
    GroupCount,
    Pair,
    RowResult,
    ValCount,
)
from pilosa_tpu_torch.pql import Call, Condition, parse
from pilosa_tpu_torch.pql.ast import Query
from pilosa_tpu_torch.shardwidth import (
    WORDS_PER_SHARD,
    next_pow2,
    position,
    shard_of,
)
from pilosa_tpu_torch.storage import heat
from pilosa_tpu_torch.storage.field import BSI_EXISTS_ROW, TYPE_INT, TYPE_TIME
from pilosa_tpu_torch.storage.index import EXISTENCE_FIELD, Index
from pilosa_tpu_torch.storage.translate import column_namespace, row_namespace
from pilosa_tpu_torch.storage.view import VIEW_STANDARD, views_by_time_range
from pilosa_tpu_torch.utils.cost import current_cost, use_node
from pilosa_tpu_torch.utils.stats import global_stats
from pilosa_tpu_torch.utils.tracing import global_tracer

# TopN phase-1 candidate overfetch per shard (the reference's value).
TOPN_CANDIDATE_FACTOR = 4

# Device bytes of one TopN phase-2 candidate matrix chunk: a candidate row
# costs shards x 128 KiB (128 MiB at 1024 shards), so chunks hold a
# power-of-two number of candidates under this budget (the reference's).
TOPN_MATRIX_BUDGET_BYTES = 1 << 30

# GroupBy cross-products of at most this many groups run as one level
# (one readback); larger ones prune one dimension per level (the
# reference's threshold, read at call time).
GROUPBY_DENSE_MAX_GROUPS = 4096

# K9 builds each candidate's mask in registers and never materializes the
# reference's [C, W] masks, so the reference's mask budget
# (GROUPBY_MASK_BUDGET_BYTES) does not size the port's level chunks: K9's
# per-shard output int32[S, K, C] does, at most this many bytes a chunk.
GROUPBY_OUT_BUDGET_BYTES = 256 << 20

_RESERVED_ARGS = {"_field", "_col", "from", "to", "n", "limit", "offset",
                  "previous", "column", "filter", "field", "ids", "timestamp",
                  "excludeColumns", "shards", "aggregate", "columnAttrs",
                  "attrName", "attrValue", "like", "threshold", "having"}

_BITMAP_CALLS = {"Row", "Union", "Intersect", "Difference", "Xor", "Not",
                 "All", "Shift", "Range"}
_AGGREGATES = ("Sum", "Min", "Max")


class PQLError(ValueError):
    pass


class _RowSpec:
    """Device leaf: OR of one row across a set of views."""

    __slots__ = ("field", "views", "row")

    def __init__(self, field: str, views: tuple[str, ...], row: int):
        self.field = field
        self.views = views
        self.row = row


class _PlanesSpec:
    """Device leaf: the stacked BSI plane matrix int32[S, 2+depth, W].
    ``depth`` is fixed at compile time, so a racing delete_field reads
    zeros of the planned shape."""

    __slots__ = ("field", "depth")

    def __init__(self, field: str, depth: int):
        self.field = field
        self.depth = depth


class _ZeroSpec:
    __slots__ = ()


class _Compiled:
    """A call compiled to (structure, leaf specs, scalars) and its plan
    for the card (``expr.plan``). ``memoizable`` is set by
    ``_compile_cached`` exactly when the plan went into the plan cache:
    only those objects keep their identity across repeated queries, so
    only their operand assemblies are memoized (a per-call plan would
    fill the operand memo with entries never served)."""

    def __init__(self, node, specs, scalars):
        self.node = node
        self.specs = specs
        self.scalars = scalars
        self.plan = None
        self.memoizable = False


def _node_has_const0(node) -> bool:
    if not isinstance(node, tuple):
        return False
    if node and node[0] == "const0":
        return True
    return any(_node_has_const0(c) for c in node[1:])


def dispatch(reduce_kind: str, launch, batch_n: int | None = None):
    """``launch()`` (one query's kernels, or a micro-batch's one launch of
    ``batch_n`` queries) in a ``device.dispatch`` span, its enqueue time
    noted on the request's cost context. No site waits for the card: a
    launch returns once its kernels are queued on the stream, and the
    readback stays in ``Deferred.result()``."""
    tags = {"reduce": reduce_kind}
    if batch_n is not None:
        tags["batch"] = batch_n
    cost = current_cost()
    with global_tracer().span("device.dispatch", **tags):
        if cost is None:
            return launch()
        t0 = time.perf_counter()
        out = launch()
        cost.note_dispatch(time.perf_counter() - t0, batch=batch_n or 1)
    return out


def instrument_calls(index_name: str, calls, run_one) -> list:
    """The stats, trace and cost envelope around a query's calls (the
    reference's): one ``executor.Execute`` span a query, one
    ``execute<Name>`` span and ``query``/``queries`` stats a call. Shared
    by ``execute`` and the serving pipeline's resolve loop, so span and
    stat names cannot drift between them. Under a PROFILE each call runs
    under its profile node: its wall time and result cardinality land
    there."""
    stats = global_stats()
    tracer = global_tracer()
    cost = current_cost()
    profile = cost.profile if cost is not None else None
    out = []
    with tracer.root_span("executor.Execute", index=index_name):
        for i, call in enumerate(calls):
            if profile is None:
                with tracer.span(f"execute{call.name}"), \
                        stats.timer("query", {"call": call.name}):
                    out.append(run_one(call))
                stats.count("queries", 1, {"call": call.name})
                continue
            node = profile.node_for(i, call)
            t0 = time.perf_counter()
            with use_node(cost, node):
                with tracer.span(f"execute{call.name}"), \
                        stats.timer("query", {"call": call.name}):
                    res = run_one(call)
                node.wall_s += time.perf_counter() - t0
                cost.note_rows(_result_cardinality(res))
            out.append(res)
            stats.count("queries", 1, {"call": call.name})
    return out


def _result_cardinality(res) -> int:
    """Rows materialized by one call's result (PROFILE only): a row
    result's bit count, a list's length."""
    if isinstance(res, RowResult):
        return int(res.count())
    if isinstance(res, list):
        return len(res)
    return 0


class Deferred:
    """Handle for a pipelined query result (Executor.submit): the kernel
    is launched (or queued in a micro-batch) at submit; ``result()``
    does the readback. Not safe to resolve from two threads at once: the
    pipeline wraps a shared one in ``_SharedDeferred``."""

    __slots__ = ("_finalize", "_value")

    def __init__(self, finalize=None, value=None):
        self._finalize = finalize
        self._value = value

    def result(self):
        if self._finalize is not None:
            self._value = self._finalize()
            self._finalize = None
        return self._value


class Executor:
    # Queries per micro-batched launch (kernels.MAX_BATCH).
    MICROBATCH_MAX = 16
    PLAN_CACHE_MAX = 4096
    # Operand-memo bound; cleared wholesale when full (the reference's).
    OPERAND_MEMO_MAX = 512

    def __init__(self, holder, device=None):
        self.holder = holder
        self.device = device_mod.resolve(device)
        if self.device != holder.device:
            raise ValueError(f"executor on {self.device}, holder on "
                             f"{holder.device}")
        self._pending: dict = {}
        self._mb_lock = threading.Lock()
        self._plan_cache: dict = {}
        self._block_memo: collections.OrderedDict = collections.OrderedDict()
        self._block_lock = threading.Lock()
        self.largest_batch = 0
        # in-place write patches must not reach a leaf that a queued
        # micro-batch captured at submit: the cache calls this first
        holder.cache.add_patch_listener(self._flush_pending_holding)
        # (plan identity, block identity) -> assembled leaves, valid for
        # one residency generation (see _eval_operands); the cache's
        # generation listener drops every entry, and with it every
        # tensor reference, on each bump, so an evicted or demoted leaf
        # frees its memory at once
        self._operand_memo: dict = {}
        self._operand_memo_gen = -1
        holder.cache.add_generation_listener(self._clear_operand_memo)
        # memoizable assemblies served from the memo and resolved (plain
        # int adds: a dashboard figure, not one of the reference's)
        self.memo_hits = 0
        self.memo_misses = 0
        # divisor of the per-device bytes of a stacked leaf: a mesh's
        # members each hold 1/size of the slots (DistExecutor sets it)
        self.arg_shard_factor = 1

    def _clear_operand_memo(self) -> None:
        """Generation listener (called under the residency lock): stays
        lock-free and cheap."""
        self._operand_memo.clear()

    # ------------------------------------------------------------ top level

    def _parse(self, index_name: str, query):
        idx = self.holder.index(index_name)
        if idx is None:
            raise PQLError(f"index {index_name!r} not found")
        if isinstance(query, str):
            query = parse(query)
        elif isinstance(query, Call):
            query = Query([query])
        return idx, query

    def execute(self, index_name: str, query, shards=None,
                deadline=None) -> list:
        """Run every call to its result. ``deadline`` (qos.Deadline) is
        checked first: an expired request launches nothing."""
        if deadline is not None:
            deadline.check("local execute")
        idx, query = self._parse(index_name, query)
        return instrument_calls(
            index_name, query.calls,
            lambda call: self._execute_call(idx, call, shards))

    def submit(self, index_name: str, query, shards=None,
               deadline=None) -> list:
        """Pipelined execution: parse, compile and launch (or queue) each
        call's kernel without waiting for the readback; one ``Deferred``
        per call. Counts of one shape coalesce into one launch per
        micro-batch; writes run at submit. ``deadline`` is enforced at
        this dispatch boundary: an expired request raises before any
        kernel is launched for it. Under a PROFILE each call's submit
        work lands on the same profile node as its resolve."""
        if deadline is not None:
            deadline.check("local submit")
        idx, query = self._parse(index_name, query)
        cost = current_cost()
        if cost is not None and cost.profile is not None:
            out = []
            for i, call in enumerate(query.calls):
                with use_node(cost, cost.profile.node_for(i, call)):
                    out.append(self._submit_one(idx, call, shards))
            return out
        return [self._submit_one(idx, call, shards) for call in query.calls]

    def _submit_one(self, idx: Index, call: Call, shards=None) -> Deferred:
        if call.name == "Count":
            return self._submit_count(idx, call, shards, pipeline=True)
        if call.name in _AGGREGATES:
            return self._submit_bsi_aggregate(idx, call, shards)
        if call.name == "TopN":
            return self._submit_topn(idx, call, shards)
        if call.name == "GroupBy":
            return self._submit_groupby(idx, call, shards)
        if call.name in _BITMAP_CALLS:
            return self._submit_bitmap(idx, call, shards)
        if call.name == "Options" and call.children:
            # the child pipelines; the result options apply at result()
            inner = self._submit_one(idx, options_child(call),
                                     options_restrict_shards(call, shards))
            return Deferred(lambda: apply_options_result(idx, call,
                                                         inner.result()))
        return Deferred(value=self._execute_call(idx, call, shards))

    def _execute_call(self, idx: Index, call: Call, shards=None):
        name = call.name
        if name == "Options":
            res = self._execute_call(idx, options_child(call),
                                     options_restrict_shards(call, shards))
            return apply_options_result(idx, call, res)
        if name == "Set":
            return self._execute_set(idx, call)
        if name == "Clear":
            return self._execute_clear(idx, call)
        if name == "ClearRow":
            return self._execute_clear_row(idx, call, shards)
        if name == "Store":
            return self._execute_store(idx, call, shards)
        if name == "Count":
            return self._submit_count(idx, call, shards).result()
        if name in _AGGREGATES:
            return self._submit_bsi_aggregate(idx, call, shards).result()
        if name in _BITMAP_CALLS:
            return self._submit_bitmap(idx, call, shards).result()
        if name == "TopN":
            return self._submit_topn(idx, call, shards).result()
        if name == "Rows":
            return self._execute_rows(idx, call, shards)
        if name == "GroupBy":
            return self._submit_groupby(idx, call, shards).result()
        if name == "IncludesColumn":
            return self._execute_includes_column(idx, call, shards)
        if name == "SetRowAttrs":
            return self._execute_set_row_attrs(idx, call)
        if name == "SetColumnAttrs":
            return self._execute_set_column_attrs(idx, call)
        raise PQLError(f"unsupported call {name!r}")

    # ------------------------------------------------------ key translation

    def _translate_col(self, idx: Index, col, create: bool = False):
        """A column id as it is; a column key → its id (None when unknown
        and not created)."""
        if isinstance(col, int):
            return col
        if not idx.keys:
            raise PQLError(f"column key {col!r} on index {idx.name!r} "
                           "without keys=true")
        return self.holder.translate.translate_one(
            column_namespace(idx.name), str(col), create=create)

    def _translate_row(self, idx: Index, field, row, create: bool = False):
        """A row id as it is; a row key → its id (None when unknown and
        not created)."""
        if isinstance(row, int):
            return row
        if not field.options.keys:
            raise PQLError(f"row key {row!r} on field {field.name!r} "
                           "without keys=true")
        return self.holder.translate.translate_one(
            row_namespace(idx.name, field.name), str(row), create=create)

    def _row_keys(self, idx: Index, field, rows) -> list:
        return self.holder.translate.keys_of(
            row_namespace(idx.name, field.name), [int(r) for r in rows])

    # --------------------------------------------------------------- shards

    def _shards(self, idx: Index, shards=None) -> list[int]:
        if shards is not None:
            return list(shards)
        return idx.available_shards()

    def _shard_block(self, shard_list: list[int]) -> batch.ShardBlock:
        """Block for a query's shard list, memoized on the list object
        (Index.available_shards returns one list until the set changes)."""
        key = id(shard_list)
        with self._block_lock:
            entry = self._block_memo.get(key)
            if entry is not None and entry[0] is shard_list:
                self._block_memo.move_to_end(key)
                return entry[1]
            block = self._make_block(shard_list)
            if len(self._block_memo) >= 64:
                self._block_memo.popitem(last=False)
            self._block_memo[key] = (shard_list, block)
            return block

    # ---------------------------------------------------------- mesh hooks
    #
    # The reference's placement and reduction hooks. On this executor
    # they are the single-device forms; DistExecutor (parallel/dist.py)
    # runs each launch over its mesh's members and reduces their
    # partials through the mesh lanes.

    def _make_block(self, shard_list: list[int]):
        return batch.ShardBlock(shard_list)

    def _note_reduce(self, reduce_kind: str, out_shape: tuple,
                     padded: int) -> None:
        """Reduction-lane accounting, once a launch of a reduction with
        its packed result's shape (the reference's) and the block's
        padded slot count. A single device has no reduction wire."""

    def _row_host(self, stacked: torch.Tensor, block) -> np.ndarray:
        """Row-gather readback: device [padded, words] → host array."""
        return stacked.cpu().numpy()

    # The quantized candidate-ranking lane: inert here (no inter-group
    # wire to shrink); DistExecutor turns it on behind the
    # topn-quantized-ranking knob.
    verify_quantized = False

    def _quant_ranking_active(self) -> bool:
        return False

    def _launch_plan(self, plan: expr.Plan, reduce_kind: str, leaves: list,
                     scalars, zeros, block) -> torch.Tensor:
        """One query's kernels (``batch.run_plan``)."""
        return batch.run_plan(plan, reduce_kind, leaves, scalars, zeros)

    def _launch_batched(self, node, reduce_kind: str, leaf_ranks: tuple,
                        rows: list) -> torch.Tensor:
        """One micro-batch of same-shape counts (``rows``: each query's
        leaves) as one K1 launch → int32[B, 2]."""
        fn = batch.local_fn_batched(node, reduce_kind, leaf_ranks, len(rows))
        return fn(*[leaf for leaves in rows for leaf in leaves])

    def _launch_countrows(self, matrix: torch.Tensor, filt, block,
                          quantized: bool = False) -> torch.Tensor:
        """TopN's recount of one candidate chunk (K8) → int32[2, R]."""
        return batch.count_rows_packed(matrix, filt)

    def _launch_groupby_level(self, block, mats: list, idxs, filt, planes,
                              quantized: bool = False,
                              padded: int = 0) -> torch.Tensor:
        """One GroupBy level chunk (K9), packed as the reference packs it;
        ``padded``: the chunk's power-of-two size, the reference's
        packed shape for the reduction accounting."""
        return batch.groupby_level_packed(mats, idxs, filt, planes)

    # ------------------------------------------------------ batched mapping

    def _eval_operands(self, idx: Index, compiled: _Compiled, block,
                       memoize: bool = True):
        """The stacked leaf of every compiled spec, resident on the card.

        A repeated (plan, block) assembly is served from the operand memo
        for one residency generation: resolving each leaf through the
        row cache's lock and LRU is a slice of a served Count's host
        time. Every write patch, invalidation, eviction and demotion
        bumps the generation (``storage/residency.py``), whose listener
        clears the memo. Correctness does not rest on the clears: an
        entry carries the generation read before its assembly and is
        served only at the current one, so an entry stored by a thread
        that raced a write is never served. The dispatcher thread and
        the request threads share the memo with plain dict operations,
        each atomic, and take no lock of their own (the listener runs
        under the cache's lock). Identity checks guard against ``id()``
        reuse once a plan or block has gone; only plan-cache plans
        (``compiled.memoizable``) are memoized. A hit re-touches its
        leaves' LRU positions, so a leaf served on every query never
        looks cold to eviction. A hit adds no leaf records to PROFILE
        and sets ``operandMemoHit``.

        Under a PROFILE each leaf resolved adds a record to the active
        node: its field and row, whether the cache hit, the containers
        decoded by type and the bytes uploaded (the request's deltas
        around it)."""
        cache = self.holder.cache
        memoize = memoize and compiled.memoizable
        if memoize:
            gen = cache.generation
            if gen != self._operand_memo_gen:
                self._operand_memo.clear()
                self._operand_memo_gen = gen
            mkey = (id(compiled), id(block))
            hit = self._operand_memo.get(mkey)
            if (hit is not None and hit[0] is compiled
                    and hit[1] is block and hit[3] == gen):
                cache.touch(hit[4])
                self.memo_hits += 1
                self._note_operands(idx, compiled.specs, block,
                                    memo_hit=True)
                return hit[2]
            self.memo_misses += 1
        leaves = self._resolve_leaves(idx, compiled, block)
        if memoize:
            if len(self._operand_memo) >= self.OPERAND_MEMO_MAX:
                self._operand_memo.clear()
            self._operand_memo[mkey] = (
                compiled, block, leaves, gen,
                tuple(batch.leaf_key(idx, spec, block)
                      for spec in compiled.specs))
        return leaves

    def _resolve_leaves(self, idx: Index, compiled: _Compiled, block):
        cost = current_cost()
        self._note_operands(idx, compiled.specs, block, cost=cost)
        cache = self.holder.cache
        node = (cost.current if cost is not None
                and cost.profile is not None else None)
        if node is None:
            return [batch.stacked_leaf(idx, spec, block, cache)
                    for spec in compiled.specs]
        leaves = []
        for spec in compiled.specs:
            snap = (cost.row_cache_hits, cost.c_array, cost.c_bitmap,
                    cost.c_run, cost.device_bytes)
            leaves.append(batch.stacked_leaf(idx, spec, block, cache))
            rec = {
                "field": getattr(spec, "field", None),
                "cacheHit": cost.row_cache_hits > snap[0],
                "containers": {"array": cost.c_array - snap[1],
                               "bitmap": cost.c_bitmap - snap[2],
                               "run": cost.c_run - snap[3]},
                "bytesMoved": cost.device_bytes - snap[4],
            }
            row = getattr(spec, "row", None)
            if row is not None:
                rec["row"] = int(row)
            node.leaves.append(rec)
        return leaves

    @staticmethod
    def _note_operands(idx: Index, specs, block, memo_hit: bool = False,
                       cost=None) -> None:
        """One operand assembly of a served query (the reference's
        ``_note_operands``): the shards it touches, whether the operand
        memo answered, and the access heat of its fields over the
        shards, one batched record. Recorded only under a request's cost
        context, so direct executor calls and background work record
        nothing."""
        if cost is None:
            cost = current_cost()
            if cost is None:
                return
        cost.note_shards(len(block.shards))
        if memo_hit and cost.current is not None:
            cost.current.operand_memo_hit = True
        fields = {spec.field for spec in specs
                  if getattr(spec, "field", None) is not None}
        if fields:
            heat.global_heat().record_access_many(
                idx.name, fields, block.shards, scope=idx.scope)

    def _zeros(self, idx: Index, block):
        """A resident all-zero [S, W] leaf for operand-free trees."""
        return lambda: batch.stacked_leaf(idx, _ZeroSpec(), block,
                                          self.holder.cache)

    def _run(self, idx: Index, compiled: _Compiled, block, reduce_kind,
             memoize: bool = True):
        """One query's kernels, launched now (``batch.run_plan``)."""
        leaves = self._eval_operands(idx, compiled, block, memoize)
        return dispatch(reduce_kind, lambda: self._launch_plan(
            compiled.plan, reduce_kind, leaves, compiled.scalars,
            self._zeros(idx, block), block))

    # ------------------------------------------------- query micro-batching
    #
    # Pipelined Counts sharing a program shape (structure, leaf shapes)
    # accumulate in a pending group and launch as ONE K1 kernel over the
    # whole group, whose [B, 2] result is read back once for every query
    # in it. A group launches when it is full, when any of its Deferreds
    # resolves, or right before a write patches one of its leaves in
    # place (_flush_pending_holding) — then stream order gives the group
    # the leaves as they were at submit.

    def _microbatch_enqueue(self, node, reduce_kind: str, leaves):
        """Queue one pipelined query; returns a thunk yielding its packed
        host result."""
        key = (node, reduce_kind, tuple(tuple(l.shape) for l in leaves))
        with self._mb_lock:
            group = self._pending.get(key)
            if group is None:
                group = self._pending[key] = {"rows": [], "out": None}
            i = len(group["rows"])
            group["rows"].append(tuple(leaves))
            if len(group["rows"]) >= self.MICROBATCH_MAX:
                self._flush_group_locked(key, group)

        def read():
            with self._mb_lock:
                if group["out"] is None:
                    self._flush_group_locked(key, group)
                out = group["out"]
            if not isinstance(out, np.ndarray):
                out = out.cpu().numpy()  # blocking readback, outside the lock
                with self._mb_lock:
                    group["out"] = out
            return out[i]

        return read

    def _flush_group_locked(self, key, group) -> None:
        """Launch a pending group as one kernel (caller holds _mb_lock)."""
        if group["out"] is not None:
            return
        node, reduce_kind, shapes = key
        rows = group["rows"]
        # the span lands in the trace of whichever request flushed the
        # group: that request paid the launch, its batchmates ride along
        # (tagged with the shared size), and the cost plane says the same
        group["out"] = dispatch(
            reduce_kind,
            lambda: self._launch_batched(
                node, reduce_kind, tuple(len(s) - 1 for s in shapes), rows),
            batch_n=len(rows))
        self.largest_batch = max(self.largest_batch, len(rows))
        if self._pending.get(key) is group:
            del self._pending[key]

    def _flush_pending_holding(self, arr) -> None:
        """Patch listener (called under the residency lock): launch every
        pending group that captured ``arr``."""
        with self._mb_lock:
            for key, group in list(self._pending.items()):
                if any(leaf is arr for leaves in group["rows"]
                       for leaf in leaves):
                    self._flush_group_locked(key, group)

    # --------------------------------------------------------- bitmap calls

    def _submit_bitmap(self, idx: Index, call: Call, shards=None) -> Deferred:
        """Row-materializing calls: K2 launches at submit; the
        [padded, words] readback happens at result()."""
        compiled = self._compile_cached(idx, call)
        shard_list = self._shards(idx, shards)
        # a plain Row's attrs as they are at submit, like its bits
        attrs = self._row_result_attrs(idx, call)
        if not shard_list:
            return Deferred(value=self._with_keys(idx, RowResult(
                {}, attrs=attrs)))
        block = self._shard_block(shard_list)
        stacked = self._run(idx, compiled, block, "row")

        def finish() -> RowResult:
            host = self._row_host(stacked, block).view(np.uint32)
            segments = {}
            for i, shard in enumerate(block.shards):
                if host[i].any():
                    segments[shard] = host[i].copy()
            return self._with_keys(idx, RowResult(segments, attrs=attrs))

        return Deferred(finish)

    def _row_result_attrs(self, idx: Index, call: Call) -> dict:
        """The row's attrs, for a plain Row call of a row that exists in
        the translate log or by id; {} for any other call."""
        if call.name == "Row" and call.condition_field()[0] is None:
            try:
                field_name, row = self._row_field_and_value(call)
                field = idx.field(field_name)
                if field is not None:
                    row_id = self._translate_row(idx, field, row)
                    if row_id is not None:
                        return field.row_attrs.attrs(row_id)
            except PQLError:
                pass
        return {}

    def _with_keys(self, idx: Index, res: RowResult) -> RowResult:
        """A keyed index's row result carries its columns' keys."""
        if idx.keys:
            res.keys = [k for k in self.holder.translate.keys_of(
                column_namespace(idx.name), res.columns().tolist())
                if k is not None]
        return res

    def _submit_count(self, idx: Index, call: Call, shards=None,
                      pipeline: bool = False) -> Deferred:
        if len(call.children) != 1:
            raise PQLError("Count requires exactly one child call")
        compiled = self._compile_cached(idx, call.children[0], wrap="count")
        shard_list = self._shards(idx, shards)
        if not shard_list:
            return Deferred(value=0)
        block = self._shard_block(shard_list)
        if not pipeline:
            packed = self._run(idx, compiled, block, "count")
            return Deferred(
                lambda: int(batch.merge_split(packed.cpu().numpy())))
        # the plan's steps launch now; the elementwise rest joins a
        # micro-batch of its shape
        zeros = self._zeros(idx, block)
        leaves = self._eval_operands(idx, compiled, block)
        if compiled.plan.steps:
            # shift, BSI-comparison and 'tree' steps launch now
            resolve = dispatch("steps", lambda: batch.materialize(
                compiled.plan, leaves, compiled.scalars, zeros))
        else:
            resolve = batch.materialize(compiled.plan, leaves,
                                        compiled.scalars, zeros)
        node, operands = compiled.plan.root
        read = self._microbatch_enqueue(node, "count",
                                        resolve(operands) or [zeros()])
        return Deferred(lambda: int(batch.merge_split(read())))

    # ------------------------------------------------------- BSI aggregates

    def _submit_bsi_aggregate(self, idx: Index, call: Call, shards=None
                              ) -> Deferred:
        """Sum / Min / Max of an int field, optionally under a filter
        child: K6 (Sum) or K7 + the cross-shard merge (Min / Max) launch
        at submit; the packed result is read back at result()."""
        field_name = call.arg("field") or call.arg("_field")
        if field_name is None:
            raise PQLError(f"{call.name} requires field=")
        field = idx.field(field_name)
        if field is None or field.options.type != TYPE_INT:
            raise PQLError(f"{call.name} requires an int field")
        filt_call = call.children[0] if call.children else None

        def build() -> _Compiled:
            specs: list = []
            scalars: list = []
            planes_i = self._planes_index(field, specs)
            filt_node = (self._compile_node(idx, filt_call, specs, scalars)
                         if filt_call else None)
            if call.name == "Sum":
                node = ("bsisum", planes_i, filt_node)
            else:
                node = ("bsiminmax", 1 if call.name == "Max" else 0,
                        planes_i, filt_node)
            return _Compiled(node, specs, scalars)

        compiled = self._compile_cached(idx, call, wrap="agg", build=build)
        base = field.options.base
        shard_list = self._shards(idx, shards)
        if not shard_list:
            return Deferred(value=ValCount(0, 0))
        block = self._shard_block(shard_list)
        packed = self._run(idx, compiled, block,
                           "bsisum" if call.name == "Sum"
                           else call.name.lower())

        if call.name == "Sum":
            def finish() -> ValCount:
                merged = batch.merge_split(packed.cpu().numpy())
                # [depth + 1]: plane counts ++ n
                count = int(merged[-1])
                total = sum(int(c) << i
                            for i, c in enumerate(merged[:-1].tolist()))
                return ValCount(total + base * count, count)
        else:
            def finish() -> ValCount:
                host = packed.cpu().numpy()  # [best, count_lo, count_hi]
                count = int(batch.merge_split(host[1:]))
                if count == 0:
                    return ValCount(0, 0)
                return ValCount(int(host[0]) + base, count)

        return Deferred(finish)

    # ----------------------------------------------------------------- TopN

    def _plan(self, node) -> expr.Plan:
        try:
            return expr.plan(node)
        except ValueError as e:  # a malformed tree
            raise PQLError(f"malformed query tree: {e}") from e

    def _filter_row(self, idx: Index, filt_call, block, note: bool = False):
        """Compile a TopN / GroupBy filter call and launch its row (its
        steps, then K2; a bare leaf as it is). None without a filter.
        ``note``: record its access heat (TopN's, as the reference)."""
        if filt_call is None:
            return None
        specs: list = []
        scalars: list = []
        node = self._compile_node(idx, filt_call, specs, scalars)
        if note:
            self._note_operands(idx, specs, block)
        plan = self._plan(node)
        leaves = [batch.stacked_leaf(idx, s, block, self.holder.cache)
                  for s in specs]
        return dispatch("row", lambda: batch.filter_row(
            plan, leaves, scalars, self._zeros(idx, block)))

    def _submit_topn(self, idx: Index, call: Call, shards=None) -> Deferred:
        """TopN in two phases. Phase 1 takes each shard's candidates from
        its row cache (``Fragment.top``, overfetched); phase 2
        recounts every candidate over all shards: stacked candidate
        matrices in power-of-two chunks padded with zero rows (the
        reference's shapes), one K8 launch per chunk at submit, read back
        at result()."""
        field_name = call.arg("_field") or call.arg("field")
        if field_name is None:
            raise PQLError("TopN requires a field")
        field = idx.field(field_name)
        if field is None:
            raise PQLError(f"field {field_name!r} not found")
        n = call.arg("n", 10)
        filt_call = call.children[0] if call.children else None
        shard_list = self._shards(idx, shards)
        if not shard_list:
            return Deferred(value=[])
        view = field.view(VIEW_STANDARD)
        explicit_ids = call.arg("ids")
        if explicit_ids is not None:
            candidates = sorted(int(i) for i in explicit_ids)
        else:
            overfetch = max(n * TOPN_CANDIDATE_FACTOR, n + 10)
            cand: set[int] = set()
            for shard in shard_list:
                frag = view.fragment(shard) if view else None
                if frag is not None:
                    cand.update(r for r, _ in frag.top(overfetch))
            candidates = sorted(cand)
        candidates = _filter_topn_candidates(field, call, candidates)
        if not candidates:
            return Deferred(value=[])

        n_real = len(candidates)
        block = self._shard_block(shard_list)
        bytes_per_cand = (block.padded * WORDS_PER_SHARD * 4
                          // self.arg_shard_factor)
        rows = max(1, min(next_pow2(n_real),
                          TOPN_MATRIX_BUDGET_BYTES // bytes_per_cand))
        rows = 1 << (rows.bit_length() - 1)  # down to a power of two
        filt = self._filter_row(idx, filt_call, block, note=True)
        cache = self.holder.cache

        def dispatch_chunks(cand_list, kind: str, chunk_rows: int = rows):
            """K8 over each chunk of ``cand_list`` (padded with zero rows
            to ``chunk_rows``), launched now: 'countrows' exact split
            sums, 'countrows_q' the quantized ranking lane."""
            reads = []
            for lo in range(0, len(cand_list), chunk_rows):
                chunk = cand_list[lo:lo + chunk_rows]
                matrix = batch.stacked_matrix(
                    idx, field_name, view, chunk, block, cache,
                    pad_rows=chunk_rows - len(chunk))
                reads.append((chunk, dispatch(
                    kind, lambda: self._launch_countrows(
                        matrix, filt, block, kind == "countrows_q"))))
            return reads

        def exact_totals(cand_list, reads=None, chunk_rows: int = rows):
            if reads is None:
                reads = dispatch_chunks(cand_list, "countrows", chunk_rows)
            totals: list[int] = []
            for chunk, packed in reads:
                totals += batch.merge_split(
                    packed.cpu().numpy())[:len(chunk)].tolist()
            return totals

        def order_pairs(cand_list, totals) -> list:
            # threshold=: the least total a row needs, after the recount
            floor = max(1, int(call.arg("threshold", 0) or 0))
            order = sorted((-c, r) for r, c in zip(cand_list, totals)
                           if c >= floor)
            return order[:n] if n else order

        def pairs_of(order) -> list[Pair]:
            pairs = [Pair(r, -negc) for negc, r in order]
            if field.options.keys and pairs:
                for p, k in zip(pairs, self._row_keys(
                        idx, field, [p.id for p in pairs])):
                    p.key = k
            return pairs

        # the quantized candidate ranking (topn-quantized-ranking, on a
        # mesh): every candidate ranked over the 8-bit lane, the top-n
        # window widened by the transmitted error bound, then only the
        # window recounted exactly; pairs come from exact counts, so they
        # are the lossless path's. ids= is a recount already, and with
        # nothing to cut the window is the whole set.
        if (self._quant_ranking_active() and explicit_ids is None and n
                and n_real > n):
            q_reads = dispatch_chunks(candidates, "countrows_q")

            def finish_quantized() -> list[Pair]:
                from pilosa_tpu_torch.parallel import reduction

                approx = np.zeros(n_real, np.int64)
                err = np.zeros(n_real, np.int64)
                pos = 0
                for chunk, packed in q_reads:
                    a, e = reduction.split_quantized(
                        batch.merge_split(packed.cpu().numpy()), rows)
                    approx[pos:pos + len(chunk)] = a[:len(chunk)]
                    err[pos:pos + len(chunk)] = e[:len(chunk)]
                    pos += len(chunk)
                widx = reduction.quant_topn_window(approx, err, n)
                reduction.global_reduce_stats().note_quant_window(
                    len(widx), n_real)
                window = [candidates[i] for i in widx]
                # the recount's chunks sized to the window, not the whole
                # candidate set
                wrows = min(rows, 1 << max(0, len(window) - 1).bit_length())
                order = order_pairs(window, exact_totals(
                    window, chunk_rows=max(1, wrows)))
                if self.verify_quantized:
                    ref = order_pairs(candidates, exact_totals(candidates))
                    if order != ref:
                        raise AssertionError(
                            "quantized TopN diverged from lossless: "
                            f"{order} != {ref}")
                return pairs_of(order)

            return Deferred(finish_quantized)
        reads = dispatch_chunks(candidates, "countrows")
        return Deferred(lambda: pairs_of(order_pairs(
            candidates, exact_totals(candidates, reads))))

    # ----------------------------------------------------------------- Rows

    def _execute_rows(self, idx: Index, call: Call, shards=None) -> list:
        field_name = call.arg("_field") or call.arg("field")
        field = idx.field(field_name) if field_name else None
        like = call.arg("like")
        if like is not None and (field is None or not field.options.keys):
            raise PQLError("Rows(like=) requires a field with keys=true")
        ids = self._rows_ids(idx, call, shards)
        if field is None or not field.options.keys:
            return ids
        keys = [k for k in self._row_keys(idx, field, ids) if k is not None]
        if like is not None:
            # after limit= has cut the ids, as in the reference
            pattern = re.compile("^" + ".*".join(
                re.escape(p) for p in str(like).split("%")) + "$")
            keys = [k for k in keys if pattern.match(k)]
        return keys

    def _rows_ids(self, idx: Index, call: Call, shards=None) -> list[int]:
        """The sorted non-empty rows of a field's standard view (from row
        counts, or those holding ``column=``), after ``previous=`` and cut
        to ``limit=``."""
        field_name = call.arg("_field") or call.arg("field")
        if field_name is None:
            raise PQLError("Rows requires a field")
        field = idx.field(field_name)
        if field is None:
            raise PQLError(f"field {field_name!r} not found")
        limit = call.arg("limit", 0)
        previous = call.arg("previous")
        column = call.arg("column")
        view = field.view(VIEW_STANDARD)
        if view is None:
            return []
        rows: set[int] = set()
        if column is not None:
            frag = view.fragment(shard_of(int(column)))
            if frag is not None:
                rows.update(frag.rows_containing(position(int(column))))
        else:
            for shard in self._shards(idx, shards):
                frag = view.fragment(shard)
                if frag is not None:
                    rows.update(frag.row_counts()[0].tolist())
        out = sorted(rows)
        if previous is not None:
            out = [r for r in out if r > int(previous)]
        if limit:
            out = out[:int(limit)]
        return out

    # -------------------------------------------------------------- GroupBy

    def _groupby_prelude(self, idx: Index, call: Call, shards=None):
        """GroupBy's arguments: (limit, filter call or None, aggregate int
        field or None, dims [(field, row ids)], having predicate or
        None); dims is empty when a dimension has no rows."""
        if not call.children or any(c.name != "Rows" for c in call.children):
            raise PQLError("GroupBy requires Rows(...) children")
        limit = call.arg("limit", 0)
        filt_call = call.arg("filter")
        if not isinstance(filt_call, Call):
            filt_call = None
        agg_call = call.arg("aggregate")
        agg_field = None
        if isinstance(agg_call, Call):
            if agg_call.name != "Sum":
                raise PQLError("GroupBy aggregate supports only Sum(...)")
            agg_name = agg_call.arg("field") or agg_call.arg("_field")
            agg_field = idx.field(agg_name) if agg_name else None
            if agg_field is None or agg_field.options.type != TYPE_INT:
                raise PQLError("GroupBy aggregate requires an int field")
        # before the empty-dims return: a malformed having errors anyway
        having = having_predicate(call, has_agg=agg_field is not None)
        dims = []
        for child in call.children:
            row_ids = self._rows_ids(idx, child, shards)
            if not row_ids:
                return limit, filt_call, agg_field, [], having
            dims.append((child.arg("_field") or child.arg("field"), row_ids))
        return limit, filt_call, agg_field, dims, having

    def _groupby_result(self, idx: Index, dims, counts: dict, sums: dict,
                        agg_field, limit, having=None) -> list[GroupCount]:
        """Groups with a count, after having=, cut to limit=. A keyed
        dimension names its rows by ``rowKey``; groups are ordered by
        what they show: row ids first (numerically), then row keys."""
        if having is not None:
            counts = {k: c for k, c in counts.items()
                      if having(c, sums.get(k))}
        dim_keys: list[dict | None] = []
        for fname, row_ids in dims:
            field = idx.field(fname)
            dim_keys.append(dict(zip(row_ids, self._row_keys(
                idx, field, row_ids))) if field is not None
                and field.options.keys else None)

        def shown(i: int, row: int):
            keys = dim_keys[i]
            key = keys.get(row) if keys is not None else None
            return (0, row) if key is None else (1, key)

        def field_row(i: int, row: int) -> dict:
            kind, v = shown(i, row)
            return {"field": dims[i][0], ("rowKey" if kind else "rowID"): v}

        out = [GroupCount([field_row(i, row) for i, row in enumerate(key)],
                          c, sum=sums.get(key) if agg_field is not None
                          else None)
               for key, c in sorted(counts.items(), key=lambda kv: tuple(
                   shown(i, row) for i, row in enumerate(kv[0])))]
        if limit:
            out = out[:int(limit)]
        return out

    def _submit_groupby(self, idx: Index, call: Call, shards=None
                        ) -> Deferred:
        """GroupBy as K9 levels. A cross-product of at most
        GROUPBY_DENSE_MAX_GROUPS groups over at most 16 dimensions is one
        level, launched at submit and read back at result(); any other
        runs the pruned levels (``_groupby_pruned``) at result(). The matrices are
        patched in place by writes, so a write landing between two levels
        is seen by the later levels only."""
        limit, filt_call, agg_field, dims, having = self._groupby_prelude(
            idx, call, shards)
        if not dims:
            return Deferred(value=[])
        shard_list = self._shards(idx, shards)
        if not shard_list:
            return Deferred(value=[])
        block = self._shard_block(shard_list)
        cache = self.holder.cache
        filt = self._filter_row(idx, filt_call, block)
        mats = []
        for fname, row_ids in dims:
            field = idx.field(fname)
            view = field.view(VIEW_STANDARD) if field else None
            mats.append(batch.stacked_matrix(idx, fname, view, row_ids, block,
                                             cache))
        planes = None
        depth = 0
        if agg_field is not None:
            depth = agg_field.options.bit_depth
            planes = batch.stacked_leaf(
                idx, _PlanesSpec(agg_field.name, depth), block, cache)
        sizes = [len(row_ids) for _, row_ids in dims]
        base = agg_field.options.base if agg_field is not None else 0

        def collect(cand, counts_arr, agg_arrs) -> list[GroupCount]:
            counts: dict[tuple, int] = {}
            sums: dict[tuple, int] = {}
            for j in range(cand.shape[0]):
                c = int(counts_arr[j])
                if c <= 0:
                    continue
                key = tuple(dims[d][1][int(cand[j, d])]
                            for d in range(cand.shape[1]))
                counts[key] = c
                if agg_arrs is not None:
                    n_g, pc = agg_arrs
                    sums[key] = sum(int(v) << b for b, v in
                                    enumerate(pc[:, j].tolist())) \
                        + base * int(n_g[j])
            return self._groupby_result(idx, dims, counts, sums, agg_field,
                                        limit, having)

        if len(dims) <= kernels.MAX_LEAVES and \
                math.prod(sizes) <= GROUPBY_DENSE_MAX_GROUPS:
            cand = np.zeros((1, 0), np.int32)
            for n in sizes:
                cand = _index_cross(cand, n)
            packed, layout = _groupby_level_enqueue(self, block, mats, cand,
                                                    filt, planes, depth)

            def finish() -> list[GroupCount]:
                return collect(cand, *_groupby_level_unpack(
                    packed.cpu().numpy(), layout, planes is not None, depth))

            return Deferred(finish)
        # the pruned levels read back after each level to choose the next
        # level's candidates: all of it runs at result(), on the thread
        # that resolves (never on the serving pipeline's dispatcher). With
        # quantized ranking on, every level but the last counts over the
        # 8-bit lane and keeps each candidate whose count plus bound could
        # be nonzero (zero quantizes to zero); the last stays lossless, so
        # the reported counts are exact.
        quant = self._quant_ranking_active()
        return Deferred(lambda: collect(*_groupby_pruned(
            self, block, [], np.zeros((1, 0), np.int32), mats, sizes, filt,
            planes, depth, quant)))

    # ------------------------------------------------------- IncludesColumn

    def _execute_includes_column(self, idx: Index, call: Call,
                                 shards=None) -> bool:
        """The child's row on the column's one shard (the row plan over a
        one-slot block), then the column's bit."""
        col = call.arg("column")
        if col is None:
            raise PQLError("IncludesColumn requires column=")
        if len(call.children) != 1:
            raise PQLError("IncludesColumn requires one child call")
        col = self._translate_col(idx, col)
        if col is None:
            return False  # an unknown column key is in no row
        shard = shard_of(col)
        if shards is not None and shard not in shards:
            return False  # Options(shards=) excludes the column's shard
        pos = position(col)
        compiled = self._compile_cached(idx, call.children[0])
        # a one-shard block of its own: nothing to memoize
        words = self._run(idx, compiled, batch.ShardBlock([shard]), "row",
                          memoize=False)
        word = int(words[0, pos // 32].item()) & 0xFFFFFFFF
        return bool((word >> (pos % 32)) & 1)

    # -------------------------------------------------------------- compile

    def _compile_cached(self, idx: Index, call: Call,
                        wrap: str | None = None, build=None) -> _Compiled:
        """_compile (or ``build()``) with a plan memo keyed by the
        (memoized, immutable) Call tree's identity, revalidated against
        the Index object and its schema epoch. The scalars (shift amounts,
        predicates) are part of the compiled plan, the structure holds
        only their indices. Plans that degenerated to const0 are not
        cached."""
        key = (idx.name, id(call), wrap)
        entry = self._plan_cache.get(key)
        cost = current_cost()
        if entry is not None:
            call_ref, idx_ref, epoch, compiled = entry
            if (call_ref is call and idx_ref() is idx
                    and epoch == idx.plan_epoch):
                if cost is not None:
                    cost.note_plan(True)
                return compiled
        if cost is not None:
            cost.note_plan(False)
        epoch = idx.plan_epoch
        if build is not None:
            compiled = build()
        else:
            specs: list = []
            scalars: list = []
            node = self._compile_node(idx, call, specs, scalars)
            if wrap == "count":
                node = ("count", node)
            compiled = _Compiled(node, specs, scalars)
        compiled.plan = self._plan(compiled.node)
        if not _node_has_const0(compiled.node):
            if len(self._plan_cache) >= self.PLAN_CACHE_MAX:
                self._plan_cache.clear()
            self._plan_cache[key] = (call, weakref.ref(idx), epoch, compiled)
            compiled.memoizable = True
        return compiled

    def _compile_node(self, idx: Index, call: Call, specs, scalars):
        name = call.name
        if name in ("Row", "Range"):
            return self._compile_row(idx, call, specs, scalars)
        if name in ("Union", "Intersect", "Xor", "Difference"):
            if not call.children:
                return ("const0",)
            tag = {"Union": "or", "Intersect": "and", "Xor": "xor",
                   "Difference": "diff"}[name]
            node = self._compile_node(idx, call.children[0], specs, scalars)
            for child in call.children[1:]:
                node = (tag, node,
                        self._compile_node(idx, child, specs, scalars))
            return node
        if name == "Not":
            if len(call.children) != 1:
                raise PQLError("Not requires exactly one child call")
            exists = self._existence_node(idx, specs)
            return ("diff", exists,
                    self._compile_node(idx, call.children[0], specs, scalars))
        if name == "All":
            return self._existence_node(idx, specs)
        if name == "Shift":
            if len(call.children) != 1:
                raise PQLError("Shift requires exactly one child call")
            scalars.append(int(call.arg("n", 1)))
            return ("shift",
                    self._compile_node(idx, call.children[0], specs, scalars),
                    len(scalars) - 1)
        raise PQLError(f"call {name!r} is not a bitmap (row-producing) call")

    def _compile_row(self, idx: Index, call: Call, specs, scalars):
        """Row/Range of one row: the standard view, or with from=/to= on
        a time field the quantum views covering [from, to), OR'd into
        one leaf (an empty cover reads zeros)."""
        cond_field, cond = call.condition_field()
        if cond is not None:
            return self._compile_bsi_compare(idx, cond_field, cond, specs,
                                             scalars)
        field_name, row = self._row_field_and_value(call)
        field = idx.field(field_name)
        if field is None:
            raise PQLError(f"field {field_name!r} not found")
        row = self._translate_row(idx, field, row)
        if row is None:
            return ("const0",)  # an unknown key reads as an empty row
        if row < 0:
            return ("const0",)  # negative rows cannot exist
        t_from, t_to = call.arg("from"), call.arg("to")
        if t_from is not None or t_to is not None:
            if field.options.type != TYPE_TIME:
                raise PQLError("from/to args require a time field")
            # a missing bound parses as the reference parses it: a bare
            # ValueError (Invalid isoformat string: 'None')
            views = tuple(views_by_time_range(
                VIEW_STANDARD, field.options.time_quantum,
                parse_time(t_from), parse_time(t_to)))
        else:
            views = (VIEW_STANDARD,)
        specs.append(_RowSpec(field_name, views, row))
        return ("leaf", len(specs) - 1)

    def _compile_bsi_compare(self, idx: Index, field_name: str,
                             cond: Condition, specs, scalars):
        field = idx.field(field_name)
        if field is None:
            raise PQLError(f"field {field_name!r} not found")
        if field.options.type != TYPE_INT:
            raise PQLError(f"comparison on non-int field {field_name!r}")
        if cond.op == "><":
            lo, hi = cond.value
            if lo > hi:
                return ("const0",)
            ge = self._compile_bsi_compare(idx, field_name,
                                           Condition(">=", lo), specs, scalars)
            le = self._compile_bsi_compare(idx, field_name,
                                           Condition("<=", hi), specs, scalars)
            return ("and", ge, le)

        base = field.options.base
        max_stored = (1 << field.options.bit_depth) - 1
        value = cond.value
        op = cond.op
        # fractional predicates only arrive as parser floats; stored values
        # are integers, so x < 1.5 is x <= 1 and x > 1.5 is x >= 2, and
        # ==/!= degenerate (plain int() would wrongly turn x < 1.5 into
        # x < 1)
        if isinstance(value, float) and not value.is_integer():
            if op == "==":
                return ("const0",)
            if op == "!=":
                return self._bsi_exists_node(field, specs)
            if math.isinf(value):
                everything = (value > 0) == (op in ("<", "<="))
                return (self._bsi_exists_node(field, specs) if everything
                        else ("const0",))
            fl = math.floor(value)
            value, op = (fl, "<=") if op in ("<", "<=") else (fl + 1, ">=")
        pred = int(value) - base
        exists = self._bsi_exists_node(field, specs)
        # range clamp: out-of-range predicates degenerate to empty/universe
        if pred < 0:
            if op in ("<", "<=", "=="):
                return ("const0",)
            return exists  # >, >=, != of anything stored
        if pred > max_stored:
            if op in (">", ">=", "=="):
                return ("const0",)
            return exists
        planes_i = self._planes_index(field, specs)
        scalars.append(pred)
        return ("bsicmp", op, planes_i, exists, len(scalars) - 1)

    def _planes_index(self, field, specs) -> int:
        for i, s in enumerate(specs):
            if isinstance(s, _PlanesSpec) and s.field == field.name:
                return i
        specs.append(_PlanesSpec(field.name, field.options.bit_depth))
        return len(specs) - 1

    def _bsi_exists_node(self, field, specs):
        specs.append(_RowSpec(field.name, (field.bsi_view_name(),),
                              BSI_EXISTS_ROW))
        return ("leaf", len(specs) - 1)

    def _existence_node(self, idx: Index, specs):
        if not idx.track_existence:
            raise PQLError("Not/All require trackExistence on the index")
        specs.append(_RowSpec(EXISTENCE_FIELD, (VIEW_STANDARD,), 0))
        return ("leaf", len(specs) - 1)

    @staticmethod
    def _row_field_and_value(call: Call):
        for k, v in call.args.items():
            if k not in _RESERVED_ARGS and not isinstance(v, Condition):
                return k, v
        raise PQLError(f"{call.name} requires a field=row argument")

    # ---------------------------------------------------------------- writes

    def _write_target(self, idx: Index, call: Call, create: bool):
        """(column, field, row or value) of a Set (``create``: new keys
        get ids) or a Clear (None when its column or row key is
        unknown); an int field's value is checked by the field itself."""
        col = call.arg("_col")
        if col is None:
            raise PQLError(f"{call.name} requires a column")
        col = self._translate_col(idx, col, create=create)
        if col is None:
            return None
        if col < 0:
            raise PQLError(f"column {col} is negative")
        field_name, row = self._row_field_and_value(call)
        field = idx.field(field_name)
        if field is None:
            raise PQLError(f"field {field_name!r} not found")
        if field.options.type == TYPE_INT:
            return col, field, row
        row = self._translate_row(idx, field, row, create=create)
        if row is None:
            return None
        _check_row(row)
        return col, field, row

    def _execute_set(self, idx: Index, call: Call) -> bool:
        """Set; the field's own ValueErrors (a bool row past 1, a
        timestamp on a field that is not a time field) and a timestamp
        that does not parse propagate bare, as in the reference."""
        col, field, row = self._write_target(idx, call, create=True)
        if field.options.type == TYPE_INT:
            try:
                changed = field.set_value(col, int(row))
            except ValueError as e:
                raise PQLError(str(e)) from e
        else:
            ts = call.arg("timestamp")
            changed = field.set_bit(
                row, col, timestamp=parse_time(ts) if ts is not None
                else None)
        idx.mark_columns_exist([col])
        return changed

    def _execute_clear(self, idx: Index, call: Call) -> bool:
        target = self._write_target(idx, call, create=False)
        if target is None:
            return False  # an unknown key: nothing to clear
        col, field, row = target
        if field.options.type == TYPE_INT:
            return field.clear_value(col)
        return field.clear_bit(row, col)

    def _execute_clear_row(self, idx: Index, call: Call, shards=None) -> bool:
        """ClearRow(f=r): every bit of the row in the field's standard
        view (time views keep theirs, as in the reference), over the
        query's shards."""
        field_name, row = self._row_field_and_value(call)
        field = idx.field(field_name)
        if field is None:
            raise PQLError(f"field {field_name!r} not found")
        row = self._translate_row(idx, field, row)
        if row is None:
            return False  # an unknown row key: nothing to clear
        _check_row(row)
        view = field.view(VIEW_STANDARD)
        changed = False
        if view is not None:
            for shard in self._shards(idx, shards):
                frag = view.fragment(shard)
                if frag is not None:
                    changed |= frag.clear_row(row) > 0
        return changed

    def _execute_store(self, idx: Index, call: Call, shards=None) -> bool:
        """Store(child, f=r): the child's row (its plan, then K2), read
        back once, replaces row r of f's standard view in every shard of
        the query, empty shards included. A missing f is created as a
        set field, after the row is checked."""
        if len(call.children) != 1:
            raise PQLError("Store requires one child call")
        field_name, row = self._row_field_and_value(call)
        field = idx.field(field_name)
        if field is None:
            _check_row(row)
            field = idx.create_field(field_name)
        else:
            row = self._translate_row(idx, field, row, create=True)
            _check_row(row)
        shard_list = self._shards(idx, shards)
        if not shard_list:
            return True
        compiled = self._compile_cached(idx, call.children[0])
        block = self._shard_block(shard_list)
        host = self._run(idx, compiled, block, "row").cpu().numpy().view(
            np.uint32)
        view = field.view(VIEW_STANDARD, create=True)
        for i, shard in enumerate(block.shards):
            view.fragment(shard, create=True).write_row_words(row, host[i])
        return True

    def _execute_set_row_attrs(self, idx: Index, call: Call) -> None:
        """SetRowAttrs(field, row, name=value, ...): merged into the
        row's attrs (a null value deletes its name); a new row key is
        created."""
        field_name = call.arg("_field")
        if field_name is None:
            raise PQLError("SetRowAttrs requires a field")
        field = idx.field(field_name)
        if field is None:
            raise PQLError(f"field {field_name!r} not found")
        row = call.arg("_col")
        if row is None:
            raise PQLError("SetRowAttrs requires a row id")
        row = self._translate_row(idx, field, row, create=True)
        field.row_attrs.set_attrs(int(row), _attr_args(call))
        return None

    def _execute_set_column_attrs(self, idx: Index, call: Call) -> None:
        """SetColumnAttrs(column, name=value, ...); a new column key is
        created."""
        col = call.arg("_col")
        if col is None:
            raise PQLError("SetColumnAttrs requires a column id")
        col = self._translate_col(idx, col, create=True)
        idx.column_attrs.set_attrs(int(col), _attr_args(call))
        return None


def _filter_topn_candidates(field, call: Call, candidates: list) -> list:
    """TopN(attrName=, attrValue=): the candidate rows whose attrs hold
    that value, from one bulk read of the candidates' attrs."""
    attr_name = call.arg("attrName")
    if attr_name is None:
        return candidates
    attr_value = call.arg("attrValue")
    attr_map = field.row_attrs.bulk(candidates) if candidates else {}
    return [r for r in candidates
            if attr_map.get(r, {}).get(attr_name) == attr_value]


def _attr_args(call: Call) -> dict:
    """The attribute arguments of an attrs call: its named arguments
    that are not reserved."""
    return {k: v for k, v in call.args.items() if k not in _RESERVED_ARGS}


def _check_row(row) -> None:
    if not isinstance(row, int):
        raise PQLError(f"row key {row!r} requires key translation "
                       "(field keys)")
    if row < 0:
        raise PQLError(f"row {row} is negative")


def parse_time(value) -> dt.datetime:
    """A from=/to=/timestamp= argument as a datetime, parsed from its
    string form as the reference parses it."""
    if isinstance(value, dt.datetime):
        return value
    return dt.datetime.fromisoformat(str(value))


# ------------------------------------------------------------ GroupBy level


def _groupby_level_enqueue(ex, block, mats: list, cand: np.ndarray, filt,
                           planes, depth: int, quantized: bool = False):
    """Launch one level's K9 chunks over the candidates ``cand`` [C, k]
    (indices into each matrix's rows) through ``ex``'s level hook, each
    chunk sized so K9's output stays under GROUPBY_OUT_BUDGET_BYTES, the
    packed chunks concatenated on the device. ``quantized`` levels pack
    the 8-bit ranking lane (no aggregate). Returns (packed, chunk
    sizes); no readback."""
    per_cand = block.padded * 4 * (1 if planes is None else 2 + depth)
    chunk = max(1, GROUPBY_OUT_BUDGET_BYTES // per_cand)
    packs, layout = [], []
    for lo in range(0, cand.shape[0], chunk):
        part = cand[lo:lo + chunk]
        padded = min(chunk, next_pow2(part.shape[0]))
        packs.append(dispatch(
            "groupby_q" if quantized else "groupby",
            lambda: ex._launch_groupby_level(
                block, mats, [part[:, d] for d in range(part.shape[1])],
                filt, planes, quantized, padded)))
        layout.append(part.shape[0])
    packed = packs[0] if len(packs) == 1 else torch.cat(packs)
    return packed, layout


def _groupby_pruned(ex, block, level_mats: list, cand: np.ndarray,
                    mats: list, sizes: list, filt, planes, depth: int,
                    quant: bool = False):
    """The pruned levels: extend the prefix candidates ``cand`` [P, k]
    (indices into the rows of ``level_mats``) one dimension of ``mats``
    a level, dropping the empty groups after each level's readback (an
    AND only shrinks a group). ``quant``: every level but the last counts
    over the quantized lane, whose upper bounds only gate survival. A
    level that would need a 17th matrix goes on in ``_groupby_folded``.
    Returns (candidates [G, k + len(mats)], counts [G], and with
    ``planes`` on the last level (n, plane counts)) of the non-empty
    groups."""
    width = cand.shape[1] + len(sizes)
    counts_arr = agg_arrs = None
    for k, n in enumerate(sizes):
        if len(level_mats) == kernels.MAX_LEAVES:
            return _groupby_folded(ex, block, level_mats, cand, mats[k:],
                                   sizes[k:], filt, planes, depth, quant)
        level_mats = level_mats + [mats[k]]
        cand = _index_cross(cand, n)
        last = k == len(sizes) - 1
        quantized = quant and not last
        packed, layout = _groupby_level_enqueue(
            ex, block, level_mats, cand, filt, planes if last else None,
            depth, quantized)
        counts_arr, agg_arrs = _groupby_level_unpack(
            packed.cpu().numpy(), layout, last and planes is not None, depth,
            quantized)
        keep = counts_arr > 0
        cand, counts_arr = cand[keep], counts_arr[keep]
        if agg_arrs is not None:
            agg_arrs = (agg_arrs[0][keep], agg_arrs[1][:, keep])
        if cand.shape[0] == 0:
            return np.zeros((0, width), np.int32), counts_arr, None
    return cand, counts_arr, agg_arrs


def _groupby_folded(ex, block, level_mats: list, cand: np.ndarray,
                    mats: list, sizes: list, filt, planes, depth: int,
                    quant: bool = False):
    """``_groupby_pruned`` past K9's 16 matrices: per chunk of the prefix
    groups ``cand``, each group's AND over ``level_mats`` becomes one row
    of a temporary int32[S, chunk, W] matrix (``_groupby_prefix_matrix``,
    each chunk's matrix under GROUPBY_OUT_BUDGET_BYTES), which stands
    for those dimensions in the remaining levels; the chunks' groups are
    concatenated in order."""
    first = level_mats[0]
    per_group = first.shape[0] * first.shape[2] * 4
    chunk = max(1, GROUPBY_OUT_BUDGET_BYTES // per_group)
    parts = []
    for lo in range(0, cand.shape[0], chunk):
        prefix = cand[lo:lo + chunk]
        folded = _groupby_prefix_matrix(level_mats, prefix)
        sub, counts_arr, agg_arrs = _groupby_pruned(
            ex, block, [folded],
            np.arange(prefix.shape[0], dtype=np.int32)[:, None], mats, sizes,
            filt, planes, depth, quant)
        del folded
        if sub.shape[0]:
            parts.append((np.concatenate([prefix[sub[:, 0]], sub[:, 1:]], 1),
                          counts_arr, agg_arrs))
    if not parts:
        return (np.zeros((0, cand.shape[1] + len(sizes)), np.int32),
                np.zeros(0, np.int64), None)
    agg_arrs = None
    if planes is not None:
        agg_arrs = (np.concatenate([p[2][0] for p in parts]),
                    np.concatenate([p[2][1] for p in parts], axis=1))
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]), agg_arrs)


def _groupby_prefix_matrix(mats: list, cand: np.ndarray) -> torch.Tensor:
    """The AND of each candidate's rows, one row per candidate:
    int32[S, P, W] for candidates ``cand`` [P, k] (indices into the k <=
    16 matrices' rows). Per chunk of candidates, each matrix's rows are
    gathered (a plain gather) and K2 ANDs them, the chunks sized so the
    gathers stay under GROUPBY_OUT_BUDGET_BYTES (one candidate at
    least)."""
    first = mats[0]
    n_shards, row_words = first.shape[0], first.shape[2]
    out = torch.empty((n_shards, cand.shape[0], row_words),
                      dtype=torch.int32, device=first.device)
    per_cand = n_shards * row_words * 4 * (len(mats) + 1)
    chunk = max(1, GROUPBY_OUT_BUDGET_BYTES // per_cand)
    program = expr.compile_program(_and_chain(len(mats)))
    for lo in range(0, cand.shape[0], chunk):
        part = cand[lo:lo + chunk]
        rows = [m[:, torch.as_tensor(part[:, d].astype(np.int64),
                                     device=m.device)]
                for d, m in enumerate(mats)]
        out[:, lo:lo + part.shape[0]] = dispatch(
            "row", lambda: kernels.tree_rows(program, rows))
    return out


def _and_chain(n: int):
    node = ("leaf", 0)
    for i in range(1, n):
        node = ("and", node, ("leaf", i))
    return node


def _groupby_level_unpack(host: np.ndarray, layout: list, has_agg: bool,
                          depth: int, quantized: bool = False):
    """A level's packed chunks on the host: per-candidate counts, and with
    an aggregate (n, plane counts [depth, C]). A ``quantized`` level's
    chunks are [2·(C + blocks)] ranking-lane packs, and its counts are
    approx + error bound: an upper bound that only gates survival."""
    total = sum(layout)
    if quantized:
        from pilosa_tpu_torch.parallel import reduction

        counts = np.zeros(total, np.int64)
        off = out = 0
        for c in layout:
            width = reduction.quant_total_elems(c)
            approx, err = reduction.split_quantized(batch.merge_split(
                host[off:off + 2 * width].reshape(2, width)), c)
            counts[out:out + c] = approx + err
            off += 2 * width
            out += c
        return counts, None
    counts = np.zeros(total, np.int64)
    n_g = np.zeros(total, np.int64) if has_agg else None
    pc = np.zeros((depth, total), np.int64) if has_agg else None
    off = out = 0
    for c in layout:
        counts[out:out + c] = batch.merge_split(
            host[off:off + 2 * c].reshape(2, c))
        off += 2 * c
        if has_agg:
            n_g[out:out + c] = batch.merge_split(
                host[off:off + 2 * c].reshape(2, c))
            off += 2 * c
            pc[:, out:out + c] = batch.merge_split(
                host[off:off + 2 * depth * c].reshape(2, depth, c))
            off += 2 * depth * c
        out += c
    return counts, (n_g, pc) if has_agg else None


def _index_cross(cand: np.ndarray, n: int) -> np.ndarray:
    """Extend candidate index tuples [P, k] by every index of the next
    dimension → [P·n, k+1]."""
    left = np.repeat(cand, n, axis=0)
    right = np.tile(np.arange(n, dtype=np.int32), cand.shape[0])[:, None]
    return np.concatenate([left, right], axis=1)


# ----------------------------------------------------------------- Options


def options_child(call: Call) -> Call:
    """Validate and return an Options() call's single child."""
    if len(call.children) != 1:
        raise PQLError("Options requires one child call")
    return call.children[0]


def options_restrict_shards(call: Call, shards):
    """Options(shards=) intersected with an engine-supplied shard list
    (each shard once)."""
    opt = call.arg("shards")
    if opt is None:
        return shards
    opt = sorted({int(s) for s in opt})
    return opt if shards is None else sorted(set(opt) & set(shards))


def apply_options_result(idx: Index, call: Call, res):
    """Options' result arguments on a row result: columnAttrs attaches the
    columns' attrs, excludeColumns drops the columns."""
    if isinstance(res, RowResult):
        if call.arg("columnAttrs"):
            res.column_attrs = column_attr_sets(idx, res)
        if call.arg("excludeColumns"):
            return strip_columns(res)
    return res


def column_attr_sets(idx: Index, res: RowResult) -> list[dict]:
    """The columnAttrs output: each result column that has attrs, with
    them, from one bulk read (PQL Options() and the request's URL
    parameter alike)."""
    cols = res.columns().tolist()
    attr_map = idx.column_attrs.bulk(cols) if cols else {}
    return [{"id": c, "attrs": attr_map[c]} for c in cols if c in attr_map]


def strip_columns(res: RowResult) -> RowResult:
    """The excludeColumns output: the row without its columns (nor their
    keys, which are the columns of a keyed index), its row attrs and
    column attrs kept."""
    out = RowResult({}, attrs=res.attrs,
                    keys=[] if res.keys is not None else None)
    out.column_attrs = res.column_attrs
    return out


# ------------------------------------------------------------------ having


def _condition_value(v):
    """Numeric coercion of a Condition's threshold: ints and floats as
    they are (``count < 1.5`` keeps count 1), quoted numbers parsed, junk
    a PQLError."""
    if isinstance(v, (int, float)):
        return v
    try:
        return int(v)
    except (TypeError, ValueError):
        try:
            return float(v)
        except (TypeError, ValueError):
            raise PQLError(f"condition value {v!r} is not numeric") from None


def condition_test(cond: Condition, val: int) -> bool:
    """A PQL Condition against a scalar (having= filters)."""
    if cond.op == "><":
        lo, hi = cond.value
        return _condition_value(lo) <= val <= _condition_value(hi)
    ref = _condition_value(cond.value)
    return {"<": val < ref, "<=": val <= ref, ">": val > ref,
            ">=": val >= ref, "==": val == ref, "!=": val != ref}[cond.op]


def having_predicate(call: Call, has_agg: bool):
    """GroupBy(having=Condition(count <op> N)) or Condition(sum <op> N):
    exactly one condition, applied to whole groups before limit=; a sum
    condition needs aggregate=Sum(...). Returns ``pred(count, sum)`` or
    None."""
    having = call.arg("having")
    if having is None:
        return None
    if not isinstance(having, Call) or having.name != "Condition":
        raise PQLError("having= requires Condition(count/sum <op> value)")
    conds = [(k, v) for k, v in having.args.items()
             if isinstance(v, Condition)]
    if len(conds) != 1 or conds[0][0] not in ("count", "sum"):
        raise PQLError("having= supports exactly one condition on count or "
                       "sum")
    subject, cond = conds[0]
    if subject == "sum" and not has_agg:
        raise PQLError("having on sum requires aggregate=Sum(...)")

    def pred(count: int, sum_) -> bool:
        return condition_test(cond, count if subject == "count"
                              else int(sum_ or 0))

    return pred


# Calls whose submit() launches kernels and defers the readback (or
# coalesces into micro-batches): the only ones the serving pipeline
# coalesces. Every other call (Rows, IncludesColumn, writes) evaluates
# fully inside submit(), so routing it through the one dispatcher thread
# would serialize work the request threads otherwise overlap.
_PIPELINED_CALLS = {"Count", "Sum", "Min", "Max", "TopN",
                    "GroupBy"} | _BITMAP_CALLS


def pipeline_coalescable(query) -> bool:
    """True when every call of the query pipelines under submit()
    (Options counts as its child)."""
    def one(call) -> bool:
        if call.name == "Options":
            return bool(call.children) and one(call.children[0])
        return call.name in _PIPELINED_CALLS

    calls = getattr(query, "calls", None)
    return calls is not None and all(one(c) for c in calls)
