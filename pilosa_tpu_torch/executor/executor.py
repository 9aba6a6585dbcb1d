"""The query executor: compile, dispatch, micro-batch, reduce.

The port's copy of ``pilosa_tpu.executor.executor`` for these slices:
Row, Union, Intersect, Difference, Xor, Not, All, Shift and Range over
set fields and int (BSI) fields, Count of any such tree, Sum/Min/Max
with or without a filter, and the Set/Clear writes (int fields
included). A call compiles to a structure (``expr``) over stacked leaves
and query-time scalars; shift and BSI-comparison nodes run first, each
through its own kernel (K4, K5), then a Count runs K1 over the rest and
a row call K2, and pipelined Counts of one shape share one K1 launch per
micro-batch; Sum runs K6 and Min/Max K7 (one launch per query). Other
calls, time ranges and keys raise ``PQLError("... not yet ported")``.
"""

from __future__ import annotations

import collections
import math
import threading
import weakref

import numpy as np

from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch import kernels
from pilosa_tpu_torch.executor import batch, expr
from pilosa_tpu_torch.executor.result import RowResult, ValCount
from pilosa_tpu_torch.pql import Call, Condition, parse
from pilosa_tpu_torch.pql.ast import Query
from pilosa_tpu_torch.storage.field import BSI_EXISTS_ROW, TYPE_INT, TYPE_SET
from pilosa_tpu_torch.storage.index import EXISTENCE_FIELD, Index
from pilosa_tpu_torch.storage.view import VIEW_STANDARD

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
    for the card (``expr.plan``)."""

    def __init__(self, node, specs, scalars):
        self.node = node
        self.specs = specs
        self.scalars = scalars
        self.plan = None


def _node_has_const0(node) -> bool:
    if not isinstance(node, tuple):
        return False
    if node and node[0] == "const0":
        return True
    return any(_node_has_const0(c) for c in node[1:])


class Deferred:
    """Handle for a pipelined query result (Executor.submit): the kernel
    is launched (or queued in a micro-batch) at submit; ``result()``
    does the readback."""

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

    def execute(self, index_name: str, query, shards=None) -> list:
        idx, query = self._parse(index_name, query)
        return [self._execute_call(idx, call, shards) for call in query.calls]

    def submit(self, index_name: str, query, shards=None) -> list:
        """Pipelined execution: parse, compile and launch (or queue) each
        call's kernel without waiting for the readback; one ``Deferred``
        per call. Counts of one shape coalesce into one launch per
        micro-batch; writes run at submit."""
        idx, query = self._parse(index_name, query)
        return [self._submit_one(idx, call, shards) for call in query.calls]

    def _submit_one(self, idx: Index, call: Call, shards=None) -> Deferred:
        if call.name == "Count":
            return self._submit_count(idx, call, shards, pipeline=True)
        if call.name in _AGGREGATES:
            return self._submit_bsi_aggregate(idx, call, shards)
        if call.name in _BITMAP_CALLS:
            return self._submit_bitmap(idx, call, shards)
        return Deferred(value=self._execute_call(idx, call, shards))

    def _execute_call(self, idx: Index, call: Call, shards=None):
        name = call.name
        if name == "Set":
            return self._execute_set(idx, call)
        if name == "Clear":
            return self._execute_clear(idx, call)
        if name == "Count":
            return self._submit_count(idx, call, shards).result()
        if name in _AGGREGATES:
            return self._submit_bsi_aggregate(idx, call, shards).result()
        if name in _BITMAP_CALLS:
            return self._submit_bitmap(idx, call, shards).result()
        raise PQLError(f"call {name!r} is not yet ported")

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
            block = batch.ShardBlock(shard_list)
            if len(self._block_memo) >= 64:
                self._block_memo.popitem(last=False)
            self._block_memo[key] = (shard_list, block)
            return block

    # ------------------------------------------------------ batched mapping

    def _eval_operands(self, idx: Index, compiled: _Compiled, block):
        """The stacked leaf of every compiled spec, resident on the card."""
        cache = self.holder.cache
        return [batch.stacked_leaf(idx, spec, block, cache)
                for spec in compiled.specs]

    def _zeros(self, idx: Index, block):
        """A resident all-zero [S, W] leaf for operand-free trees."""
        return lambda: batch.stacked_leaf(idx, _ZeroSpec(), block,
                                          self.holder.cache)

    def _run(self, idx: Index, compiled: _Compiled, block, reduce_kind):
        """One query's kernels, launched now (``batch.run_plan``)."""
        return batch.run_plan(compiled.plan, reduce_kind,
                              self._eval_operands(idx, compiled, block),
                              compiled.scalars, self._zeros(idx, block))

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
        fn = batch.local_fn_batched(node, reduce_kind,
                                    tuple(len(s) - 1 for s in shapes),
                                    len(rows))
        group["out"] = fn(*[leaf for leaves in rows for leaf in leaves])
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
        if not shard_list:
            return Deferred(value=RowResult({}))
        block = self._shard_block(shard_list)
        stacked = self._run(idx, compiled, block, "row")

        def finish() -> RowResult:
            host = stacked.cpu().numpy().view(np.uint32)
            segments = {}
            for i, shard in enumerate(block.shards):
                if host[i].any():
                    segments[shard] = host[i].copy()
            return RowResult(segments)

        return Deferred(finish)

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
        resolve = batch.materialize(compiled.plan,
                                    self._eval_operands(idx, compiled, block),
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
        if (call.name != "Sum" and field.options.bit_depth
                > kernels.BSI_MINMAX_MAX_DEPTH):
            raise PQLError(f"{call.name} over more than "
                           f"{kernels.BSI_MINMAX_MAX_DEPTH} bit planes is "
                           "not yet ported")
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
        if entry is not None:
            call_ref, idx_ref, epoch, compiled = entry
            if (call_ref is call and idx_ref() is idx
                    and epoch == idx.plan_epoch):
                return compiled
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
        try:
            # the kernels' operand, length and depth limits
            compiled.plan = expr.plan(compiled.node)
        except ValueError as e:
            raise PQLError(f"query tree is not yet ported: {e}") from e
        if not _node_has_const0(compiled.node):
            if len(self._plan_cache) >= self.PLAN_CACHE_MAX:
                self._plan_cache.clear()
            self._plan_cache[key] = (call, weakref.ref(idx), epoch, compiled)
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
        cond_field, cond = call.condition_field()
        if cond is not None:
            return self._compile_bsi_compare(idx, cond_field, cond, specs,
                                             scalars)
        if call.arg("from") is not None or call.arg("to") is not None:
            raise PQLError("time ranges are not yet ported")
        field_name, row = self._row_field_and_value(call)
        field = idx.field(field_name)
        if field is None:
            raise PQLError(f"field {field_name!r} not found")
        if field.options.type not in (TYPE_SET, TYPE_INT) or \
                not isinstance(row, int):
            raise PQLError(f"{field.options.type} fields and row keys are "
                           "not yet ported")
        if row < 0:
            return ("const0",)  # negative rows cannot exist
        specs.append(_RowSpec(field_name, (VIEW_STANDARD,), row))
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

    def _write_target(self, idx: Index, call: Call):
        """(column, field, row or value) of a Set/Clear; an int field's
        value is checked by the field itself."""
        col = call.arg("_col")
        if col is None:
            raise PQLError(f"{call.name} requires a column")
        if not isinstance(col, int):
            raise PQLError("column keys are not yet ported")
        if col < 0:
            raise PQLError(f"column {col} is negative")
        field_name, row = self._row_field_and_value(call)
        field = idx.field(field_name)
        if field is None:
            raise PQLError(f"field {field_name!r} not found")
        if field.options.type == TYPE_INT:
            return col, field, row
        if not isinstance(row, int):
            raise PQLError(
                f"row key {row!r} requires key translation (field keys)")
        if row < 0:
            raise PQLError(f"row {row} is negative")
        if call.arg("timestamp") is not None:
            raise PQLError("timestamped writes are not yet ported")
        return col, field, row

    def _execute_set(self, idx: Index, call: Call) -> bool:
        col, field, row = self._write_target(idx, call)
        try:
            if field.options.type == TYPE_INT:
                changed = field.set_value(col, int(row))
            else:
                changed = field.set_bit(row, col)
        except ValueError as e:
            raise PQLError(str(e)) from e
        idx.mark_columns_exist([col])
        return changed

    def _execute_clear(self, idx: Index, call: Call) -> bool:
        col, field, row = self._write_target(idx, call)
        try:
            if field.options.type == TYPE_INT:
                return field.clear_value(col)
            return field.clear_bit(row, col)
        except ValueError as e:
            raise PQLError(str(e)) from e
