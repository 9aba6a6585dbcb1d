"""Batched shard evaluation: few kernel launches, one readback per query.

The port's copy of ``pilosa_tpu.executor.batch``. A query's leaves are
stacked ``int32[S_padded, 32768]`` row tensors or ``int32[S_padded, 2 +
depth, 32768]`` BSI plane tensors (one slot per shard, the shard count
padded to a power of two with zero slots, as in the reference, so packed
results compare equal), built once per (query leaf, shard set) and kept
resident by the holder's ``DeviceRowCache``. Writes patch resident
leaves in place (K3, on a plane leaf through its row form) instead of
evicting them.

A structure's shift and bsicmp nodes, and the subtrees cut off a tree
over the kernels' limits, run first, each through its own kernel (K4,
K5, K2) into a temporary row (``materialize``, see ``expr.plan``); the
elementwise rest goes to K1 (counts) or K2 (rows).
TopN's candidate rows and GroupBy's dimensions are stacked row matrices
``int32[S_padded, R, 32768]`` (``stacked_matrix``), reduced by K8
(``countrows``) and K9 (a GroupBy level).

Reduce kinds and their packed results (int32):
  'count'     → [2]: split-sum scalar; the micro-batched form is [B, 2]
  'countrows' → [2, R]: split sums of each matrix row's popcount
  'bsisum'    → [2, depth + 1]: per-plane popcount split sums ++ [n]
  'min'/'max' → int64 [3]: [offset-encoded extremum, count_lo,
                count_hi] (count 0 → empty; the reference packs int32 and
                wraps an extremum past 31 bits)
  'row'       → [S_padded, words] (the only multi-row readback)

Split sums: partial popcounts are int32 and a per-shard popcount can
reach 2^20, so every cross-row sum is carried in two int32 channels — lo
15 bits and hi bits of each partial summed separately — and recombined
on the host as ``hi·2^15 + lo``.
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch import kernels
from pilosa_tpu_torch.executor import expr
from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD, next_pow2
from pilosa_tpu_torch.storage.residency import WordPatch, upload

SPLIT_SHIFT = 15
SPLIT_MASK = (1 << SPLIT_SHIFT) - 1
INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1

# Row width of the count reduction: per-row partials of 2^18 words stay
# <= 2^23 and fit int32. Divides every stacked block of 8+ slots
# (S_padded·2^15 words, S_padded a power of two); smaller blocks reduce
# as one row.
COUNT_CHUNK_WORDS = 1 << 18


def split_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum int32 partials over ``dim`` in two overflow-safe int32
    channels, stacked on that axis: [..., n] → [..., 2] (lo-bit sums,
    hi-bit sums); ``dim=0`` gives the reference's [2, ...] layout."""
    lo = (x & SPLIT_MASK).sum(dim=dim, dtype=torch.int32)
    hi = (x >> SPLIT_SHIFT).sum(dim=dim, dtype=torch.int32)
    return torch.stack([lo, hi], dim=dim)


def merge_split(packed: np.ndarray) -> np.ndarray:
    """Host-side recombination of split sums [2, ...] → int64 [...]."""
    packed = np.asarray(packed, np.int64)
    return (packed[1] << SPLIT_SHIFT) + packed[0]


class ShardBlock:
    """Orders a query's shard list as the leading axis of stacked leaves;
    the slot count pads to the next power of two. The mesh form
    (``parallel.mesh.ShardAssignment``) pads to a multiple of its member
    count instead; ``n_devices`` and ``local_slots`` enter the key, so a
    mesh block keys its leaves apart from a single-device block of the
    same shards. ``patchable``: writes patch the leaf in place (always,
    in one process)."""

    def __init__(self, shards: list[int]):
        self.shards = sorted(shards)
        self.padded = next_pow2(max(len(self.shards), 1))
        self.n_devices = 1
        self.local_slots = (0, self.padded)
        self.patchable = True
        self._key = None

    def key(self) -> tuple:
        if self._key is None:
            self._key = ("blk", tuple(self.shards), self.padded,
                         self.n_devices, self.local_slots)
        return self._key

    def stack(self, per_shard_fn, inner: tuple) -> np.ndarray:
        """The [padded, *inner] host array: per_shard_fn(shard) → row
        block; padding slots are zeros."""
        out = np.zeros((self.padded,) + tuple(inner), np.uint32)
        for i, s in enumerate(self.shards):
            out[i] = per_shard_fn(s)
        return out


def host_row(idx, spec, shard: int) -> np.ndarray:
    """Dense uint32[words] for a _RowSpec leaf on one shard (host side)."""
    field = idx.field(spec.field)
    acc = None
    for vname in spec.views:
        view = field.view(vname) if field else None
        frag = view.fragment(shard) if view else None
        if frag is None:
            continue
        words = frag.row_words(spec.row)
        acc = words if acc is None else np.bitwise_or(acc, words)
    return acc if acc is not None else np.zeros(WORDS_PER_SHARD, np.uint32)


def host_planes(idx, spec, shard: int, depth: int) -> np.ndarray:
    """uint32[depth, words] BSI plane matrix for one shard (host side);
    ``depth`` counts the exists and sign rows. A field deleted or a view
    missing reads zeros."""
    field = idx.field(spec.field)
    view = field.view(field.bsi_view_name()) if field is not None else None
    frag = view.fragment(shard) if view else None
    if frag is None:
        return np.zeros((depth, WORDS_PER_SHARD), np.uint32)
    return np.stack([frag.row_words(r) for r in range(depth)])


# ------------------------------------------------------ cached stacked leaves


def _word_masks(positions) -> tuple[np.ndarray, np.ndarray]:
    """In-shard positions → (unique word indices int32, OR-combined masks
    uint32). Unpadded: the patch kernel takes the real pair count."""
    positions = np.asarray(positions, np.uint32)
    words = (positions >> 5).astype(np.int32)
    bits = np.uint32(1) << (positions & np.uint32(31))
    uw = np.unique(words)
    masks = np.zeros(uw.size, np.uint32)
    np.bitwise_or.at(masks, np.searchsorted(uw, words), bits)
    return uw, masks


def _make_probe(block: ShardBlock, match, row_pos_of, decode_row,
                delta_on_clear: bool):
    """Write-routing probe for a stacked leaf: None when the event does
    not touch the leaf, else how to patch the shard's slot in place — the
    exact word delta as a ``WordPatch`` (K3, launched with the rest of
    the write request's patches) when the event carries positions, else
    ``apply(arr)``, a fresh host decode of the row. ``row_pos_of(ev)``: the
    inner row of an ``[S, R, W]`` leaf (None for ``[S, W]`` leaves).
    ``delta_on_clear``: clears may delta-patch (single-view leaves only:
    with several OR'd views a cleared bit may survive in another view).
    An event without positions (a row replaced by Store) or with more
    positions than half a row's words (ClearRow of a dense row) decodes
    the row instead: its (word, mask) pairs would stage more bytes than
    the row's upload."""
    slot_of = {s: i for i, s in enumerate(block.shards)}

    def probe(ev):
        slot = slot_of.get(ev.shard)
        if slot is None or not match(ev):
            return None
        row = row_pos_of(ev) if row_pos_of is not None else None
        if ev.positions is not None and \
                len(ev.positions) <= WORDS_PER_SHARD // 2 and (
                    ev.added or (ev.added is False and delta_on_clear)):
            word_idx, masks = _word_masks(ev.positions)
            return WordPatch(slot, row, word_idx, masks, not ev.added)

        def set_row(arr):
            target = arr[slot] if row is None else arr[slot, row]
            target.copy_(upload(decode_row(ev), arr.device))

        return set_row

    return probe


def leaf_key(idx, spec, block: ShardBlock) -> tuple:
    """Residency key of a compiled spec's stacked leaf."""
    from pilosa_tpu_torch.executor.executor import (
        PQLError,
        _PlanesSpec,
        _RowSpec,
        _ZeroSpec,
    )

    if isinstance(spec, _RowSpec):
        return ("stack", idx.scope, idx.name, spec.field, spec.views,
                spec.row, block.key())
    if isinstance(spec, _PlanesSpec):
        return ("stackp", idx.scope, idx.name, spec.field, 2 + spec.depth,
                block.key())
    if isinstance(spec, _ZeroSpec):
        return ("stackz", block.key())
    raise PQLError(f"unknown leaf spec {type(spec).__name__}")


def stacked_leaf(idx, spec, block: ShardBlock, cache) -> torch.Tensor:
    """Device-resident stacked leaf for a compiled spec, via ``cache``."""
    from pilosa_tpu_torch.executor.executor import (
        PQLError,
        _PlanesSpec,
        _RowSpec,
        _ZeroSpec,
    )
    from pilosa_tpu_torch.storage.view import view_name_bsi

    key = leaf_key(idx, spec, block)
    if isinstance(spec, _ZeroSpec):
        return cache.get_row(
            key, lambda: np.zeros((block.padded, WORDS_PER_SHARD), np.uint32))
    if isinstance(spec, _RowSpec):
        def decode():
            return block.stack(lambda shard: host_row(idx, spec, shard),
                               inner=(WORDS_PER_SHARD,))

        def probe():
            views = frozenset(spec.views)
            return _make_probe(
                block,
                match=lambda ev: ev.row == spec.row and ev.view in views,
                row_pos_of=None,
                decode_row=lambda ev: host_row(idx, spec, ev.shard),
                delta_on_clear=len(spec.views) == 1,
            )
    elif isinstance(spec, _PlanesSpec):
        # compile-time depth and a name-derived view: a delete_field racing
        # the query reads zeros of the planned shape
        depth = 2 + spec.depth
        bsi_view = view_name_bsi(spec.field)

        def decode():
            return block.stack(
                lambda shard: host_planes(idx, spec, shard, depth),
                inner=(depth, WORDS_PER_SHARD))

        def decode_row(ev):
            field = idx.field(spec.field)
            view = field.view(bsi_view) if field is not None else None
            frag = view.fragment(ev.shard) if view else None
            if frag is None:
                return np.zeros(WORDS_PER_SHARD, np.uint32)
            return frag.row_words(ev.row)

        def probe():
            return _make_probe(
                block,
                match=lambda ev: ev.view == bsi_view and ev.row < depth,
                row_pos_of=lambda ev: ev.row,
                decode_row=decode_row,
                delta_on_clear=True,
            )
    else:
        raise PQLError(f"unknown leaf spec {type(spec).__name__}")

    return cache.get_or_build(key, (idx.scope, idx.name, spec.field),
                              probe, decode)


def stacked_matrix(idx, field_name: str, view, row_ids, block: ShardBlock,
                   cache, pad_rows: int = 0) -> torch.Tensor:
    """Device-resident row matrix ``int32[padded, len(row_ids) + pad_rows,
    words]`` of one view (TopN's phase-2 candidates, GroupBy's
    dimensions), via ``cache``. ``pad_rows`` appends zero rows, never
    duplicates of a real row: the write probe maps each row id to ONE
    inner position, and patches it there in place (K3's row form)."""
    view_name = view.name if view is not None else None
    n_rows = len(row_ids) + pad_rows
    key = ("stackm", idx.scope, idx.name, field_name, view_name,
           tuple(row_ids), pad_rows, block.key())

    def live_view():
        # by NAME at decode time: a field deleted or recreated while the
        # matrix builds reads the live schema, not a dead view
        field = idx.field(field_name)
        return field.view(view_name) if field and view_name else None

    def decode():
        v = live_view()

        def per_shard(shard):
            out = np.zeros((n_rows, WORDS_PER_SHARD), np.uint32)
            frag = v.fragment(shard) if v else None
            if frag is not None:
                for i, r in enumerate(row_ids):
                    out[i] = frag.row_words(r)
            return out

        return block.stack(per_shard, inner=(n_rows, WORDS_PER_SHARD))

    def decode_row(ev):
        v = live_view()
        frag = v.fragment(ev.shard) if v else None
        if frag is None:
            return np.zeros(WORDS_PER_SHARD, np.uint32)
        return frag.row_words(ev.row)

    def probe():
        row_pos = {r: i for i, r in enumerate(row_ids)}
        return _make_probe(
            block,
            match=lambda ev: ev.view == view_name and ev.row in row_pos,
            row_pos_of=lambda ev: row_pos[ev.row],
            decode_row=decode_row,
            delta_on_clear=True,
        )

    return cache.get_or_build(key, (idx.scope, idx.name, field_name), probe,
                              decode)


# ------------------------------------------------------------------ programs


def count_elementwise_sub(structure, leaf_ranks: tuple):
    """For a ('count', sub) structure whose tree is purely elementwise over
    rank-1 word leaves (and/or/xor/diff/leaf/const0), return ``sub``;
    else None. Bit position never matters to such a count, so the whole
    stacked block reduces as one flat array in wide rows."""
    if not structure or structure[0] != "count":
        return None
    if any(r != 1 for r in leaf_ranks):
        return None

    def ok(n):
        if n[0] in ("leaf", "const0"):
            return True
        if n[0] in ("and", "or", "xor", "diff"):
            return all(ok(c) for c in n[1:])
        return False

    return structure[1] if ok(structure[1]) else None


def count_flat_batched(program, batch_leaves) -> torch.Tensor:
    """K1 over a micro-batch: each query's count program over its stacked
    leaves, popcounts reduced in COUNT_CHUNK_WORDS-wide rows, split-summed
    on the device → int32[B, 2]. One kernel launch for the batch."""
    n_words = batch_leaves[0][0].numel()
    row_words = min(COUNT_CHUNK_WORDS, n_words)
    partials = kernels.tree_count(program, batch_leaves,
                                  [0] * len(batch_leaves), row_words)
    return split_sum(partials)


def count_flat(program, leaves) -> torch.Tensor:
    """Single-query form of count_flat_batched → int32[2]."""
    return count_flat_batched(program, [leaves])[0]


def check_kind(structure, reduce_kind: str, leaf_ranks: tuple) -> tuple:
    if reduce_kind == "count":
        if count_elementwise_sub(structure, leaf_ranks) is None:
            raise ValueError(f"count of {structure!r} is not ported yet")
    elif reduce_kind == "row":
        if any(r != 1 for r in leaf_ranks):
            raise ValueError("row results take rank-1 word leaves")
    else:
        raise ValueError(f"reduce kind {reduce_kind!r} is not ported yet")
    return expr.compile_program(structure)


def local_fn_batched(structure, reduce_kind: str, leaf_ranks: tuple,
                     n_queries: int):
    """ONE launch evaluating ``n_queries`` same-shape elementwise count
    queries (the micro-batch): args are the queries' leaves back to back;
    returns int32[n_queries, 2]."""
    if reduce_kind != "count":
        raise ValueError("only count queries are micro-batched")
    program = check_kind(structure, reduce_kind, leaf_ranks)
    n_leaves = len(leaf_ranks)

    def fn(*args):
        batch = [list(args[i * n_leaves:(i + 1) * n_leaves])
                 for i in range(n_queries)]
        return count_flat_batched(program, batch)

    return fn


# ---------------------------------------------------------- planned dispatch


def row_expr(sub, tensors: list, zeros) -> torch.Tensor:
    """The words of a ``(node, operands)`` row expression over its
    resolved operand tensors: the operand itself when the node is a bare
    leaf (read-only uses), else K2 (``zeros()`` stands in for an
    operand-free node)."""
    node, _ = sub
    if node == ("leaf", 0) and len(tensors) == 1:
        return tensors[0]
    return kernels.tree_rows(expr.compile_program(node), tensors or [zeros()])


def materialize(plan: expr.Plan, leaves: list, scalars, zeros):
    """Run a plan's steps, innermost first, each through its own kernel
    (K2 tree, K4 shift, K5 bsicmp) into a temporary [S, W] row. Returns
    ``resolve(operands) -> tensors`` over the stacked leaves and those
    temporaries. Every launch is queued on the stream now, so the
    temporaries see the leaves as they are at submit."""
    temps: list = []

    def resolve(operands) -> list:
        return [leaves[i] if kind == "spec" else temps[i]
                for kind, i in operands]

    for step in plan.steps:
        if step[0] == "tree":
            temps.append(row_expr(step[1], resolve(step[1][1]), zeros))
        elif step[0] == "shift":
            _, sub, j = step
            temps.append(kernels.row_shift(
                row_expr(sub, resolve(sub[1]), zeros), int(scalars[j])))
        else:
            _, op, planes_i, sub, j = step
            temps.append(kernels.bsi_compare(
                leaves[planes_i], row_expr(sub, resolve(sub[1]), zeros), op,
                int(scalars[j])))
    return resolve


def filter_row(plan: expr.Plan, leaves: list, scalars, zeros):
    """The words of a row plan, or of an aggregate plan's filter (None
    without one): its steps, then its elementwise root (K2, or the bare
    leaf itself)."""
    if plan.root is None:
        return None
    resolve = materialize(plan, leaves, scalars, zeros)
    return row_expr(plan.root, resolve(plan.root[1]), zeros)


def count_rows_packed(matrix: torch.Tensor, filt) -> torch.Tensor:
    """K8's per-shard counts split-summed over shards on the device: the
    reference's packed int32[2, R]."""
    return split_sum(kernels.count_rows(matrix, filt), dim=0)


def bsi_sum_packed(planes: torch.Tensor, filt) -> torch.Tensor:
    """K6's per-shard counts split-summed over shards on the device: the
    reference's packed int32[2, depth + 1] (plane counts ++ n)."""
    return split_sum(kernels.bsi_sum(planes, filt), dim=0)


def minmax_mask(values, counts, want_max: bool):
    """Per-shard masking for the Min/Max merge: shards with no candidates
    (count 0 — padded slots included) get the opposite-extreme sentinel so
    they lose every comparison. Returns (masked, valid)."""
    valid = counts > 0
    sentinel = INT64_MIN if want_max else INT64_MAX
    return torch.where(valid, values, sentinel), valid


def minmax_at_best(values, counts, valid, best):
    """Split-sum count of the candidates holding the extremum."""
    return split_sum(torch.where(valid & (values == best), counts, 0))


def minmax_finalize(best, n, any_valid):
    """Pack [best, count_lo, count_hi] int64 (count 0 → empty result)."""
    best = torch.where(any_valid, best, 0)
    return torch.cat([best.to(torch.int64).reshape(1), n.to(torch.int64)])


def minmax_merge(values, counts, want_max: bool) -> torch.Tensor:
    """Device-side cross-shard Min/Max merge of K7's per-shard pairs: a
    few tensor ops on [S] values."""
    masked, valid = minmax_mask(values, counts, want_max)
    best = masked.max() if want_max else masked.min()
    n = minmax_at_best(values, counts, valid, best)
    return minmax_finalize(best, n, valid.any())


def run_plan(plan: expr.Plan, reduce_kind: str, leaves: list, scalars,
             zeros) -> torch.Tensor:
    """One query of a planned structure, packed as ``reduce_kind`` packs
    it: steps first, then K1 ('count'), K2 ('row'), K8 ('countrows'), K6
    ('bsisum') or K7 + merge ('min' / 'max')."""
    if reduce_kind in ("count", "row"):
        if plan.kind != reduce_kind:
            raise ValueError(f"a {plan.kind} plan cannot reduce as "
                             f"{reduce_kind!r}")
        resolve = materialize(plan, leaves, scalars, zeros)
        node, operands = plan.root
        tensors = resolve(operands) or [zeros()]
        program = check_kind(node, reduce_kind, tuple(t.dim() - 1
                                                       for t in tensors))
        if reduce_kind == "count":
            return count_flat(program, tensors)
        return kernels.tree_rows(program, tensors)
    want = {"bsisum": "bsisum", "min": "bsiminmax", "max": "bsiminmax",
            "countrows": "countrows"}
    if want.get(reduce_kind) != plan.kind:
        raise ValueError(f"reduce kind {reduce_kind!r} does not fit a "
                         f"{plan.kind} plan")
    if reduce_kind in ("min", "max"):
        values, counts = minmax_parts(plan, leaves, scalars, zeros,
                                      reduce_kind == "max")
        return minmax_merge(values, counts, reduce_kind == "max")
    planes = leaves[plan.planes]
    filt = filter_row(plan, leaves, scalars, zeros)
    if reduce_kind == "countrows":
        return count_rows_packed(planes, filt)
    return bsi_sum_packed(planes, filt)


def minmax_parts(plan: expr.Plan, leaves: list, scalars, zeros,
                 want_max: bool):
    """A Min / Max plan's per-shard (values int64[S], counts int32[S]):
    its filter's steps and row, then K7."""
    return kernels.bsi_minmax(leaves[plan.planes],
                              filter_row(plan, leaves, scalars, zeros),
                              want_max)


def local_fn(structure, reduce_kind: str, leaf_ranks: tuple,
             n_scalars: int = 0):
    """The single-query evaluator for a query shape (the reference's
    ``local_fn`` contract), called as ``fn(*leaves, *scalars)`` with
    stacked leaves: 'count' → int32[2] split sums, 'row' →
    int32[S_padded, words], 'countrows' → int32[2, R], 'bsisum' →
    int32[2, depth + 1], 'min'/'max' → int32[3]."""
    plan = expr.plan(structure)
    n_leaves = len(leaf_ranks)

    def fn(*args):
        leaves = list(args[:n_leaves])
        scalars = [int(x) for x in args[n_leaves:n_leaves + n_scalars]]
        first = leaves[0]
        return run_plan(plan, reduce_kind, leaves, scalars,
                        lambda: torch.zeros((first.shape[0], first.shape[-1]),
                                            dtype=torch.int32,
                                            device=first.device))

    return fn


# ------------------------------------------------------------ GroupBy level


def groupby_level_packed(dims: list, idxs, filt, planes) -> torch.Tensor:
    """One GroupBy level through K9, split-summed over shards on the
    device into the reference's packed layout: counts [2·C], then with
    planes n_g [2·C] and plane counts [2·depth·C] (each a [2, ...] split
    sum, raveled)."""
    return pack_groupby_level(split_sum(
        kernels.groupby_level(dims, idxs, filt, planes), dim=0),
        planes is not None)


def pack_groupby_level(out: torch.Tensor, has_planes: bool) -> torch.Tensor:
    """A level's split sums int32[2, K, C] in the packed layout of
    ``groupby_level_packed``."""
    if not has_planes:
        return out[:, 0].reshape(-1)
    return torch.cat([out[:, 0].reshape(-1), out[:, 1].reshape(-1),
                      out[:, 2:].reshape(-1)])


def local_groupby_level_fn(filt_structure, n_filt: int, n_scalars: int,
                           n_gather: int, has_agg: bool):
    """The reference's single-device GroupBy level contract: called as
    ``fn(*filt_leaves, *dim_matrices, [planes], *idx_arrays, *scalars)``
    with dimension matrices int32[S, n_i, W], planes int32[S, 2 + depth,
    W] and one host int32[C] candidate index array per dimension; returns
    the packed level (``groupby_level_packed``). The filter structure, a
    row structure over the filter leaves, runs first (its steps, then
    K2)."""
    plan = expr.plan(filt_structure) if filt_structure is not None else None
    n_leaves = n_filt + n_gather + (1 if has_agg else 0)

    def fn(*args):
        leaves = list(args[:n_leaves])
        idxs = args[n_leaves:n_leaves + n_gather]
        scalars = [int(x) for x in args[n_leaves + n_gather:
                                        n_leaves + n_gather + n_scalars]]
        dims = leaves[n_filt:n_filt + n_gather]
        planes = leaves[n_filt + n_gather] if has_agg else None
        first = dims[0]

        def zeros():
            return torch.zeros((first.shape[0], first.shape[-1]),
                               dtype=torch.int32, device=first.device)

        filt = (filter_row(plan, leaves[:n_filt], scalars, zeros)
                if plan is not None else None)
        return groupby_level_packed(dims, idxs, filt, planes)

    return fn
