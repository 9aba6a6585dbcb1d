"""Distributed executor: every launch of a query runs over the mesh's
members, and their partials reduce through the mesh lanes.

The port's copy of ``pilosa_tpu.parallel.dist``. The reference runs a
query as one ``shard_map`` program: each device evaluates the fused body
over its block of shard slots, then ``psum`` / ``pmax`` over the mesh
reduce the partials (``_dist_body``, and its micro-batched and GroupBy
forms ``_dist_fn_batched`` and ``_dist_groupby_level_fn``). The port
keeps the reference's single controller: one process drives a grid of
members (``parallel/mesh.py``), each a ``torch.device``.

- **The per-member body.** Each member runs the existing kernel of the
  reduce kind over its slot range (K1 counts, K2 rows, K5-K9), on a view
  of the resident stacked leaf when its device holds the leaf (no copy;
  a member on another device takes a copy of its slots). A plan's steps
  (shift, BSI comparison, K2 'tree' steps) run per member too, except in
  a micro-batched Count and in a TopN or GroupBy filter, whose row is
  launched once over the whole leaf on the holder's device before the
  members read their views of it: the same words in one process.
- **The reduce.** One K12+K13 launch a reduction reads the members'
  partials in place (no stack, no copy): on a flat mesh the exact int32
  sum of their split channels, on a 2-D mesh the intra-group sum cast
  into the narrow inter-group lane and the receivers' fold, as
  ``_dist_body`` does. Min / Max: the best over the members (one
  launch), the valid flag (one), then the count at the best value
  reduced like any split channel (one). TopN's quantized ranking pass
  and GroupBy's quantized pruning levels cross the 8-bit lane, one
  K14+K15 launch that reads the partials in place too (a GroupBy
  level's [2, k, c] as [2, k*c] views). ``row`` stays per slot: the
  members' words are gathered into one [padded, W] result, which a
  hierarchical mesh reads back through roaring block frames
  (``_row_host``).
- **The gather between members.** On one card each member's partial is
  read where its kernel wrote it, and the narrow and 8-bit lanes live
  in the reducing kernel's registers. A member on another device is
  first copied to the lead member's; between cards that would be a peer
  copy (``Tensor.copy_``), which a one-card machine cannot run.
- **Writes** patch the one resident leaf through K3 as on one device; a
  member's view sees the patch.
- **Accounting.** ``_note_reduce`` records, per reduction, the
  reference's dense-equivalent and actual lane bytes from the packed
  result's shape (``global_reduce_stats()`` and the cost plane's
  ``reduceBytes``); micro-batches note the reference's power-of-two
  batch shape. Sum, Min, Max and TopN chunks launch per query here,
  where the reference's ``submit`` micro-batches them, so their notes
  match the reference's through ``execute``. A GroupBy level chunks by
  K9's output budget, where the reference chunks by its mask budget: the
  two agree wherever the reference makes one chunk a level.
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.executor import batch
from pilosa_tpu_torch.executor.executor import Executor
from pilosa_tpu_torch.parallel import reduction
from pilosa_tpu_torch.parallel.mesh import (
    ShardAssignment,
    make_mesh,
    mesh_groups,
    visible_devices,
)
from pilosa_tpu_torch.shardwidth import next_pow2
from pilosa_tpu_torch.utils.cost import current_cost


class DistExecutor(Executor):
    """Executor whose launches run over a mesh's members.

    ``mesh`` defaults to ``make_mesh(groups=groups)`` over the visible
    CUDA devices (the holder's device when it is the CPU). A 2-D
    ``groups x shards`` mesh engages the hierarchical reduction plane:
    identical results, the cross-group traffic narrowed, row gathers as
    roaring frames, and per-reduction dense-against-actual bytes
    recorded. ``quantized_ranking`` (the topn-quantized-ranking knob)
    ranks TopN candidates and gates GroupBy pruning over the 8-bit lane,
    with an exact recount of what the error bound cannot exclude, so
    results stay byte-identical; on a flat mesh the lane is a lossless
    pass-through. ``verify_quantized`` also runs the lossless ranking per
    TopN and raises when the two differ (a certification mode, not for
    serving)."""

    def __init__(self, holder, mesh=None, groups: int | None = None,
                 quantized_ranking: bool = False,
                 verify_quantized: bool = False):
        super().__init__(holder, device=holder.device)
        if mesh is None:
            devices = (visible_devices() if holder.device.type == "cuda"
                       else [holder.device])
            mesh = make_mesh(devices=devices, groups=groups)
        self.mesh = mesh
        self.arg_shard_factor = mesh.size
        self._hier = mesh_groups(mesh)
        self._lead = mesh.members[0]
        self.quantized_ranking = bool(quantized_ranking)
        self.verify_quantized = bool(verify_quantized)

    def _quant_ranking_active(self) -> bool:
        return self.quantized_ranking

    def _make_block(self, shard_list):
        return ShardAssignment(shard_list, self.mesh)

    # ------------------------------------------------------------ members

    def _meshed(self, block) -> bool:
        """A launch over ``block`` runs on the members: the block is this
        mesh's (IncludesColumn's one-shard block runs on one device)."""
        return isinstance(block, ShardAssignment) and block.mesh is self.mesh

    def _pieces(self, padded: int):
        """Per member: a function taking a stacked tensor to the member's
        slots, a view where the member's device holds it."""
        per = padded // self.mesh.size

        def piece_of(m: int, dev):
            def piece(t):
                if t is None:
                    return None
                part = t[m * per:(m + 1) * per]
                return part if part.device == dev else part.to(dev)
            return piece

        return [piece_of(m, dev) for m, dev in enumerate(self.mesh.members)]

    def _members(self, parts: list) -> list:
        """The members' partials on the lead member's device: each where
        it lies when it lies there (one card), else a copy."""
        lead = self._lead
        return [p if p.device == lead else p.to(lead) for p in parts]

    def _reduce_split(self, parts, padded: int) -> torch.Tensor:
        """Split-sum partials (a list of the members' int32[2, N] or [2],
        or int32[M, 2, N]) → the mesh's exact int32[2, N]: the flat sum,
        or the hierarchical lanes."""
        if self._hier is None:
            return reduction.flat_split_sum(parts)
        g = self._hier[0]
        return reduction.hier_split_channels(parts, g, max(padded // g, 1))

    def _groups(self) -> int | None:
        return self._hier[0] if self._hier is not None else None

    # ------------------------------------------------------ launch hooks

    def _launch_plan(self, plan, reduce_kind: str, leaves: list, scalars,
                     zeros, block) -> torch.Tensor:
        if not self._meshed(block):
            return super()._launch_plan(plan, reduce_kind, leaves, scalars,
                                        zeros, block)
        pieces = self._pieces(block.padded)
        if reduce_kind in ("min", "max"):
            return self._minmax(plan, reduce_kind, leaves, scalars, zeros,
                                block, pieces)
        parts = []
        for piece in pieces:
            parts.append(batch.run_plan(
                plan, reduce_kind, [piece(l) for l in leaves], scalars,
                lambda piece=piece: piece(zeros())))
        if reduce_kind == "row":
            return torch.cat([p.to(self._lead) for p in parts])
        shape = parts[0].shape
        out = self._reduce_split(self._members(parts),
                                 block.padded).reshape(shape)
        self._note_reduce(reduce_kind, tuple(out.shape), block.padded)
        return out

    def _minmax(self, plan, reduce_kind: str, leaves: list, scalars, zeros,
                block, pieces) -> torch.Tensor:
        """Min / Max over the members: each member's K7 pairs and its best,
        the best over the members, then the count at it."""
        want_max = reduce_kind == "max"
        members, bests, anys = [], [], []
        for piece in pieces:
            values, counts = batch.minmax_parts(
                plan, [piece(l) for l in leaves], scalars,
                lambda piece=piece: piece(zeros()), want_max)
            masked, valid = batch.minmax_mask(values, counts, want_max)
            bests.append(masked.max() if want_max else masked.min())
            anys.append(valid.any().to(torch.int32))
            members.append((values, counts, valid))
        groups = self._groups()
        # the group best is exact (no bound: a sentinel is negative); the
        # valid flag is 0/1 and crosses as uint8
        best = reduction.gather_extreme(self._members(bests), groups,
                                        want_max)[0]
        any_valid = reduction.gather_extreme(
            self._members(anys), groups, True, bound=1)[0] > 0
        ns = [batch.minmax_at_best(v, c, ok, best.to(v.device))
              for v, c, ok in members]
        n = self._reduce_split(self._members(ns), block.padded).reshape(2)
        out = batch.minmax_finalize(best, n, any_valid)
        self._note_reduce(reduce_kind, tuple(out.shape), block.padded)
        return out

    def _launch_batched(self, node, reduce_kind: str, leaf_ranks: tuple,
                        rows: list) -> torch.Tensor:
        """The micro-batch (the reference's ``_dist_fn_batched``): one K1
        launch a member over the batch's slices, the [B, 2] partials
        reduced as split channels [2, B] (their transposed views)."""
        padded = rows[0][0].shape[0]
        if padded % self.mesh.size:
            return super()._launch_batched(node, reduce_kind, leaf_ranks,
                                           rows)
        program = batch.check_kind(node, reduce_kind, leaf_ranks)
        parts = []
        for piece in self._pieces(padded):
            parts.append(batch.count_flat_batched(
                program, [[piece(l) for l in leaves] for leaves in rows]))
        out = self._reduce_split([p.t() for p in self._members(parts)],
                                 padded).t()
        # the reference pads a batch to a power of two
        self._note_reduce(reduce_kind,
                          (min(self.MICROBATCH_MAX, next_pow2(len(rows))), 2),
                          padded)
        return out

    def _launch_countrows(self, matrix: torch.Tensor, filt, block,
                          quantized: bool = False) -> torch.Tensor:
        if not self._meshed(block):
            return super()._launch_countrows(matrix, filt, block, quantized)
        parts = [batch.count_rows_packed(piece(matrix), piece(filt))
                 for piece in self._pieces(block.padded)]
        if quantized:
            out = reduction.hier_quantized_counts(self._members(parts),
                                                  self._groups())
            self._note_reduce("countrows_q", tuple(out.shape), block.padded)
            return out
        out = self._reduce_split(self._members(parts), block.padded)
        self._note_reduce("countrows", tuple(out.shape), block.padded)
        return out

    def _launch_groupby_level(self, block, mats: list, idxs, filt, planes,
                              quantized: bool = False,
                              padded: int = 0) -> torch.Tensor:
        """A level chunk (the reference's ``_dist_groupby_level_fn``): K9 a
        member, the split sums reduced; a ``quantized`` (pruning) level's
        counts cross the 8-bit lane."""
        if not self._meshed(block):
            return super()._launch_groupby_level(block, mats, idxs, filt,
                                                 planes, quantized, padded)
        from pilosa_tpu_torch import kernels

        parts = [batch.split_sum(kernels.groupby_level(
            [piece(d) for d in mats], idxs, piece(filt), piece(planes)),
            dim=0) for piece in self._pieces(block.padded)]
        _, k, c = parts[0].shape
        padded = padded or next_pow2(c)
        if quantized:
            if planes is not None:
                raise AssertionError("quantized GroupBy levels never carry "
                                     "aggregates (the last level is "
                                     "lossless)")
            out = reduction.hier_quantized_counts(
                [p.reshape(2, k * c) for p in self._members(parts)],
                self._groups()).reshape(-1)
            self._note_reduce(
                "groupby_q", (2 * reduction.quant_total_elems(padded),),
                block.padded)
            return out
        out = batch.pack_groupby_level(
            self._reduce_split([p.reshape(2, k * c)
                                for p in self._members(parts)],
                               block.padded).reshape(2, k, c),
            planes is not None)
        self._note_reduce("groupby", (2 * padded * k,), block.padded)
        return out

    # ------------------------------------------- wire-byte accounting

    def _note_reduce(self, reduce_kind: str, out_shape: tuple,
                     padded: int) -> None:
        """Per-reduction lane bytes, from static shapes only (the
        reference's model): dense-equivalent = a flat int32 ring
        all-reduce over the whole mesh; actual = the narrow inter-group
        hop (equal to dense on a flat mesh); intra = the per-group dense
        traffic, apart."""
        if reduce_kind == "row":
            return  # row gathers are accounted in _row_host
        elems = 1
        for d in out_shape:
            elems *= int(d)
        quantized = 0
        if reduce_kind in ("countrows_q", "groupby_q"):
            # [2, R + n_blocks] (groupby: raveled, one chunk): recover R
            # and model the 8-bit hop against its lossless equivalent
            width = (elems // 2 if reduce_kind == "groupby_q"
                     else int(out_shape[-1]))
            mult = max(elems // (2 * width), 1)
            n_rows = reduction.quant_real_elems(width)
            dense = reduction.dense_reduce_bytes(
                self.mesh.size, 2 * n_rows * mult)
            if self._hier is None:
                actual, intra, lossless = dense, 0, dense
            else:
                g, spg = self._hier
                actual, intra, lossless = reduction.quant_hier_bytes(
                    n_rows, g, spg, max(padded // g, 1))
                actual, intra, lossless = (actual * mult, intra * mult,
                                           lossless * mult)
            reduction.global_reduce_stats().note_quant_reduce(actual,
                                                              lossless)
            quantized = actual
        else:
            dense = reduction.dense_reduce_bytes(self.mesh.size, elems)
            if self._hier is None:
                actual, intra = dense, 0
            else:
                g, spg = self._hier
                actual, intra = reduction.hier_reduce_bytes(
                    reduce_kind, elems, g, spg, max(padded // g, 1))
        reduction.global_reduce_stats().note_reduce(
            dense, actual, intra, self._hier is not None)
        cost = current_cost()
        if cost is not None:
            cost.note_reduce(dense, actual, quantized=quantized)

    def _row_host(self, stacked: torch.Tensor, block) -> np.ndarray:
        """Row-gather readback. On a hierarchical mesh the dense
        [padded, words] result crosses as per-slot roaring payloads in
        block frames, and the result is decoded from those frames."""
        host = stacked.cpu().numpy()
        if self._hier is None or not self._meshed(block):
            return host
        frames, actual = reduction.encode_row_frames(host.view(np.uint32))
        reduction.global_reduce_stats().note_row_gather(host.nbytes, actual)
        cost = current_cost()
        if cost is not None:
            cost.note_reduce(host.nbytes, actual)
        return reduction.decode_row_frames(frames, host.shape)
