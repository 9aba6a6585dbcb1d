"""The mesh lanes' plain versions (K12+K13, K14+K15) against the
reference's reduction functions, on the CPU.

The reference's ``hier_split_channels``, ``gather_extreme`` and
``hier_quantized_counts`` run under its own ``shard_map`` on
``make_mesh(8, groups=g)`` (conftest's 8 forced CPU devices; one group
of 8 as a 1 x 8 grid), after the intra-group ``psum`` / ``pmax`` that
``_dist_body`` runs before them; the port's functions take the same 8
members' partials stacked, and ``lane_reduce`` and ``quant_reduce`` also
take them as a list of member tensors in each layout the executor gives
them ([2, N], [B, 2] as its transposed view, a GroupBy level's [2, k, c]
as [2, k*c], [2], 0-d, strided views). Inputs are seeded numpy integers
with group totals at the lane bounds (255 and 256, 65 535 and 65 536),
candidate counts that are not a multiple of 256, all-small blocks (scale
1), wrapped (negative) totals and sums that wrap. Tolerance 0
throughout. The host side (the lane widths, the byte model, the
quantized window, the row frames) is compared function for function.
"""

import numpy as np
import pytest
import torch

import jax
from jax import lax
from jax.sharding import Mesh

from pilosa_tpu.parallel import dist as jdist
from pilosa_tpu.parallel import reduction as jred
from pilosa_tpu.parallel.mesh import GROUPS_AXIS, SHARDS_AXIS
from pilosa_tpu.parallel.mesh import make_mesh as j_make_mesh
from pilosa_tpu.parallel.mesh import shards_spec
from pilosa_tpu_torch import kernels
from pilosa_tpu_torch.parallel import reduction
from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD

torch.set_num_threads(1)

MEMBERS = 8


def _run_mesh(groups, body, *arrays):
    """``body`` under the reference's shard_map, one member's rows a
    device; returns member 0's (replicated) result. ``groups`` 1 is a
    1 x 8 grid (make_mesh gives the flat mesh for it)."""
    mesh = j_make_mesh(MEMBERS, groups=groups) if groups != 1 else Mesh(
        np.asarray(jax.devices()[:MEMBERS]).reshape(1, MEMBERS),
        (GROUPS_AXIS, SHARDS_AXIS))
    hier = (groups, MEMBERS // groups) if groups else None
    spec = shards_spec(mesh)
    fn = jax.jit(jdist._smap(lambda *a: body(*[x[0] for x in a])[None],
                             mesh, tuple(spec for _ in arrays), spec, hier))
    return np.asarray(fn(*arrays))[0]


def _parts(rng, n: int, lo_total: int, hi_total: int) -> np.ndarray:
    """int32[8, 2, n] member split channels whose every group sum stays
    within (lo_total, hi_total), column 0 of group 0 exactly at them."""
    out = np.zeros((MEMBERS, 2, n), np.int32)
    out[:, 0] = rng.integers(0, lo_total // MEMBERS + 1, (MEMBERS, n))
    out[:, 1] = rng.integers(0, hi_total // MEMBERS + 1, (MEMBERS, n))
    out[:, 0, 0] = 0
    out[:, 1, 0] = 0
    out[0, 0, 0], out[0, 1, 0] = lo_total, hi_total
    return out


# (groups, group_slots): the lo lane uint16 or int32, the hi lane uint8 or
# uint16, by the slots' static bounds
SPLIT_CASES = [(2, 1), (2, 2), (4, 8), (2, 7), (4, 3)]


@pytest.mark.parametrize("groups,group_slots", SPLIT_CASES)
def test_hier_split_channels_matches_reference(groups, group_slots):
    lo_b, hi_b = reduction.split_channel_bounds(group_slots)
    assert (lo_b, hi_b) == jred.split_channel_bounds(group_slots)
    rng = np.random.default_rng(group_slots * 10 + groups)
    parts = _parts(rng, 37, lo_b, hi_b)
    want = _run_mesh(groups, lambda p: jred.hier_split_channels(
        lax.psum(p, SHARDS_AXIS), GROUPS_AXIS, group_slots), parts)
    got = reduction.hier_split_channels(torch.from_numpy(parts), groups,
                                        group_slots)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    lanes = kernels.lane_pack_plain(torch.from_numpy(parts), groups,
                                    (reduction.lane_dtype_bytes(lo_b),
                                     reduction.lane_dtype_bytes(hi_b)))
    assert lanes[0].dtype == reduction.lane_dtype(lo_b)
    assert lanes[1].dtype == reduction.lane_dtype(hi_b)
    assert [np.dtype(str(l.dtype).split(".")[1]) for l in lanes] == [
        np.dtype(jred.lane_dtype(lo_b)), np.dtype(jred.lane_dtype(hi_b))]


def test_flat_mesh_sum_matches_reference_psum():
    rng = np.random.default_rng(4)
    parts = _parts(rng, 65, 1 << 20, 1 << 20)
    want = _run_mesh(None, lambda p: lax.psum(p, SHARDS_AXIS), parts)
    got = reduction.flat_split_sum(torch.from_numpy(parts))
    assert np.array_equal(got.numpy(), want)


# (want_max, bound, the largest value): the valid flag's 0/1, lanes at
# 255/256 and 65 535/65 536, and the exact int32 lane (no bound)
EXTREME_CASES = [(True, 1, 1), (True, 255, 255), (False, 256, 256),
                 (True, 65535, 65535), (False, 65536, 65536),
                 (True, None, 1 << 30), (False, None, 1 << 30)]


@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("want_max,bound,top", EXTREME_CASES)
def test_gather_extreme_matches_reference(groups, want_max, bound, top):
    rng = np.random.default_rng(top % 1000 + groups)
    low = 0 if bound is not None else -top
    vals = rng.integers(low, top + 1, (MEMBERS, 5)).astype(np.int32)
    vals[3, 2] = top
    vals[6, 4] = low

    def body(v):
        best = (lax.pmax if want_max else lax.pmin)(v, SHARDS_AXIS)
        return jred.gather_extreme(best, GROUPS_AXIS, want_max, bound=bound)

    want = _run_mesh(groups, body, vals)
    got = reduction.gather_extreme(torch.from_numpy(vals), groups, want_max,
                                   bound=bound)
    assert np.array_equal(got.numpy(), want)
    flat = reduction.gather_extreme(torch.from_numpy(vals), None, want_max)
    assert np.array_equal(flat.numpy(), (vals.max(0) if want_max
                                         else vals.min(0)))


def test_gather_extreme_keeps_int64_best():
    """The port's Min/Max bests are int64 (K7 to depth 63): no lane
    narrows them."""
    vals = torch.tensor([[1 << 40], [-(1 << 50)], [7], [3]],
                        dtype=torch.int64).repeat(2, 1)
    assert reduction.gather_extreme(vals, 4, True).tolist() == [1 << 40]
    assert reduction.gather_extreme(vals, 2, False).tolist() == [-(1 << 50)]


def _quant_parts(rng, rows: int) -> np.ndarray:
    """Split channels of member totals: block 0 all-small (every group's
    sums <= 120: scale 1), block 1's group maximum exactly 255 (scale 1),
    block 2's exactly 256 (scale 2), the rest far past 255."""
    totals = rng.integers(0, 1 << 19, (MEMBERS, rows))
    totals[:, :256] = rng.integers(0, 16, (MEMBERS, min(rows, 256)))
    if rows > 512:
        totals[:, 256:512] = 0
        totals[0, 300] = 255
    if rows > 768:
        totals[:, 512:768] = 0
        totals[0, 700] = 256
    return np.stack([totals & reduction.SPLIT_MASK,
                     totals >> reduction.SPLIT_SHIFT], 1).astype(np.int32)


def _quant_layouts(parts: np.ndarray) -> dict:
    """The same int32[M, 2, R] partials as quant_reduce takes them:
    stacked, a list of members, strided views of a wider buffer (stacked
    and as members) and GroupBy's [2, k, c] member partials viewed as
    [2, k*c], contiguous and strided."""
    t = torch.from_numpy(parts)
    m, _, rows = parts.shape
    k = 2 if rows % 2 == 0 else 1
    wide = torch.zeros((m, 2, 3 * rows), dtype=torch.int32)
    wide[:, :, ::3] = t
    cube = torch.zeros((m, 2, k, 2 * (rows // k)), dtype=torch.int32)
    cube[..., ::2] = t.reshape(m, 2, k, rows // k)
    return {
        "stacked": t,
        "members": [t[j].clone() for j in range(m)],
        "stacked_strided": wide[:, :, ::3],
        "members_strided": [wide[j, :, ::3] for j in range(m)],
        "groupby": [t[j].reshape(2, k, rows // k).clone().reshape(2, rows)
                    for j in range(m)],
        "groupby_strided": [cube[j, ..., ::2].reshape(2, rows)
                            for j in range(m)],
    }


def _check_quant_layouts(parts: np.ndarray, groups, want) -> None:
    """quant_reduce, and hier_quantized_counts through it, from every
    layout of ``parts`` against ``want``, bit-exact, dtype too; the plain
    version is the composition of its two halves."""
    rows = parts.shape[2]
    assert want.shape == (2, reduction.quant_total_elems(rows))
    for name, layout in _quant_layouts(parts).items():
        got = kernels.quant_reduce(layout, groups)
        assert got.dtype == torch.int32, name
        assert np.array_equal(got.numpy(), want), name
        via = reduction.hier_quantized_counts(layout, groups)
        assert np.array_equal(via.numpy(), want), name
    if groups is not None:
        halves = kernels.quant_fold_plain(*kernels.quant_pack_plain(
            torch.from_numpy(parts), groups), rows)
        assert np.array_equal(halves.numpy(), want)


def _reference_quantized(parts: np.ndarray, groups):
    return _run_mesh(groups, lambda p: jred.hier_quantized_counts(
        lax.psum(p, SHARDS_AXIS), GROUPS_AXIS if groups else None), parts)


@pytest.mark.parametrize("groups", [None, 2, 4])
@pytest.mark.parametrize("rows", [1, 255, 256, 300, 1000])
def test_hier_quantized_counts_matches_reference(groups, rows):
    rng = np.random.default_rng(rows + (groups or 0))
    parts = _quant_parts(rng, rows)
    want = _reference_quantized(parts, groups)
    got = reduction.hier_quantized_counts(torch.from_numpy(parts), groups)
    assert got.shape == (2, reduction.quant_total_elems(rows))
    assert np.array_equal(got.numpy(), want)
    _check_quant_layouts(parts, groups, want)
    if groups:
        q, s = kernels.quant_pack_plain(torch.from_numpy(parts), groups)
        assert q.dtype == torch.uint8 and s.dtype == torch.int32
        assert int(s[:, 0].max()) == 1  # the all-small first block
        if rows > 768:
            assert int(s[:, 1].max()) == 1  # a block max of 255
            assert int(s[:, 2].max()) == 2  # a block max of 256


def _quant_edge(kind: str, rng) -> tuple:
    """(int32[8, 2, R] member split channels, groups) of one edge of the
    8-bit lane's int32 arithmetic."""
    rows = 300  # the last block partly padded (44 real candidates)
    totals = rng.integers(0, 1 << 19, (MEMBERS, rows)).astype(np.int64)
    groups = 2
    if kind == "wrapped_last_block":
        # every real group total of the last block past 2^31 (4 members
        # a group): negative as int32, so the block's max is a pad
        # lane's 0 and its scale 1
        totals[:, 256:] = rng.integers((1 << 29) + 1, 1 << 30,
                                       (MEMBERS, rows - 256))
    elif kind == "negative_numerator":
        # one wrapped (negative) group total beside large ones: a
        # negative numerator under a scale > 1 (floor division)
        totals[:, 7] = rng.integers((1 << 29) + 1, 1 << 30, MEMBERS)
    elif kind == "sums_wrap":
        # every member near 2^31: the group sums wrap modulo 2^32
        totals = rng.integers((1 << 31) - (1 << 20), 1 << 31,
                              (MEMBERS, rows))
    elif kind == "groups_are_members":
        groups = MEMBERS
    elif kind == "one_group":
        groups = 1
    else:
        raise AssertionError(kind)
    totals &= 0xFFFFFFFF
    lo = totals & reduction.SPLIT_MASK
    hi = totals >> reduction.SPLIT_SHIFT
    return np.stack([lo, hi], 1).astype(np.uint32).view(np.int32), groups


@pytest.mark.parametrize("kind", ["wrapped_last_block", "negative_numerator",
                                  "sums_wrap", "groups_are_members",
                                  "one_group"])
def test_quant_reduce_edges_match_reference(kind):
    """Wrapped totals (the last, partly padded block all negative: scale
    1 from the pad lanes), a negative numerator under a scale > 1, group
    sums that wrap, G = M and one quantized group of all 8 members, from
    every member layout."""
    parts, groups = _quant_edge(kind, np.random.default_rng(len(kind)))
    want = _reference_quantized(parts, groups)
    _check_quant_layouts(parts, groups, want)
    _, s = kernels.quant_pack_plain(torch.from_numpy(parts), groups)
    if kind == "wrapped_last_block":
        assert int(s[:, 1].max()) == 1
    if kind == "negative_numerator":
        assert int(s[:, 0].min()) > 1


@pytest.mark.parametrize("groups", [8, 4])
def test_quant_reduce_takes_64_members(groups):
    """The cap itself: 64 members against the reference on 8 devices,
    each device one eighth of the members' wrapped int32 sum (the
    intra-group psum is associative, so the groups' totals agree)."""
    rng = np.random.default_rng(64 + groups)
    totals = rng.integers(0, 1 << 16, (64, 2, 700))
    totals[:, :, :256] %= 2  # an all-small block: scale 1
    parts = totals.astype(np.int32)
    per_device = parts.reshape(MEMBERS, 8, 2, 700).sum(
        1, dtype=np.int64).astype(np.uint32).view(np.int32)
    want = _reference_quantized(per_device, groups)
    for layout in (torch.from_numpy(parts),
                   [torch.from_numpy(p) for p in parts]):
        got = kernels.quant_reduce(layout, groups)
        assert np.array_equal(got.numpy(), want)
    assert np.array_equal(kernels.quant_reduce_plain(
        torch.from_numpy(parts), groups).numpy(), want)


def test_quant_window_and_error_bound_properties():
    """The decoded counts stay within the transmitted bound of the exact
    totals, the window is the reference's and a superset of the exact
    top n, and the host decode is the reference's."""
    rng = np.random.default_rng(5)
    for _ in range(12):
        rows = int(rng.integers(1, 700))
        groups = int(rng.choice([2, 4]))
        parts = _quant_parts(rng, rows)
        packed = reduction.hier_quantized_counts(torch.from_numpy(parts),
                                                 groups).numpy()
        merged = (packed[1].astype(np.int64) << 15) + packed[0]
        approx, err = reduction.split_quantized(merged, rows)
        japprox, jerr = jred.split_quantized(merged, rows)
        assert np.array_equal(approx, japprox) and np.array_equal(err, jerr)
        exact = (parts[:, 0].astype(np.int64)
                 + (parts[:, 1].astype(np.int64) << 15)).sum(0)
        assert np.all(np.abs(approx - exact) <= err)
        for n in (0, 1, 5, rows, rows + 3):
            widx = reduction.quant_topn_window(approx, err, n)
            assert np.array_equal(widx, jred.quant_topn_window(approx, err,
                                                               n))
            top = sorted(range(rows), key=lambda r: (-exact[r], r))[:n]
            assert set(top) <= set(widx.tolist())


def test_byte_model_and_lane_widths_match_reference():
    for bound in (0, 1, 255, 256, 65535, 65536, 1 << 30):
        assert reduction.lane_dtype_bytes(bound) == jred.lane_dtype_bytes(
            bound)
    for total in range(1, 1200, 7):
        assert reduction.quant_real_elems(total) == jred.quant_real_elems(
            total)
        assert reduction.quant_blocks(total) == jred.quant_blocks(total)
        assert reduction.quant_payload_bytes(total) == \
            jred.quant_payload_bytes(total)
    for kind in ("count", "countrows", "bsisum", "min", "max", "groupby"):
        for elems in (2, 3, 6, 48, 514):
            for g, spg, slots in ((2, 4, 8), (4, 2, 1), (2, 1, 1024)):
                assert reduction.hier_reduce_bytes(kind, elems, g, spg,
                                                   slots) == \
                    jred.hier_reduce_bytes(kind, elems, g, spg, slots)
                assert reduction.dense_reduce_bytes(g * spg, elems) == \
                    jred.dense_reduce_bytes(g * spg, elems)
    for rows in (1, 256, 257, 4096):
        assert reduction.quant_hier_bytes(rows, 4, 2, 16) == \
            jred.quant_hier_bytes(rows, 4, 2, 16)


def test_row_frames_match_reference_bytes():
    rng = np.random.default_rng(3)
    host = np.zeros((5, WORDS_PER_SHARD), np.uint32)
    host[1, rng.integers(0, WORDS_PER_SHARD, 300)] = 0x80000001
    host[2, :7] = 0xFFFFFFFF  # a run container
    host[3] = rng.integers(0, 1 << 32, WORDS_PER_SHARD, dtype=np.uint32)
    frames, nbytes = reduction.encode_row_frames(host)
    jframes, jbytes = jred.encode_row_frames(host)
    assert frames == jframes and nbytes == jbytes < host.nbytes
    assert np.array_equal(reduction.decode_row_frames(frames, host.shape),
                          host)


def test_reduce_stats_snapshot_keys_match_reference():
    stats = reduction.ReduceStats()
    stats.note_reduce(10, 4, 2, True)
    stats.note_quant_reduce(3, 9)
    stats.note_quant_window(2, 7)
    stats.note_row_gather(100, 10)
    jstats = jred.ReduceStats()
    jstats.note_reduce(10, 4, 2, True)
    jstats.note_quant_reduce(3, 9)
    jstats.note_quant_window(2, 7)
    jstats.note_row_gather(100, 10)
    assert stats.snapshot() == jstats.snapshot()
    stats.reset()
    jstats.reset()
    assert stats.snapshot() == jstats.snapshot()


def test_lane_wrappers_check_their_arguments():
    parts = torch.zeros((8, 2, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.lane_reduce(parts, 3, (1, 1))  # 3 groups over 8 members
    with pytest.raises(ValueError):
        kernels.lane_reduce(parts, 2, (8, 1))  # no int64 split lane
    with pytest.raises(TypeError):
        kernels.lane_reduce(parts.to(torch.int64), 2, (4, 4))
    with pytest.raises(ValueError):
        kernels.lane_reduce(parts, 2, 4, "median")
    with pytest.raises(TypeError):
        kernels.lane_reduce(torch.zeros((2, 3), dtype=torch.int16), 1, 2,
                            "max")
    with pytest.raises(ValueError):
        kernels.quant_reduce(parts, 3)  # 3 groups over 8 members
    with pytest.raises(TypeError):
        kernels.quant_reduce(parts.to(torch.int64), 2)
    with pytest.raises(ValueError):
        kernels.quant_reduce(parts[:, :1], 2)  # one channel
    with pytest.raises(ValueError):
        kernels.quant_reduce(list(parts[:7]) + [parts[7].t().contiguous()
                                                .t()], None)
    lo, hi = kernels.lane_pack_plain(parts, 2, (2, 1))
    assert (lo.dtype, hi.dtype, lo.shape) == (torch.uint16, torch.uint8,
                                              (2, 3))


# ------------------------------------------ K12+K13 over member layouts


def _member_layouts(parts: np.ndarray) -> dict:
    """The same int32[8, 2, n] partials as lane_reduce takes them: the
    executor's member lists ([2, n] each; [n, 2] each as its transposed
    view, as a micro-batch's [B, 2]), the stacked tensor, and strided
    views of a wider buffer, stacked and as members."""
    t = torch.from_numpy(parts)
    wide = torch.zeros((MEMBERS, 2, 3 * parts.shape[2]), dtype=torch.int32)
    wide[:, :, ::3] = t
    strided = wide[:, :, ::3]
    return {
        "members": [t[m].clone() for m in range(MEMBERS)],
        "members_b2": [t[m].t().contiguous().t() for m in range(MEMBERS)],
        "stacked": t,
        "stacked_strided": strided,
        "members_strided": [strided[m] for m in range(MEMBERS)],
    }


# (groups or None: flat, group_slots, the lo and hi group totals): the
# lanes at their bounds (255, 65 535), past them (the cast wraps as
# astype does), and int32 group sums that wrap
LANE_REDUCE_CASES = [
    (2, 2, 65535, 255),
    (4, 1, 70000, 300),
    (2, 8, (1 << 31) + 5, 65536),
    (None, 1, (1 << 31) + 9, 70000),
]


@pytest.mark.parametrize("groups,group_slots,lo_total,hi_total",
                         LANE_REDUCE_CASES)
def test_lane_reduce_layouts_match_reference(groups, group_slots, lo_total,
                                             hi_total):
    rng = np.random.default_rng(lo_total % 997 + group_slots)
    n = 300  # past one block of 256 threads, not a multiple of it
    parts = np.zeros((MEMBERS, 2, n), np.int64)
    parts[:, 0] = rng.integers(0, lo_total // MEMBERS + 1, (MEMBERS, n))
    parts[:, 1] = rng.integers(0, hi_total // MEMBERS + 1, (MEMBERS, n))
    parts[:, 0, 0] = lo_total // MEMBERS
    parts[:, 1, 0] = hi_total // MEMBERS
    parts[0, 0, 0] += lo_total % MEMBERS
    parts[0, 1, 0] += hi_total % MEMBERS
    parts = parts.astype(np.uint32).view(np.int32)  # int32 bit patterns
    if groups is None:
        want = _run_mesh(None, lambda p: lax.psum(p, SHARDS_AXIS), parts)
        widths = (4, 4)
    else:
        want = _run_mesh(groups, lambda p: jred.hier_split_channels(
            lax.psum(p, SHARDS_AXIS), GROUPS_AXIS, group_slots), parts)
        widths = tuple(reduction.lane_dtype_bytes(b) for b in
                       reduction.split_channel_bounds(group_slots))
    for name, layout in _member_layouts(parts).items():
        got = kernels.lane_reduce(layout, groups or 1, widths)
        assert got.dtype == torch.int32 and got.shape == (2, n), name
        assert np.array_equal(got.numpy(), want), name
        via = (reduction.flat_split_sum(layout) if groups is None else
               reduction.hier_split_channels(layout, groups, group_slots))
        assert np.array_equal(via.numpy(), want), name
    # the executor's [2] partials (a Count's, a Min's count at the best)
    column = [torch.from_numpy(parts[m, :, 0].copy()) for m in range(MEMBERS)]
    got = kernels.lane_reduce(column, groups or 1, widths)
    assert got.shape == (2, 1)
    assert np.array_equal(got.numpy()[:, 0], want[:, 0])


# (groups or None: flat, want_max, bound, the largest value): the valid
# flag's 0/1, the uint8 lane at 255 and past it (300 casts to 44), the
# uint16 lane past 65 535, and the exact int32 lane
EXTREME_LAYOUT_CASES = [(2, True, 1, 1), (4, True, 255, 300),
                        (2, False, 65535, 70000), (4, False, None, 1 << 30),
                        (None, True, None, 1 << 30)]


@pytest.mark.parametrize("groups,want_max,bound,top", EXTREME_LAYOUT_CASES)
def test_lane_reduce_extrema_layouts_match_reference(groups, want_max, bound,
                                                     top):
    rng = np.random.default_rng(top % 1000 + (groups or 0))
    low = 0 if bound is not None else -top
    vals = rng.integers(low, top + 1, (MEMBERS, 5)).astype(np.int32)
    vals[3, 2] = top
    vals[6, 4] = low

    def body(v):
        best = (lax.pmax if want_max else lax.pmin)(v, SHARDS_AXIS)
        if groups is None:
            return best
        return jred.gather_extreme(best, GROUPS_AXIS, want_max, bound=bound)

    want = _run_mesh(groups, body, vals)
    mode = "max" if want_max else "min"
    width = 4 if groups is None or bound is None else         reduction.lane_dtype_bytes(bound)
    t = torch.from_numpy(vals)
    wide = torch.zeros((MEMBERS, 10), dtype=torch.int32)
    wide[:, ::2] = t
    layouts = {"members": [t[m].clone() for m in range(MEMBERS)],
               "stacked": t, "stacked_strided": wide[:, ::2],
               "members_strided": [wide[m, ::2] for m in range(MEMBERS)]}
    for name, layout in layouts.items():
        got = kernels.lane_reduce(layout, groups or 1, width, mode)
        assert got.dtype == torch.int32, name
        assert np.array_equal(got.numpy(), want), name
        via = reduction.gather_extreme(layout, groups, want_max, bound=bound)
        assert np.array_equal(via.numpy(), want), name
    # the executor's 0-d partials (a Min's or Max's best, its valid flag)
    for col in range(5):
        scalars = [torch.tensor(int(vals[m, col]), dtype=torch.int32)
                   for m in range(MEMBERS)]
        got = reduction.gather_extreme(scalars, groups, want_max, bound=bound)
        assert got.tolist() == [int(want[col])]


@pytest.mark.parametrize("groups", [None, 2, 4])
def test_lane_reduce_keeps_int64_extrema_in_every_layout(groups):
    """int64 bests (K7 to depth 63) cross unnarrowed, as members, stacked
    and 0-d: the plain composition's answer, the members' true best."""
    vals = torch.tensor([[1 << 40, -3], [-(1 << 50), 9], [7, 1 << 33],
                         [3, -(1 << 62)]], dtype=torch.int64).repeat(2, 1)
    for want_max in (True, False):
        mode = "max" if want_max else "min"
        want = vals.amax(0) if want_max else vals.amin(0)
        for layout in (vals, list(vals), [v.clone() for v in vals]):
            got = reduction.gather_extreme(layout, groups, want_max)
            assert got.dtype == torch.int64 and torch.equal(got, want)
            assert torch.equal(got, kernels.lane_reduce_plain(
                layout, groups or 1, 8, mode))
        got = reduction.gather_extreme([v[0] for v in vals], groups, want_max)
        assert got.tolist() == [int(want[0])]


def _refused(kind: str):
    parts = [torch.zeros((2, 3), dtype=torch.int32) for _ in range(8)]
    if kind == "too_many_members":
        return [parts[0]] * (kernels.LANE_MAX_MEMBERS + 2), 2, ValueError
    if kind == "mixed_devices":
        return parts[:7] + [parts[7].to("meta")], 2, ValueError
    if kind == "mixed_dtypes":
        return parts[:7] + [parts[7].to(torch.int64)], 2, TypeError
    if kind == "groups_do_not_divide":
        return parts[:6], 4, ValueError
    if kind == "mixed_layouts":
        return parts[:7] + [torch.zeros((3, 2), dtype=torch.int32).t()], 2, \
            ValueError
    if kind == "overlapping_channels":
        row = torch.zeros(3, dtype=torch.int32)
        return [row.expand(2, 3)] * 8, 2, ValueError
    if kind == "no_members":
        return [], 1, ValueError
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", [
    "too_many_members", "mixed_devices", "mixed_dtypes",
    "groups_do_not_divide", "mixed_layouts", "overlapping_channels",
    "no_members"])
def test_lane_reduce_refuses(kind):
    parts, groups, err = _refused(kind)
    with pytest.raises(err):
        kernels.lane_reduce(parts, groups, (4, 4))


@pytest.mark.parametrize("kind", [
    "too_many_members", "mixed_devices", "mixed_dtypes",
    "groups_do_not_divide", "mixed_layouts", "overlapping_channels",
    "no_members"])
def test_quant_reduce_refuses(kind):
    parts, groups, err = _refused(kind)
    with pytest.raises(err):
        kernels.quant_reduce(parts, groups)


def test_lane_reduce_takes_64_members():
    """The cap itself: 64 members in 8 groups, from the numpy sum."""
    rng = np.random.default_rng(64)
    parts = rng.integers(0, 1 << 20, (64, 2, 7)).astype(np.int32)
    got = kernels.lane_reduce([torch.from_numpy(p) for p in parts], 8,
                              (4, 4))
    assert np.array_equal(got.numpy(), parts.sum(0, dtype=np.int32))
