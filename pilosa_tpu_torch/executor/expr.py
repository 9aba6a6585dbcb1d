"""Bitmap-expression structures, their plain evaluator, planner and compiler.

A PQL bitmap call tree is lowered to a *structure* — nested hashable
tuples with leaf and scalar indices, the grammar of
``pilosa_tpu.executor.expr`` — evaluated against (leaves, scalars):
leaves are stacked int32 rows ``[S, W]`` or BSI plane matrices
``[S, 2 + depth, W]``, scalars query-time integers (shift amounts,
offset-encoded BSI predicates), so one structure serves every query of
its shape.

Node grammar:
  ('leaf', i)                     — int32[S, W] row leaf
  ('const0',)                     — empty row
  ('and'|'or'|'xor'|'diff', a, b)
  ('flipall', a)                  — bitwise NOT over the full shard width
  ('shift', a, j)                 — shift each shard row by scalars[j]
  ('bsicmp', op, i_planes, a, j)  — BSI comparison row (a: exists row)
  ('count', a)                    — int32 popcount reduction
  ('countrows', i_matrix, a|None) — int32[S, R] popcount of each row of the
                                    [S, R, W] matrix leaf, under filter a
  ('bsisum', i_planes, a|None)    — (int32[S, depth] plane counts, int32[S] n)
  ('bsiminmax', want_max, i_planes, a|None) — (int32[S] value, int32[S] count)

On the card the elementwise part (leaf/const0/and/or/xor/diff/flipall)
compiles once per structure (module-level cache, as ``_JIT_CACHE`` is
there) to the postfix program that K1 and K2 interpret. The reference
fuses shift and bsicmp into the same XLA pass; here ``plan`` lifts each
of them out as a *step* that its own kernel (K4, K5) materializes into a
temporary row, innermost first, and the rest becomes an elementwise
structure over the stacked leaves and those temporaries. An elementwise
part over the kernels' limits (more than 16 operands, a program longer
than 64 instructions or deeper than 16 stack slots) gives up whole
subtrees as ``tree`` steps, which K2 materializes the same way.
"""

from __future__ import annotations

import torch

from pilosa_tpu_torch import kernels
from pilosa_tpu_torch.ops.bitops import shift

_PROGRAM_CACHE: dict = {}
_PLAN_CACHE: dict = {}

PLANES_EXISTS = 0
PLANES_OFFSET = 2

_ELEMENTWISE = ("and", "or", "xor", "diff")


def compile_program(structure) -> tuple:
    """Postfix program (tuple of int instructions) for an elementwise
    structure; a ('count', sub) structure compiles its ``sub``. Cached by
    structure."""
    prog = _PROGRAM_CACHE.get(structure)
    if prog is None:
        node = structure[1] if structure[0] == "count" else structure
        out: list = []
        _emit(node, out)
        prog = tuple(out)
        n_leaves = 1 + max((c >> 8 for c in prog
                            if c & 0xFF == kernels.OP_LEAF), default=0)
        kernels.check_program(prog, n_leaves)  # depth/length limits
        if len(_PROGRAM_CACHE) >= 4096:
            _PROGRAM_CACHE.clear()
        _PROGRAM_CACHE[structure] = prog
    return prog


def _emit(node, out: list) -> None:
    tag = node[0]
    if tag == "leaf":
        out.append(kernels.OP_LEAF | (node[1] << 8))
    elif tag == "const0":
        out.append(kernels.OP_ZERO)
    elif tag in kernels.OP_NAMES:
        _emit(node[1], out)
        _emit(node[2], out)
        out.append(kernels.OP_NAMES[tag])
    elif tag == "flipall":
        _emit(node[1], out)
        out.append(kernels.OP_NOT)
    else:
        raise ValueError(f"expr node {tag!r} is not elementwise")


# ------------------------------------------------------------------ planning


class Plan:
    """A structure split for dispatch on the card.

    ``steps``: the materializing kernels, innermost first — ``('shift',
    sub, j)``, ``('bsicmp', op, i_planes, sub, j)`` and ``('tree', sub)``
    (K2 over a subtree cut off to keep every program inside the kernels'
    limits), where ``sub`` is a ``(node, operands)`` row expression. ``root``: the elementwise rest
    — the structure itself for 'count' and row structures (with the
    'count' wrapper kept), the filter's row expression or None for
    'bsisum', 'bsiminmax' and 'countrows'. An *operand* is ``('spec', i)``
    (stacked leaf i) or ``('temp', k)`` (the row step k produced); a row
    expression's node indexes its operand list. ``kind``: 'count', 'row',
    'bsisum', 'bsiminmax' or 'countrows'; ``planes``: the index of the
    [S, R, W] leaf an aggregate reduces (BSI planes, countrows' matrix)."""

    __slots__ = ("steps", "root", "kind", "planes")

    def __init__(self, steps: tuple, root, kind: str, planes=None):
        self.steps = steps
        self.root = root
        self.kind = kind
        self.planes = planes


def plan(structure) -> Plan:
    """Split ``structure`` into steps and an elementwise root (cached by
    structure). Raises ValueError only for a malformed structure."""
    out = _PLAN_CACHE.get(structure)
    if out is not None:
        return out
    steps: list = []
    tag = structure[0]
    planes = None
    if tag == "count":
        node, ops = _split(structure[1], steps)
        root = (("count", node), ops)
    elif tag in ("bsisum", "bsiminmax", "countrows"):
        planes, filt = structure[-2], structure[-1]
        root = _split(filt, steps) if filt is not None else None
    else:
        tag = "row"
        root = _split(structure, steps)
    subs = [s[1] if s[0] == "tree" else s[-2] for s in steps]
    for expr_ in subs + ([root] if root else []):
        _check_limits(*expr_)
    out = Plan(tuple(steps), root, tag, planes)
    if len(_PLAN_CACHE) >= 4096:
        _PLAN_CACHE.clear()
    _PLAN_CACHE[structure] = out
    return out


def _split(node, steps: list) -> tuple:
    """Lift shift/bsicmp out of ``node``: returns (elementwise node over an
    operand list, operands), appending the lifted steps to ``steps``; a
    part over the kernels' limits is cut to fit (``_fit``)."""
    operands: list = []

    def go(n):
        tag = n[0]
        if tag == "leaf":
            operands.append(("spec", n[1]))
            return ("leaf", len(operands) - 1)
        if tag == "const0":
            return n
        if tag in _ELEMENTWISE:
            return (tag, go(n[1]), go(n[2]))
        if tag == "flipall":
            return (tag, go(n[1]))
        if tag == "shift":
            steps.append(("shift", _split(n[1], steps), n[2]))
        elif tag == "bsicmp":
            steps.append(("bsicmp", n[1], n[2], _split(n[3], steps), n[4]))
        else:
            raise ValueError(f"expr node {tag!r} is not a row node")
        operands.append(("temp", len(steps) - 1))
        return ("leaf", len(operands) - 1)

    node = go(node)
    return _fit(node, operands, steps)


def _size(node) -> tuple:
    """(operands, instructions, stack depth) of an elementwise node's
    postfix program."""
    tag = node[0]
    if tag in ("leaf", "const0"):
        return (tag == "leaf", 1, 1)
    if tag == "flipall":
        n, ins, depth = _size(node[1])
        return n, ins + 1, depth
    na, ia, da = _size(node[1])
    nb, ib, db = _size(node[2])
    return na + nb, ia + ib + 1, max(da, db + 1)


def _fits(size) -> bool:
    n, ins, depth = size
    return (n <= kernels.MAX_LEAVES and ins <= kernels.MAX_OPS
            and depth <= kernels.MAX_STACK)


def _local(node, operands) -> tuple:
    """``node`` renumbered over the operands it uses, in order of use:
    (node, operands)."""
    used: list = []

    def go(n):
        if n[0] == "leaf":
            used.append(operands[n[1]])
            return ("leaf", len(used) - 1)
        if n[0] == "const0":
            return n
        return (n[0], *[go(c) for c in n[1:]])

    node = go(node)
    return node, tuple(used)


def _fit(node, operands: list, steps: list) -> tuple:
    """(node, operands) with every program inside the kernels' limits.
    Bottom-up, a node that does not fit while its children do cuts its
    largest child (by operands, then depth, then instructions) into a
    ``('tree', sub)`` step, and the other too if that is not enough: a
    left-deep fold of 40 leaves becomes two steps of 16 and a root of
    10."""

    def cut(n):
        sub = _local(n, operands)
        steps.append(("tree", sub))
        operands.append(("temp", len(steps) - 1))
        return ("leaf", len(operands) - 1)

    def go(n):
        tag = n[0]
        if tag in ("leaf", "const0"):
            return n
        kids = [go(c) for c in n[1:]]
        while not _fits(_size((tag, *kids))):
            order = sorted(
                (i for i, k in enumerate(kids) if k[0] != "leaf"),
                key=lambda i: (_size(kids[i])[0], _size(kids[i])[2],
                               _size(kids[i])[1]))
            kids[order[-1]] = cut(kids[order[-1]])
        return (tag, *kids)

    return _local(go(node), operands)


def _check_limits(node, operands) -> None:
    if len(operands) > kernels.MAX_LEAVES:
        raise ValueError(f"{len(operands)} operands, the kernels take "
                         f"{kernels.MAX_LEAVES}")
    compile_program(node)


# ------------------------------------------------------------ plain evaluator


def evaluate(node, leaves, scalars=()):
    """Plain recursive evaluator over torch tensors (the reference form of
    what the kernels compute), on stacked leaves: rows int32[..., W],
    planes int32[..., 2 + depth, W]. ('count', a) returns an int32
    scalar tensor, ('countrows', ...) int32[S, R]; 'bsisum' and
    'bsiminmax' return their pairs of per leading-index tensors."""
    tag = node[0]
    if tag == "leaf":
        return leaves[node[1]]
    if tag == "const0":
        first = leaves[0]
        return torch.zeros_like(first if first.dim() != 3 else first[:, 0])
    if tag == "and":
        return evaluate(node[1], leaves, scalars) & evaluate(node[2], leaves,
                                                             scalars)
    if tag == "or":
        return evaluate(node[1], leaves, scalars) | evaluate(node[2], leaves,
                                                             scalars)
    if tag == "xor":
        return evaluate(node[1], leaves, scalars) ^ evaluate(node[2], leaves,
                                                             scalars)
    if tag == "diff":
        return evaluate(node[1], leaves, scalars) & ~evaluate(node[2], leaves,
                                                              scalars)
    if tag == "flipall":
        return ~evaluate(node[1], leaves, scalars)
    if tag == "shift":
        return shift(evaluate(node[1], leaves, scalars), int(scalars[node[2]]))
    if tag == "count":
        return kernels.popcount32(evaluate(node[1], leaves, scalars)).sum(
            dtype=torch.int32)
    if tag == "bsicmp":
        return kernels.bsi_compare_plain(
            leaves[node[2]], evaluate(node[3], leaves, scalars), node[1],
            int(scalars[node[4]]))
    if tag == "countrows":
        filt = (evaluate(node[2], leaves, scalars)
                if node[2] is not None else None)
        return kernels.count_rows_plain(leaves[node[1]], filt)
    if tag == "bsisum":
        filt = (evaluate(node[2], leaves, scalars)
                if node[2] is not None else None)
        packed = kernels.bsi_sum_plain(leaves[node[1]], filt)
        return packed[:, :-1], packed[:, -1]
    if tag == "bsiminmax":
        filt = (evaluate(node[3], leaves, scalars)
                if node[3] is not None else None)
        return kernels.bsi_minmax_plain(leaves[node[2]], filt, bool(node[1]))
    raise ValueError(f"unknown expr node {tag!r}")
