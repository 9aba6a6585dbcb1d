"""Bitmap-expression structures, their plain evaluator and their compiler.

A PQL bitmap call tree is lowered to a *structure* — nested hashable
tuples with leaf indices, the grammar of ``pilosa_tpu.executor.expr`` —
and each distinct structure is compiled once (module-level cache keyed by
the structure, as ``_JIT_CACHE`` is there) to the postfix program that
the CUDA kernels interpret (``pilosa_tpu_torch.kernels``).

Node grammar of this slice:
  ('leaf', i)                     — int32[words] row leaf
  ('const0',)                     — empty row
  ('and'|'or'|'xor'|'diff', a, b)
  ('count', a)                    — int32 scalar popcount reduction

(flipall, shift and the BSI/countrows nodes are not ported yet.)
"""

from __future__ import annotations

import torch

from pilosa_tpu_torch import kernels

_PROGRAM_CACHE: dict = {}


def compile_program(structure) -> tuple:
    """Postfix program (tuple of int instructions) for a bitmap structure;
    a ('count', sub) structure compiles its ``sub``. Cached by structure."""
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
    else:
        raise ValueError(f"expr node {tag!r} is not ported yet")


def evaluate(node, leaves):
    """Plain recursive evaluator over torch tensors (the reference form of
    what the compiled program computes); ('count', a) returns an int32
    scalar tensor."""
    tag = node[0]
    if tag == "leaf":
        return leaves[node[1]]
    if tag == "const0":
        return torch.zeros_like(leaves[0])
    if tag == "and":
        return evaluate(node[1], leaves) & evaluate(node[2], leaves)
    if tag == "or":
        return evaluate(node[1], leaves) | evaluate(node[2], leaves)
    if tag == "xor":
        return evaluate(node[1], leaves) ^ evaluate(node[2], leaves)
    if tag == "diff":
        return evaluate(node[1], leaves) & ~evaluate(node[2], leaves)
    if tag == "count":
        return kernels.popcount32(evaluate(node[1], leaves)).sum(
            dtype=torch.int32)
    raise ValueError(f"expr node {tag!r} is not ported yet")
