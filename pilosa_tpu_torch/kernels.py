"""The port's hand-written CUDA kernels, their wrappers and plain versions.

Thirteen kernels carry the main paths (sources in ``csrc/``):

- K1 ``tree_count``: per-row popcount of a postfix bitwise program over
  up to 16 stacked leaves, one launch per micro-batch, in the program's
  form as K2 classifies it (replaces ``bench_pallas.pallas_intersect_count``
  and ``batch.count_flat``);
- K2 ``tree_rows``: the words of the same program, for row results
  (replaces ``expr._go`` under the 'row' reduce kind, ``flipall``
  included as ``OP_NOT``);
- K3 ``word_patch``: OR / AND-NOT host-deduplicated word masks into a
  batch of rows of resident ``[S, W]`` and ``[S, R, W]`` leaves, in
  place, one launch a write request (replaces ``batch._or_delta`` /
  ``_andnot_delta`` and their ``_row`` forms);
- K4 ``row_shift``: every shard row's bits shifted by n (replaces
  ``ops/bitops.py::shift``);
- K5 ``bsi_compare``: the bit-sliced comparison of a BSI plane leaf
  against a predicate (replaces ``expr._bsi_compare``);
- K6 ``bsi_sum``: per-shard plane popcounts under exists and a filter
  (replaces the 'bsisum' node);
- K7 ``bsi_minmax``: per-shard greedy extremum (64 bits) and its count,
  one thread block cluster a shard (replaces ``expr._bsi_minmax``);
- K8 ``count_rows``: per-shard popcount of every row of a stacked row
  matrix under an optional filter row (replaces the 'countrows' node,
  TopN's phase 2);
- K9 ``groupby_level``: per shard and candidate group, the popcount of
  the AND of one row of each dimension matrix and a filter, with the
  aggregate's plane counts (replaces ``batch.groupby_level_body``);
- K10 ``block_gather``: the listed 4 KiB blocks of one flat leaf, or of
  a batch of leaves in one launch, compacted (replaces
  ``residency._gather_blocks``);
- K11 ``block_scatter``: the dense leaf from its compacted blocks
  (replaces ``residency._scatter_blocks``);
- K12+K13 ``lane_reduce``: a mesh's whole reduce of its members'
  partials in one launch, read where the members' kernels wrote them:
  the intra-group sum (or best), the cast to the narrow inter-group
  lane and the receivers' widening fold, the lanes kept in registers;
  on the flat mesh the int32 sum (or best) over the members (replaces
  ``reduction.hier_split_channels`` and ``gather_extreme`` with the
  psum/pmax before them, and the flat psum);
- K14+K15 ``quant_reduce``: the 8-bit candidate-ranking lane of a
  mesh's reduce whole, in one launch that reads the members' partials in
  place: the intra-group sum, per 256-candidate block each group's
  integer scale and rounded mantissas, and the receivers' decode into
  approximate counts and per-block error bounds in split form, the
  lanes kept in registers; on the flat mesh the exact sum with zero
  bounds (replaces ``reduction.hier_quantized_counts`` with the psum
  before it).

Each source builds with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface under ``build/kernels/`` at first use, and is
loaded with ctypes. A wrapper takes its plain PyTorch version only for a
tensor that lies on the CPU; for a CUDA tensor it launches the kernel or
raises. Words are int32 tensors holding the uint32 bit patterns.
"""

from __future__ import annotations

import ctypes
import hashlib
import heapq
import itertools
import os
import shutil
import struct
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from pilosa_tpu_torch.ops.bitops import shift

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("tree_count", "tree_rows", "word_patch", "row_shift",
           "bsi_compare", "bsi_sum", "bsi_minmax", "count_rows",
           "groupby_level", "block_gather", "block_scatter",
           "lane_reduce", "quant_reduce")

# Opcodes of the postfix program (csrc/tree_program.cuh holds the same).
OP_LEAF, OP_ZERO, OP_AND, OP_OR, OP_XOR, OP_DIFF, OP_SALT, OP_NOT = range(1, 9)
OP_NAMES = {"and": OP_AND, "or": OP_OR, "xor": OP_XOR, "diff": OP_DIFF}
MAX_BATCH = 16
MAX_LEAVES = 16
MAX_OPS = 64
MAX_STACK = 16
# BSI comparison operators, numbered as csrc/bsi_compare.cu numbers them.
BSI_OPS = {"<": 0, "<=": 1, ">": 2, ">=": 3, "==": 4, "!=": 5}
BSI_MAX_DEPTH = 63         # bit planes K5 and K6 take (a 64-bit predicate)
BSI_MINMAX_MAX_DEPTH = 63  # K7's extremum is an int64 (as K5's predicate)
MINMAX_MAX_WORDS = 32768  # words per shard row K7 takes (one cluster each)
GROUPBY_MAX_DEPTH = 63     # bit planes of K9's aggregate (as K6)
# Masks the plain GroupBy level holds at once ([S, chunk, W] per step)
GROUPBY_PLAIN_MASK_BYTES = 256 << 20
# K9's block (csrc/groupby_level.cu holds the same numbers): shared
# memory it may use, the part kept for its row pointers, the staged rows a
# candidate tile may hold, the candidates of one group and the warps
GROUPBY_SMEM_BYTES = 232448
GROUPBY_SMEM_RESERVE = 1024
GROUPBY_MAX_SLOTS = 128
GROUPBY_GROUP_MAX = 8
GROUPBY_WARPS = 16
GROUPBY_TILE_WORDS = (1024, 512, 256)  # word tiles the plan picks from
GROUPBY_SRC_FILT = MAX_LEAVES          # slot sources past the dimensions
GROUPBY_SRC_PLANES = MAX_LEAVES + 1
BLOCK_WORDS = 1024  # words of a residency block (K10, K11): 4 KiB
# Candidates a scale block of the 8-bit ranking lane covers (K14+K15;
# csrc/quant_reduce.cu holds the same) and the split-sum shift.
QUANT_BLOCK = 256
SPLIT_SHIFT = 15
SPLIT_MASK = (1 << SPLIT_SHIFT) - 1
# The mesh lanes' element types by width in bytes (K12+K13): the
# narrow lanes unsigned, the exact ones signed; the members one
# lane_reduce or quant_reduce launch takes (csrc/lane_reduce.cu and
# csrc/quant_reduce.cu hold the same).
LANE_DTYPES = {1: torch.uint8, 2: torch.uint16, 4: torch.int32,
               8: torch.int64}
_LANE_MODES = {"sum": 0, "max": 1, "min": 2}
LANE_MAX_MEMBERS = 64

# --------------------------------------------------------------- launches

_launch_lock = threading.Lock()
# one count a kernel, and K10's launches over more than one leaf apart
LAUNCHES = {name: 0 for name in (*SOURCES, "block_gather_batch")}


def _count_launch(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launches() -> dict:
    with _launch_lock:
        return dict(LAUNCHES)


# ------------------------------------------------------------------ build

_libs: dict = {}
_build_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels build on a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict:
    """Compile the named sources that are not built yet, one ``nvcc``
    process per source, all started together. Returns {name: seconds of
    the build, 0.0 when the library was already there}. Each compiler's
    output (register and shared-memory use) lands beside its library
    as ``<lib>.log``."""
    nvcc = None
    procs = {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, out, log)
    times = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        times[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}, see "
                          f"{out.with_suffix('.log')}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or none
    if failed:
        raise RuntimeError("kernel build failed: " + "; ".join(failed))
    return times


def _lib(name: str):
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _build_lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _bind(name, lib)
            _libs[name] = lib
    return lib


def _bind(name: str, lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    argtypes = {
        "tree_count": [p, i, i, i, i, p, p, p, i, ll, ll, i, i, p, p],
        "tree_rows": [p, i, i, i, ctypes.c_uint32, ctypes.c_uint32, p, i,
                      ll, i, p, p],
        "word_patch": [p, i, i, p],
        "row_shift": [p, p, ll, ll, ll, i, p],
        "bsi_compare": [p, p, p, ll, ll, i, ctypes.c_ulonglong, i, i, p],
        "bsi_sum": [p, p, p, ll, ll, i, i, p],
        "bsi_minmax": [p, p, ll, ll, i, i, i, p, p, p],
        "count_rows": [p, p, p, ll, i, ll, i, p],
        "groupby_level": [p, p, i, p, p, p, p, i, ll, ll, i, i, p, p],
        "block_gather": [p, p, p, ll, i, p],
        "block_scatter": [p, p, i, p, ll, p],
        "lane_reduce": [ctypes.c_char_p, p, p],
        "quant_reduce": [ctypes.c_char_p, p, p],
    }
    getattr(lib, f"{name}_launch").argtypes = argtypes[name]
    getattr(lib, f"{name}_launch").restype = i
    if name == "block_gather":
        lib.block_gather_batch_launch.argtypes = [p, p, i, i, i, i, p]
        lib.block_gather_batch_launch.restype = i
        lib.block_gather_inline_launch.argtypes = [p, ll, p, i, p, p, p]
        lib.block_gather_inline_launch.restype = i
    if name == "word_patch":
        lib.word_patch_staged_launch.argtypes = [p, p, i, i, i, p]
        lib.word_patch_staged_launch.restype = i
        lib.word_patch_empty_launch.argtypes = [p]
        lib.word_patch_empty_launch.restype = i
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [i]
    err.restype = ctypes.c_char_p


def _check(name: str, lib, rc: int) -> None:
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {rc})")


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


# ------------------------------------------------------------- validation


def _check_words(tensors, device) -> None:
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"kernel words must be int32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"leaf on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError("kernel words must be contiguous")


def check_program(program, n_leaves: int) -> None:
    if not 1 <= len(program) <= MAX_OPS:
        raise ValueError(f"program length {len(program)} outside 1..{MAX_OPS}")
    sp = 0
    for code in program:
        op, arg = code & 0xFF, code >> 8
        if op == OP_LEAF:
            if not 0 <= arg < n_leaves:
                raise ValueError(f"leaf {arg} of {n_leaves}")
            sp += 1
        elif op == OP_ZERO:
            sp += 1
        elif op in (OP_SALT, OP_NOT):
            if sp < 1:
                raise ValueError("unary op on an empty stack")
        elif OP_AND <= op <= OP_DIFF:
            sp -= 1
            if sp < 1:
                raise ValueError("stack underflow")
        else:
            raise ValueError(f"bad opcode {op}")
        if sp > MAX_STACK:
            raise ValueError(f"stack deeper than {MAX_STACK}")
    if sp != 1:
        raise ValueError("program must leave exactly one result")


# K1's and K2's program forms (csrc/tree_program.cuh numbers them the same)
FORM_GENERAL, FORM_CHAIN, FORM_HEAD_DIFF = 0, 1, 2
# Steps of R groups a thread that one K1 block walks inside its row, per
# form, as scripts/k1_steps_sweep.py measured them on an H100 (PERF.md
# §6): the folds ran fastest at one or two steps, the general form
# fastest at four
TREE_COUNT_STEPS = {FORM_CHAIN: 1, FORM_HEAD_DIFF: 1, FORM_GENERAL: 4}
_FOLD_OPS = (OP_AND, OP_OR, OP_XOR)
_FORM_CACHE: dict = {}


class Form(tuple):
    """A classified K2 program: ``(kind, op, leaves, n_not, n_salt)``.
    ``kind`` is FORM_CHAIN (a left fold of ``op`` over the leaf indices
    ``leaves``), FORM_HEAD_DIFF (``leaves[0] & ~fold(op, leaves[1:])``)
    or FORM_GENERAL (the program as it is; ``op`` 0, ``leaves`` empty);
    the result is then xored with ~0 ``n_not`` times and with the salt
    ``n_salt`` times (only for the two folds: the general program keeps
    its own unary ops)."""

    __slots__ = ()

    kind = property(lambda self: self[0])
    op = property(lambda self: self[1])
    leaves = property(lambda self: self[2])
    n_not = property(lambda self: self[3])
    n_salt = property(lambda self: self[4])

    def xor_mask(self, salt: int) -> int:
        """The uint32 a fold's result is xored with."""
        mask = 0xFFFFFFFF if self.n_not % 2 else 0
        return mask ^ (_salt_u32(salt) if self.n_salt % 2 else 0)


def _program_tree(program):
    """The postfix program as a nested tuple: ('leaf', i), ('zero',),
    (op, a) for OP_NOT / OP_SALT, (op, a, b) for the binary ops."""
    stack = []
    for code in program:
        op, arg = code & 0xFF, code >> 8
        if op == OP_LEAF:
            stack.append(("leaf", arg))
        elif op == OP_ZERO:
            stack.append(("zero",))
        elif op in (OP_SALT, OP_NOT):
            stack.append((op, stack.pop()))
        else:
            b = stack.pop()
            stack.append((op, stack.pop(), b))
    return stack[0]


def _fold_leaves(node, op):
    """The leaf indices of ``node`` when it is a tree of ``op`` over bare
    leaves (any association: and, or and xor are associative and
    commutative), else None."""
    if node[0] == "leaf":
        return [node[1]]
    if node[0] != op or len(node) != 3:
        return None
    a, b = _fold_leaves(node[1], op), _fold_leaves(node[2], op)
    return None if a is None or b is None else a + b


def _classify(program) -> Form:
    root = _program_tree(program)
    n_not = n_salt = 0
    while root[0] in (OP_NOT, OP_SALT):
        n_not += root[0] == OP_NOT
        n_salt += root[0] == OP_SALT
        root = root[1]
    if root[0] == "leaf":
        return Form((FORM_CHAIN, OP_OR, (root[1],), n_not, n_salt))
    if root[0] in _FOLD_OPS:
        leaves = _fold_leaves(root, root[0])
        if leaves is not None and len(leaves) <= MAX_LEAVES:
            return Form((FORM_CHAIN, root[0], tuple(leaves), n_not, n_salt))
    if root[0] == OP_DIFF:
        subs = []  # a - b - c as head a and subtrahends [b, c]
        head = root
        while head[0] == OP_DIFF:
            subs.insert(0, head[2])
            head = head[1]
        if head[0] == "leaf":
            if all(s[0] == "leaf" for s in subs):
                rest = [s[1] for s in subs]
                op = OP_OR
            elif len(subs) == 1 and subs[0][0] in _FOLD_OPS:
                op = subs[0][0]
                rest = _fold_leaves(subs[0], op)
            else:
                rest = None
            if rest is not None and 1 + len(rest) <= MAX_LEAVES:
                return Form((FORM_HEAD_DIFF, op, (head[1], *rest), n_not,
                             n_salt))
    return Form((FORM_GENERAL, 0, (), 0, 0))


def classify_program(program) -> Form:
    """K2's form of a valid postfix program (cached by program)."""
    program = tuple(program)
    form = _FORM_CACHE.get(program)
    if form is None:
        form = _classify(program)
        if len(_FORM_CACHE) >= 4096:
            _FORM_CACHE.clear()
        _FORM_CACHE[program] = form
    return form


def _aligned(tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _salt_u32(salt: int) -> int:
    return int(salt) & 0xFFFFFFFF


def _salt_i32(salt: int) -> int:
    s = _salt_u32(salt)
    return s - (1 << 32) if s >= 1 << 31 else s


# ------------------------------------------------------------ plain versions


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32 words (their uint32 bit patterns), as
    int32: a SWAR count in int32. torch's ``>>`` is arithmetic, but every
    mask after a shift clears the copied sign bits, and the subtraction
    wraps as uint32 would; from the nibble step on every value is
    non-negative, and the byte sums are added without a multiply. The
    words are read once (a copy): on the CPU a write may patch a resident
    leaf while a count reads it, and two reads of one word could see two
    values."""
    v = words.clone()
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    return (v + (v >> 16)) & 0x3F


def eval_program_plain(program, leaves, salt: int = 0) -> torch.Tensor:
    """The postfix program on whole tensors (the kernels' plain version)."""
    stack = []
    for code in program:
        op, arg = code & 0xFF, code >> 8
        if op == OP_LEAF:
            stack.append(leaves[arg])
        elif op == OP_ZERO:
            stack.append(torch.zeros_like(leaves[0]))
        elif op == OP_SALT:
            stack.append(stack.pop() ^ _salt_i32(salt))
        elif op == OP_NOT:
            stack.append(~stack.pop())
        else:
            b = stack.pop()
            a = stack.pop()
            if op == OP_AND:
                stack.append(a & b)
            elif op == OP_OR:
                stack.append(a | b)
            elif op == OP_XOR:
                stack.append(a ^ b)
            else:
                stack.append(a & ~b)
    return stack[0]


def tree_count_plain(program, batch_leaves, salts, row_words: int) -> torch.Tensor:
    out = []
    for leaves, salt in zip(batch_leaves, salts):
        words = eval_program_plain(program, leaves, salt).reshape(-1, row_words)
        out.append(popcount32(words).sum(dim=1, dtype=torch.int32))
    return torch.stack(out)


def tree_rows_plain(program, leaves, salt: int = 0) -> torch.Tensor:
    return eval_program_plain(program, leaves, salt).clone()


def eval_form_plain(form: Form, leaves, salt: int = 0) -> torch.Tensor:
    """A classified chain or head-diff form on whole tensors: the
    arithmetic K2's form kernels do (tests hold it against
    ``tree_rows_plain``)."""
    if form.kind == FORM_GENERAL:
        raise ValueError("the general form runs the program itself")
    fold = {OP_AND: torch.bitwise_and, OP_OR: torch.bitwise_or,
            OP_XOR: torch.bitwise_xor}[form.op]
    first = 1 if form.kind == FORM_HEAD_DIFF else 0
    acc = leaves[form.leaves[first]].clone()
    for i in form.leaves[first + 1:]:
        acc = fold(acc, leaves[i])
    if form.kind == FORM_HEAD_DIFF:
        acc = leaves[form.leaves[0]] & ~acc
    return acc ^ _salt_i32(form.xor_mask(salt))


def word_patch_batch_plain(targets) -> None:
    """K3's plain version: each target ``(leaf, slot, row, word_idx,
    masks, clear)`` ORs its masks into (or, with ``clear``, clears them
    from) the words ``word_idx`` of ``leaf[slot]``, or of
    ``leaf[slot, row]`` when ``row`` is not None, in place, in order."""
    for leaf, slot, row, word_idx, masks, clear in targets:
        idx = torch.from_numpy(np.asarray(word_idx, np.int64)).to(leaf.device)
        m = torch.from_numpy(np.ascontiguousarray(masks, np.uint32).view(
            np.int32)).to(leaf.device)
        target = leaf[slot] if row is None else leaf[slot, row]
        if clear:
            target[idx] = target[idx] & ~m
        else:
            target[idx] = target[idx] | m


row_shift_plain = shift  # ops/bitops.py holds K4's plain version


def bsi_compare_plain(planes: torch.Tensor, exists: torch.Tensor, op: str,
                      pred: int) -> torch.Tensor:
    """The classic O(depth) bit-sliced comparison (``expr._bsi_compare``)
    on stacked shards: planes int32[S, 2 + depth, W], exists int32[S, W],
    ``pred`` the offset-encoded predicate."""
    depth = planes.shape[1] - 2
    zeros = torch.zeros_like(exists)
    eq, lt, gt = exists, zeros, zeros
    for i in reversed(range(depth)):
        p = planes[:, 2 + i]
        if (pred >> i) & 1:
            lt = lt | (eq & ~p)
            eq = eq & p
        else:
            gt = gt | (eq & p)
            eq = eq & ~p
    return {"<": lt, "<=": lt | eq, ">": gt, ">=": gt | eq, "==": eq,
            "!=": exists & ~eq}[op].clone()


def bsi_sum_plain(planes: torch.Tensor, filt: torch.Tensor | None
                  ) -> torch.Tensor:
    """Per-shard popcounts of every plane under exists (& filter), then
    of exists (& filter) itself: int32[S, depth + 1]."""
    depth = planes.shape[1] - 2
    mask = planes[:, 0] if filt is None else planes[:, 0] & filt
    cols = [popcount32(planes[:, 2 + i] & mask).sum(dim=1, dtype=torch.int32)
            for i in range(depth)]
    cols.append(popcount32(mask).sum(dim=1, dtype=torch.int32))
    return torch.stack(cols, dim=1)


def bsi_minmax_plain(planes: torch.Tensor, filt: torch.Tensor | None,
                     want_max: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The greedy MSB-first walk (``expr._bsi_minmax``) per shard:
    (offset-encoded extremum int64[S], candidate count int32[S]); a shard
    with no candidate has count 0. The value is built in 64 bits: the
    reference accumulates it in int32 and wraps past 31 planes."""
    depth = planes.shape[1] - 2
    cand = planes[:, 0] if filt is None else planes[:, 0] & filt
    value = torch.zeros(planes.shape[0], dtype=torch.int64,
                        device=planes.device)
    for i in reversed(range(depth)):
        p = planes[:, 2 + i]
        t = cand & (p if want_max else ~p)
        nonempty = (t != 0).any(dim=1)  # per shard, as the vmap has it
        cand = torch.where(nonempty[:, None], t, cand)
        bit = nonempty if want_max else ~nonempty
        value = value | (bit.to(torch.int64) << i)
    return value, popcount32(cand).sum(dim=1, dtype=torch.int32)


def count_rows_plain(matrix: torch.Tensor, filt: torch.Tensor | None
                     ) -> torch.Tensor:
    """Per-shard popcount of every row of int32[S, R, W] (ANDed with the
    filter row int32[S, W] when given): int32[S, R]. One row at a time,
    so the widened popcount stays [S, W]."""
    cols = []
    for r in range(matrix.shape[1]):
        row = matrix[:, r] if filt is None else matrix[:, r] & filt
        cols.append(popcount32(row).sum(dim=1, dtype=torch.int32))
    return torch.stack(cols, dim=1)


def groupby_level_plain(dims, idxs, filt: torch.Tensor | None = None,
                        planes: torch.Tensor | None = None) -> torch.Tensor:
    """``batch.groupby_level_body`` per shard, stacked: int32[S, K, C],
    K = 1 or 2 + depth (counts, then n and the plane counts under the
    aggregate's exists row). Candidate masks are built in chunks of at
    most GROUPBY_PLAIN_MASK_BYTES."""
    first = dims[0]
    n_shards, row_words = first.shape[0], first.shape[2]
    sel = [torch.as_tensor(np.asarray(ix, np.int64), device=first.device)
           for ix in idxs]
    n_cand = sel[0].numel()
    depth = planes.shape[1] - 2 if planes is not None else 0
    out = torch.zeros((n_shards, 1 if planes is None else 2 + depth, n_cand),
                      dtype=torch.int32, device=first.device)
    chunk = max(1, GROUPBY_PLAIN_MASK_BYTES // (n_shards * row_words * 4))
    for lo in range(0, n_cand, chunk):
        part = slice(lo, lo + chunk)
        mask = first[:, sel[0][part]]
        for d, ii in zip(dims[1:], sel[1:]):
            mask = mask & d[:, ii[part]]
        if filt is not None:
            mask = mask & filt[:, None]
        out[:, 0, part] = popcount32(mask).sum(dim=2, dtype=torch.int32)
        if planes is None:
            continue
        g = mask & planes[:, 0:1]
        out[:, 1, part] = popcount32(g).sum(dim=2, dtype=torch.int32)
        for b in range(depth):
            out[:, 2 + b, part] = popcount32(planes[:, 2 + b:3 + b] & g).sum(
                dim=2, dtype=torch.int32)
    return out


# ------------------------------------------------------------ K9's plan


class GroupPlan:
    """K9's host plan for one GroupBy level.

    Candidates are sorted lexicographically by their row in each
    dimension (``order[i]`` is the caller's position of sorted candidate
    i) and cut into *tiles*, contiguous runs of sorted candidates whose
    distinct rows fit a block's shared memory; a block stages each of its
    tile's distinct rows once per word tile and evaluates every candidate
    of the tile from there. A tile's *slots* are its staged rows, in the
    order [filter] + dimension rows + [exists, bit planes]; a *group* is
    a run of at most GROUPBY_GROUP_MAX candidates of one tile that share
    their rows in every dimension but the last (their AND, the group's
    prefix, is built once per word); with the aggregate a group is one
    candidate. A *unit* is a group, or with the aggregate one *part* of
    a candidate's plane counts (``part_planes`` planes; part 0 also
    counts the mask and n). Each of the block's GROUPBY_WARPS warps
    walks its own list of units over every word tile; the lists balance
    the units' popcounts (longest first, onto the least-loaded warp).

    Arrays (int32): ``tiles`` [T, 6] (first slot, slots, first group,
    groups, first candidate, candidates), ``slots`` [N, 2] (source: a
    dimension 0..15, GROUPBY_SRC_FILT or GROUPBY_SRC_PLANES; row),
    ``groups`` [G, 2] (first sorted candidate, count), ``cslots`` [C,
    n_dims] (each sorted candidate's slot per dimension, tile-local),
    ``cout`` [C] (``order``), ``units`` [U, 2] (group, part), ``warps``
    [T, GROUPBY_WARPS + 1] (each warp's first unit, then the end).
    ``packed`` holds them back to back at ``offsets``. ``tile_words``
    (TW), ``chunk_elems`` (word groups per lane per step) and
    ``smem_bytes`` size the launch."""

    def __init__(self, n_dims: int, has_filt: bool, depth: int | None,
                 order, tiles, slots, groups, cslots, units, warps,
                 part_planes: int, tile_words: int, chunk_elems: int,
                 smem_bytes: int):
        self.n_dims = n_dims
        self.has_filt = has_filt
        self.depth = depth
        self.order = order
        self.tiles = tiles
        self.slots = slots
        self.groups = groups
        self.cslots = cslots
        self.cout = order.astype(np.int32)
        self.units = units
        self.warps = warps
        self.part_planes = part_planes
        self.tile_words = tile_words
        self.chunk_elems = chunk_elems
        self.smem_bytes = smem_bytes
        parts = [tiles, slots, groups, cslots, self.cout, units, warps]
        sizes = np.cumsum([0] + [a.size for a in parts])
        self.offsets = tuple(int(x) for x in sizes[:-1])
        self.packed = np.ascontiguousarray(np.concatenate(
            [a.reshape(-1) for a in parts]).astype(np.int32))
        self._device: dict = {}
        self._lock = threading.Lock()

    @property
    def staged_rows(self) -> int:
        """Rows staged per shard, summed over tiles: the HBM bytes of a
        level are staged_rows x shards x row words x 4."""
        return int(self.tiles[:, 1].sum())

    def meta(self) -> list:
        """The launch's int[12]: tiles, the seven array offsets, TW, the
        chunk, the planes of a part and the shared-memory bytes."""
        return [len(self.tiles), *self.offsets, self.tile_words,
                self.chunk_elems, self.part_planes, self.smem_bytes]

    def on(self, device) -> torch.Tensor:
        """The packed plan on ``device`` (copied once, then kept)."""
        with self._lock:
            t = self._device.get(device)
            if t is None:
                t = torch.from_numpy(self.packed).pin_memory().to(
                    device, non_blocking=True)
                self._device[device] = t
        return t


def _tile_bytes(n_slots: int, n_cands: int, k: int, tile_words: int) -> int:
    return GROUPBY_SMEM_RESERVE + 8 * n_slots * tile_words + 4 * n_cands * k


def _cut_tiles(cands: np.ndarray, fixed: int, k: int, max_slots: int):
    """[(lo, hi)] runs of the sorted candidates [C, n_dims] whose distinct
    rows, plus ``fixed`` rows every tile stages, fit max_slots and the
    shared memory at the smallest word tile."""
    n_cand = cands.shape[0]
    tw = GROUPBY_TILE_WORDS[-1]

    def fits(n_slots, n):
        return (n_slots <= max_slots and
                _tile_bytes(n_slots, n, k, tw) <= GROUPBY_SMEM_BYTES)

    whole = fixed + sum(np.unique(cands[:, d]).size
                        for d in range(cands.shape[1]))
    if fits(whole, n_cand):
        return [(0, n_cand)]
    out, lo, seen = [], 0, set()
    for c in range(n_cand):
        new = {(d, int(r)) for d, r in enumerate(cands[c])} - seen
        if c > lo and not fits(fixed + len(seen) + len(new), c - lo + 1):
            out.append((lo, c))
            lo, seen = c, set()
            new = {(d, int(r)) for d, r in enumerate(cands[c])}
        seen |= new
        if not fits(fixed + len(seen), 1):
            raise ValueError("one GroupBy candidate's rows do not fit K9's "
                             "shared memory")
    out.append((lo, n_cand))
    return out


def _groups(cands: np.ndarray, lo: int, hi: int, group_max: int) -> list:
    """[(first, count)] of one tile: runs of sorted candidates with one
    prefix (every dimension's row but the last), at most group_max."""
    cut = np.zeros(hi - lo, bool)
    cut[0] = True
    if cands.shape[1] > 1:
        cut[1:] = (cands[lo + 1:hi, :-1] != cands[lo:hi - 1, :-1]).any(1)
    starts = np.flatnonzero(cut)
    ends = np.append(starts[1:], hi - lo)
    out = []
    for a, b in zip(starts.tolist(), ends.tolist()):
        out += [(lo + c, min(group_max, b - c))
                for c in range(a, b, group_max)]
    return out


# A unit's cost in popcount rows, beside its popcounts: building the
# prefix (a staged row read and ANDed, per row) and its fixed overhead
_PREFIX_COST = 0.25
_UNIT_COST = 6.0


def _units(groups: list, n_prefix: int, depth: int | None,
           part_planes: int) -> list:
    """[(group, part, cost)] of one tile's groups (indices local)."""
    out = []
    for g, (_, k) in enumerate(groups):
        if depth is None:
            out.append((g, 0, k + _PREFIX_COST * n_prefix + _UNIT_COST))
            continue
        for part in range(max(1, -(-depth // part_planes))):
            planes = min(part_planes, depth - part * part_planes)
            out.append((g, part, planes + 2 * (part == 0)
                        + _PREFIX_COST * (n_prefix + 2) + _UNIT_COST))
    return out


def _assign(units: list) -> tuple[list, float, float]:
    """Each warp's units (longest first onto the least-loaded warp), the
    busiest warp's load and that over the mean load."""
    heap = [(0.0, w) for w in range(GROUPBY_WARPS)]
    lists: list = [[] for _ in range(GROUPBY_WARPS)]
    for g, part, cost in sorted(units, key=lambda u: -u[2]):
        load, w = heapq.heappop(heap)
        heapq.heappush(heap, (load + cost, w))
        lists[w].append((g, part))
    busiest = max(load for load, _ in heap)
    return lists, busiest, busiest * GROUPBY_WARPS / sum(u[2] for u in units)


def groupby_plan(idxs, has_filt: bool, depth: int | None, row_words: int,
                 vec: bool, max_slots: int = GROUPBY_MAX_SLOTS,
                 tile_words: int | None = None,
                 chunk_elems: int | None = None,
                 group_max: int | None = None) -> GroupPlan:
    """K9's plan (``GroupPlan``) for candidate index arrays ``idxs`` (one
    int array of C rows per dimension), a filter or none, the aggregate's
    depth (None: no aggregate), over rows of ``row_words`` words.
    ``max_slots`` caps a tile's staged rows (tests lower it to force a
    split). The plan picks the group size (without the aggregate) or the
    planes of a part (with it) that balance the warps best, the word tile
    (the largest that lets two blocks share an SM, else the largest that
    fits) and the chunk (as many word groups a lane as the tile holds, up
    to 4); ``tile_words``, ``chunk_elems`` and ``group_max`` force them
    (measurements; with the aggregate ``group_max`` sets the planes of a
    part)."""
    idx = np.stack([np.asarray(ix, np.int64).reshape(-1) for ix in idxs])
    n_dims, n_cand = idx.shape
    order = np.lexsort(idx[::-1])
    cands = np.ascontiguousarray(idx[:, order].T)
    k = 1 if depth is None else 2 + depth
    fixed = int(has_filt) + (0 if depth is None else 1 + depth)
    bounds = _cut_tiles(cands, fixed, k, max_slots)
    slots, tiles = [], []
    cslots = np.zeros((n_cand, n_dims), np.int32)
    for lo, hi in bounds:
        part = cands[lo:hi]
        local = [(GROUPBY_SRC_FILT, 0)] if has_filt else []
        for d in range(n_dims):
            rows, inv = np.unique(part[:, d], return_inverse=True)
            cslots[lo:hi, d] = len(local) + inv.reshape(-1)
            local += [(d, int(r)) for r in rows]
        if depth is not None:
            local += [(GROUPBY_SRC_PLANES, 0)] + [
                (GROUPBY_SRC_PLANES, 2 + b) for b in range(depth)]
        tiles.append((len(slots), len(local), lo, hi - lo))
        slots += local
    n_prefix = int(has_filt) + n_dims - 1
    choices = [group_max] if group_max else (
        range(GROUPBY_GROUP_MAX, 0, -1))
    best = None
    for gm in choices:  # group size, or planes of a part
        per_tile = []
        worst = spread = 0.0
        for _, _, lo, n in tiles:
            groups = _groups(cands, lo, lo + n,
                             1 if depth is not None else gm)
            lists, busiest, ratio = _assign(_units(groups, n_prefix, depth,
                                                   gm))
            per_tile.append((groups, lists))
            worst, spread = max(worst, busiest), max(spread, ratio)
        if best is None or worst < best[0] - 1e-9:
            best = (worst, gm, per_tile)
        if spread <= 1.05:  # balanced: smaller units only cost more
            break
    _, gm, per_tile = best
    groups, units, warps, packed_tiles = [], [], [], []
    for (slot0, n_slots, lo, n), (tile_groups, lists) in zip(tiles,
                                                              per_tile):
        packed_tiles.append((slot0, n_slots, len(groups), len(tile_groups),
                             lo, n))
        first = len(groups)
        groups += tile_groups
        offs = [len(units)]
        for w in lists:
            units += [(first + g, part) for g, part in w]
            offs.append(len(units))
        warps.append(offs)

    kw = 4 if vec else 1
    cap = -(-row_words // kw) * kw

    def launch_bytes(tw):
        return max(_tile_bytes(n, c, k, min(tw, cap))
                   for _, n, _, c in tiles)

    if tile_words is None:
        tile_words = ([tw for tw in GROUPBY_TILE_WORDS
                       if 2 * launch_bytes(tw) <= GROUPBY_SMEM_BYTES] +
                      [tw for tw in GROUPBY_TILE_WORDS
                       if launch_bytes(tw) <= GROUPBY_SMEM_BYTES])[0]
    elif tile_words % 4 or launch_bytes(tile_words) > GROUPBY_SMEM_BYTES:
        raise ValueError(f"word tile {tile_words} does not fit")
    tw = min(tile_words, cap)
    if chunk_elems is None:
        chunk_elems = next(c for c in (4, 2, 1) if c == 1 or
                           32 * c <= tw // kw)
    elif chunk_elems not in (1, 2, 4):
        raise ValueError("chunk_elems is 1, 2 or 4")
    return GroupPlan(n_dims, has_filt, depth, order,
                     np.array(packed_tiles, np.int32).reshape(-1, 6),
                     np.array(slots, np.int32).reshape(-1, 2),
                     np.array(groups, np.int32).reshape(-1, 2), cslots,
                     np.array(units, np.int32).reshape(-1, 2),
                     np.array(warps, np.int32).reshape(-1, GROUPBY_WARPS + 1),
                     gm if depth is not None else GROUPBY_GROUP_MAX, tw,
                     chunk_elems, launch_bytes(tile_words))


_GROUPBY_PLANS: dict = {}
_plans_lock = threading.Lock()


def _cached_plan(host_idx, has_filt, depth, row_words, vec) -> GroupPlan:
    idx = np.ascontiguousarray(np.stack(host_idx).astype(np.int32))
    key = (idx.shape, idx.tobytes(), has_filt, depth, row_words, vec)
    with _plans_lock:
        plan = _GROUPBY_PLANS.get(key)
    if plan is None:
        plan = groupby_plan(list(idx), has_filt, depth, row_words, vec)
        with _plans_lock:
            if len(_GROUPBY_PLANS) >= 64:
                _GROUPBY_PLANS.clear()
            _GROUPBY_PLANS[key] = plan
    return plan


def groupby_plan_plain(plan: GroupPlan, dims, filt=None, planes=None
                       ) -> torch.Tensor:
    """The level evaluated the way K9 walks its plan, on whole tensors:
    per tile the staged rows gathered by slot, per warp its units, per
    unit the group's prefix (the filter and every dimension but the last)
    built once, then each candidate's mask and counts (with the aggregate
    the part's plane counts) added at its caller position. Tests hold it
    against ``groupby_level_plain``."""
    first = dims[0]
    n_shards = first.shape[0]
    depth = plan.depth or 0
    k = 1 if plan.depth is None else 2 + depth
    out = torch.zeros((n_shards, k, plan.cout.size), dtype=torch.int32,
                      device=first.device)

    def count(m):
        return popcount32(m).sum(dim=1, dtype=torch.int32)

    for t, (slot0, n_slots, _, _, _, _) in enumerate(plan.tiles.tolist()):
        rows = []
        for src, row in plan.slots[slot0:slot0 + n_slots].tolist():
            rows.append(filt if src == GROUPBY_SRC_FILT else
                        planes[:, row] if src == GROUPBY_SRC_PLANES else
                        dims[src][:, row])
        lo, hi = plan.warps[t, 0], plan.warps[t, -1]
        for g, part in plan.units[lo:hi].tolist():
            c0, n = plan.groups[g].tolist()
            pre = torch.full_like(rows[0], -1)
            if plan.has_filt:
                pre = pre & rows[0]
            for d in range(plan.n_dims - 1):
                pre = pre & rows[plan.cslots[c0, d]]
            for c in range(c0, c0 + n):
                m = pre & rows[plan.cslots[c, -1]]
                col = int(plan.cout[c])
                if plan.depth is None:
                    out[:, 0, col] += count(m)
                    continue
                g_rows = m & rows[n_slots - 1 - depth]
                if part == 0:
                    out[:, 0, col] += count(m)
                    out[:, 1, col] += count(g_rows)
                b0 = part * plan.part_planes
                for b in range(b0, min(depth, b0 + plan.part_planes)):
                    out[:, 2 + b, col] += count(
                        rows[n_slots - depth + b] & g_rows)
    return out


def block_gather_plain(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K10's plain version: the 4 KiB blocks ``idx`` of a flat leaf,
    ``int32[len(idx), 1024]``."""
    return flat.view(-1, BLOCK_WORDS).index_select(0, idx.long())


def block_gather_batch_plain(flats, idxs) -> torch.Tensor:
    """K10's batched plain version: each leaf's blocks ``idxs[k]`` (int32
    tensors on the leaves' device), concatenated."""
    return torch.cat([block_gather_plain(f, i) for f, i in zip(flats, idxs)])


def block_scatter_plain(blocks: torch.Tensor, idx: torch.Tensor,
                        n_blocks: int) -> torch.Tensor:
    """K11's plain version: a flat ``int32[n_blocks * 1024]`` leaf of
    zeros with ``blocks[j]`` at block ``idx[j]``. Duplicate indices carry
    identical blocks (the padding), so their order does not matter."""
    out = torch.zeros((n_blocks, BLOCK_WORDS), dtype=torch.int32,
                      device=blocks.device)
    out.index_copy_(0, idx.long(), blocks)
    return out.view(-1)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values taken modulo 2^32 as int32 (an int32 add's result)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def lane_pack_plain(parts: torch.Tensor, groups: int, lane_bytes,
                    mode: str = "sum"):
    """The encode half of K12+K13's plain version, the lanes' semantics.
    ``mode`` "sum": parts int32[M, 2, N] → (lo, hi) lanes [G, N] of
    ``lane_bytes`` = (lo bytes, hi bytes), each the int32 sum over the
    group's members cast to its lane type; "max" / "min": parts [M, N] →
    the group's best [G, N] cast to ``lane_bytes`` bytes."""
    m = parts.shape[0]
    if mode == "sum":
        n = parts.shape[2]
        sums = _wrap32(parts.reshape(groups, m // groups, 2, n).to(
            torch.int64).sum(1))
        lo_b, hi_b = lane_bytes
        return (sums[:, 0].to(LANE_DTYPES[lo_b]).contiguous(),
                sums[:, 1].to(LANE_DTYPES[hi_b]).contiguous())
    v = parts.reshape(groups, m // groups, parts.shape[1])
    best = v.amax(1) if mode == "max" else v.amin(1)
    return best.to(LANE_DTYPES[lane_bytes]).contiguous()


def _widen(lane: torch.Tensor) -> torch.Tensor:
    return lane.to(torch.int64 if lane.dtype == torch.int64 else torch.int32)


def lane_fold_plain(lanes, mode: str = "sum") -> torch.Tensor:
    """The fold half of K12+K13's plain version. "sum": ``lanes`` = (lo
    [G, N], hi [G, N]) widened to int32 and summed over G → int32[2, N];
    "max" / "min": ``lanes`` [G, N] widened (int64 lanes stay int64) and
    folded → [N]."""
    if mode == "sum":
        lo, hi = lanes
        return torch.stack([_wrap32(lo.to(torch.int64).sum(0)),
                            _wrap32(hi.to(torch.int64).sum(0))])
    wide = _widen(lanes)
    return wide.amax(0) if mode == "max" else wide.amin(0)


def lane_reduce_plain(parts, groups: int, lane_bytes, mode: str = "sum"
                      ) -> torch.Tensor:
    """K12+K13's plain version: the members' partials (a sequence of
    member tensors or one stacked [M, ...] tensor, as ``lane_reduce``
    takes them) stacked, then the two lanes' plain halves composed:
    ``lane_fold_plain(lane_pack_plain(...))``."""
    stacked = parts if isinstance(parts, torch.Tensor) else torch.stack(
        list(parts))
    m = stacked.shape[0]
    stacked = stacked.reshape((m, 2, -1) if mode == "sum" else (m, -1))
    return lane_fold_plain(lane_pack_plain(stacked, groups, lane_bytes, mode),
                           mode)


def quant_pack_plain(parts: torch.Tensor, groups: int):
    """The encode half of K14+K15's plain version, the 8-bit lane's
    semantics: parts int32[M, 2, R] → (q uint8[G, nb, 256], scales
    int32[G, nb]), the reference's jnp arithmetic in torch."""
    m, _, rows = parts.shape
    tot = parts.reshape(groups, m // groups, 2, rows).to(torch.int64).sum(1)
    flat = _wrap32(tot[:, 0] + (tot[:, 1] << SPLIT_SHIFT))
    nb = max(1, -(-rows // QUANT_BLOCK))
    blocks = torch.zeros((groups, nb * QUANT_BLOCK), dtype=torch.int32,
                         device=parts.device)
    blocks[:, :rows] = flat
    blocks = blocks.reshape(groups, nb, QUANT_BLOCK)
    mx = blocks.amax(2)
    s = torch.clamp(torch.div(_wrap32(mx.to(torch.int64) + 254), 255,
                              rounding_mode="floor"), min=1)
    num = _wrap32(blocks.to(torch.int64) + (s >> 1)[..., None])
    q = torch.div(num, s[..., None], rounding_mode="floor")
    return q.to(torch.uint8), s.to(torch.int32)


def quant_fold_plain(q: torch.Tensor, scales: torch.Tensor, rows: int
                     ) -> torch.Tensor:
    """The decode half of K14+K15's plain version: q uint8[G, nb, 256]
    and scales int32[G, nb] → the split-form int32[2, rows + nb] of
    approx counts then per-block error bounds."""
    groups, nb, _ = q.shape
    approx = (q.to(torch.int64) * scales.to(torch.int64)[..., None]).sum(0)
    s = scales.to(torch.int64)
    err = torch.where(s > 1, (s + 1) >> 1, 0).sum(0)
    out = _wrap32(torch.cat([approx.reshape(-1)[:rows], err]))
    return torch.stack([out & SPLIT_MASK, out >> SPLIT_SHIFT])


def quant_reduce_plain(parts, groups: int | None) -> torch.Tensor:
    """K14+K15's plain version: the members' split channels (a sequence
    of member tensors [2, R] or [2], or one stacked [M, 2, R] tensor, as
    ``quant_reduce`` takes them) stacked, then the two halves composed:
    ``quant_fold_plain(*quant_pack_plain(...), R)``; ``groups`` None the
    lossless pass-through, the exact sum over the members then nb zero
    bounds → int32[2, R + nb]."""
    stacked = parts if isinstance(parts, torch.Tensor) else torch.stack(
        list(parts))
    stacked = stacked.reshape(stacked.shape[0], 2, -1)
    rows = stacked.shape[2]
    if groups is not None:
        return quant_fold_plain(*quant_pack_plain(stacked, groups), rows)
    tot = stacked.to(torch.int64).sum(0)
    flat = _wrap32(tot[0] + (tot[1] << SPLIT_SHIFT))
    out = torch.cat([flat, flat.new_zeros(-(-rows // QUANT_BLOCK))])
    return torch.stack([out & SPLIT_MASK, out >> SPLIT_SHIFT])


# ----------------------------------------------------------------- wrappers


def _on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (take the plain version); False for a CUDA
    one (launch); raise for anything else."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def tree_count(program, batch_leaves, salts, row_words: int) -> torch.Tensor:
    """K1: ``int32[B, n_words // row_words]`` partial popcounts of the
    program over each query's leaves (queries in ``batch_leaves``, each a
    list of same-shaped int32 tensors). One launch for the whole batch,
    of the form ``classify_program`` gives the program (every query runs
    the same program; a fold's xor mask is per query, from its salt); a
    block walks the form's TREE_COUNT_STEPS steps."""
    first = batch_leaves[0][0] if batch_leaves and batch_leaves[0] else None
    if first is None:
        raise ValueError("tree_count needs at least one leaf")
    n_words = first.numel()
    if n_words < 1 or row_words < 1 or n_words % row_words:
        raise ValueError(f"{n_words} words do not split in rows of {row_words}")
    n_leaves = len(batch_leaves[0])
    if not 1 <= len(batch_leaves) <= MAX_BATCH or n_leaves > MAX_LEAVES:
        raise ValueError("batch or leaf count over the kernel's limits")
    if len(salts) != len(batch_leaves):
        raise ValueError("one salt per query")
    flat = [t for leaves in batch_leaves for t in leaves]
    if any(len(leaves) != n_leaves for leaves in batch_leaves) or any(
            t.numel() != n_words for t in flat):
        raise ValueError("every query needs the same number of equal leaves")
    check_program(program, n_leaves)
    _check_words(flat, first.device)
    if _on_cpu(first):
        return tree_count_plain(program, batch_leaves, salts, row_words)
    lib = _lib("tree_count")
    out = torch.zeros((len(batch_leaves), n_words // row_words),
                      dtype=torch.int32, device=first.device)
    vec = int(row_words % 4 == 0 and _aligned(flat))
    form = classify_program(program) if vec else Form((FORM_GENERAL, 0, (),
                                                       0, 0))
    steps = TREE_COUNT_STEPS[form.kind]
    if form.kind == FORM_GENERAL:
        ptr_list, masks = [t.data_ptr() for t in flat], [0] * len(salts)
        n_ptrs = n_leaves
    else:
        ptr_list = [leaves[i].data_ptr() for leaves in batch_leaves
                    for i in form.leaves]
        masks = [form.xor_mask(s) for s in salts]
        n_ptrs = len(form.leaves)
    ptrs = (ctypes.c_void_p * len(ptr_list))(*ptr_list)
    mask_arr = (ctypes.c_uint32 * len(masks))(*masks)
    salt_arr = (ctypes.c_uint32 * len(salts))(*[_salt_u32(s) for s in salts])
    code = (ctypes.c_int * len(program))(*program)
    rc = lib.tree_count_launch(ptrs, len(batch_leaves), n_ptrs, form.kind,
                               form.op, mask_arr, salt_arr, code,
                               len(program), n_words, row_words, vec, steps,
                               ctypes.c_void_p(out.data_ptr()), _stream(out))
    _check("tree_count", lib, rc)
    _count_launch("tree_count")
    return out


def tree_rows(program, leaves, salt: int = 0) -> torch.Tensor:
    """K2: the program's words over ``leaves`` (same shape as a leaf).
    The program is classified on the host (``classify_program``): a chain
    or head-diff launches its template kernel over the form's leaves, any
    other program the register-stack interpreter."""
    if not leaves:
        raise ValueError("tree_rows needs at least one leaf")
    first = leaves[0]
    if len(leaves) > MAX_LEAVES or any(t.shape != first.shape for t in leaves):
        raise ValueError("tree_rows needs at most 16 leaves of one shape")
    check_program(program, len(leaves))
    _check_words(leaves, first.device)
    if _on_cpu(first):
        return tree_rows_plain(program, leaves, salt)
    lib = _lib("tree_rows")
    out = torch.empty_like(first)
    n_words = first.numel()
    vec = int(n_words % 4 == 0 and _aligned(list(leaves) + [out]))
    form = classify_program(program)
    if not vec:
        form = Form((FORM_GENERAL, 0, (), 0, 0))
    if form.kind == FORM_GENERAL:
        ptr_list, mask = [t.data_ptr() for t in leaves], 0
    else:
        ptr_list = [leaves[i].data_ptr() for i in form.leaves]
        mask = form.xor_mask(salt)
    ptrs = (ctypes.c_void_p * len(ptr_list))(*ptr_list)
    code = (ctypes.c_int * len(program))(*program)
    rc = lib.tree_rows_launch(ptrs, len(ptr_list), form.kind, form.op, mask,
                              _salt_u32(salt), code, len(program), n_words,
                              vec, ctypes.c_void_p(out.data_ptr()),
                              _stream(out))
    _check("tree_rows", lib, rc)
    _count_launch("tree_rows")
    return out


# K3's staging: pinned host buffers a device, each with its device buffer
# and an event recorded behind the launch that last read it. A buffer is
# refilled only once its event has completed. When none is free and large
# enough, a new one is made (a free one too small is replaced by one twice
# its size), so taking a buffer never waits on the card: it runs under the
# residency cache's lock, and an event may sit behind long queued work.
# The pool keeps as many buffers as batches were ever in flight at once.
_pools: dict = {}
_pools_lock = threading.Lock()


class _StagingPool:
    def __init__(self, device):
        self.device = device
        # [pinned tensor, its numpy view, device tensor, event]
        self.slots: list = []
        self.next = 0
        self.lock = threading.Lock()

    def take(self, n_bytes: int):
        """A buffer of at least ``n_bytes`` whose last launch has
        completed; round robin from the last one taken, never waiting."""
        small = None
        for step in range(len(self.slots)):
            k = (self.next + step) % len(self.slots)
            slot = self.slots[k]
            if not slot[3].query():
                continue
            if slot[1].size >= n_bytes:
                self.next = k + 1
                return slot
            small = k if small is None else small
        cap = 4096 if small is None else 2 * self.slots[small][1].size
        while cap < n_bytes:
            cap *= 2
        pinned = torch.empty(cap, dtype=torch.uint8, pin_memory=True)
        slot = [pinned, pinned.numpy(),
                torch.empty(cap, dtype=torch.uint8, device=self.device),
                torch.cuda.Event()]
        if small is None:
            self.slots.append(slot)
            self.next = len(self.slots)
        else:
            self.slots[small] = slot
            self.next = small + 1
        return slot


def _pool(device) -> _StagingPool:
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    with _pools_lock:
        pool = _pools.get(device)
        if pool is None:
            pool = _pools[device] = _StagingPool(device)
        return pool


def _check_patch_targets(targets):
    """Validate a K3 batch; returns (row addresses, run ends, clear flags,
    word indices, masks) as numpy arrays."""
    first = targets[0][0]
    leaves: dict = {}
    rows, counts, clears, words, masks, limits = [], [], [], [], [], []
    for leaf, slot, row, w, m, clear in targets:
        info = leaves.get(id(leaf))
        if info is None:
            _check_words([leaf], first.device)
            info = leaves[id(leaf)] = (leaf.dim(), leaf.shape, leaf.stride(),
                                       leaf.data_ptr(), leaf.element_size())
        dim, shape, stride, ptr, size = info
        if dim != (2 if row is None else 3):
            raise ValueError("word_patch patches a [slots, words] leaf, or "
                             "with a row a [slots, rows, words] leaf")
        if not 0 <= slot < shape[0]:
            raise IndexError(f"slot {slot} outside {shape[0]} slots")
        if row is not None and not 0 <= row < shape[1]:
            raise IndexError(f"row {row} outside {shape[1]} rows")
        if len(w) != len(m) or len(w) == 0:
            raise ValueError("a target needs as many masks as words, and one")
        rows.append(ptr + size * (slot * stride[0] + (
            0 if row is None else row * stride[1])))
        counts.append(len(w))
        clears.append(1 if clear else 0)
        words.append(w)
        masks.append(m)
        limits.append(shape[-1])
    if len(set(rows)) != len(rows):
        raise ValueError("a batch patches each row at most once")
    ends = list(itertools.accumulate(counts))
    if len(words) == 1:  # one run: a write into one row (cheap checks)
        words, masks = np.asarray(words[0]), np.asarray(masks[0])
        bad_order = words.size > 1 and bool((words[1:] <= words[:-1]).any())
        bad_range = words.ndim != 1 or words[0] < 0 or words[-1] >= limits[0]
    else:
        words, masks = np.concatenate(words), np.concatenate(masks)
        ends_a = np.asarray(ends)
        step = np.diff(words)
        step[ends_a[:-1] - 1] = 1  # run boundaries may step down
        bad_order = bool((step <= 0).any())
        bad_range = bool(words[ends_a - np.asarray(counts)].min() < 0 or (
            words[ends_a - 1] >= np.asarray(limits)).any())
    if words.ndim != 1 or words.shape != masks.shape:
        raise ValueError("word indices and masks must be flat and equal")
    # ascending within each run (so unique): no two threads share a word
    if bad_order:
        raise ValueError("a target's word indices must ascend, unique")
    if bad_range:
        raise IndexError("word index outside the row")
    return (np.asarray(rows, np.uint64), ends, np.asarray(clears, np.int32),
            words.astype(np.int32, copy=False),
            masks.astype(np.uint32, copy=False))


def word_patch_pack(targets) -> tuple[np.ndarray, int, int]:
    """The staged blob of a checked K3 batch (csrc/word_patch.cu's
    layout), with its target and pair counts."""
    parts = _check_patch_targets(targets)
    t, n = parts[0].size, parts[3].size
    blob = np.empty(16 * t + 4 + 8 * n, np.uint8)
    _fill_blob(blob, *parts)
    return blob, t, n


def _fill_blob(blob, rows, ends, clears, words, masks) -> None:
    t, n = rows.size, words.size
    blob[:8 * t].view(np.uint64)[:] = rows
    offs = blob[8 * t:12 * t + 4].view(np.int32)
    offs[0] = 0
    offs[1:] = ends
    blob[12 * t + 4:16 * t + 4].view(np.int32)[:] = clears
    blob[16 * t + 4:16 * t + 4 + 4 * n].view(np.int32)[:] = words
    blob[16 * t + 4 + 4 * n:].view(np.uint32)[:] = masks


def word_patch_batch(targets) -> None:
    """K3: every target ``(leaf, slot, row, word_idx, masks, clear)``
    patched in place, one launch for the batch: ``leaf[slot,
    word_idx[i]] |= masks[i]`` (``&= ~masks[i]`` with ``clear``), or into
    ``leaf[slot, row]`` of an ``[S, R, W]`` leaf when ``row`` is not None.
    A target's word indices ascend (unique); a batch holds each row at
    most once, so the order of its targets does not matter. The batch
    travels through a pinned staging buffer that the card has finished
    reading (never waiting for one): one host-to-device copy and one
    launch, issued together by one C call."""
    if not targets:
        return
    first = targets[0][0]
    if _on_cpu(first):
        _check_patch_targets(targets)
        word_patch_batch_plain(targets)
        return
    parts = _check_patch_targets(targets)
    t, n = parts[0].size, parts[3].size
    n_bytes = 16 * t + 4 + 8 * n
    lib = _lib("word_patch")
    stream = torch.cuda.current_stream(first.device)
    pool = _pool(first.device)
    with pool.lock:
        pinned, host, staged, event = pool.take(n_bytes)
        _fill_blob(host[:n_bytes], *parts)
        rc = lib.word_patch_staged_launch(
            ctypes.c_void_p(pinned.data_ptr()),
            ctypes.c_void_p(staged.data_ptr()), n_bytes, t, n,
            ctypes.c_void_p(stream.cuda_stream))
        event.record(stream)
    _check("word_patch", lib, rc)
    _count_launch("word_patch")


def word_patch_launch_staged(staged: torch.Tensor, n_targets: int,
                             n_pairs: int) -> None:
    """K3's launch alone, on a blob already staged on the card (no count:
    for timing the device side)."""
    lib = _lib("word_patch")
    _check("word_patch", lib, lib.word_patch_launch(
        ctypes.c_void_p(staged.data_ptr()), n_targets, n_pairs,
        _stream(staged)))


def launch_floor(device) -> None:
    """An empty kernel launched through K3's C path (the launch floor)."""
    lib = _lib("word_patch")
    stream = torch.cuda.current_stream(device)
    _check("word_patch", lib, lib.word_patch_empty_launch(
        ctypes.c_void_p(stream.cuda_stream)))


def row_shift(words: torch.Tensor, n: int) -> torch.Tensor:
    """K4: every row of int32[S, W] shifted by ``n`` bit positions
    (``ops.bitops.shift`` per row: negative n toward lower positions,
    nothing crosses a row's ends). Returns a new tensor."""
    if words.dim() != 2:
        raise ValueError("row_shift takes [rows, words]")
    _check_words([words], words.device)
    if _on_cpu(words):
        return row_shift_plain(words, n)
    lib = _lib("row_shift")
    out = torch.empty_like(words)
    n_rows, row_words = words.shape
    word_shift, bit_shift = int(n) // 32, int(n) % 32
    # past a whole row every word reads as zero: keep the shift in range
    word_shift = max(-row_words - 1, min(row_words + 1, word_shift))
    rc = lib.row_shift_launch(ctypes.c_void_p(words.data_ptr()),
                              ctypes.c_void_p(out.data_ptr()), n_rows,
                              row_words, word_shift, bit_shift, _stream(out))
    _check("row_shift", lib, rc)
    _count_launch("row_shift")
    return out


def _check_planes(planes: torch.Tensor, rows, max_depth: int) -> int:
    """Validate a stacked planes leaf int32[S, 2 + depth, W] and the
    [S, W] rows used beside it; returns depth."""
    if planes.dim() != 3 or planes.shape[1] < 2:
        raise ValueError("planes must be [shards, 2 + depth, words]")
    depth = planes.shape[1] - 2
    if depth > max_depth:
        raise ValueError(f"bit depth {depth} over the kernel's {max_depth}")
    present = [r for r in rows if r is not None]
    for r in present:
        if r.shape != (planes.shape[0], planes.shape[2]):
            raise ValueError(f"row operand {tuple(r.shape)} does not match "
                             f"planes {tuple(planes.shape)}")
    _check_words([planes, *present], planes.device)
    return depth


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def bsi_compare(planes: torch.Tensor, exists: torch.Tensor, op: str,
                pred: int) -> torch.Tensor:
    """K5: int32[S, W] rows of the columns whose offset-encoded value
    compares ``op`` against ``pred`` (0 <= pred < 2^depth)."""
    if op not in BSI_OPS:
        raise ValueError(f"bad bsi op {op!r}")
    depth = _check_planes(planes, [exists], BSI_MAX_DEPTH)
    if not 0 <= pred < (1 << 63):
        raise ValueError(f"predicate {pred} outside the encoded range")
    if _on_cpu(planes):
        return bsi_compare_plain(planes, exists, op, pred)
    lib = _lib("bsi_compare")
    out = torch.empty_like(exists)
    n_shards, row_words = exists.shape
    vec = int(row_words % 4 == 0 and _aligned([planes, exists, out]))
    rc = lib.bsi_compare_launch(_ptr(planes), _ptr(exists), _ptr(out),
                                n_shards, row_words, depth, pred,
                                BSI_OPS[op], vec, _stream(out))
    _check("bsi_compare", lib, rc)
    _count_launch("bsi_compare")
    return out


def bsi_sum(planes: torch.Tensor, filt: torch.Tensor | None = None
            ) -> torch.Tensor:
    """K6: int32[S, depth + 1] per-shard popcounts of each plane under
    exists (planes row 0) and ``filt`` (None: no filter), then of exists
    & filt."""
    depth = _check_planes(planes, [filt], BSI_MAX_DEPTH)
    if _on_cpu(planes):
        return bsi_sum_plain(planes, filt)
    lib = _lib("bsi_sum")
    n_shards, _, row_words = planes.shape
    out = torch.zeros((n_shards, depth + 1), dtype=torch.int32,
                      device=planes.device)
    tensors = [planes] + ([filt] if filt is not None else [])
    vec = int(row_words % 4 == 0 and _aligned(tensors))
    rc = lib.bsi_sum_launch(_ptr(planes), _ptr(filt), _ptr(out), n_shards,
                            row_words, depth, vec, _stream(out))
    _check("bsi_sum", lib, rc)
    _count_launch("bsi_sum")
    return out


def bsi_minmax(planes: torch.Tensor, filt: torch.Tensor | None,
               want_max: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """K7: per shard the offset-encoded extremum int64[S] and the count of
    candidates holding it int32[S]; count 0 marks a shard without
    candidates."""
    depth = _check_planes(planes, [filt], BSI_MINMAX_MAX_DEPTH)
    if _on_cpu(planes):
        return bsi_minmax_plain(planes, filt, want_max)
    n_shards, _, row_words = planes.shape
    if row_words > MINMAX_MAX_WORDS:
        raise ValueError(f"bsi_minmax takes rows of at most "
                         f"{MINMAX_MAX_WORDS} words")
    lib = _lib("bsi_minmax")
    values = torch.empty(n_shards, dtype=torch.int64, device=planes.device)
    counts = torch.empty(n_shards, dtype=torch.int32, device=planes.device)
    tensors = [planes] + ([filt] if filt is not None else [])
    vec = int(row_words % 4 == 0 and _aligned(tensors))
    rc = lib.bsi_minmax_launch(_ptr(planes), _ptr(filt), n_shards, row_words,
                               depth, int(bool(want_max)), vec, _ptr(values),
                               _ptr(counts), _stream(values))
    _check("bsi_minmax", lib, rc)
    _count_launch("bsi_minmax")
    return values, counts


def count_rows(matrix: torch.Tensor, filt: torch.Tensor | None = None
               ) -> torch.Tensor:
    """K8: int32[S, R] per-shard popcounts of every row of the stacked
    matrix int32[S, R, W], ANDed with the filter row int32[S, W] when
    one is given (None: no filter)."""
    if matrix.dim() != 3 or matrix.shape[1] < 1:
        raise ValueError("count_rows takes a [shards, rows >= 1, words] matrix")
    n_shards, n_rows, row_words = matrix.shape
    if filt is not None and filt.shape != (n_shards, row_words):
        raise ValueError(f"filter {tuple(filt.shape)} does not match matrix "
                         f"{tuple(matrix.shape)}")
    _check_words([matrix] + ([filt] if filt is not None else []),
                 matrix.device)
    if _on_cpu(matrix):
        return count_rows_plain(matrix, filt)
    lib = _lib("count_rows")
    out = torch.zeros((n_shards, n_rows), dtype=torch.int32,
                      device=matrix.device)
    tensors = [matrix] + ([filt] if filt is not None else [])
    vec = int(row_words % 4 == 0 and _aligned(tensors))
    rc = lib.count_rows_launch(_ptr(matrix), _ptr(filt), _ptr(out), n_shards,
                               n_rows, row_words, vec, _stream(out))
    _check("count_rows", lib, rc)
    _count_launch("count_rows")
    return out


def groupby_level(dims, idxs, filt: torch.Tensor | None = None,
                  planes: torch.Tensor | None = None,
                  plan: GroupPlan | None = None) -> torch.Tensor:
    """K9: one GroupBy level, int32[S, K, C] per-shard counts. ``dims``:
    up to MAX_LEAVES stacked dimension matrices int32[S, n_d, W];
    ``idxs``: one host integer array of C candidate row positions per
    dimension; ``filt``: int32[S, W] or None; ``planes``: the aggregate's
    int32[S, 2 + depth, W] or None. K is 1 (counts) or 2 + depth (counts,
    n, plane counts). ``plan`` replaces the cached host plan (it must be
    ``groupby_plan``'s for these arguments; measurements compare
    plans)."""
    if not 1 <= len(dims) <= MAX_LEAVES or len(idxs) != len(dims):
        raise ValueError(f"groupby_level takes 1..{MAX_LEAVES} dimensions, "
                         "one index array each")
    first = dims[0]
    if any(d.dim() != 3 or d.shape[0] != first.shape[0]
           or d.shape[2] != first.shape[2] for d in dims):
        raise ValueError("dimension matrices must be [shards, rows, words] "
                         "over one shard block")
    n_shards, row_words = first.shape[0], first.shape[2]
    host_idx = [np.asarray(ix, np.int64).reshape(-1) for ix in idxs]
    n_cand = host_idx[0].size
    if n_cand < 1 or any(ix.size != n_cand for ix in host_idx):
        raise ValueError("every dimension needs the same candidate count >= 1")
    for ix, d in zip(host_idx, dims):
        if ix.min() < 0 or ix.max() >= d.shape[1]:
            raise IndexError("candidate row outside its dimension matrix")
    if filt is not None and filt.shape != (n_shards, row_words):
        raise ValueError(f"filter {tuple(filt.shape)} does not match "
                         f"[{n_shards}, {row_words}]")
    depth = 0
    if planes is not None:
        depth = _check_planes(planes, [filt], GROUPBY_MAX_DEPTH)
        if planes.shape[0] != n_shards or planes.shape[2] != row_words:
            raise ValueError("planes do not match the dimension matrices")
    tensors = list(dims) + [t for t in (filt, planes) if t is not None]
    _check_words(tensors, first.device)
    if _on_cpu(first):
        return groupby_level_plain(dims, host_idx, filt, planes)
    lib = _lib("groupby_level")
    vec = row_words % 4 == 0 and _aligned(tensors)
    agg_depth = depth if planes is not None else None
    if plan is None:
        plan = _cached_plan(host_idx, filt is not None, agg_depth, row_words,
                            vec)
    elif (plan.n_dims, plan.cout.size, plan.has_filt, plan.depth) != (
            len(dims), n_cand, filt is not None, agg_depth):
        raise ValueError("the plan was made for another level")
    if int(plan.tiles[:, 1].max()) > GROUPBY_MAX_SLOTS:
        raise ValueError("a candidate tile stages more rows than K9 takes")
    dev_plan = plan.on(first.device)
    out = torch.empty((n_shards, 1 if planes is None else 2 + depth, n_cand),
                      dtype=torch.int32, device=first.device)
    ptrs = (ctypes.c_void_p * len(dims))(*[d.data_ptr() for d in dims])
    rows = (ctypes.c_longlong * len(dims))(*[d.shape[1] for d in dims])
    meta = (ctypes.c_int * 12)(*plan.meta())
    rc = lib.groupby_level_launch(ptrs, rows, len(dims), _ptr(dev_plan), meta,
                                  _ptr(filt), _ptr(planes), depth, n_shards,
                                  row_words, int(vec), n_cand, _ptr(out),
                                  _stream(out))
    _check("groupby_level", lib, rc)
    _count_launch("groupby_level")
    return out


def _check_blocks(idx: torch.Tensor, *tensors) -> None:
    if idx.dtype != torch.int32 or idx.dim() != 1 or idx.numel() < 1:
        raise ValueError("block index must be a non-empty int32 vector")
    _check_words([idx, *tensors], idx.device)
    if idx.device.type == "cuda" and not _aligned(tensors):
        raise ValueError("block kernels take 16-byte aligned words")


def _raw_stream(card: int) -> int:
    """The current stream of card ``card`` as an int, without building a
    ``torch.cuda.Stream`` (K10's single call is host-bound)."""
    return torch._C._cuda_getCurrentRawStream(card)


def block_gather(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K10: the 4 KiB blocks ``idx`` (int32, on the leaf's device) of the
    flat int32 leaf ``flat``, compacted to ``int32[len(idx), 1024]``; an
    index outside the leaf gives a zero block on the card. One launch,
    the one-leaf case of ``block_gather_batch``'s kernel."""
    # the checks inline, in the cheapest calls (the call is host-bound):
    # one leaf of whole blocks and one non-empty index, int32,
    # contiguous, on one device
    n_out = idx.numel()
    card = flat.get_device()
    if flat.dim() != 1 or flat.numel() % BLOCK_WORDS or idx.dim() != 1 \
            or not 0 < n_out < 1 << 31 or flat.dtype is not torch.int32 \
            or idx.dtype is not torch.int32 or not flat.is_contiguous() \
            or not idx.is_contiguous() or card != idx.get_device() \
            or flat.is_cuda != idx.is_cuda:
        raise ValueError(f"block_gather takes a flat int32 leaf of whole "
                         f"{BLOCK_WORDS}-word blocks and a non-empty int32 "
                         f"index on its device")
    if not flat.is_cuda:
        _on_cpu(flat)  # raises for a device that is neither
        return block_gather_plain(flat, idx)
    if (flat.data_ptr() | idx.data_ptr()) & 15:
        raise ValueError("block kernels take 16-byte aligned words")
    lib = _lib("block_gather")
    out = flat.new_empty((n_out, BLOCK_WORDS))
    rc = lib.block_gather_launch(
        flat.data_ptr(), idx.data_ptr(), out.data_ptr(),
        flat.numel() // BLOCK_WORDS, n_out, _raw_stream(card))
    if rc:
        _check("block_gather", lib, rc)
    _count_launch("block_gather")
    return out


_GATHER_LEAF_BYTES = 32  # a leaf's entry in K10's batch table
_GATHER_INLINE_ROWS = 960  # an index K10 takes in its launch parameters


def _gather_operand(t: torch.Tensor, shape: tuple, device) -> int:
    """The address of one of K10's batch operands, checked: int32,
    contiguous, ``shape``, on ``device``, 16-byte aligned on the card."""
    if t.dtype is not torch.int32 or t.shape != shape \
            or not t.is_contiguous() or t.device != device:
        raise ValueError(f"block_gather_batch takes contiguous int32 "
                         f"{list(shape)} tensors on {device}, got "
                         f"{t.dtype} {list(t.shape)} on {t.device}")
    ptr = t.data_ptr()
    if ptr & 15 and t.is_cuda:
        raise ValueError("block kernels take 16-byte aligned words")
    return ptr


def _gather_leaf(f: torch.Tensor, i: np.ndarray, out: torch.Tensor,
                 with_index: bool, device) -> tuple:
    """One leaf of a K10 batch, checked: its address, 4 KiB blocks,
    output and index copy (0: none)."""
    if type(i) is not np.ndarray or i.dtype.char != "i" or i.ndim != 1 \
            or not i.size or not i.flags.c_contiguous:
        raise ValueError("block indices must be non-empty int32 host "
                         "vectors")
    words = f.numel()
    if f.dim() != 1 or not words or words % BLOCK_WORDS:
        raise ValueError(f"block_gather_batch takes flat leaves of whole "
                         f"{BLOCK_WORDS}-word blocks")
    m = i.size
    dst = _gather_operand(out, (m * (BLOCK_WORDS + with_index),), device)
    return (_gather_operand(f, (words,), device), words // BLOCK_WORDS, dst,
            dst + 4 * BLOCK_WORDS * m if with_index else 0)


def _gather_table(flats, idxs, outs, with_index: bool
                  ) -> tuple[np.ndarray, int]:
    """The checked table of a K10 batch (csrc/block_gather.cu's layout)
    and the byte offset of its indices: each leaf's address, block
    count, output and index copy (0: none), the row starts, then the
    concatenated padded indices."""
    n = len(flats)
    device = flats[0].device
    leaves, start = [], [0]
    for f, i, out in zip(flats, idxs, outs):
        leaves += _gather_leaf(f, i, out, with_index, device)
        start.append(start[-1] + i.size)
    if start[-1] >= 1 << 31:
        raise ValueError("block_gather_batch: over 2^31 output blocks")
    head = _GATHER_LEAF_BYTES * n
    offset = (head + 4 * (n + 1) + 15) // 16 * 16
    blob = np.zeros(offset + 4 * start[-1], np.uint8)
    blob[:head].view(np.int64)[:] = leaves
    blob[head:head + 4 * (n + 1)].view(np.int32)[:] = start
    np.concatenate(idxs, out=blob[offset:].view(np.int32))
    return blob, offset


def block_gather_batch(flats, idxs, outs, *, with_index: bool = False
                       ) -> None:
    """K10 over a batch, one launch: the blocks ``idxs[k]`` (a non-empty
    host int32 vector of m entries) of each flat int32 leaf ``flats[k]``
    of whole 4 KiB blocks, written to the flat int32 ``outs[k]``: its
    ``m * 1024`` words, then, ``with_index``, ``idxs[k]`` itself (the
    device index K11 later reads; ``outs[k]`` then has ``m * 1025``
    words), all on one device. One leaf with at most 960 indices (a
    month leaf's 512) passes them in the launch's parameters; a larger
    batch's table and indices travel through a pinned staging buffer
    (never waiting for one), copied and launched by one C call."""
    n = len(flats)
    if not n or len(idxs) != n or len(outs) != n:
        raise ValueError("block_gather_batch takes one index and one "
                         "output a leaf")
    first = flats[0]
    if n == 1 and first.is_cuda and idxs[0].size <= _GATHER_INLINE_ROWS:
        # the cache's one victim: its index in the launch's parameters
        idx = idxs[0]
        flat, n_blocks, out, copy = _gather_leaf(first, idx, outs[0],
                                                 with_index, first.device)
        lib = _lib("block_gather")
        rc = lib.block_gather_inline_launch(
            flat, n_blocks, idx.ctypes.data, idx.size, out, copy,
            _raw_stream(first.get_device()))
        if rc:
            _check("block_gather", lib, rc)
        _count_launch("block_gather")
        return
    blob, offset = _gather_table(flats, idxs, outs, with_index)
    if _on_cpu(first):
        for f, i, out in zip(flats, idxs, outs):
            m = i.size * BLOCK_WORDS
            out[:m].copy_(block_gather_plain(f, torch.from_numpy(i))
                          .view(-1))
            if with_index:
                out[m:].copy_(torch.from_numpy(i))
        return
    lib = _lib("block_gather")
    device = first.device
    stream = torch.cuda.current_stream(device)
    pool = _pool(device)
    with pool.lock:
        _, host, staged, event = pool.take(blob.size)
        host[:blob.size] = blob
        rc = lib.block_gather_batch_launch(
            host.ctypes.data, staged.data_ptr(), blob.size, offset, n,
            (blob.size - offset) // 4, stream.cuda_stream)
        event.record(stream)
    _check("block_gather", lib, rc)
    _count_launch("block_gather")
    if n > 1:
        _count_launch("block_gather_batch")


def block_scatter(blocks: torch.Tensor, idx: torch.Tensor, n_blocks: int,
                  block_idx: np.ndarray) -> torch.Tensor:
    """K11: the flat ``int32[n_blocks * 1024]`` leaf holding ``blocks[j]``
    at block ``idx[j]`` and zeros elsewhere, one pass, one launch.
    ``block_idx`` is the host copy of the real prefix of ``idx`` (the
    rest repeats a real index with identical data); it must ascend
    strictly, which is checked here, because the kernel searches it."""
    if blocks.dim() != 2 or blocks.shape[1] != BLOCK_WORDS \
            or blocks.shape[0] != idx.numel():
        raise ValueError(f"block_scatter takes int32[len(idx), "
                         f"{BLOCK_WORDS}] blocks")
    _check_blocks(idx, blocks)
    nb = len(block_idx)
    if nb > idx.numel() or not 1 <= n_blocks < (1 << 31):
        raise ValueError("block_scatter: bad block counts")
    if nb and (np.any(np.diff(block_idx) <= 0) or block_idx[0] < 0
               or block_idx[-1] >= n_blocks):
        raise ValueError("block_scatter: the real block indices must "
                         "ascend strictly within the leaf")
    if _on_cpu(blocks):
        return block_scatter_plain(blocks, idx, n_blocks)
    lib = _lib("block_scatter")
    out = torch.empty(n_blocks * BLOCK_WORDS, dtype=torch.int32,
                      device=blocks.device)
    rc = lib.block_scatter_launch(_ptr(blocks), _ptr(idx), nb, _ptr(out),
                                  n_blocks, _stream(out))
    _check("block_scatter", lib, rc)
    _count_launch("block_scatter")
    return out


def intersect_count(a: torch.Tensor, b: torch.Tensor, salt: int = 0
                    ) -> torch.Tensor:
    """The Pallas kernel's contract (``bench_pallas.pallas_intersect_count``):
    per-row ``sum(popcount(a & (b ^ salt)))`` over int32[R, W] → int32[R],
    through K1 with one output row per input row."""
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError("intersect_count takes two equal [R, W] tensors")
    program = (OP_LEAF, OP_LEAF | (1 << 8), OP_SALT, OP_AND)
    return tree_count(program, [[a, b]], [salt], a.shape[1])[0]


# ----------------------------------------------------------- mesh lanes


def _lane_layout(shape, strides, mode: str) -> tuple:
    """(n, channel stride, element stride) of one member's partial of
    ``shape`` and ``strides``: "sum" takes [2, N] (or [2]: N = 1), the
    extrema [N] (or 0-d)."""
    if mode == "sum":
        if len(shape) == 1 and shape[0] == 2:
            return 1, strides[0], 1
        if len(shape) != 2 or shape[0] != 2 or shape[1] < 1:
            raise ValueError("a split-channel partial is [2, n] or [2]")
        n = shape[1]
        chan, elem = strides
        # the two channels' n elements must be 2n distinct addresses
        if chan == 0 or (n > 1 and (elem == 0 or (
                chan % elem == 0 and chan < n * elem))):
            raise ValueError("a partial's channels overlap")
        return n, chan, elem
    if not shape:
        return 1, 0, 1
    if len(shape) != 1 or shape[0] < 1:
        raise ValueError("an extremum partial is [n] or 0-d")
    if shape[0] > 1 and strides[0] == 0:
        raise ValueError("a partial's elements overlap")
    return shape[0], 0, strides[0]


_fns: dict = {}


def _launch_fn(name: str):
    """The bound C launch function of ``name``, looked up once."""
    fn = _fns.get(name)
    if fn is None:
        fn = _fns[name] = getattr(_lib(name), f"{name}_launch")
    return fn


def _walk_members(parts, groups: int) -> tuple:
    """One pass over the members' partials that a mesh reduce takes (a
    sequence of M member tensors of one dtype, device, shape and strides,
    or one stacked [M, ...] tensor; 1 <= M <= 64, ``groups`` dividing M)
    → (M, the first member, its shape, its strides, the members'
    addresses)."""
    stacked = isinstance(parts, torch.Tensor)
    m = parts.shape[0] if stacked and parts.dim() else len(parts)
    if not 1 <= m <= LANE_MAX_MEMBERS:
        raise ValueError(f"{m} members: a mesh reduce takes 1 to "
                         f"{LANE_MAX_MEMBERS}")
    if groups < 1 or m % groups:
        raise ValueError(f"{groups} groups over {m} members")
    if stacked:
        strides = parts.stride()
        step = strides[0] * parts.element_size()
        base = parts.data_ptr()
        return (m, parts, parts.shape[1:], strides[1:],
                [base + k * step for k in range(m)])
    first = parts[0]
    dtype, device = first.dtype, first.device
    shape, strides = first.shape, first.stride()
    ptrs = []
    for t in parts:
        if t.dtype != dtype:
            raise TypeError("the members' partials differ in dtype")
        if t.device != device:
            raise ValueError("the members' partials lie on different "
                             "devices")
        if t.stride() != strides or t.shape != shape:
            raise ValueError("the members' partials differ in layout")
        ptrs.append(t.data_ptr())
    return m, first, shape, strides, ptrs


def _lane_prepare(parts, groups: int, lane_bytes, mode: str):
    """Check lane_reduce's arguments in one pass over the members; None
    for partials on the CPU, else (the bound C function, its arguments:
    the packed blob csrc/lane_reduce.cu reads, the output's address and
    the stream, and the output)."""
    code = _LANE_MODES.get(mode)
    if code is None:
        raise ValueError(f"bad lane mode {mode!r}")
    m, first, shape, strides, ptrs = _walk_members(parts, groups)
    dtype, device = first.dtype, first.device
    if mode == "sum":
        lo_b, hi_b = lane_bytes
        if dtype != torch.int32:
            raise TypeError(f"split channels are int32, not {dtype}")
        if lo_b not in (1, 2, 4) or hi_b not in (1, 2, 4):
            raise ValueError(f"bad lane widths {lane_bytes!r}")
    else:
        lo_b, hi_b = lane_bytes, 0
        if dtype != torch.int32 and dtype != torch.int64:
            raise TypeError(f"extrema are int32 or int64, not {dtype}")
        if lo_b not in LANE_DTYPES:
            raise ValueError(f"bad lane width {lane_bytes!r}")
    n, chan, elem = _lane_layout(shape, strides, mode)
    if _on_cpu(first):
        return None
    fn = _launch_fn("lane_reduce")
    out = torch.empty(2, n, dtype=torch.int32, device=device) if mode == \
        "sum" else torch.empty(n, dtype=torch.int64 if lo_b == 8 else
                               torch.int32, device=device)
    blob = struct.pack(f"9q{m}Q", m, groups, first.element_size(), lo_b,
                       hi_b, code, n, chan, elem, *ptrs)
    # the current stream's handle, without a torch.cuda.Stream object
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    return fn, (blob, out.data_ptr(), stream), out


def lane_reduce(parts, groups: int, lane_bytes, mode: str = "sum"
                ) -> torch.Tensor:
    """K12+K13: a mesh's reduce of its members' partials, one launch that
    reads them in place. ``parts``: a sequence of M member tensors of one
    dtype, device, shape and strides, or one stacked [M, ...] tensor;
    group g is members g·M/G .. (g+1)·M/G - 1, M <= 64. ``mode`` "sum":
    each member's int32 split channels [2, N] (any strides: a [B, 2]
    partial passes as its transposed view) or [2]; each group's sum is
    cast to its lane of ``lane_bytes`` = (lo bytes, hi bytes) in (1, 2,
    4) and widened back, and the groups summed → int32[2, N]. "max" /
    "min": each member's int32 or int64 [N] or 0-d; each group's best is
    cast to its lane of ``lane_bytes`` in (1, 2, 4, 8) and widened back,
    and the groups folded → [N], int64 for an 8-byte lane, else int32.
    The flat mesh is ``groups`` 1 with lanes as wide as the partials."""
    prep = _lane_prepare(parts, groups, lane_bytes, mode)
    if prep is None:
        return lane_reduce_plain(parts, groups, lane_bytes, mode)
    return _run_prepared("lane_reduce", prep)


def lane_reduce_staged(parts, groups: int, lane_bytes, mode: str = "sum"):
    """lane_reduce's C call alone, its arguments built once, into one
    output (no count): a function that makes the call, for timing the
    ctypes call and the launch apart from the wrapper's Python."""
    return _staged("lane_reduce", _lane_prepare(parts, groups, lane_bytes,
                                                mode))


def _run_prepared(name: str, prep) -> torch.Tensor:
    """Make a mesh reduce's prepared C call, count its launch and return
    its output."""
    fn, args, out = prep
    rc = fn(*args)
    if rc:
        _check(name, _lib(name), rc)
    _count_launch(name)
    return out


def _staged(name: str, prep):
    """A function that makes a mesh reduce's prepared C call again and
    again into one output, uncounted."""
    fn, args, out = prep
    lib = _lib(name)

    def call() -> torch.Tensor:
        _check(name, lib, fn(*args))
        return out  # held while the call lives: the kernel writes it

    return call


def _quant_prepare(parts, groups: int | None):
    """Check quant_reduce's arguments in the members' one pass; None for
    partials on the CPU, else (the bound C function, its arguments: the
    packed blob csrc/quant_reduce.cu reads, the output's address and the
    stream, and the output)."""
    m, first, shape, strides, ptrs = _walk_members(
        parts, 1 if groups is None else groups)
    if first.dtype != torch.int32:
        raise TypeError(f"split channels are int32, not {first.dtype}")
    rows, chan, elem = _lane_layout(shape, strides, "sum")
    if _on_cpu(first):
        return None
    fn = _launch_fn("quant_reduce")
    device = first.device
    out = torch.empty(2, rows + -(-rows // QUANT_BLOCK), dtype=torch.int32,
                      device=device)
    blob = struct.pack(f"6q{m}Q", m, groups or 1, groups is not None, rows,
                       chan, elem, *ptrs)
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    return fn, (blob, out.data_ptr(), stream), out


def quant_reduce(parts, groups: int | None) -> torch.Tensor:
    """K14+K15: a mesh's quantized candidate-ranking reduce, one launch
    that reads the members' partials in place. ``parts``: a sequence of M
    member tensors of int32 split channels [2, R] (or [2]: R = 1), of one
    device, shape and strides, or one stacked [M, 2, R] tensor; group g is
    members g·M/G .. (g+1)·M/G - 1, M <= 64. Each group's totals cross
    as 8-bit max-scaled mantissas a 256-candidate block and are decoded
    → split-form int32[2, R + nb]: approx counts, then each block's error
    bound (nb = ceil(R / 256)). ``groups`` None (the flat mesh) is the
    lossless pass-through: the exact sum over the members, bounds 0."""
    prep = _quant_prepare(parts, groups)
    if prep is None:
        return quant_reduce_plain(parts, groups)
    return _run_prepared("quant_reduce", prep)


def quant_reduce_staged(parts, groups: int | None):
    """quant_reduce's C call alone, its arguments built once, into one
    output (no count): a function that makes the call, for timing the
    ctypes call and the launch apart from the wrapper's Python."""
    return _staged("quant_reduce", _quant_prepare(parts, groups))
