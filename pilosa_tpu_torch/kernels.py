"""The port's hand-written CUDA kernels, their wrappers and plain versions.

Nine kernels carry the main paths (sources in ``csrc/``):

- K1 ``tree_count``: per-row popcount of a postfix bitwise program over
  up to 16 stacked leaves, one launch per micro-batch (replaces
  ``bench_pallas.pallas_intersect_count`` and ``batch.count_flat``);
- K2 ``tree_rows``: the words of the same program, for row results
  (replaces ``expr._go`` under the 'row' reduce kind, ``flipall``
  included as ``OP_NOT``);
- K3 ``word_patch``: OR / AND-NOT host-deduplicated word masks into one
  row of a resident ``[S, W]`` or ``[S, R, W]`` leaf, in place (replaces
  ``batch._or_delta`` / ``_andnot_delta`` and their ``_row`` forms);
- K4 ``row_shift``: every shard row's bits shifted by n (replaces
  ``ops/bitops.py::shift``);
- K5 ``bsi_compare``: the bit-sliced comparison of a BSI plane leaf
  against a predicate (replaces ``expr._bsi_compare``);
- K6 ``bsi_sum``: per-shard plane popcounts under exists and a filter
  (replaces the 'bsisum' node);
- K7 ``bsi_minmax``: per-shard greedy extremum and its count (replaces
  ``expr._bsi_minmax``);
- K8 ``count_rows``: per-shard popcount of every row of a stacked row
  matrix under an optional filter row (replaces the 'countrows' node,
  TopN's phase 2);
- K9 ``groupby_level``: per shard and candidate group, the popcount of
  the AND of one row of each dimension matrix and a filter, with the
  aggregate's plane counts (replaces ``batch.groupby_level_body``).

Each source builds with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface under ``build/kernels/`` at first use, and is
loaded with ctypes. A wrapper takes its plain PyTorch version only for a
tensor that lies on the CPU; for a CUDA tensor it launches the kernel or
raises. Words are int32 tensors holding the uint32 bit patterns.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
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
           "groupby_level")

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
BSI_MINMAX_MAX_DEPTH = 31  # K7's extremum is an int32
MINMAX_MAX_WORDS = 32768  # words per shard row K7 takes (one block each)
GROUPBY_MAX_DEPTH = 63     # bit planes of K9's aggregate (as K6)
# Masks the plain GroupBy level holds at once ([S, chunk, W] per step)
GROUPBY_PLAIN_MASK_BYTES = 256 << 20

# --------------------------------------------------------------- launches

_launch_lock = threading.Lock()
LAUNCHES = {name: 0 for name in SOURCES}


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
        "tree_count": [p, i, i, p, p, i, ll, ll, i, p, p],
        "tree_rows": [p, i, ctypes.c_uint32, p, i, ll, i, p, p],
        "word_patch": [p, p, i, i, p],
        "row_shift": [p, p, ll, ll, ll, i, p],
        "bsi_compare": [p, p, p, ll, ll, i, ctypes.c_ulonglong, i, i, p],
        "bsi_sum": [p, p, p, ll, ll, i, i, p],
        "bsi_minmax": [p, p, ll, ll, i, i, p, p, p],
        "count_rows": [p, p, p, ll, i, ll, i, p],
        "groupby_level": [p, p, i, p, i, p, p, i, ll, ll, i, p, p],
    }
    getattr(lib, f"{name}_launch").argtypes = argtypes[name]
    getattr(lib, f"{name}_launch").restype = i
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


def word_patch_plain(leaf: torch.Tensor, slot: int, pairs: np.ndarray,
                     clear: bool, row: int | None = None) -> None:
    idx = torch.from_numpy(np.ascontiguousarray(pairs[0], np.int64)).to(
        leaf.device)
    masks = torch.from_numpy(np.ascontiguousarray(pairs[1]).view(np.int32)
                             ).to(leaf.device)
    target = leaf[slot] if row is None else leaf[slot, row]
    if clear:
        target[idx] = target[idx] & ~masks
    else:
        target[idx] = target[idx] | masks


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
    (offset-encoded extremum int32[S], candidate count int32[S]); a shard
    with no candidate has count 0."""
    depth = planes.shape[1] - 2
    cand = planes[:, 0] if filt is None else planes[:, 0] & filt
    value = torch.zeros(planes.shape[0], dtype=torch.int32,
                        device=planes.device)
    for i in reversed(range(depth)):
        p = planes[:, 2 + i]
        t = cand & (p if want_max else ~p)
        nonempty = (t != 0).any(dim=1)  # per shard, as the vmap has it
        cand = torch.where(nonempty[:, None], t, cand)
        bit = nonempty if want_max else ~nonempty
        value = value | (bit.to(torch.int32) << i)
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
    list of same-shaped int32 tensors). One launch for the whole batch."""
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
    ptrs = (ctypes.c_void_p * len(flat))(*[t.data_ptr() for t in flat])
    salt_arr = (ctypes.c_uint32 * len(salts))(*[_salt_u32(s) for s in salts])
    code = (ctypes.c_int * len(program))(*program)
    vec = int(row_words % 4 == 0 and _aligned(flat))
    rc = lib.tree_count_launch(ptrs, len(batch_leaves), n_leaves, salt_arr,
                               code, len(program), n_words, row_words, vec,
                               ctypes.c_void_p(out.data_ptr()), _stream(out))
    _check("tree_count", lib, rc)
    _count_launch("tree_count")
    return out


def tree_rows(program, leaves, salt: int = 0) -> torch.Tensor:
    """K2: the program's words over ``leaves`` (same shape as a leaf)."""
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
    ptrs = (ctypes.c_void_p * len(leaves))(*[t.data_ptr() for t in leaves])
    code = (ctypes.c_int * len(program))(*program)
    vec = int(n_words % 4 == 0 and _aligned(list(leaves) + [out]))
    rc = lib.tree_rows_launch(ptrs, len(leaves), _salt_u32(salt), code,
                              len(program), n_words, vec,
                              ctypes.c_void_p(out.data_ptr()), _stream(out))
    _check("tree_rows", lib, rc)
    _count_launch("tree_rows")
    return out


def word_patch(leaf: torch.Tensor, slot: int, word_idx, masks, n: int,
               clear: bool, row: int | None = None) -> None:
    """K3: ``leaf[slot, word_idx[i]] |= masks[i]`` (or ``&= ~masks[i]``
    when ``clear``) for the first ``n`` pairs, in place; with ``row``, the
    same into ``leaf[slot, row]`` of an ``[S, R, W]`` leaf (BSI planes).
    Word indices must be unique; pairs past ``n`` (padding) are ignored."""
    if leaf.dim() != (2 if row is None else 3):
        raise ValueError("word_patch patches a [slots, words] leaf, or with "
                         "row= a [slots, rows, words] leaf")
    _check_words([leaf], leaf.device)
    if not 0 <= slot < leaf.shape[0]:
        raise IndexError(f"slot {slot} outside {leaf.shape[0]} slots")
    if row is not None and not 0 <= row < leaf.shape[1]:
        raise IndexError(f"row {row} outside {leaf.shape[1]} rows")
    idx = np.asarray(word_idx)[:n].astype(np.int64)
    m = np.asarray(masks)[:n].astype(np.uint32)
    if idx.size != n or m.size != n:
        raise ValueError("fewer pairs than n")
    if n == 0:
        return
    if idx.min() < 0 or idx.max() >= leaf.shape[-1]:
        raise IndexError("word index outside the row")
    if np.unique(idx).size != n:
        raise ValueError("word indices must be unique")
    pairs = np.stack([idx.astype(np.int32), m.view(np.int32)])
    if _on_cpu(leaf):
        word_patch_plain(leaf, slot, pairs, clear, row)
        return
    lib = _lib("word_patch")
    # pinned + non_blocking: a pageable copy would first wait for every
    # kernel already queued on the stream
    dev_pairs = torch.from_numpy(pairs).pin_memory().to(leaf.device,
                                                        non_blocking=True)
    first_word = slot * leaf.shape[1] if row is None else \
        (slot * leaf.shape[1] + row) * leaf.shape[2]
    row_ptr = leaf.data_ptr() + first_word * leaf.element_size()
    rc = lib.word_patch_launch(ctypes.c_void_p(row_ptr),
                               ctypes.c_void_p(dev_pairs.data_ptr()), n,
                               int(clear), _stream(leaf))
    _check("word_patch", lib, rc)
    _count_launch("word_patch")


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
    """K7: per shard (offset-encoded extremum, count of candidates holding
    it) as two int32[S]; count 0 marks a shard without candidates."""
    depth = _check_planes(planes, [filt], BSI_MINMAX_MAX_DEPTH)
    if _on_cpu(planes):
        return bsi_minmax_plain(planes, filt, want_max)
    n_shards, _, row_words = planes.shape
    if row_words > MINMAX_MAX_WORDS:
        raise ValueError(f"bsi_minmax takes rows of at most "
                         f"{MINMAX_MAX_WORDS} words")
    lib = _lib("bsi_minmax")
    values = torch.empty(n_shards, dtype=torch.int32, device=planes.device)
    counts = torch.empty_like(values)
    rc = lib.bsi_minmax_launch(_ptr(planes), _ptr(filt), n_shards, row_words,
                               depth, int(bool(want_max)), _ptr(values),
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
                  planes: torch.Tensor | None = None) -> torch.Tensor:
    """K9: one GroupBy level, int32[S, K, C] per-shard counts. ``dims``:
    up to MAX_LEAVES stacked dimension matrices int32[S, n_d, W];
    ``idxs``: one host integer array of C candidate row positions per
    dimension; ``filt``: int32[S, W] or None; ``planes``: the aggregate's
    int32[S, 2 + depth, W] or None. K is 1 (counts) or 2 + depth (counts,
    n, plane counts)."""
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
    idx = np.ascontiguousarray(np.stack(host_idx).astype(np.int32))
    dev_idx = torch.from_numpy(idx).pin_memory().to(first.device,
                                                    non_blocking=True)
    out = torch.zeros((n_shards, 1 if planes is None else 2 + depth, n_cand),
                      dtype=torch.int32, device=first.device)
    ptrs = (ctypes.c_void_p * len(dims))(*[d.data_ptr() for d in dims])
    rows = (ctypes.c_longlong * len(dims))(*[d.shape[1] for d in dims])
    vec = int(row_words % 4 == 0 and _aligned(tensors))
    rc = lib.groupby_level_launch(ptrs, rows, len(dims), _ptr(dev_idx),
                                  n_cand, _ptr(filt), _ptr(planes), depth,
                                  n_shards, row_words, vec, _ptr(out),
                                  _stream(out))
    _check("groupby_level", lib, rc)
    _count_launch("groupby_level")
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
