"""Fragment checksums: the ``.checksums`` sidecar and verified loads.

The port's copy of the digest part of ``pilosa_tpu.storage.integrity``.
Every snapshot writes the block digests of its bits beside the fragment
file (``<fragment>.checksums``): per 100-row block, blake2b over the
block's sorted bit ids, the same digests and the same self-checksummed
JSON as the reference, so either package verifies the other's files.
Opening a fragment decodes its snapshot with every decode error typed as
``CorruptFragmentError`` and, when a sidecar exists, compares the
snapshot's digests with it before the op log is replayed. (The
reference's quarantine, storage-health and integrity-stats planes are
not ported.)
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import zlib

import numpy as np

# Sidecar beside every fragment snapshot holding its block digests.
CHECKSUM_SUFFIX = ".checksums"
# Rows per checksum block (the reference fragment's BLOCK_ROWS).
BLOCK_ROWS = 100


class CorruptFragmentError(ValueError):
    """A fragment's bytes fail structural decode or digest verification;
    carries the path and the byte offset or block where known."""

    def __init__(self, path: str, reason: str, offset: int | None = None,
                 block: int | None = None):
        self.path = path
        self.reason = reason
        self.offset = offset
        self.block = block
        where = ""
        if offset is not None:
            where = f" at byte {offset}"
        elif block is not None:
            where = f" in checksum block {block}"
        super().__init__(f"corrupt fragment {path}{where}: {reason}")


# Decode failures that mean "these bytes are not a fragment".
DECODE_ERRORS = (ValueError, struct.error, zlib.error, OverflowError,
                 IndexError, MemoryError)


def block_digests(ids, block_rows: int = BLOCK_ROWS
                  ) -> list[tuple[int, str]]:
    """Per-block blake2b digests of a fragment's sorted bit ids: for each
    block of ``block_rows`` rows that holds a bit, the digest of its ids
    as little-endian uint64. ``ids`` is one sorted array or an iterable
    of sorted consecutive arrays (``RoaringBitmap.iter_ids``): each is
    split at block edges by binary search and hashed in place."""
    if isinstance(ids, np.ndarray):
        ids = (ids,)
    span = np.uint64(block_rows) << np.uint64(20)
    out: list[tuple[int, str]] = []
    block, h = None, None
    for part in ids:
        if part.size == 0:
            continue
        part = np.ascontiguousarray(part, "<u8")
        first, last = int(part[0] // span), int(part[-1] // span)
        bounds = np.searchsorted(
            part, np.arange(first + 1, last + 1, dtype=np.uint64) * span)
        edges = [0, *bounds.tolist(), part.size]
        for b, lo, hi in zip(range(first, last + 1), edges, edges[1:]):
            if lo == hi:
                continue
            if b != block:
                if h is not None:
                    out.append((block, h.hexdigest()))
                block, h = b, hashlib.blake2b(digest_size=16)
            h.update(part[lo:hi])
    if h is not None:
        out.append((block, h.hexdigest()))
    return out


def save_checksums(path: str, blocks) -> None:
    """Persist a fragment's block digests atomically. Self-checksummed, so
    a torn sidecar reads as absent, not as a corrupt fragment."""
    body = json.dumps([[int(b), d] for b, d in blocks],
                      separators=(",", ":")).encode()
    payload = json.dumps(
        {"v": 1, "crc": zlib.crc32(body), "blocks": json.loads(body)},
        separators=(",", ":"),
    ).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_checksums(path: str) -> list[tuple[int, str]] | None:
    """A checksum sidecar's digests; None when absent or torn (the load
    is then unverified)."""
    try:
        with open(path, "rb") as f:
            doc = json.loads(f.read().decode("utf-8", errors="strict"))
        blocks = doc["blocks"]
        body = json.dumps([[int(b), d] for b, d in blocks],
                          separators=(",", ":")).encode()
        if zlib.crc32(body) != doc["crc"]:
            return None
        return [(int(b), str(d)) for b, d in blocks]
    except (OSError, ValueError, KeyError, TypeError):
        return None


def verify_snapshot_blocks(bitmap, sidecar: list[tuple[int, str]],
                           path: str) -> None:
    """Compare a decoded snapshot's block digests with its sidecar (before
    op replay: the sidecar describes the snapshot alone). Raises
    CorruptFragmentError on the first block that differs."""
    _check_digests(block_digests(bitmap.iter_ids()), sidecar, path)


def _check_digests(live: list[tuple[int, str]],
                   sidecar: list[tuple[int, str]], path: str) -> None:
    if live == sidecar:
        return
    want = dict(sidecar)
    got = dict(live)
    for block in sorted(set(want) | set(got)):
        if want.get(block) != got.get(block):
            raise CorruptFragmentError(
                path,
                f"block digest mismatch (have {got.get(block)}, "
                f"checksum index says {want.get(block)})",
                block=block,
            )
    raise CorruptFragmentError(path, "block digest ordering mismatch")


def load_verified(data: bytes, path: str, verify: bool = False):
    """Decode a fragment file's snapshot with decode errors typed as
    CorruptFragmentError; with ``verify``, check its block digests
    against the sidecar when there is one. Returns (bitmap, ops_at); op
    replay stays with the caller."""
    from pilosa_tpu_torch.roaring.format import deserialize

    try:
        bitmap, ops_at = deserialize(data)
    except DECODE_ERRORS as e:
        offset = len(data) if "truncated" in str(e).lower() else None
        raise CorruptFragmentError(
            path, f"snapshot decode failed: {e}", offset=offset) from e
    if verify:
        sidecar = load_checksums(path + CHECKSUM_SUFFIX)
        if sidecar is not None:
            verify_snapshot_blocks(bitmap, sidecar, path)
    return bitmap, ops_at
