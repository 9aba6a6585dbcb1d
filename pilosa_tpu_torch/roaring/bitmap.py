"""64-bit roaring bitmap on the host (numpy), the port's copy.

Same model and the same container choices as ``pilosa_tpu.roaring.bitmap``:
values are uint64, containers are keyed by ``value >> 16`` and hold the
low 16 bits as a sorted uint16 **array**, a 1024×uint64 **bitmap** or a
**run** list of inclusive [start, last] intervals. Container choice is
part of the on-disk bytes, so it follows ``Container.from_lows`` exactly
and each package opens the other's data directory.

Whole-bitmap reads go through the batched kernels of ``kernels.py``
(``to_ids``, ``range_ids``); a container's decode and the small-batch
write loop use the fastbits library (``pilosa_tpu_torch.native``) when
it is active; a write batch of ``merge_kernels.KERNEL_MIN_IDS`` ids or
more merges through ``merge_kernels.merge_ids`` in one pass over every
container it touches. Each path builds the same bytes as the plain
per-container loop (``_merge_loop``).
"""

from __future__ import annotations

import bisect

import numpy as np

from pilosa_tpu_torch import native

ARRAY = 1
BITMAP = 2
RUN = 3

# Above this cardinality an array container is worse than a bitmap
# (4096 * 2 bytes == 8 KiB == bitmap size).
ARRAY_MAX = 4096
BITMAP_N_WORDS = 1024  # uint64 words per container (65536 bits)


def _scatter_bits(words8: np.ndarray, lows: np.ndarray) -> None:
    """OR uint16 bit positions into a byte view of a bitmap container."""
    np.bitwise_or.at(
        words8,
        (lows >> np.uint16(3)).astype(np.int64),
        np.uint8(1) << (lows & np.uint16(7)).astype(np.uint8),
    )


class Container:
    __slots__ = ("kind", "data", "n")

    def __init__(self, kind: int, data: np.ndarray, n: int):
        self.kind = kind
        self.data = data
        self.n = n  # cardinality

    @staticmethod
    def from_lows(lows: np.ndarray) -> "Container":
        """Build the optimal container for sorted unique uint16 lows."""
        n = int(lows.size)
        if n == 0:
            return Container(ARRAY, np.empty(0, np.uint16), 0)
        d = np.diff(lows.astype(np.int32))
        n_runs = int(np.count_nonzero(d != 1)) + 1
        # cost in bytes: array 2n, run 4*n_runs, bitmap 8192
        if 4 * n_runs < min(2 * n, 8192):
            starts_idx = np.concatenate(([0], np.nonzero(d != 1)[0] + 1))
            ends_idx = np.concatenate((np.nonzero(d != 1)[0], [n - 1]))
            runs = np.stack([lows[starts_idx], lows[ends_idx]], axis=1)
            return Container(RUN, np.ascontiguousarray(runs, np.uint16), n)
        if n <= ARRAY_MAX:
            return Container(ARRAY, np.ascontiguousarray(lows, np.uint16), n)
        words = np.zeros(BITMAP_N_WORDS * 8, np.uint8)
        _scatter_bits(words, lows)
        return Container(BITMAP, words.view("<u8").copy(), n)

    def lows(self) -> np.ndarray:
        """Sorted unique uint16 values in this container."""
        if self.kind == ARRAY:
            return self.data
        if self.kind == BITMAP:
            bits = np.unpackbits(
                np.ascontiguousarray(self.data).view(np.uint8), bitorder="little"
            )
            return np.nonzero(bits)[0].astype(np.uint16)
        runs = self.data.astype(np.int64)
        if runs.size == 0:
            return np.empty(0, np.uint16)
        lengths = runs[:, 1] - runs[:, 0] + 1
        total = int(lengths.sum())
        out = np.repeat(
            runs[:, 0] - np.concatenate(([0], np.cumsum(lengths)[:-1])), lengths
        )
        return (out + np.arange(total)).astype(np.uint16)

    def contains_low(self, low: int) -> bool:
        if self.kind == ARRAY:
            i = int(np.searchsorted(self.data, low))
            return i < self.data.size and int(self.data[i]) == low
        if self.kind == BITMAP:
            return bool((int(self.data[low >> 6]) >> (low & 63)) & 1)
        runs = self.data
        if runs.size == 0:
            return False
        i = int(np.searchsorted(runs[:, 0], low, side="right")) - 1
        return i >= 0 and low <= int(runs[i, 1])

    def contains_lows(self, lows: np.ndarray) -> np.ndarray:
        """Membership of each uint16 low (bool), vectorized."""
        if self.kind == BITMAP:
            words = self.data[(lows >> np.uint16(6)).astype(np.int64)]
            return ((words >> (lows & np.uint16(63)).astype(np.uint64))
                    & np.uint64(1)).astype(bool)
        data = self.data if self.kind == ARRAY else self.data[:, 0]
        if data.size == 0:
            return np.zeros(lows.size, bool)
        if self.kind == ARRAY:
            i = np.minimum(np.searchsorted(data, lows), data.size - 1)
            return data[i] == lows
        i = np.searchsorted(data, lows, side="right") - 1
        return (i >= 0) & (lows <= self.data[np.maximum(i, 0), 1])

    def dense_words32(self) -> np.ndarray:
        """Container as 2048 uint32 words (65536 bits), through fastbits
        when it is active."""
        if self.kind == BITMAP:
            return np.ascontiguousarray(self.data).view("<u4").copy()
        if self.kind == RUN:
            fast = native.runs_to_words(self.data)
        else:
            fast = native.pack_positions(self.data.astype(np.uint64), 2048)
        if fast is not None:
            return fast
        words = np.zeros(2048 * 4, np.uint8)
        lows = self.lows()
        if lows.size:
            _scatter_bits(words, lows)
        return words.view("<u4").copy()


class RoaringBitmap:
    """Sorted map: container key (high 48 bits) → Container."""

    def __init__(self):
        self.keys: list[int] = []
        self._containers: dict[int, Container] = {}

    def container(self, key: int) -> Container | None:
        return self._containers.get(key)

    def count(self) -> int:
        return sum(c.n for c in self._containers.values())

    def iter_ids(self, chunk: int = 16):
        """The sorted set values as uint64 arrays, ``chunk`` containers at
        a time (a fragment row is 16), each small enough to stay in the
        CPU's caches. A run of bitmap containers decodes in one pass, and
        when their keys run without a gap the decoded positions are the
        values after one add."""
        pairs = [(k, c) for k in list(self.keys)
                 if (c := self._containers.get(k)) is not None]
        for lo in range(0, len(pairs), chunk):
            part = pairs[lo:lo + chunk]
            if any(c.kind != BITMAP for _, c in part):
                yield np.concatenate([
                    np.uint64(k << 16) + c.lows().astype(np.uint64)
                    for k, c in part])
                continue
            bits = np.unpackbits(np.stack([c.data for _, c in part]).view(
                np.uint8), axis=1, bitorder="little")
            pos = np.flatnonzero(bits).view(np.uint64)
            keys = np.array([k for k, _ in part], np.uint64)
            if int(keys[-1] - keys[0]) == len(part) - 1:
                yield pos + (keys[0] << np.uint64(16))
            else:
                yield (keys[pos >> np.uint64(16)] << np.uint64(16)) | (
                    pos & np.uint64(0xFFFF))

    def to_ids(self) -> np.ndarray:
        """Every set value, sorted, as one uint64 array (the reference's:
        one flatten, one batched decode; a corrupt key's ids wrap past
        2^64 as there)."""
        from pilosa_tpu_torch.roaring import kernels

        return kernels.fragment_ids(kernels.flatten(self))

    def count_range(self, start: int, stop: int) -> int:
        if stop <= start:
            return 0
        keys = self.keys
        lo_i = bisect.bisect_left(keys, start >> 16)
        hi_i = bisect.bisect_right(keys, (stop - 1) >> 16)
        total = 0
        for key in keys[lo_i:hi_i]:
            c = self._containers.get(key)
            if c is None:
                continue
            if key << 16 >= start and (key + 1) << 16 <= stop:
                total += c.n
            else:
                lows = c.lows().astype(np.int64) + (key << 16)
                total += int(((lows >= start) & (lows < stop)).sum())
        return total

    def dense_range_words32(self, start: int, stop: int) -> np.ndarray:
        """Materialize [start, stop) as packed uint32 words (both
        65536-aligned): a fragment row (2^20 bits, 16 containers) becomes
        uint32[32768]. One windowed flatten and one batched decode."""
        if start % 65536 or stop % 65536 or stop <= start:
            raise ValueError("dense range must be 65536-aligned and non-empty")
        from pilosa_tpu_torch.roaring import kernels

        base_key, n_containers = start >> 16, (stop - start) >> 16
        flat = kernels.flatten(self, base_key, base_key + n_containers - 1)
        return kernels.dense_words32(flat, base_key, n_containers)

    def range_ids(self, start: int, stop: int) -> np.ndarray:
        """Sorted ids in [start, stop): only the containers that overlap
        the range are flattened."""
        if stop <= start or not self.keys:
            return np.empty(0, np.uint64)
        from pilosa_tpu_torch.roaring import kernels

        flat = kernels.flatten(self, start >> 16, (stop - 1) >> 16)
        return kernels.range_ids(flat, start, stop)

    # --- mutation (op-log replay + write path) ---

    def add_ids(self, ids) -> int:
        """Set bits; returns number actually changed."""
        return self._merge(ids, remove=False)

    def remove_ids(self, ids) -> int:
        return self._merge(ids, remove=True)

    def _merge(self, ids, remove: bool) -> int:
        """A write batch: the whole-batch merge kernel from
        ``merge_kernels.KERNEL_MIN_IDS`` ids, the per-container loop below
        (a point write must not pay the batch's bookkeeping). Both build
        the same bytes."""
        ids = np.atleast_1d(np.asarray(ids, dtype=np.uint64))
        if ids.size == 0:
            return 0
        from pilosa_tpu_torch.roaring import merge_kernels

        if ids.size >= merge_kernels.KERNEL_MIN_IDS:
            return merge_kernels.merge_ids(self, ids, remove)
        merge_kernels.global_merge_stats().loop_fallbacks += 1
        return self._merge_loop(ids, remove)

    def _merge_loop(self, ids, remove: bool) -> int:
        """The per-container merge: the small-batch path, and the bytes
        ``merge_kernels.merge_ids`` must build."""
        ids = np.atleast_1d(np.asarray(ids, dtype=np.uint64))
        if ids.size == 0:
            return 0
        if ids.size > 1:
            if not bool(np.all(ids[1:] >= ids[:-1])):
                ids = np.sort(ids)
            ids = ids[np.concatenate(([True], ids[1:] != ids[:-1]))]
        hi = (ids >> np.uint64(16)).astype(np.int64)
        lows = (ids & np.uint64(0xFFFF)).astype(np.uint16)
        boundaries = np.concatenate(
            ([0], np.nonzero(np.diff(hi))[0] + 1, [ids.size])
        )
        changed = 0
        for i in range(boundaries.size - 1):
            lo_i, hi_i = int(boundaries[i]), int(boundaries[i + 1])
            key = int(hi[lo_i])
            batch = lows[lo_i:hi_i]
            c = self._containers.get(key)
            delta = None
            if c is not None and c.kind == BITMAP:
                delta = self._merge_bitmap_inplace(key, c, batch, remove)
            elif (not remove and c is not None and c.kind == ARRAY
                  and c.n + batch.size > ARRAY_MAX):
                words = np.zeros(BITMAP_N_WORDS * 8, np.uint8)
                _scatter_bits(words, c.data)
                tmp = Container(BITMAP, words.view("<u8"), c.n)
                delta = self._merge_bitmap_inplace(key, tmp, batch, remove)
            elif not remove and c is None and batch.size > ARRAY_MAX:
                self._containers[key] = Container.from_lows(batch)
                delta = int(batch.size)
            if delta is None and c is not None:
                # nothing to change (columns already marked existing, a
                # clear of absent bits): skip decoding and re-sorting a
                # run or array container of up to 65536 values
                present = c.contains_lows(batch)
                if present.all() if not remove else not present.any():
                    delta = 0
            if delta is None:
                existing = c.lows() if c is not None else np.empty(0, np.uint16)
                # both sides sorted and unique: fastbits' two-pointer
                # merge, or numpy's set operations
                if remove:
                    new = native.diff_sorted_u16(existing, batch)
                    if new is None:
                        new = np.setdiff1d(existing, batch, assume_unique=True)
                else:
                    new = native.union_sorted_u16(existing, batch)
                    if new is None:
                        new = np.union1d(existing, batch)
                delta = abs(int(new.size) - int(existing.size))
                if delta and new.size == 0:
                    self._containers.pop(key, None)
                elif delta:
                    self._containers[key] = Container.from_lows(new)
            changed += delta
        if changed:
            self.keys = sorted(self._containers)
        return changed

    def _merge_bitmap_inplace(self, key: int, c: Container, batch,
                              remove: bool) -> int:
        """Scatter a unique uint16 batch into a copy of a BITMAP container
        and swap the new container in (readers always see an immutable,
        self-consistent container). Returns the cardinality delta."""
        words8 = np.array(c.data.view(np.uint8))
        if remove:
            idx = (batch >> np.uint16(3)).astype(np.int64)
            np.bitwise_and.at(
                words8, idx,
                np.uint8(0xFF) ^ (np.uint8(1) << (batch & np.uint16(7)).astype(np.uint8)),
            )
        else:
            _scatter_bits(words8, batch)
        new_n = int(np.bitwise_count(words8).sum(dtype=np.int64))
        delta = abs(new_n - c.n)
        if new_n == 0:
            self._containers.pop(key, None)
        elif delta == 0:
            pass
        elif new_n <= ARRAY_MAX:
            new_c = Container(BITMAP, words8.view("<u8"), new_n)
            self._containers[key] = Container.from_lows(new_c.lows())
        else:
            self._containers[key] = Container(BITMAP, words8.view("<u8"), new_n)
        return delta

    def __contains__(self, id_: int) -> bool:
        c = self._containers.get(int(id_) >> 16)
        if c is None:
            return False
        return c.contains_low(int(id_) & 0xFFFF)
