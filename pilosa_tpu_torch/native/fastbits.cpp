// Host helpers of the port: bit pack/unpack/popcount, run expansion and
// sorted uint16 set merges.
//
// The card runs the query kernels (csrc/); the host feeds it: decoding
// roaring containers into dense rows before their upload, packing
// result bitmaps and merging write batches into array containers. These
// loops are numpy hot spots (np.bitwise_or.at is an order of magnitude
// off a plain loop), so they get a small C++ library with a plain C ABI,
// loaded through ctypes (native/__init__.py). It is built with g++ at
// first use (native/build.py); every entry point has a numpy fallback.

#include <cstdint>

extern "C" {

// Set bits at `positions[0..n)` in a zeroed word vector of `n_words`
// uint32 words. Positions beyond the vector are ignored (caller checks).
void pack_positions(const uint64_t* positions, int64_t n,
                    uint32_t* words, int64_t n_words) {
    const uint64_t limit = static_cast<uint64_t>(n_words) * 32u;
    for (int64_t i = 0; i < n; ++i) {
        const uint64_t p = positions[i];
        if (p < limit) {
            words[p >> 5] |= (1u << (p & 31u));
        }
    }
}

// Extract sorted bit positions (+offset) from a word vector.
// Returns the number written; writes at most `cap` entries.
int64_t unpack_positions(const uint32_t* words, int64_t n_words,
                         uint64_t offset, uint64_t* out, int64_t cap) {
    int64_t written = 0;
    for (int64_t w = 0; w < n_words; ++w) {
        uint32_t v = words[w];
        const uint64_t base = offset + (static_cast<uint64_t>(w) << 5);
        while (v != 0 && written < cap) {
            const int bit = __builtin_ctz(v);
            out[written++] = base + static_cast<uint64_t>(bit);
            v &= v - 1;
        }
        if (written >= cap && v != 0) return written;  // caller re-sizes
    }
    return written;
}

// Total set bits in a word vector.
uint64_t popcount_words(const uint32_t* words, int64_t n_words) {
    uint64_t total = 0;
    int64_t i = 0;
    // bulk as uint64 for throughput
    const int64_t pairs = n_words / 2;
    const uint64_t* w64 = reinterpret_cast<const uint64_t*>(words);
    for (int64_t j = 0; j < pairs; ++j) total += __builtin_popcountll(w64[j]);
    for (i = pairs * 2; i < n_words; ++i) total += __builtin_popcount(words[i]);
    return total;
}

// Expand run intervals [start,last] (inclusive, uint16 pairs) into a
// 2048-word (65536-bit) container block.
void runs_to_words(const uint16_t* runs, int64_t n_runs, uint32_t* words) {
    for (int64_t i = 0; i < n_runs; ++i) {
        uint32_t start = runs[2 * i];
        uint32_t last = runs[2 * i + 1];
        for (uint32_t b = start; b <= last; ++b) {
            words[b >> 5] |= (1u << (b & 31u));
            if (b == 65535u) break;  // avoid wrap
        }
    }
}

// Union of two SORTED UNIQUE uint16 arrays (two-pointer merge) — the
// ARRAY-container bulk-import path. `out` must hold na+nb; returns the
// merged length. Replaces np.union1d's concat+sort (O((n+m)log(n+m)))
// with O(n+m).
int64_t union_sorted_u16(const uint16_t* a, int64_t na,
                         const uint16_t* b, int64_t nb, uint16_t* out) {
    int64_t i = 0, j = 0, k = 0;
    while (i < na && j < nb) {
        const uint16_t x = a[i], y = b[j];
        if (x < y)      { out[k++] = x; ++i; }
        else if (y < x) { out[k++] = y; ++j; }
        else            { out[k++] = x; ++i; ++j; }
    }
    while (i < na) out[k++] = a[i++];
    while (j < nb) out[k++] = b[j++];
    return k;
}

// a \ b for SORTED UNIQUE uint16 arrays — the remove path. `out` must
// hold na; returns the result length.
int64_t diff_sorted_u16(const uint16_t* a, int64_t na,
                        const uint16_t* b, int64_t nb, uint16_t* out) {
    int64_t i = 0, j = 0, k = 0;
    while (i < na) {
        while (j < nb && b[j] < a[i]) ++j;
        if (j < nb && b[j] == a[i]) { ++i; continue; }
        out[k++] = a[i++];
    }
    return k;
}

}  // extern "C"
