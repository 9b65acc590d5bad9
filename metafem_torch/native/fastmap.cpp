// Native host kernels for metafem's setup pipeline.
//
// The assembly setup inverts contribution->slot maps over O(100M)
// entries; numpy's comparison argsort costs O(N log N) with large
// constants (~minutes at cylinder-flow scale).  These counting-sort
// passes are O(N) and memory-bandwidth bound (~1 s at the same scale).
//
// Built on demand with g++ -O3 -shared (see native/__init__.py), called
// through ctypes — no extension-module build step required.

#include <cstdint>
#include <cstring>

extern "C" {

// Pass 1: per-slot counts.  slots: [n] in [0, num).
void count_slots(const int64_t* slots, int64_t n, int64_t num,
                 int64_t* counts) {
    std::memset(counts, 0, sizeof(int64_t) * num);
    for (int64_t i = 0; i < n; ++i) counts[slots[i]]++;
}

// Pass 2: fill the padded gather map (gmap[num*cap], sentinel = n) and
// the overflow COO (indices into the data vector + destination slots).
// cursor: scratch [num] (zero-initialized by caller or reused).
// Returns the number of overflow entries written.
int64_t fill_gather_map(const int64_t* slots, int64_t n, int64_t num,
                        int32_t cap, int32_t* gmap, int64_t* cursor,
                        int32_t* of_src, int32_t* of_dst) {
    for (int64_t s = 0; s < num * (int64_t)cap; ++s) gmap[s] = (int32_t)n;
    std::memset(cursor, 0, sizeof(int64_t) * num);
    int64_t n_of = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t s = slots[i];
        const int64_t k = cursor[s]++;
        if (k < cap) {
            gmap[s * cap + k] = (int32_t)i;
        } else {
            of_src[n_of] = (int32_t)i;
            of_dst[n_of] = (int32_t)s;
            ++n_of;
        }
    }
    return n_of;
}

// Dedup of packed int64 keys (pair-key dedup for the sparsity pattern):
// counting by bucketed radix would need key range; here keys are
// ci * n_cp + cj < n_cp^2 which can reach 1e12, so we instead assign
// group ids with a two-pass scheme over the *per-row* structure:
// key = ci * n_cp + cj; rows ci < n_cp are small, so bucket by ci.
// uniq_out must have capacity n; inv_out [n].
// Returns the number of unique keys.
int64_t unique_pairs(const int64_t* ci, const int64_t* cj, int64_t n,
                     int64_t n_cp, int64_t* row_counts /* scratch n_cp+1 */,
                     int64_t* row_starts /* scratch n_cp+1 */,
                     int64_t* scratch_idx /* scratch n */,
                     int64_t* uniq_ci, int64_t* uniq_cj,
                     int64_t* inv_out) {
    // bucket contributions by row ci
    std::memset(row_counts, 0, sizeof(int64_t) * (n_cp + 1));
    for (int64_t i = 0; i < n; ++i) row_counts[ci[i]]++;
    row_starts[0] = 0;
    for (int64_t r = 0; r < n_cp; ++r)
        row_starts[r + 1] = row_starts[r] + row_counts[r];
    // place indices row-major
    int64_t* cursor = row_counts;  // reuse as cursors
    for (int64_t r = 0; r < n_cp; ++r) cursor[r] = row_starts[r];
    for (int64_t i = 0; i < n; ++i) scratch_idx[cursor[ci[i]]++] = i;
    // per-row: sort by cj (insertion into small per-row set via simple
    // counting over a local map is overkill; rows are ~10-100 wide, use
    // in-place insertion sort on the row slice)
    int64_t n_uniq = 0;
    for (int64_t r = 0; r < n_cp; ++r) {
        const int64_t lo = row_starts[r], hi = row_starts[r + 1];
        // insertion sort of scratch_idx[lo:hi] by cj value
        for (int64_t a = lo + 1; a < hi; ++a) {
            const int64_t v = scratch_idx[a];
            const int64_t key = cj[v];
            int64_t b = a - 1;
            while (b >= lo && cj[scratch_idx[b]] > key) {
                scratch_idx[b + 1] = scratch_idx[b];
                --b;
            }
            scratch_idx[b + 1] = v;
        }
        int64_t prev = -1;
        for (int64_t a = lo; a < hi; ++a) {
            const int64_t v = scratch_idx[a];
            if (cj[v] != prev) {
                uniq_ci[n_uniq] = r;
                uniq_cj[n_uniq] = cj[v];
                prev = cj[v];
                ++n_uniq;
            }
            inv_out[v] = n_uniq - 1;
        }
    }
    return n_uniq;
}

// Pair dedup directly from the element->cp table: the logical pair
// stream is (ci, cj) = (el_cp[e,a], el_cp[e,b]) for all (e, a, b) in
// contribution order i = (e*na + a)*na + b.  Generating pairs on the
// fly avoids materializing the two n-length int64 pair arrays (1.1 GB
// at 3D 1M-DOF scale).  This host is a single slow vCPU whose dominant
// cost is first-touch page faults (~70-100 MB/s on fresh pages), so the
// design minimizes bytes written: ONE scatter pass bucketing packed
// (cj << 32 | i) keys by ci — the na keys of each (e, a) land
// contiguously at one cursor (160-byte sequential runs) — then an
// in-place insertion sort per row on the CONTIGUOUS packed keys
// (replacing the dependent cj[scratch_idx[b]] random loads of
// unique_pairs above), then a sequential dedup scan.
//
// Preconditions: n = E*na*na < 2^31 and n_cp < 2^31 (the wrapper falls
// back otherwise).  counts: scratch [n_cp+1] int64 — on return,
// counts[r] is the END of row r in keys (the wrapper's extraction call
// needs it).  keys: scratch [n] int64 (reusable arena).  inv_out: [n]
// int32.  Returns the number of unique pairs, sorted by (ci, cj) —
// identical ordering contract to unique_pairs.
int64_t pair_radix_inv(const int32_t* el_cp, int64_t E, int64_t na,
                       int64_t n_cp, int64_t* counts, int64_t* keys,
                       int32_t* inv_out) {
    const int64_t nn = na * na;
    const int64_t n = E * nn;
    // histogram by ci: each cp occurrence in el_cp owns na pairs
    std::memset(counts, 0, sizeof(int64_t) * (n_cp + 1));
    for (int64_t f = 0; f < E * na; ++f) counts[el_cp[f]] += na;
    int64_t run = 0;
    for (int64_t r = 0; r < n_cp; ++r) {
        const int64_t c = counts[r]; counts[r] = run; run += c;
    }
    // scatter packed (cj << 32 | i) by ci — na contiguous writes per
    // (e, a) at one cursor
    for (int64_t e = 0; e < E; ++e) {
        const int32_t* row = el_cp + e * na;
        const int64_t i0 = e * nn;
        for (int64_t a = 0; a < na; ++a) {
            int64_t* dst = keys + counts[row[a]];
            counts[row[a]] += na;
            const int64_t ia = i0 + a * na;
            for (int64_t b = 0; b < na; ++b)
                dst[b] = ((int64_t)row[b] << 32) | (ia + b);
        }
    }
    // counts[r] is now the END of row r; per-row insertion sort of the
    // contiguous packed keys orders by cj (high bits) then i (stable)
    int64_t n_uniq = 0;
    int64_t row_start = 0;
    for (int64_t r = 0; r < n_cp; ++r) {
        const int64_t lo = row_start, hi = counts[r];
        row_start = hi;
        for (int64_t a = lo + 1; a < hi; ++a) {
            const int64_t key = keys[a];
            int64_t b = a - 1;
            while (b >= lo && keys[b] > key) {
                keys[b + 1] = keys[b];
                --b;
            }
            keys[b + 1] = key;
        }
        // dedup scan fused into the row walk
        int64_t prev_cj = -1;
        for (int64_t a = lo; a < hi; ++a) {
            const int64_t key = keys[a];
            const int64_t cj_v = key >> 32;
            if (cj_v != prev_cj) { prev_cj = cj_v; ++n_uniq; }
            inv_out[(uint32_t)key] = (int32_t)(n_uniq - 1);
        }
    }
    return n_uniq;
}

// Extraction pass (after pair_radix_inv, which leaves keys row-sorted
// and counts[r] = row ends): writes the unique (ci, cj) pairs into
// exact-size int32 arrays — avoids allocating capacity-n int64 uniq
// buffers and the big copies out of them.
void pair_extract_uniq(const int64_t* keys, const int64_t* counts,
                       int64_t n_cp, int32_t* uniq_ci, int32_t* uniq_cj) {
    int64_t u = 0;
    int64_t row_start = 0;
    for (int64_t r = 0; r < n_cp; ++r) {
        const int64_t hi = counts[r];
        int64_t prev_cj = -1;
        for (int64_t a = row_start; a < hi; ++a) {
            const int64_t cj_v = keys[a] >> 32;
            if (cj_v != prev_cj) {
                prev_cj = cj_v;
                uniq_ci[u] = (int32_t)r;
                uniq_cj[u] = (int32_t)cj_v;
                ++u;
            }
        }
        row_start = hi;
    }
}

}  // extern "C"
