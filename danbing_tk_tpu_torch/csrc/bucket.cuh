// The bucket-table probe shared by KB (bucket_lookup.cu), KF
// (read_filter.cu), KG (novel_edges.cu) and KI (sharded_lookup.cu): one
// copy of the salted hash and the 8-slot row compare of
// index/device_table.py.
#pragma once

#include "common.cuh"

constexpr int DTK_MAXLEV = 32;

// A table's levels as the wrappers pass them (index/device_table.py
// level_args): row pointers, bucket counts and salt constants.
struct DtkLevels {
    const uint32_t* t[DTK_MAXLEV];
    uint32_t mask[DTK_MAXLEV];
    uint32_t salt[DTK_MAXLEV];
    int n;
};

// Fills lv from the wrapper's three arrays; false when there are too many
// levels.
inline bool dtk_levels(DtkLevels* lv, const void* tabs, const void* nbs,
                       const void* salts, int64_t nlev) {
    if (nlev > DTK_MAXLEV) return false;
    lv->n = (int)nlev;
    for (int l = 0; l < lv->n; ++l) {
        lv->t[l] = ((const uint32_t* const*)tabs)[l];
        lv->mask[l] = (uint32_t)(((const int64_t*)nbs)[l] - 1);
        lv->salt[l] = (uint32_t)((const int64_t*)salts)[l];
    }
    return true;
}

// The bucket of (lo, hi[, locus]) in a level of 2^k buckets: the salted
// mix32 cascade of index/device_table.py, masked with nb - 1.
__device__ __forceinline__ uint32_t dtk_bucket(uint32_t salt, uint32_t mask,
                                               int composite, uint32_t lo,
                                               uint32_t hi, uint32_t loc) {
    uint32_t h = dtk_mix32(hi ^ salt);
    if (composite) h = dtk_mix32(h ^ loc);
    return dtk_mix32(lo ^ h) & mask;
}

// Compares (lo, hi[, locus]) with the 8 slots of one row (8 * W u32);
// v / v2 get the max value of the matching slots (0 when none matches or
// the table has no such plane).  Returns whether a slot matched.
__device__ __forceinline__ bool dtk_row_match(const uint32_t* row, int W,
                                              int composite, int nval,
                                              uint32_t lo, uint32_t hi,
                                              uint32_t loc, uint32_t* v,
                                              uint32_t* v2) {
    const int vp = 2 + composite;
    bool f = false;
    uint32_t a = 0, b2 = 0;
    for (int s = 0; s < 8; ++s) {
        const uint32_t* sl = row + s * W;
        bool m = __ldg(sl) == lo && __ldg(sl + 1) == hi &&
                 (!composite || __ldg(sl + 2) == loc);
        if (m) {
            f = true;
            if (nval >= 1) a = max(a, __ldg(sl + vp));
            if (nval == 2) b2 = max(b2, __ldg(sl + vp + 1));
        }
    }
    *v = a;
    *v2 = b2;
    return f;
}

// Probes one key (and locus, for a composite table): walks the levels in
// order and reads the key's row; the first level that hits wins.
__device__ __forceinline__ bool dtk_probe(const DtkLevels& lv, int W,
                                          int composite, int nval,
                                          uint64_t key, uint32_t loc,
                                          uint32_t* v, uint32_t* v2) {
    const uint32_t lo = (uint32_t)key, hi = (uint32_t)(key >> 32);
    *v = 0;
    *v2 = 0;
    for (int l = 0; l < lv.n; ++l) {
        uint32_t b = dtk_bucket(lv.salt[l], lv.mask[l], composite, lo, hi,
                                loc);
        if (dtk_row_match(lv.t[l] + (size_t)b * 8 * W, W, composite, nval,
                          lo, hi, loc, v, v2))
            return true;
    }
    return false;
}
