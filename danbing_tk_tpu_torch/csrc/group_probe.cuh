// The cooperative bucket-table probe of KB (bucket_lookup.cu), which KI
// (sharded_lookup.cu) also launches for a row block that holds every row
// of a non-composite table (D = 1, the sharded funnel at world 1), its
// count instance (KI[count]) taking the lanes' answers in registers
// (dtk_group_probe_lanes); KF (read_filter.cu) probes in the same layout
// with its group max.
//
// A row of 8 slots (8 * W u32: 128 B at W = 4, 64 B for the member
// table's W = 2) lands in a random place, so what bounds a probe is how
// many rows are in flight.  A group of 8 lanes probes one query: lane s
// loads slot s as one uint4 (W = 4) or uint2 (W = 2), so a row is one
// coalesced transaction; a ballot gives the group its matching slots and a
// 3-step xor-shuffle max their values; the first level that hits wins, and
// a group stops there.  A warp takes a tile of 32 consecutive queries in
// rounds of four: one coalesced load of keys (and loci) first, and lane j
// stores query j's found, val and val2 last, so the outputs are coalesced
// too.  A tile of one repeated query probes it once (the trfl probe's
// queries are mostly runs of (EMPTY, 0)); in a tile where some query
// repeats its neighbour's, lanes of one (key, locus) probe once
// (__match_any_sync).  Any other W (or a level not aligned for the vector
// load) takes the same layout with scalar loads.
#pragma once

#include "bucket.cuh"

constexpr unsigned DTK_FULL = 0xFFFFFFFFu;
constexpr int DTK_PROBE_THREADS = 256;   // 32 queries a warp

// Slot s of row b of a level: whether it matches, and its value planes.
template <int VW>
__device__ __forceinline__ bool dtk_slot_match(const uint32_t* t, uint32_t b,
                                               int s, int W, int composite,
                                               int nval, uint32_t lo,
                                               uint32_t hi, uint32_t loc,
                                               uint32_t* va, uint32_t* vb) {
    const uint32_t* sl = t + ((size_t)b * 8 + s) * W;
    bool m;
    if constexpr (VW == 4) {            // lo, hi, val, val2 | lo, hi, loc, val
        const uint4 x = __ldg((const uint4*)sl);
        m = x.x == lo && x.y == hi && (!composite || x.z == loc);
        *va = m && nval >= 1 ? (composite ? x.w : x.z) : 0u;
        *vb = m && nval == 2 ? x.w : 0u;
    } else if constexpr (VW == 2) {     // lo, hi (membership)
        const uint2 x = __ldg((const uint2*)sl);
        m = x.x == lo && x.y == hi;
        *va = *vb = 0u;
    } else {
        const int vp = 2 + composite;
        m = __ldg(sl) == lo && __ldg(sl + 1) == hi &&
            (!composite || __ldg(sl + 2) == loc);
        *va = m && nval >= 1 ? __ldg(sl + vp) : 0u;
        *vb = m && nval == 2 ? __ldg(sl + vp + 1) : 0u;
    }
    return m;
}

__device__ __forceinline__ uint32_t dtk_group_max(uint32_t v) {
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
        v = max(v, __shfl_xor_sync(DTK_FULL, v, o));
    return v;
}

// The vector width the levels allow: W when it is 4 or 2 and every level's
// rows are aligned to a slot, else 0 (scalar loads).
template <class Lv>
inline int dtk_vector_width(const Lv& lv, int W) {
    int VW = (W == 4 || W == 2) ? W : 0;
    for (int l = 0; l < lv.n; ++l)
        if ((uintptr_t)lv.t[l] % (4 * (uintptr_t)W)) VW = 0;
    return VW;
}

// One warp's tile of up to 32 queries held in its lanes (lane i: key myq
// and locus myloc where inb, else 0 and 0; the inb lanes need not be the
// low ones); every lane of the warp calls it.  Sets *rf, *rv, *rv2 to the
// answer to the lane's query, a repeated query's lanes each to theirs.
// ul: 32 bytes of shared memory for this warp.
template <int VW>
__device__ __forceinline__ void dtk_group_probe_lanes(
    bool inb, uint64_t myq, uint32_t myloc, const DtkLevels& lv, int W,
    int composite, int nval, uint8_t* ul, uint32_t* rf, uint32_t* rv,
    uint32_t* rv2) {
    const int lane = threadIdx.x & 31, g = lane >> 3, s = lane & 7;
    // a repeated (key, locus) is probed once, by its lowest lane; the match
    // runs only where some query repeats its neighbour's (random k-mers
    // seldom do)
    const unsigned inm = __ballot_sync(DTK_FULL, inb);
    const uint64_t pq = __shfl_up_sync(DTK_FULL, myq, 1);
    const uint32_t pl = __shfl_up_sync(DTK_FULL, myloc, 1);
    const uint64_t q0 = __shfl_sync(DTK_FULL, myq, 0);
    const uint32_t l0 = __shfl_sync(DTK_FULL, myloc, 0);
    unsigned same = 1u << lane;
    if (__all_sync(DTK_FULL, !inb || (myq == q0 && myloc == l0))) {
        same = inm;                              // one query in the tile
    } else if (__any_sync(DTK_FULL, inb && lane > 0 && pq == myq &&
                                        pl == myloc) && inb) {
        same = __match_any_sync(inm, (unsigned long long)myq);
        if (composite) same &= __match_any_sync(inm, myloc);
    }
    const int lead = inb ? __ffs(same) - 1 : lane;
    const unsigned uniq = __ballot_sync(DTK_FULL, inb && lead == lane);
    const int nu = __popc(uniq);
    const int rank = __popc(uniq & ((1u << lead) - 1u));  // lead's, of nu
    // unique query -> its lane: the identity when the leaders are the low
    // lanes (a tile of distinct queries from lane 0)
    const bool dup = uniq != (nu == 32 ? DTK_FULL : (1u << nu) - 1u);
    if (dup && inb && lead == lane) ul[rank] = (uint8_t)lane;
    __syncwarp();
    *rf = *rv = *rv2 = 0;                        // the lane's answer

#pragma unroll 1
    for (int it = 0; it * 4 < nu; ++it) {
        const int u = it * 4 + g;                // this group's unique query
        bool done = u >= nu;
        const int qi = done ? 0 : dup ? ul[u] : u;
        const uint64_t key = __shfl_sync(DTK_FULL, myq, qi);
        const uint32_t loc = __shfl_sync(DTK_FULL, myloc, qi);
        const uint32_t lo = (uint32_t)key, hi = (uint32_t)(key >> 32);
        uint32_t f = 0, a = 0, b2 = 0;
        for (int l = 0; l < lv.n && __any_sync(DTK_FULL, !done); ++l) {
            uint32_t va = 0, vb = 0;
            bool m = false;
            if (!done)
                m = dtk_slot_match<VW>(lv.t[l],
                                       dtk_bucket(lv.salt[l], lv.mask[l],
                                                  composite, lo, hi, loc),
                                       s, W, composite, nval, lo, hi, loc,
                                       &va, &vb);
            const unsigned hit =
                (__ballot_sync(DTK_FULL, m) >> (g * 8)) & 0xFFu;
            const uint32_t x = dtk_group_max(va), y = dtk_group_max(vb);
            if (!done && hit) {
                f = 1;
                a = x;
                b2 = y;
                done = true;
            }
        }
        // unique query u = 4 it + g' was answered at lane 8 g'; every lane
        // whose leader has that rank takes it
        const int rr = rank - it * 4, src = (rr & 3) * 8;
        const uint32_t ff = __shfl_sync(DTK_FULL, f, src);
        const uint32_t fa = __shfl_sync(DTK_FULL, a, src);
        const uint32_t fb = __shfl_sync(DTK_FULL, b2, src);
        if (rr >= 0 && rr < 4) {
            *rf = ff;
            *rv = fa;
            *rv2 = fb;
        }
    }
}

// One warp's tile of 32 queries from q[base]; every lane of the warp
// calls it.  ul: 32 bytes of shared memory for this warp.
template <int VW, class TF, class TV>
__device__ __forceinline__ void dtk_group_probe(
    const int64_t* __restrict__ q, const int64_t* __restrict__ qloc,
    int64_t n, int64_t base, const DtkLevels& lv, int W, int composite,
    int nval, TF* __restrict__ found, TV* __restrict__ val,
    TV* __restrict__ val2, uint8_t* ul) {
    const int64_t mi = base + (threadIdx.x & 31);
    const bool inb = mi < n;
    const uint64_t myq = inb ? (uint64_t)q[mi] : 0ull;
    const uint32_t myloc = composite && inb ? (uint32_t)qloc[mi] : 0u;
    uint32_t rf, rv, rv2;                        // query mi's answer
    dtk_group_probe_lanes<VW>(inb, myq, myloc, lv, W, composite, nval, ul,
                              &rf, &rv, &rv2);
    if (inb) {
        found[mi] = (TF)rf;
        val[mi] = (TV)rv;
        val2[mi] = (TV)rv2;
    }
}
