// The warp-tile probe of a composite 1-value table (lo, hi, locus, value
// slots, W = 4) shared by KG (novel_edges.cu, the tre table) and KE
// (thread_walk.cu, the graph table): a warp's tile of up to 32 queries, all
// at one locus (the read's dst0), in KB's cooperative layout
// (group_probe.cuh), with two changes that the tile's queries allow.
//
//  * Only the active lanes' keys are probed, compacted (a ballot and popc),
//    and a key repeated in the tile (a tandem repeat's period under 32) may
//    be probed once, by its lowest lane (__match_any_sync).
//  * The level stop.  build_bucket_table (index/device_table.py) keeps the
//    first eight keys of each bucket in a level and passes only the rest
//    on, so a key in level l >= 1 found a full row at every earlier level.
//    A query that misses a row holding an empty slot is therefore in no
//    later level and stops there; only a miss on a full row reads on.  A
//    slot is empty when its lo and hi are both all ones, which no k-mer of
//    k <= 31 is.  KF (read_filter.cu) reads its slots through
//    dtk_stop_slot too.  Its level loop is a copy of the one here: moved
//    into one shared function, the loop changed KF's compiled code (two
//    of its instances spilled 4-16 B) and KE's and KG's, while sharing the
//    slot read alone leaves all three as they were (PERF.md §6).
//
// A group of 8 lanes takes one unique key a round (lane s loads slot s as
// one uint4, a ballot gives the group its matches and its occupied slots);
// the warp's four groups take KEYS keys each a pass, their level-0 rows in
// flight at once.  The answer of unique key u lands in the warp's shared
// bytes, where each lane of that key reads it.  What holds a warp is the
// chain of passes, and the kernels' blocks cap registers at 32 so that all
// 2P warps of a P = 4096 step are resident at once: more keys a pass
// (KEYS = 4, 8), with their rows in registers or copied to shared memory
// by cp.async, cost occupancy and ran no faster (PERF.md §6).
#pragma once

#include "group_probe.cuh"

// Shared scratch of one warp's tile.
struct DtkTile {
    uint8_t lane[32];    // unique key u -> the lane that holds it
    uint8_t found[32];
    uint32_t val[32];
};

// Slot s of (lo, hi, loc)'s row at level l: whether it matches, whether it
// holds a key, and its value where it matches.
template <int VW>
__device__ __forceinline__ void dtk_stop_slot(const DtkLevels& lv, int l,
                                              uint32_t lo, uint32_t hi,
                                              uint32_t loc, int s, bool* m,
                                              bool* occ, uint32_t* v) {
    const uint32_t* sl =
        lv.t[l] +
        ((size_t)dtk_bucket(lv.salt[l], lv.mask[l], 1, lo, hi, loc) * 8 + s) *
            4;
    uint4 x;
    if constexpr (VW == 4) {
        x = __ldg((const uint4*)sl);
    } else {
        x = make_uint4(__ldg(sl), __ldg(sl + 1), __ldg(sl + 2), __ldg(sl + 3));
    }
    *m = x.x == lo && x.y == hi && x.z == loc;
    *occ = (x.x & x.y) != DTK_NAN32;
    *v = *m ? x.w : 0u;
}

// Every lane of the warp calls it; lanes with act probe key at loc.
// Returns whether this lane's key was found (false where !act) and sets
// *val to the max value of its matching slots at the first level that hit
// (kVal; else 0).  t: this warp's scratch.  kDedup: a key repeated in the
// tile is probed once (__match_any_sync); else every active lane probes
// its own.
template <int VW, int KEYS, bool kVal, bool kDedup>
__device__ __forceinline__ bool dtk_tile_probe(const DtkLevels& lv, bool act,
                                               uint64_t key, uint32_t loc,
                                               DtkTile* t, uint32_t* val) {
    const int lane = threadIdx.x & 31, g = lane >> 3, s = lane & 7;
    const unsigned sh = 8 * g;
    *val = 0;
    const unsigned am = __ballot_sync(DTK_FULL, act);
    if (!am) return false;                          // warp-uniform
    int lead = lane;
    if (kDedup && (am & (am - 1u)) && act)
        lead = __ffs(__match_any_sync(am, (unsigned long long)key)) - 1;
    const unsigned uniq = __ballot_sync(DTK_FULL, act && lead == lane);
    const int nu = __popc(uniq);
    const int rank = __popc(uniq & ((1u << lead) - 1u));   // lead's, of nu
    if (act && lead == lane) t->lane[rank] = (uint8_t)lane;
    __syncwarp();

#pragma unroll 1
    for (int it = 0; it * 4 * KEYS < nu; ++it) {
        uint32_t lo[KEYS], hi[KEYS], f[KEYS], v[KEYS];
        bool need[KEYS];
#pragma unroll
        for (int j = 0; j < KEYS; ++j) {
            const int u = (it * KEYS + j) * 4 + g;
            need[j] = u < nu;
            const uint64_t q =
                __shfl_sync(DTK_FULL, key, need[j] ? t->lane[u] : 0);
            lo[j] = (uint32_t)q;
            hi[j] = (uint32_t)(q >> 32);
            f[j] = v[j] = 0;
        }
        for (int l = 0; l < lv.n; ++l) {
            bool any = false;
#pragma unroll
            for (int j = 0; j < KEYS; ++j) any |= need[j];
            if (!__any_sync(DTK_FULL, any)) break;
            bool m[KEYS], occ[KEYS];
            uint32_t x[KEYS];
#pragma unroll
            for (int j = 0; j < KEYS; ++j) {
                m[j] = occ[j] = false;
                x[j] = 0;
                if (need[j])
                    dtk_stop_slot<VW>(lv, l, lo[j], hi[j], loc, s, &m[j],
                                      &occ[j], &x[j]);
            }
#pragma unroll
            for (int j = 0; j < KEYS; ++j) {
                const unsigned hit =
                    (__ballot_sync(DTK_FULL, m[j]) >> sh) & 0xFFu;
                const unsigned full =
                    (__ballot_sync(DTK_FULL, occ[j]) >> sh) & 0xFFu;
                uint32_t xm = 0;
                if constexpr (kVal) xm = dtk_group_max(x[j]);
                if (need[j] && hit) {
                    f[j] = 1;
                    v[j] = xm;
                }
                need[j] = need[j] && !hit && full == 0xFFu;
            }
        }
#pragma unroll
        for (int j = 0; j < KEYS; ++j) {
            const int u = (it * KEYS + j) * 4 + g;
            if (s == 0 && u < nu) {
                t->found[u] = (uint8_t)f[j];
                t->val[u] = v[j];
            }
        }
    }
    __syncwarp();
    const bool found = act && t->found[rank];
    if (found && kVal) *val = t->val[rank];
    __syncwarp();                 // the next tile rewrites the scratch
    return found;
}
