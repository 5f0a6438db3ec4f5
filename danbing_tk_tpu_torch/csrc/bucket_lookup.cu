// KB bucket_lookup: probe a bucketized multi-level hash table.
//
// Replaces K2, danbing_tk_tpu/index/device_table.py:336 bucket_index_jax +
// :356 lookup_bucket_jax (one row gather per level on the TPU, where the
// gather unit's per-row cost bound every probe stage).
//
// Bound on the H100: bytes.  Each query moves one 8-slot row (8 * W u32:
// 128 B at W = 4, 64 B for the member table's W = 2) from HBM for level 0,
// plus one more row only for misses and second-level keys; the rows land
// in random places, so nothing coalesces across queries, and what the card
// gives for random rows is set by how many are in flight.  The first
// design had one thread per query compare its 8 slots with up to 32
// dependent scalar loads, so a few sectors were in flight per thread and
// the probe ran at a third of the bytes' time.
//
// Here a group of 8 lanes probes one query: lane s loads slot s of the row
// as one uint4 (W = 4) or uint2 (W = 2), so a row is one coalesced 128 B
// (64 B) transaction.  A ballot gives each group its matching slots and a
// 3-step xor-shuffle max their values; the first level that hits wins,
// and a group stops there.  A warp takes a tile of 32 consecutive queries
// in rounds of four: one coalesced load of keys (and loci) first, and lane
// j stores query j's found, val and val2 last, so the outputs are
// coalesced too.  A tile of one repeated query probes it once (the trfl
// probe's queries are mostly runs of (EMPTY, 0)); in a tile where some
// query repeats its neighbour's, lanes of one (key, locus) probe once
// (__match_any_sync).  Any other W (or a level not aligned for the vector
// load) takes the same layout with scalar loads.  The hash is bucket.cuh's
// dtk_bucket, shared with KF, KG, KI and KJ, whose own per-thread probe
// (dtk_probe) is unchanged.
#include "bucket.cuh"

constexpr unsigned FULL = 0xFFFFFFFFu;

// Slot s of row b of a level: whether it matches, and its value planes.
template <int VW>
__device__ __forceinline__ bool slot_match(const uint32_t* t, uint32_t b,
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

__device__ __forceinline__ uint32_t group_max(uint32_t v) {
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

template <int VW>
__global__ void __launch_bounds__(256)
bucket_lookup_kernel(const int64_t* __restrict__ q,
                     const int64_t* __restrict__ qloc, int64_t n,
                     DtkLevels lv, int W, int composite, int nval,
                     uint8_t* __restrict__ found, int64_t* __restrict__ val,
                     int64_t* __restrict__ val2) {
    const int lane = threadIdx.x & 31, g = lane >> 3, s = lane & 7;
    const int64_t base =
        (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * 32;
    if (base >= n) return;                       // whole warps
    const int64_t mi = base + lane;
    const bool inb = mi < n;
    const uint64_t myq = inb ? (uint64_t)q[mi] : 0ull;
    const uint32_t myloc = composite && inb ? (uint32_t)qloc[mi] : 0u;
    // a repeated (key, locus) is probed once, by its lowest lane; the match
    // runs only where some query repeats its neighbour's (random k-mers
    // seldom do)
    const unsigned inm = __ballot_sync(FULL, inb);
    const uint64_t pq = __shfl_up_sync(FULL, myq, 1);
    const uint32_t pl = __shfl_up_sync(FULL, myloc, 1);
    const uint64_t q0 = __shfl_sync(FULL, myq, 0);
    const uint32_t l0 = __shfl_sync(FULL, myloc, 0);
    unsigned same = 1u << lane;
    if (__all_sync(FULL, !inb || (myq == q0 && myloc == l0))) {
        same = inm;                              // one query in the tile
    } else if (__any_sync(FULL, inb && lane > 0 && pq == myq &&
                                    pl == myloc) && inb) {
        same = __match_any_sync(inm, (unsigned long long)myq);
        if (composite) same &= __match_any_sync(inm, myloc);
    }
    const int lead = inb ? __ffs(same) - 1 : lane;
    const unsigned uniq = __ballot_sync(FULL, inb && lead == lane);
    const int nu = __popc(uniq);
    const int rank = __popc(uniq & ((1u << lead) - 1u));  // lead's, of nu
    // unique query -> its lane (the identity when nothing repeats: the
    // in-range lanes are the low ones)
    __shared__ uint8_t ulane[256 / 32][32];
    uint8_t* ul = ulane[threadIdx.x >> 5];
    const bool dup = uniq != inm;
    if (dup && inb && lead == lane) ul[rank] = (uint8_t)lane;
    __syncwarp();
    uint32_t rf = 0, rv = 0, rv2 = 0;            // query mi's answer

#pragma unroll 1
    for (int it = 0; it * 4 < nu; ++it) {
        const int u = it * 4 + g;                // this group's unique query
        bool done = u >= nu;
        const int qi = done ? 0 : dup ? ul[u] : u;
        const uint64_t key = __shfl_sync(FULL, myq, qi);
        const uint32_t loc = __shfl_sync(FULL, myloc, qi);
        const uint32_t lo = (uint32_t)key, hi = (uint32_t)(key >> 32);
        uint32_t f = 0, a = 0, b2 = 0;
        for (int l = 0; l < lv.n && __any_sync(FULL, !done); ++l) {
            uint32_t va = 0, vb = 0;
            bool m = false;
            if (!done)
                m = slot_match<VW>(lv.t[l],
                                   dtk_bucket(lv.salt[l], lv.mask[l],
                                              composite, lo, hi, loc),
                                   s, W, composite, nval, lo, hi, loc, &va,
                                   &vb);
            const unsigned hit = (__ballot_sync(FULL, m) >> (g * 8)) & 0xFFu;
            const uint32_t x = group_max(va), y = group_max(vb);
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
        const uint32_t ff = __shfl_sync(FULL, f, src);
        const uint32_t fa = __shfl_sync(FULL, a, src);
        const uint32_t fb = __shfl_sync(FULL, b2, src);
        if (rr >= 0 && rr < 4) {
            rf = ff;
            rv = fa;
            rv2 = fb;
        }
    }
    if (inb) {
        found[mi] = (uint8_t)rf;
        val[mi] = rv;
        val2[mi] = rv2;
    }
}

DTK_EXPORT int dtk_bucket_lookup(const void* q, const void* qloc, int64_t n,
                                 const void* tabs, const void* nbs,
                                 const void* salts, int64_t nlev,
                                 int64_t composite, int64_t nval,
                                 void* found, void* val, void* val2,
                                 void* stream) {
    DtkLevels lv;
    if (!dtk_levels(&lv, tabs, nbs, salts, nlev))
        return (int)cudaErrorInvalidValue;
    const int W = 2 + (int)composite + (int)nval;
    // the vector loads need every level's rows aligned to a slot
    int VW = (W == 4 || W == 2) ? W : 0;
    for (int l = 0; l < lv.n; ++l)
        if ((uintptr_t)lv.t[l] % (4 * (uintptr_t)W)) VW = 0;
    const int threads = 256;                     // 32 queries a warp
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    const cudaStream_t st = (cudaStream_t)stream;
    if (n > 0) {
#define DTK_KB_LAUNCH(V)                                                  \
    bucket_lookup_kernel<V><<<blocks, threads, 0, st>>>(                  \
        (const int64_t*)q, (const int64_t*)qloc, n, lv, W, (int)composite, \
        (int)nval, (uint8_t*)found, (int64_t*)val, (int64_t*)val2)
        if (VW == 4) DTK_KB_LAUNCH(4);
        else if (VW == 2) DTK_KB_LAUNCH(2);
        else DTK_KB_LAUNCH(0);
#undef DTK_KB_LAUNCH
    }
    return (int)cudaGetLastError();
}
