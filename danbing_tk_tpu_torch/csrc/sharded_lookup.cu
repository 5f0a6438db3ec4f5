// KI sharded_lookup: probe the rows of a bucket table that one rank owns.
//
// Replaces K14's probe, danbing_tk_tpu/parallel/sharded_index.py:53
// lookup_bucket_sharded (inside shard_map: all_gather the queries, probe
// the chip's 1/D row block of every level with a bucket-range mask, then
// psum_scatter the int32 found/val/val2 planes).  The collectives stay in
// torch.distributed (parallel/sharded_index.py); this kernel is the
// middle step.  Per level a query hashes with the FULL level's bucket
// count (the block's own row count would send every probe to the wrong
// row), skips the level unless the bucket lies in [off, off + rows), and
// compares the 8 slots of the local row b - off.  The probe stops at the
// first owned hit in level order, which sets val/val2 (JAX probes every
// level, as shard_map runs them data-parallel, and keeps the first hit's
// values: the same answer); an unowned level is skipped, not a miss that
// ends the probe.  found/val/val2 come out as int32 planes, zero where
// this rank owns no matching bucket, so the sum over ranks is the whole
// table's answer (a real key lives in one bucket of one level, which
// exactly one rank owns).
//
// Bound on the H100: bytes.  Each gathered query is read once (8 B, 16
// with a locus), each owned (query, level) up to the query's first owned
// hit reads one 8-slot row (128 B at W = 4) from a random place, and three
// int32 planes are written; what the card gives for random rows is set by
// how many are in flight.  The first design ran one thread per query that
// compared its row with up to 32 dependent scalar loads: at D = 1 (every
// row owned, the sharded funnel at world 1) it took twice KB's time on the
// same queries.  Now the launch is chosen from the block's shape:
//   * a block that holds every row of a non-composite table launches KB's
//     group probe (group_probe.cuh: 8 lanes a query, one coalesced row
//     load, repeated queries probed once), with int32 planes;
//   * a block of 1/D of the rows keeps a lane a query, which skips an
//     unowned level without a load (at D = 4 three lanes in four own no
//     level-0 bucket, and 8-lane groups over the few owned queries left
//     rounds of mostly idle groups), and reads an owned W = 4 or W = 2 row
//     with 8 independent vector loads marked evict-first (__ldcs: a random
//     row is read once), so every owned lane's row is in flight at once
//     (on an H100, the same rows through group_probe.cuh's dtk_slot_match,
//     which loads with __ldg, took 17% longer at D = 4);
//   * a composite table (trfl) keeps bucket.cuh's scalar compare at every
//     D: its queries are mostly (EMPTY, 0), one hot row that stays in L1,
//     where the compare's short-circuit loads beat 8 vector loads a lane
//     (on an H100, the D = 4 block that owns that row takes a third longer
//     with vector loads, and the group probe at D = 1 is slower too).
#include "group_probe.cuh"

// A rank's row block of each level: the block's rows, the full level's
// bucket mask and salt, and the block's first bucket and row count.
struct DtkBlock {
    const uint32_t* t[DTK_MAXLEV];
    uint32_t mask[DTK_MAXLEV];
    uint32_t salt[DTK_MAXLEV];
    int64_t off[DTK_MAXLEV];
    int64_t rows[DTK_MAXLEV];
    int n;
};

// A block that owns every row of a non-composite table: KB's group probe.
template <int VW>
__global__ void __launch_bounds__(DTK_PROBE_THREADS)
whole_lookup_kernel(const int64_t* __restrict__ q,
                    const int64_t* __restrict__ qloc, int64_t n,
                    DtkLevels lv, int W, int composite, int nval,
                    int32_t* __restrict__ found, int32_t* __restrict__ val,
                    int32_t* __restrict__ val2) {
    __shared__ uint8_t ulane[DTK_PROBE_THREADS / 32][32];
    const int64_t base =
        (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * 32;
    if (base >= n) return;                       // whole warps
    dtk_group_probe<VW>(q, qloc, n, base, lv, W, composite, nval, found, val,
                        val2, ulane[threadIdx.x >> 5]);
}

// One lane's probe of its owned levels: VW = 4 (lo, hi, val, val2) or 2
// (lo, hi) rows as vector loads, VW = 0 with the scalar compare (any W,
// composite rows).  Returns found, with *a / *b2 the first owned hit's
// values.
template <int VW>
__device__ __forceinline__ uint32_t ki_owned_probe(const DtkBlock& lv, int W,
                                                   int composite, int nval,
                                                   uint64_t key,
                                                   uint32_t loc, uint32_t* a,
                                                   uint32_t* b2) {
    const uint32_t lo = (uint32_t)key, hi = (uint32_t)(key >> 32);
    uint32_t f = 0;
    *a = *b2 = 0;
    for (int l = 0; l < lv.n && !f; ++l) {
        const int64_t b = dtk_bucket(lv.salt[l], lv.mask[l], composite, lo,
                                     hi, loc);
        if (b < lv.off[l] || b >= lv.off[l] + lv.rows[l]) continue;
        const uint32_t* row = lv.t[l] + (size_t)(b - lv.off[l]) * 8 * W;
        if constexpr (VW == 0) {
            f = dtk_row_match(row, W, composite, nval, lo, hi, loc, a, b2);
        } else {
#pragma unroll
            for (int s = 0; s < 8; ++s) {
                bool m;
                uint32_t va = 0, vb = 0;
                if constexpr (VW == 4) {
                    const uint4 x = __ldcs((const uint4*)(row + s * 4));
                    m = x.x == lo && x.y == hi;
                    va = nval >= 1 ? x.z : 0u;
                    vb = nval == 2 ? x.w : 0u;
                } else {
                    const uint2 x = __ldcs((const uint2*)(row + s * 2));
                    m = x.x == lo && x.y == hi;
                }
                if (m) {
                    f = 1;
                    *a = max(*a, va);
                    *b2 = max(*b2, vb);
                }
            }
        }
    }
    return f;
}

// A lane a query over its owned levels.
template <int VW>
__global__ void __launch_bounds__(DTK_PROBE_THREADS)
owned_lookup_kernel(const int64_t* __restrict__ q,
                    const int64_t* __restrict__ qloc, int64_t n,
                    DtkBlock lv, int W, int composite, int nval,
                    int32_t* __restrict__ found, int32_t* __restrict__ val,
                    int32_t* __restrict__ val2) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t a, b2;
    const uint32_t f = ki_owned_probe<VW>(
        lv, W, composite, nval, (uint64_t)q[i],
        composite ? (uint32_t)qloc[i] : 0u, &a, &b2);
    found[i] = (int32_t)f;
    val[i] = (int32_t)a;
    val2[i] = (int32_t)b2;
}

// The block's levels from the wrapper's arrays (owned_args); returns
// whether it owns every row of every level.
static bool ki_block(DtkBlock* bl, const void* tabs, const void* nbs,
                     const void* salts, const void* offs, const void* rows,
                     int64_t nlev) {
    bl->n = (int)nlev;
    bool whole = true;
    for (int l = 0; l < bl->n; ++l) {
        const int64_t nb = ((const int64_t*)nbs)[l];
        bl->t[l] = ((const uint32_t* const*)tabs)[l];
        bl->mask[l] = (uint32_t)(nb - 1);
        bl->salt[l] = (uint32_t)((const int64_t*)salts)[l];
        bl->off[l] = ((const int64_t*)offs)[l];
        bl->rows[l] = ((const int64_t*)rows)[l];
        whole = whole && bl->off[l] == 0 && bl->rows[l] == nb;
    }
    return whole;
}

DTK_EXPORT int dtk_sharded_lookup(const void* q, const void* qloc, int64_t n,
                                  const void* tabs, const void* nbs,
                                  const void* salts, const void* offs,
                                  const void* rows, int64_t nlev,
                                  int64_t composite, int64_t nval,
                                  void* found, void* val, void* val2,
                                  void* stream) {
    if (nlev > DTK_MAXLEV) return (int)cudaErrorInvalidValue;
    DtkBlock bl;
    // whole: the block owns every row
    const bool whole = ki_block(&bl, tabs, nbs, salts, offs, rows, nlev);
    const int W = 2 + (int)composite + (int)nval;
    // the vector loads need every level's rows aligned to a slot
    const int VW = dtk_vector_width(bl, W);
    const unsigned blocks =
        (unsigned)((n + DTK_PROBE_THREADS - 1) / DTK_PROBE_THREADS);
    const cudaStream_t st = (cudaStream_t)stream;
    if (n > 0) {
        const int64_t* qq = (const int64_t*)q;
        const int64_t* ql = (const int64_t*)qloc;
        int32_t *f = (int32_t*)found, *v = (int32_t*)val,
                *v2 = (int32_t*)val2;
#define DTK_KI_LAUNCH(K, L, V)                                             \
    K<V><<<blocks, DTK_PROBE_THREADS, 0, st>>>(qq, ql, n, L, W,            \
                                              (int)composite, (int)nval,  \
                                              f, v, v2)
        if (whole && !composite) {
            DtkLevels lv;
            dtk_levels(&lv, tabs, nbs, salts, nlev);
            if (VW == 4) DTK_KI_LAUNCH(whole_lookup_kernel, lv, 4);
            else if (VW == 2) DTK_KI_LAUNCH(whole_lookup_kernel, lv, 2);
            else DTK_KI_LAUNCH(whole_lookup_kernel, lv, 0);
        } else if (!composite && VW == 4) {
            DTK_KI_LAUNCH(owned_lookup_kernel, bl, 4);
        } else if (!composite && VW == 2) {
            DTK_KI_LAUNCH(owned_lookup_kernel, bl, 2);
        } else {
            DTK_KI_LAUNCH(owned_lookup_kernel, bl, 0);
        }
#undef DTK_KI_LAUNCH
    }
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// KI[count]: the sharded prefilter's probe, one hit count a read
// ---------------------------------------------------------------------------
//
// Replaces the member probe of K14 inside the JAX sharded prefilter,
// danbing_tk_tpu/parallel/sharded_index.py:131-137 (lookup_bucket_sharded's
// found plane, then prefilter_decide's (found & valid).sum(1) on the
// rank that asked).  It takes the gathered queries (world 2P_local, nf)
// int64, rank-major as all_gather leaves them, with EMPTY (-1) wherever
// the sampler found no valid window (no canonical k-mer of k <= 31 is -1,
// so q != -1 is valid), and writes hits (world 2P_local,) int32: how many
// of a read's queries are not EMPTY and hit in a bucket this rank owns.
// Each of a read's nf samples counts, a repeated window as often as it
// occurs.  A real key lives in one bucket that one rank owns, so the sum
// over ranks (one reduce_scatter of this plane, taken as it is) is the
// read's hits in the whole table; no value plane is read or written.
//
// Bound on the H100: bytes.  8 B a gathered query and 4 B a read written,
// and each distinct owned row that a non-EMPTY query probes up to its
// first owned hit (64 B at the member table's W = 2).  Layout: a warp takes
// the R = 32 / nf consecutive reads from r0 (1 from nf = 33), whose R nf
// queries are contiguous, in tiles of 32 lanes (one at nf <= 32); lane r
// counts read r0 + r's hits from the tiles' hit ballots (the popc of its
// nf lanes) and writes them.  The probe is KI's for the block's shape:
//   * WHOLE (the block owns every row, world 1): group_probe.cuh's group
//     probe over the tile's non-EMPTY queries (8 lanes a query, a tile's
//     queries of one key probed once, each lane given its own answer, so
//     a read whose windows repeat one k-mer counts each);
//   * else a lane a query over its owned levels (ki_owned_probe).
constexpr int KIC_WARPS = DTK_PROBE_THREADS / 32;

template <int VW, bool WHOLE, class Lv>
__global__ void __launch_bounds__(DTK_PROBE_THREADS)
count_lookup_kernel(const int64_t* __restrict__ q, int64_t R, int nf,
                    int rpw, Lv lv, int W, int nval,
                    int32_t* __restrict__ hits) {
    __shared__ uint8_t ulane[KIC_WARPS][32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t r0 = ((int64_t)blockIdx.x * KIC_WARPS + warp) * rpw;
    if (r0 >= R) return;                         // whole warps
    const int nr = (int)(R - r0 < rpw ? R - r0 : rpw);
    const int nq = nr * nf;
    const int64_t* qw = q + r0 * nf;
    // lane r's read: its nf lanes of the one tile's hit ballot (nf <= 32),
    // or every tile's hits (nf > 32, one read a warp)
    const unsigned mine =
        nf >= 32 ? DTK_FULL
                 : ((1u << nf) - 1u) << (lane < nr ? lane * nf : 0);
    // the hits of tile t's lanes, as a ballot
    auto tile = [&](int t) {
        const int w = t + lane;
        const uint64_t key = w < nq ? (uint64_t)qw[w] : ~0ull;
        const bool real = key != ~0ull;          // EMPTY is never probed
        uint32_t f = 0, a, b2;
        if constexpr (WHOLE) {
            dtk_group_probe_lanes<VW>(real, real ? key : 0ull, 0u, lv, W, 0,
                                      nval, ulane[warp], &f, &a, &b2);
        } else {
            if (real) f = ki_owned_probe<VW>(lv, W, 0, nval, key, 0u, &a,
                                             &b2);
        }
        return __ballot_sync(DTK_FULL, real && f);
    };
    int cnt;
    if (nf <= 32) {                              // one tile
        cnt = __popc(tile(0) & mine);
    } else {
        cnt = 0;
        for (int t = 0; t < nq; t += 32) {
            cnt += __popc(tile(t));
            __syncwarp();                        // ulane's next tile
        }
    }
    if (lane < nr) hits[r0 + lane] = cnt;
}

// hits (R,) int32 from the gathered queries q (R, nf) int64 and one rank's
// row blocks of a non-composite table of 2 + nval u32 a slot (the member
// table's W = 2, the dbi's 4), given as dtk_sharded_lookup takes them.
DTK_EXPORT int dtk_sharded_lookup_count(const void* q, int64_t R, int64_t nf,
                                        const void* tabs, const void* nbs,
                                        const void* salts, const void* offs,
                                        const void* rows, int64_t nlev,
                                        int64_t nval, void* hits,
                                        void* stream) {
    if (nlev > DTK_MAXLEV || nf < 1 || nf > (1 << 20) || nval < 0 ||
        nval > 2)
        return (int)cudaErrorInvalidValue;
    if ((uintptr_t)q & 7) return (int)cudaErrorMisalignedAddress;
    DtkBlock bl;
    const bool whole = ki_block(&bl, tabs, nbs, salts, offs, rows, nlev);
    const int W = 2 + (int)nval;
    const int VW = dtk_vector_width(bl, W);
    if (R <= 0) return (int)cudaGetLastError();
    const int rpw = nf <= 32 ? 32 / (int)nf : 1;
    const int64_t per_block = (int64_t)KIC_WARPS * rpw;
    const unsigned blocks = (unsigned)((R + per_block - 1) / per_block);
    const cudaStream_t st = (cudaStream_t)stream;
    const int64_t* qq = (const int64_t*)q;
    int32_t* h = (int32_t*)hits;
#define DTK_KIC_LAUNCH(V, WH, L)                                           \
    count_lookup_kernel<V, WH><<<blocks, DTK_PROBE_THREADS, 0, st>>>(      \
        qq, R, (int)nf, rpw, L, W, (int)nval, h)
    if (whole) {
        DtkLevels lv;
        dtk_levels(&lv, tabs, nbs, salts, nlev);
        if (VW == 4) DTK_KIC_LAUNCH(4, true, lv);
        else if (VW == 2) DTK_KIC_LAUNCH(2, true, lv);
        else DTK_KIC_LAUNCH(0, true, lv);
    } else if (VW == 4) {
        DTK_KIC_LAUNCH(4, false, bl);
    } else if (VW == 2) {
        DTK_KIC_LAUNCH(2, false, bl);
    } else {
        DTK_KIC_LAUNCH(0, false, bl);
    }
#undef DTK_KIC_LAUNCH
    return (int)cudaGetLastError();
}
