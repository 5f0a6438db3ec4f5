// KF read_filter: the QC mask and the bait filter of the counting step.
//
// Replaces K10, danbing_tk_tpu/engine/device_align.py:979-985 (qc[dst0]
// and the qc_drop / dev_pair planes), and K9, :990-1029 (bait: per read,
// lax.sort of the quality-masked k-mers, run starts and run lengths by
// prefix scans, a bait probe at every run start, an OR over the read).  On
// the TPU the sort and the scans were full-width passes over (2P, NKW)
// planes, the probe one gather per position.
//
// What a read's verdict needs is each distinct masked k-mer's multiplicity
// (& 0xFF, the reference's u8 count) and one bait probe at (k-mer, dst0);
// the order of the k-mers does not matter, since bf is an OR.  So:
//   1. qc_ok = qc[min(dst0, nloci)] == 1 (the table has nloci + 1 entries,
//      the last one 0); dev_pair = vote_pass & ~referee & qc_ok and
//      qc_drop = vote_pass & ~referee & ~qc_ok.  A pair that is not
//      dev_pair ends here with bf = 0: JAX masks bf by dev_pair.
//   2. A warp a read, a pair's mates in adjacent warps.  The read's k-mer
//      row is loaded as 16-B pairs (its quality mask as 2-B pairs) into
//      shared memory (masked positions EMPTY) and counted in the warp's
//      open-addressing table there: TS u32 words, TS the power of two
//      >= 1.25 NKW + 1, each 0 (free) or (count << 16) | (position + 1) of
//      the key's first claimant.  A key's first lane claims its slot with
//      one 32-bit CAS, which also counts it; a lane whose slot holds its
//      key adds 1 << 16; keys compare through the staged row.
//   3. The distinct keys are compacted to the front of the table and
//      probed in the layout of KB's cooperative probe (group_probe.cuh: 8
//      lanes a key, one uint4 slot a lane, a ballot and a shuffle max per
//      row): a group takes two keys a round, both rows in flight at
//      once.  A level of the table keeps the first eight keys of each
//      bucket and passes the rest to the next level, so a key that misses
//      a row with an empty slot is in no later level: only misses on full
//      rows (about one in eight at level 0's five keys a bucket) read on.
//      The first level that hits wins.  A violation is cnt < mi or
//      cnt > ma of the window (mi << 8) | ma; a read stops probing at its
//      first one.
//   4. bf per mate, and bf_pair = bf0 | bf1 through a 64-thread named
//      barrier of the pair's two warps.
// Without a bait table (QC only) a thread takes a pair.
//
// Bound on the H100: bytes.  The k-mer rows of the dev_pair reads (8 B per
// position, plus 1 B of qmask), the distinct bait rows their distinct
// k-mers read, and the small per-pair planes.  Pairs that are not
// dev_pair read 11 B and write 12.  Rows are read once, coalesced; the
// counting stays in shared memory; what is left are the random 128-B bait
// rows, one a distinct k-mer of a read (most miss, and stop at level 0),
// whose latency the warps in flight, two rows a lane, cover.
#include "tile_probe.cuh"

constexpr int KF_WARPS = 8;              // device_align.py KF_WARPS
constexpr int KF_SMEM_MAX = 232448;      // a block's shared memory
constexpr uint64_t KF_EMPTY = ~0ull;
constexpr int KF_KEYS = 2;               // keys a probe group takes a round

// The slots of a read's table and the warps of a block for NKW positions
// (device_align.py read_filter_launch).
inline int kf_table_slots(int64_t NKW) {
    int ts = 32;
    while (ts < NKW + NKW / 4 + 1) ts *= 2;
    return ts;
}
__host__ __device__ inline int64_t kf_warp_bytes(int64_t NKW, int ts) {
    return 8 * NKW + 4 * ts;
}
inline int kf_block_warps(int64_t NKW, int ts) {
    int w = KF_WARPS;
    while (w > 2 && w * kf_warp_bytes(NKW, ts) > KF_SMEM_MAX) w /= 2;
    return w;
}

__device__ __forceinline__ uint32_t kf_hash(uint64_t key) {
    return dtk_mix32((uint32_t)key ^ dtk_mix32((uint32_t)(key >> 32)));
}

// QC only: dev_pair and qc_drop, bf = 0.
__global__ void qc_filter_kernel(int64_t P, const int64_t* __restrict__ dst0,
                                 const uint8_t* __restrict__ vote_pass,
                                 const uint8_t* __restrict__ pack,
                                 const uint8_t* __restrict__ qc,
                                 int64_t nloci, uint8_t* __restrict__ dev_pair,
                                 uint8_t* __restrict__ qc_drop,
                                 int32_t* __restrict__ bf,
                                 uint8_t* __restrict__ bf_pair) {
    const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P) return;
    const uint64_t d = (uint64_t)dst0[p];
    const bool vp = vote_pass[p] != 0 && (pack[p] & 1) == 0;
    const bool qc_ok = qc[d < (uint64_t)nloci ? d : nloci] == 1;
    dev_pair[p] = vp && qc_ok;
    qc_drop[p] = vp && !qc_ok;
    *(int2*)(bf + 2 * p) = make_int2(0, 0);
    bf_pair[p] = 0;
}

// Counts position j's key in the warp's table (skey: the staged row).
__device__ __forceinline__ void kf_insert(const uint64_t* skey,
                                          uint32_t* tab, uint32_t mask,
                                          int j) {
    const uint64_t key = skey[j];
    if (key == KF_EMPTY) return;
    uint32_t s = kf_hash(key) & mask;
    for (;;) {
        const uint32_t old = atomicCAS(tab + s, 0u, (1u << 16) | (j + 1));
        if (old == 0) return;
        if (skey[(old & 0xFFFFu) - 1] == key) {
            atomicAdd(tab + s, 1u << 16);
            return;
        }
        s = (s + 1) & mask;
    }
}

template <bool kQc, bool kQmask, int VW>
__global__ void __launch_bounds__(KF_WARPS * 32)
read_filter_kernel(int64_t P, int NKW, int TS,
                   const int64_t* __restrict__ kmer,
                   const uint8_t* __restrict__ qmask,
                   const int64_t* __restrict__ dst0,
                   const uint8_t* __restrict__ vote_pass,
                   const uint8_t* __restrict__ pack,
                   const uint8_t* __restrict__ qc, int64_t nloci,
                   DtkLevels bait, uint8_t* __restrict__ dev_pair,
                   uint8_t* __restrict__ qc_drop, int32_t* __restrict__ bf,
                   uint8_t* __restrict__ bf_pair) {
    extern __shared__ unsigned long long kf_smem[];
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int pb = wid >> 1, m = wid & 1;
    const int64_t p = (int64_t)blockIdx.x * (blockDim.x >> 6) + pb;
    if (p >= P) return;                      // both warps of the pair
    const uint64_t d = (uint64_t)dst0[p];
    const bool vp = vote_pass[p] != 0 && (pack[p] & 1) == 0;
    bool qc_ok = true;
    if constexpr (kQc) qc_ok = qc[d < (uint64_t)nloci ? d : nloci] == 1;
    const bool dev = vp && qc_ok;
    if (m == 0 && lane == 0) {
        dev_pair[p] = dev;
        qc_drop[p] = vp && !qc_ok;
    }
    if (!dev) {                              // both warps of the pair
        if (lane == 0) {
            bf[2 * p + m] = 0;
            if (m == 0) bf_pair[p] = 0;
        }
        return;
    }
    uint64_t* skey = (uint64_t*)((char*)kf_smem +
                                 (size_t)wid * kf_warp_bytes(NKW, TS));
    uint32_t* tab = (uint32_t*)(skey + NKW);
    const uint32_t mask = (uint32_t)TS - 1u;
    for (int s = lane; s < TS; s += 32) tab[s] = 0;

    // 2. stage the read's masked k-mers, then count them
    const int64_t o = (2 * p + m) * (int64_t)NKW;
    const int64_t* row = kmer + o;
    const uint8_t* qrow = kQmask ? qmask + o : nullptr;
    const int head = (int)(o & 1);           // position 0 alone
    const int np = (NKW - head) / 2;
    for (int j = lane; j < np; j += 32) {
        const int w = head + 2 * j;
        const longlong2 v = __ldg((const longlong2*)(row + w));
        uint64_t k0 = (uint64_t)v.x, k1 = (uint64_t)v.y;
        if constexpr (kQmask) {
            const uint16_t q = __ldg((const unsigned short*)(qrow + w));
            if ((q & 0xFFu) == 0) k0 = KF_EMPTY;
            if ((q >> 8) == 0) k1 = KF_EMPTY;
        }
        skey[w] = k0;
        skey[w + 1] = k1;
    }
    {
        const int w = lane == 0 ? (head ? 0 : -1)
                                : lane == 1 && ((NKW - head) & 1) ? NKW - 1
                                                                  : -1;
        if (w >= 0)
            skey[w] = !kQmask || qrow[w] ? (uint64_t)row[w] : KF_EMPTY;
    }
    __syncwarp();
    for (int j = lane; j < NKW; j += 32) kf_insert(skey, tab, mask, j);
    __syncwarp();

    // 3. compact the occupied words to the front; a chunk is read whole
    // before any lane writes, and writes land at or below their own slot
    int nu = 0;
    for (int base = 0; base < TS; base += 32) {
        const uint32_t e = tab[base + lane];
        const unsigned b = __ballot_sync(DTK_FULL, e != 0);
        __syncwarp();
        if (e != 0) tab[nu + __popc(b & ((1u << lane) - 1u))] = e;
        nu += __popc(b);
        __syncwarp();
    }

    // probe: group g of 8 lanes takes keys 4 (KF_KEYS it + j) + g
    // (j < KF_KEYS), their level-0 rows in flight at once.  A level keeps
    // the first eight keys of each bucket (index/device_table.py
    // build_bucket_table), so a key that misses a row with an empty slot
    // is in no later level; only misses on full rows read on.
    const int g = lane >> 3, s = lane & 7;
    const unsigned sh = 8 * g;
    const uint32_t loc = (uint32_t)d;
    bool viol = false;
    for (int it = 0; it * 4 * KF_KEYS < nu; ++it) {
        uint64_t key[KF_KEYS];
        uint32_t c[KF_KEYS], f[KF_KEYS], v[KF_KEYS];
        bool need[KF_KEYS];
#pragma unroll
        for (int j = 0; j < KF_KEYS; ++j) {
            const int u = it * 4 * KF_KEYS + 4 * j + g;
            need[j] = u < nu;
            const uint32_t e = need[j] ? tab[u] : 0;
            key[j] = need[j] ? skey[(e & 0xFFFFu) - 1] : 0;
            c[j] = (e >> 16) & 0xFFu;
            f[j] = v[j] = 0;
        }
        for (int l = 0; l < bait.n; ++l) {
            bool any = false;
#pragma unroll
            for (int j = 0; j < KF_KEYS; ++j) any |= need[j];
            if (!__any_sync(DTK_FULL, any)) break;
            bool hit_[KF_KEYS], occ[KF_KEYS];
            uint32_t x[KF_KEYS];
#pragma unroll
            for (int j = 0; j < KF_KEYS; ++j) {
                hit_[j] = occ[j] = false;
                x[j] = 0;
                if (need[j])
                    dtk_stop_slot<VW>(bait, l, (uint32_t)key[j],
                                      (uint32_t)(key[j] >> 32), loc, s,
                                      &hit_[j], &occ[j], &x[j]);
            }
#pragma unroll
            for (int j = 0; j < KF_KEYS; ++j) {
                const unsigned hit =
                    (__ballot_sync(DTK_FULL, hit_[j]) >> sh) & 0xFFu;
                const unsigned full =
                    (__ballot_sync(DTK_FULL, occ[j]) >> sh) & 0xFFu;
                const uint32_t val = dtk_group_max(x[j]);
                if (need[j] && hit) {
                    f[j] = 1;
                    v[j] = val;
                }
                need[j] = need[j] && !hit && full == 0xFFu;
            }
        }
#pragma unroll
        for (int j = 0; j < KF_KEYS; ++j)
            viol |= f[j] && (c[j] < (v[j] >> 8) || c[j] > (v[j] & 0xFFu));
        if (__any_sync(DTK_FULL, viol)) break;
    }
    viol = __any_sync(DTK_FULL, viol);

    // 4. the table's first word carries this warp's verdict to the pair's
    // other warp
    if (lane == 0) {
        tab[0] = viol;
        bf[2 * p + m] = viol;
    }
    __syncwarp();
    asm volatile("bar.sync %0, 64;" ::"r"(pb + 1) : "memory");
    if (m == 0 && lane == 0) {
        const uint32_t* other = (const uint32_t*)(
            (const char*)tab + kf_warp_bytes(NKW, TS));
        bf_pair[p] = viol || other[0] != 0;
    }
}

template <bool kQc, bool kQmask, int VW>
static cudaError_t kf_launch(int64_t P, int NKW, const void* kmer,
                             const void* qmask, const void* dst0,
                             const void* vote_pass, const void* pack,
                             const void* qc, int64_t nloci,
                             const DtkLevels& bait, void* dev_pair,
                             void* qc_drop, void* bf, void* bf_pair,
                             cudaStream_t stream) {
    auto kernel = read_filter_kernel<kQc, kQmask, VW>;
    const int ts = kf_table_slots(NKW), nw = kf_block_warps(NKW, ts);
    const size_t smem = (size_t)nw * kf_warp_bytes(NKW, ts);
    if (smem > (size_t)KF_SMEM_MAX) return cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    const int ppb = nw / 2;
    kernel<<<(unsigned)((P + ppb - 1) / ppb), nw * 32, smem, stream>>>(
        P, NKW, ts, (const int64_t*)kmer, (const uint8_t*)qmask,
        (const int64_t*)dst0, (const uint8_t*)vote_pass,
        (const uint8_t*)pack, (const uint8_t*)qc, nloci, bait,
        (uint8_t*)dev_pair, (uint8_t*)qc_drop, (int32_t*)bf,
        (uint8_t*)bf_pair);
    return cudaGetLastError();
}

// qc may be null (no QC), bnlev 0 (no bait table), qmask null (no quality
// mask); the wrapper never asks for neither QC nor bait.  kmer must start
// on a 16-B boundary, qmask on a 2-B one, bf on an 8-B one (torch
// allocations do).
DTK_EXPORT int dtk_read_filter(int64_t P, int64_t NKW, const void* kmer,
                               const void* qmask, const void* dst0,
                               const void* vote_pass, const void* pack,
                               const void* qc, int64_t nloci,
                               const void* btabs, const void* bnbs,
                               const void* bsalts, int64_t bnlev,
                               void* dev_pair, void* qc_drop, void* bf,
                               void* bf_pair, void* stream) {
    DtkLevels bait;
    bait.n = 0;
    if (bnlev > 0 && !dtk_levels(&bait, btabs, bnbs, bsalts, bnlev))
        return (int)cudaErrorInvalidValue;
    if (qc == nullptr && bnlev <= 0) return (int)cudaErrorInvalidValue;
    if (((uintptr_t)kmer & 15) || ((uintptr_t)qmask & 1) ||
        ((uintptr_t)bf & 7))
        return (int)cudaErrorMisalignedAddress;
    if (P <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    if (bnlev <= 0) {
        qc_filter_kernel<<<dtk_grid(P, 256), 256, 0, s>>>(
            P, (const int64_t*)dst0, (const uint8_t*)vote_pass,
            (const uint8_t*)pack, (const uint8_t*)qc, nloci,
            (uint8_t*)dev_pair, (uint8_t*)qc_drop, (int32_t*)bf,
            (uint8_t*)bf_pair);
        return (int)cudaGetLastError();
    }
    if (NKW < 1 || NKW > 0xFFFF) return (int)cudaErrorInvalidValue;
    const bool has_qc = qc != nullptr, has_qm = qmask != nullptr,
               vec = dtk_vector_width(bait, 4) == 4;
#define KF_ARGS P, (int)NKW, kmer, qmask, dst0, vote_pass, pack, qc, nloci, \
    bait, dev_pair, qc_drop, bf, bf_pair, s
#define KF_QM(QC, VW) (has_qm ? kf_launch<QC, true, VW>(KF_ARGS) \
                              : kf_launch<QC, false, VW>(KF_ARGS))
    cudaError_t e;
    if (vec)
        e = has_qc ? KF_QM(true, 4) : KF_QM(false, 4);
    else
        e = has_qc ? KF_QM(true, 0) : KF_QM(false, 0);
#undef KF_QM
#undef KF_ARGS
    return (int)e;
}
