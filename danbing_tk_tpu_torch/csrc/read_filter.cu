// KF read_filter: the QC mask and the bait filter of the counting step.
//
// Replaces K10, danbing_tk_tpu/engine/device_align.py:979-985 (qc[dst0]
// and the qc_drop / dev_pair planes), and K9, :990-1029 (bait: per read,
// lax.sort of the quality-masked k-mers, run starts and run lengths by
// prefix scans, a bait probe at every run start, an OR over the read).  On
// the TPU the sort and the scans were full-width passes over (2P, NKW)
// planes, the probe one gather per position.
//
// One block per pair:
//   1. qc_ok = qc[min(dst0, nloci)] == 1 (the table has nloci + 1 entries,
//      the last one 0); dev_pair = vote_pass & ~referee & qc_ok and
//      qc_drop = vote_pass & ~referee & ~qc_ok.  A pair that is not
//      dev_pair ends here with bf = 0: JAX masks bf by dev_pair.
//   2. Both mates' k-mer rows go into shared memory, one tile of NP (the
//      power of two >= NKW) entries each, quality-masked positions and
//      EMPTY as all ones; a bitonic sort per tile, comparing as unsigned,
//      so EMPTY sorts last as in JAX's u32 (hi, lo) sort.
//   3. At each run start of a valid k-mer: cnt = run length & 0xFF (the
//      reference's u8 count), one probe of the bait table at (k-mer, dst0)
//      through the shared bucket.cuh probe, a violation when the window
//      (mi << 8) | ma says cnt < mi or cnt > ma.
//   4. bf per mate and bf_pair = bf0 | bf1.
//
// Bound on the H100: bytes.  The k-mer rows of the dev_pair reads (8 B per
// position, plus 1 B of qmask), the distinct bait rows their run starts
// read, and the small per-pair planes.  Pairs that are not dev_pair read
// 11 B and write 12.  The design reads each row once, coalesced, and keeps
// the sort and the run scan in shared memory; only run starts probe.
#include "bucket.cuh"

constexpr int KF_THREADS = 256;
constexpr uint64_t KF_EMPTY = ~0ull;

template <bool kQc, bool kBait, bool kQmask>
__global__ void read_filter_kernel(int NKW, int NP,
                                   const int64_t* __restrict__ kmer,
                                   const uint8_t* __restrict__ qmask,
                                   const int64_t* __restrict__ dst0,
                                   const uint8_t* __restrict__ vote_pass,
                                   const uint8_t* __restrict__ pack,
                                   const uint8_t* __restrict__ qc,
                                   int64_t nloci, DtkLevels bait,
                                   uint8_t* __restrict__ dev_pair,
                                   uint8_t* __restrict__ qc_drop,
                                   int32_t* __restrict__ bf,
                                   uint8_t* __restrict__ bf_pair) {
    extern __shared__ uint64_t s_key[];       // 2 * NP
    __shared__ int s_viol[2];
    const int64_t p = blockIdx.x;
    const int tid = threadIdx.x;
    const uint64_t d = (uint64_t)dst0[p];
    const bool vp = vote_pass[p] != 0 && (pack[p] & 1) == 0;
    bool qc_ok = true;
    if constexpr (kQc) qc_ok = qc[d < (uint64_t)nloci ? d : nloci] == 1;
    const bool dev = vp && qc_ok;
    if (tid == 0) {
        dev_pair[p] = dev;
        qc_drop[p] = vp && !qc_ok;
    }
    if (!kBait || !dev) {
        if (tid < 2) bf[2 * p + tid] = 0;
        if (tid == 0) bf_pair[p] = 0;
        return;
    }
    for (int i = tid; i < 2 * NP; i += blockDim.x) {
        const int m = i >= NP, j = i - m * NP;
        uint64_t key = KF_EMPTY;
        if (j < NKW) {
            const int64_t o = (2 * p + m) * NKW + j;
            if (!kQmask || qmask[o]) key = (uint64_t)kmer[o];
        }
        s_key[i] = key;
    }
    if (tid < 2) s_viol[tid] = 0;
    __syncthreads();
    // one bitonic network over both tiles: j < NP keeps a partner in its
    // own tile, and the direction bit is taken within the tile
    for (int k = 2; k <= NP; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int i = tid; i < 2 * NP; i += blockDim.x) {
                const int ixj = i ^ j;
                if (ixj > i) {
                    const bool asc = ((i & (NP - 1)) & k) == 0;
                    const uint64_t a = s_key[i], b = s_key[ixj];
                    if ((a > b) == asc) {
                        s_key[i] = b;
                        s_key[ixj] = a;
                    }
                }
            }
            __syncthreads();
        }
    }
    const uint32_t loc = (uint32_t)d;
    for (int i = tid; i < 2 * NP; i += blockDim.x) {
        const uint64_t key = s_key[i];
        const int m = i >= NP, j = i - m * NP;
        if (key == KF_EMPTY || (j > 0 && s_key[i - 1] == key)) continue;
        int e = j + 1;
        while (e < NP && s_key[m * NP + e] == key) ++e;
        const uint32_t cnt = (uint32_t)(e - j) & 0xFFu;
        uint32_t v, v2;
        if (dtk_probe(bait, 4, 1, 1, key, loc, &v, &v2) &&
            (cnt < (v >> 8) || cnt > (v & 0xFFu)))
            s_viol[m] = 1;
    }
    __syncthreads();
    if (tid < 2) bf[2 * p + tid] = s_viol[tid];
    if (tid == 0) bf_pair[p] = s_viol[0] | s_viol[1];
}

template <bool kQc, bool kBait, bool kQmask>
static cudaError_t launch(int64_t P, int NKW, int NP, const void* kmer,
                          const void* qmask, const void* dst0,
                          const void* vote_pass, const void* pack,
                          const void* qc, int64_t nloci,
                          const DtkLevels& bait, void* dev_pair,
                          void* qc_drop, void* bf, void* bf_pair,
                          cudaStream_t stream) {
    auto kernel = read_filter_kernel<kQc, kBait, kQmask>;
    const size_t smem = kBait ? (size_t)2 * NP * sizeof(uint64_t) : 0;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    kernel<<<(unsigned)P, KF_THREADS, smem, stream>>>(
        NKW, NP, (const int64_t*)kmer, (const uint8_t*)qmask,
        (const int64_t*)dst0, (const uint8_t*)vote_pass,
        (const uint8_t*)pack, (const uint8_t*)qc, nloci, bait,
        (uint8_t*)dev_pair, (uint8_t*)qc_drop, (int32_t*)bf,
        (uint8_t*)bf_pair);
    return cudaGetLastError();
}

// qc may be null (no QC), bnlev 0 (no bait table), qmask null (no quality
// mask); the wrapper never asks for neither QC nor bait.
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
    if (P <= 0) return (int)cudaGetLastError();
    int NP = 1;
    while (NP < NKW) NP <<= 1;
    const bool has_qc = qc != nullptr, has_bait = bnlev > 0,
               has_qm = has_bait && qmask != nullptr;
    cudaStream_t s = (cudaStream_t)stream;
#define KF_ARGS P, (int)NKW, NP, kmer, qmask, dst0, vote_pass, pack, qc, \
    nloci, bait, dev_pair, qc_drop, bf, bf_pair, s
    cudaError_t e;
    if (!has_bait)
        e = launch<true, false, false>(KF_ARGS);
    else if (has_qc)
        e = has_qm ? launch<true, true, true>(KF_ARGS)
                   : launch<true, true, false>(KF_ARGS);
    else
        e = has_qm ? launch<false, true, true>(KF_ARGS)
                   : launch<false, true, false>(KF_ARGS);
#undef KF_ARGS
    return (int)e;
}
