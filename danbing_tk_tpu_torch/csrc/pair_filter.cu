// KL pair_filter: the counting step's subfilter and k-mer filter over
// KB's dbi probe, and KL[decide]: the sampled-k-mer prefilter's decision
// after a collective probe.
//
// Replaces K4, danbing_tk_tpu/engine/device_align.py:597-620 (make_step's
// subfilter and kfilter: the nf sampled positions' hits, kf, pair_kf and
// the vote's use plane), and on the collective-probe paths K3's decision,
// :371 prefilter_decide.  The arithmetic is engine/device_align.py's
// pair_filter_plain and prefilter_decide:
//   found &= kvalid; nonshort = any_valid of both mates & live;
//   S = nk / max(nf - 1, 1), sample i at i S and the last at nk - 1, each
//   index clamped into [0, NKW - 1] (JAX's clamping gather: nk = 0 reads
//   position 0); with nf = 0 or nmf = 0 every pair passes the subfilter,
//   else a pair passes when each mate has >= nmf sampled hits;
//   kf = (found count < cth); pair_kf = pair_sub & !(both mates kf);
//   use = found & kf == 0 & pair_kf.
//
// Bound on the H100: bytes.  KL reads found and kvalid (2P, NKW) u8 once
// and writes the masked found and use once: four planes of 2 P NKW bytes
// (1,146,880 B each at P = 4096, NKW = 140), plus 11 B a pair of nk,
// any_valid and live in and 11 B a pair of kf, nonshort, sub_drop and
// pair_kf out: 4,677,632 B, 1.4 us at 3.35 TB/s.
//
// The first design gave a warp a pair and swept its rows a byte a lane (9
// chunks of 32 B at NKW = 140, a load, a ballot and a store each, then 9
// more byte stores of use): 0.0077 ms, 18% of the bound.  Staging a
// block's rows in shared memory and sweeping them so, a byte a lane with
// ballot words, ran no faster (0.0079 against 0.0075 in one call): a
// warp's ~700 instructions a pair, not its memory round trips, held both.
// Here a block takes G consecutive pairs (8; fewer only where their span
// passes a block's shared memory, NKW past ~14,500), whose rows are one
// contiguous span of n = 2 G NKW bytes in each plane (2,240 B at NKW =
// 140, a multiple of 16 at G = 8), and a thread a 16-byte chunk of it,
// four positions a 32-bit word:
//   1. one round trip in: each thread loads its chunk of found and of
//      kvalid (uint4 loads, neighbouring threads on neighbouring
//      addresses; the last chunk's bytes past the span, and every byte of
//      a span whose start is not 16-byte aligned, byte-wise), ANDs them
//      word-wise (0/1 bytes), stores the masked chunk to found_out at once
//      and into the block's span in shared memory, and adds each row's
//      ones in the chunk (popc of the words under the row's byte mask)
//      into the row's count with a shared-memory atomic (a chunk meets one
//      or two rows at NKW >= 16);
//   2. warp 0, a lane a row: the row's nf sampled positions read from the
//      shared span (32-bit index arithmetic), its kf, and with its mate's
//      lane (a shuffle) the pair's nonshort, sub_drop and pair_kf, and a
//      flag a row whether its positions are used (pair_kf and the mate's
//      kf == 0);
//   3. one round trip out: each thread ANDs its masked chunk with the used
//      rows' byte masks and stores use (uint4, bytes past the span
//      byte-wise).
// Three barriers (the counters zeroed while the loads are in flight, and
// between the steps); nothing else touches device memory.  A position is
// a byte of 0 or 1 (torch's bool).  Each chunk's thread deciding the pairs
// its chunk meets itself, one barrier fewer, ran slower (0.0063 ms): the
// decisions' divisions and sample reads, once a pair in warp 0, were then
// made in every chunk's thread.
//
// KL[decide] reads hits (2P,) int32 (each read's valid sampled k-mers
// found: the collective probe's count, KI[count] summed over the ranks),
// nonshort (2P,) as bool, or as the sampler's nk int32 (a read is
// nonshort where nk > 0), and live (P,), and writes survive (P,): a
// thread a pair, 256 a block.  A pair survives when it is live and each
// mate is nonshort with hits >= nmf.  Bound: bytes, 4 x 2 + 2 + 1 B a pair
// in (8 B of nk in place of 2 of nonshort), 1 B out (196,608 B, or
// 294,912 B with nk, at 16,384 pairs: under 0.1 us); the launch is what
// it costs.  Its first form read the (2P, nf) found and valid planes of a
// collective probe that returned KI's three value planes per query; the
// counting now happens on the probe's side (sharded_lookup.cu).
#include "common.cuh"

constexpr int KL_G = 8;                  // pairs a block at most
constexpr int KL_THREADS = 256;          // a thread a 16-byte chunk a pass
constexpr int KLD_THREADS = 256;         // KL[decide]: a thread a pair
constexpr size_t KL_SMEM_MAX = 232448;   // a block's shared memory

// Shared memory of a block of g pairs: the masked span in 16-byte chunks,
// and a count and a use flag a row.
inline size_t kl_smem(int g, int64_t NKW) {
    return (size_t)((2 * g * NKW + 15) & ~(int64_t)15) + (size_t)g * 2 * 8;
}

inline int kl_block_pairs(int64_t NKW) {
    int g = KL_G;
    while (g > 1 && kl_smem(g, NKW) > KL_SMEM_MAX) g >>= 1;
    return kl_smem(g, NKW) > KL_SMEM_MAX ? 0 : g;
}

// Bytes [a, b) of a 32-bit word (a, b clamped to [0, 4]) as a mask.
__device__ __forceinline__ uint32_t kl_bytes(int a, int b) {
    a = a < 0 ? 0 : (a > 4 ? 4 : a);
    b = b < 0 ? 0 : (b > 4 ? 4 : b);
    if (a >= b) return 0u;
    const uint64_t hi = (1ull << (8 * b)) - 1ull,
                   lo = (1ull << (8 * a)) - 1ull;
    return (uint32_t)(hi & ~lo);
}

// Bytes [a, b) of a 16-byte chunk as four word masks.
__device__ __forceinline__ uint4 kl_chunk_mask(int a, int b) {
    return make_uint4(kl_bytes(a, b), kl_bytes(a - 4, b - 4),
                      kl_bytes(a - 8, b - 8), kl_bytes(a - 12, b - 12));
}

__device__ __forceinline__ uint4 kl_and(uint4 x, uint4 y) {
    return make_uint4(x.x & y.x, x.y & y.y, x.z & y.z, x.w & y.w);
}

// Chunk c of the span at g (n bytes): a uint4 load where the span starts
// 16-byte aligned and the chunk is whole, else byte by byte (0 past n).
__device__ __forceinline__ uint4 kl_load(const uint8_t* g, bool aligned,
                                         int c, int n) {
    const int j0 = 16 * c;
    if (aligned && j0 + 16 <= n) return __ldg((const uint4*)g + c);
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int t = 0; t < 16; ++t)
        if (j0 + t < n) w[t >> 2] |= (uint32_t)g[j0 + t] << (8 * (t & 3));
    return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void kl_store(uint8_t* g, bool aligned, int c,
                                         int n, uint4 v) {
    const int j0 = 16 * c;
    if (aligned && j0 + 16 <= n) {
        ((uint4*)g)[c] = v;
        return;
    }
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int t = 0; t < 16; ++t)
        if (j0 + t < n) g[j0 + t] = (uint8_t)(w[t >> 2] >> (8 * (t & 3)));
}

__global__ void __launch_bounds__(KL_THREADS)
pair_filter_kernel(const uint8_t* __restrict__ found,
                   const uint8_t* __restrict__ kvalid,
                   const int32_t* __restrict__ nk,
                   const uint8_t* __restrict__ any_valid,
                   const uint8_t* __restrict__ live, int64_t P, int NKW,
                   int G, int64_t nf, int64_t nmf, int64_t cth,
                   uint8_t* __restrict__ found_out,
                   int32_t* __restrict__ kf_out,
                   uint8_t* __restrict__ nonshort_out,
                   uint8_t* __restrict__ sub_drop_out,
                   uint8_t* __restrict__ pair_kf_out,
                   uint8_t* __restrict__ use_out) {
    extern __shared__ uint4 kl_smem4[];
    const int tid = threadIdx.x;
    const int64_t p0 = (int64_t)blockIdx.x * G;
    const int np = (int)(P - p0 < G ? P - p0 : G);   // pairs of this block
    const int nr = 2 * np;                            // rows (reads)
    const int n = nr * NKW, nch = (n + 15) >> 4;      // the span
    const int64_t base = p0 * 2 * NKW;
    uint8_t* span = (uint8_t*)kl_smem4;               // masked found
    const int PB = (2 * G * NKW + 15) & ~15;
    int* s_cnt = (int*)(span + PB);                   // a row's ones
    int* s_use = s_cnt + 2 * G;                       // its use flag
    const uint8_t* gF = found + base;
    const uint8_t* gK = kvalid + base;
    uint8_t* gO = found_out + base;
    uint8_t* gU = use_out + base;
    const bool aF = ((uintptr_t)gF & 15) == 0, aK = ((uintptr_t)gK & 15) == 0,
               aO = ((uintptr_t)gO & 15) == 0, aU = ((uintptr_t)gU & 15) == 0;
    // ---- 1. the first chunk's loads and the pairs' scalars in flight
    // before the counters are zeroed
    uint4 f0 = make_uint4(0u, 0u, 0u, 0u), k0 = f0;
    if (tid < nch) {
        f0 = kl_load(gF, aF, tid, n);
        k0 = kl_load(gK, aK, tid, n);
    }
    // warp 0's lane r < nr: row r's nk, any_valid and its pair's live
    int nkr = 0;
    bool avr = false, lvr = false;
    if (tid < nr) {
        nkr = nk[2 * p0 + tid];
        avr = any_valid[2 * p0 + tid] != 0;
        lvr = live[p0 + (tid >> 1)] != 0;
        s_cnt[tid] = 0;
    }
    __syncthreads();
    for (int c = tid; c < nch; c += KL_THREADS) {
        uint4 f = f0, k = k0;
        if (c != tid) {
            f = kl_load(gF, aF, c, n);
            k = kl_load(gK, aK, c, n);
        }
        const uint4 m = kl_and(f, k);
        kl_store(gO, aO, c, n, m);
        kl_smem4[c] = m;
        // each row's ones in the chunk
        const int j0 = 16 * c, j1 = j0 + 16 < n ? j0 + 16 : n;
        for (int r = j0 / NKW, a = j0; a < j1; ++r) {
            const int b = (r + 1) * NKW < j1 ? (r + 1) * NKW : j1;
            const uint4 w = kl_and(m, kl_chunk_mask(a - j0, b - j0));
            const int ones =
                __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
            if (ones) atomicAdd(s_cnt + r, ones);
            a = b;
        }
    }
    __syncthreads();
    // ---- 2. warp 0, a lane a row (nr <= 2 KL_G = 16): the row's nf
    // samples, i S (floor division, as torch's //) or, the last, nk - 1,
    // clamped into the row (nk = 0 reads position 0; nf = 1 samples nk - 1
    // alone and never divides; i < nf - 1 = d, so |i S| <= |nk| + nf stays
    // within int), its kf, and the pair's decision from its mate's lane
    if (tid < 32) {
        const bool on = tid < nr;
        const bool sub = nf != 0 && nmf != 0;
        int hits = 0;
        if (on && sub) {
            const int d = nf - 1 > 1 ? (int)(nf - 1) : 1;
            const int S = nkr >= 0 ? nkr / d : -((-nkr + d - 1) / d);
            const uint8_t* row = span + tid * NKW;
            const int last = (int)nf - 1;
#pragma unroll 4
            for (int i = 0; i < last; ++i) {
                int idx = i * S;
                idx = idx < 0 ? 0 : (idx > NKW - 1 ? NKW - 1 : idx);
                hits += row[idx];
            }
            if (last >= 0) {
                int idx = nkr - 1;
                idx = idx < 0 ? 0 : (idx > NKW - 1 ? NKW - 1 : idx);
                hits += row[idx];
            }
        }
        const int kfr = on && s_cnt[tid] < cth;
        const int hits_m = __shfl_xor_sync(0xFFFFFFFFu, hits, 1);
        const int kf_m = __shfl_xor_sync(0xFFFFFFFFu, kfr, 1);
        const bool av_m = __shfl_xor_sync(0xFFFFFFFFu, (int)avr, 1) != 0;
        const bool nonshort = avr && av_m && lvr;
        const bool sub_pass = !sub || (hits >= nmf && hits_m >= nmf);
        const bool pair_sub = nonshort && sub_pass;
        const bool pair_kf = pair_sub && !(kfr == 1 && kf_m == 1);
        if (on) {
            kf_out[2 * p0 + tid] = kfr;
            s_use[tid] = pair_kf && kfr == 0;
            if (!(tid & 1)) {
                const int64_t p = p0 + (tid >> 1);
                nonshort_out[p] = nonshort;
                sub_drop_out[p] = nonshort && !pair_sub;
                pair_kf_out[p] = pair_kf;
            }
        }
    }
    __syncthreads();
    // ---- 3. use: the masked chunk under the used rows' bytes
    for (int c = tid; c < nch; c += KL_THREADS) {
        const int j0 = 16 * c, j1 = j0 + 16 < n ? j0 + 16 : n;
        uint4 keep = make_uint4(0u, 0u, 0u, 0u);
        for (int r = j0 / NKW, a = j0; a < j1; ++r) {
            const int b = (r + 1) * NKW < j1 ? (r + 1) * NKW : j1;
            if (s_use[r]) {
                const uint4 w = kl_chunk_mask(a - j0, b - j0);
                keep = make_uint4(keep.x | w.x, keep.y | w.y, keep.z | w.z,
                                  keep.w | w.w);
            }
            a = b;
        }
        kl_store(gU, aU, c, n, kl_and(kl_smem4[c], keep));
    }
}

template <class NS>
__global__ void __launch_bounds__(KLD_THREADS)
prefilter_decide_kernel(const int32_t* __restrict__ hits,
                        const NS* __restrict__ nonshort,
                        const uint8_t* __restrict__ live, int64_t P,
                        int64_t nmf, uint8_t* __restrict__ survive) {
    const int64_t p = (int64_t)blockIdx.x * KLD_THREADS + threadIdx.x;
    if (p >= P) return;
    survive[p] = live[p] != 0 && nonshort[2 * p] > 0 &&
                 nonshort[2 * p + 1] > 0 && hits[2 * p] >= nmf &&
                 hits[2 * p + 1] >= nmf;
}

// found (2P, NKW) bool (KB's dbi probe, before the kvalid mask), kvalid
// (2P, NKW) bool, nk (2P,) int32, any_valid (2P,) bool, live (P,) bool ->
// found_out and use (2P, NKW) bool, kf (2P,) int32, nonshort, sub_drop and
// pair_kf (P,) bool.
DTK_EXPORT int dtk_pair_filter(const void* found, const void* kvalid,
                               const void* nk, const void* any_valid,
                               const void* live, int64_t P, int64_t NKW,
                               int64_t nf, int64_t nmf, int64_t cth,
                               void* found_out, void* kf, void* nonshort,
                               void* sub_drop, void* pair_kf, void* use,
                               void* stream) {
    if (NKW < 1 || NKW > (1 << 24) || nf > INT32_MAX || nf < INT32_MIN)
        return (int)cudaErrorInvalidValue;
    if (((uintptr_t)nk & 3) || ((uintptr_t)kf & 3))
        return (int)cudaErrorMisalignedAddress;
    const int G = kl_block_pairs(NKW);
    if (G == 0) return (int)cudaErrorInvalidValue;
    const size_t smem = kl_smem(G, NKW);
    if (P <= 0) return (int)cudaGetLastError();
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            pair_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const unsigned blocks = (unsigned)((P + G - 1) / G);
    pair_filter_kernel<<<blocks, KL_THREADS, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)found, (const uint8_t*)kvalid, (const int32_t*)nk,
        (const uint8_t*)any_valid, (const uint8_t*)live, P, (int)NKW, G, nf,
        nmf, cth, (uint8_t*)found_out, (int32_t*)kf, (uint8_t*)nonshort,
        (uint8_t*)sub_drop, (uint8_t*)pair_kf, (uint8_t*)use);
    return (int)cudaGetLastError();
}

// KL's pairs a block at NKW (the launch is ceil(P / this) blocks of 256
// threads); 0 past a block's shared memory.
DTK_EXPORT int dtk_pair_filter_block_pairs(int64_t NKW) {
    return NKW < 1 || NKW > (1 << 24) ? 0 : kl_block_pairs(NKW);
}

// hits (2P,) int32, nonshort (2P,) of ns_bytes 1 (bool) or 4 (int32 nk),
// live (P,) bool -> survive (P,) bool.
DTK_EXPORT int dtk_prefilter_decide(const void* hits, const void* nonshort,
                                    int64_t ns_bytes, const void* live,
                                    int64_t P, int64_t nmf, void* survive,
                                    void* stream) {
    if (ns_bytes != 1 && ns_bytes != 4) return (int)cudaErrorInvalidValue;
    if (((uintptr_t)hits & 3) ||
        (ns_bytes == 4 && ((uintptr_t)nonshort & 3)))
        return (int)cudaErrorMisalignedAddress;
    if (P <= 0) return (int)cudaGetLastError();
    const unsigned blocks = (unsigned)dtk_grid(P, KLD_THREADS);
    const cudaStream_t st = (cudaStream_t)stream;
    if (ns_bytes == 1)
        prefilter_decide_kernel<<<blocks, KLD_THREADS, 0, st>>>(
            (const int32_t*)hits, (const uint8_t*)nonshort,
            (const uint8_t*)live, P, nmf, (uint8_t*)survive);
    else
        prefilter_decide_kernel<<<blocks, KLD_THREADS, 0, st>>>(
            (const int32_t*)hits, (const int32_t*)nonshort,
            (const uint8_t*)live, P, nmf, (uint8_t*)survive);
    return (int)cudaGetLastError();
}
