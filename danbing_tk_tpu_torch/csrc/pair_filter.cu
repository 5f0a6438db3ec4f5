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
// pair_kf out: 4,677,632 B, 1.4 us at 3.35 TB/s.  A warp takes a pair
// (8 warps a block): its two rows are 2 NKW contiguous bytes, swept once
// with one coalesced byte a lane a plane; the masked found goes out in
// the same sweep and into a ballot word a 32 positions in shared memory
// (4 B, not 32), from which popc gives each mate's count, the nf sampled
// positions their hits, and the second sweep its use bytes.  Nothing
// else touches device memory.
//
// KL[decide] reads found and valid (2P, nf) u8, nonshort (2P,) and live
// (P,) and writes survive (P,): a thread a pair, 256 a block.  Bound:
// bytes, 4 nf + 3 B a pair in, 1 B out (327,680 B at 16,384 pairs and nf
// = 4: 0.1 us); the launch is what it costs.
#include "common.cuh"

constexpr int KL_WARPS = 8;              // warps a block, a warp a pair
constexpr int KLD_THREADS = 256;         // KL[decide]: a thread a pair
constexpr unsigned KL_FULL = 0xFFFFFFFFu;
constexpr size_t KL_SMEM_MAX = 232448;   // a block's shared memory

// Ballot words a warp keeps: one per 32 of its pair's 2 NKW positions.
__host__ __device__ inline int kl_words(int NKW) {
    return (2 * NKW + 31) / 32;
}

__global__ void __launch_bounds__(KL_WARPS * 32)
pair_filter_kernel(const uint8_t* __restrict__ found,
                   const uint8_t* __restrict__ kvalid,
                   const int32_t* __restrict__ nk,
                   const uint8_t* __restrict__ any_valid,
                   const uint8_t* __restrict__ live, int64_t P, int NKW,
                   int64_t nf, int64_t nmf, int64_t cth,
                   uint8_t* __restrict__ found_out,
                   int32_t* __restrict__ kf_out,
                   uint8_t* __restrict__ nonshort_out,
                   uint8_t* __restrict__ sub_drop_out,
                   uint8_t* __restrict__ pair_kf_out,
                   uint8_t* __restrict__ use_out) {
    extern __shared__ uint32_t kl_smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t p = (int64_t)blockIdx.x * KL_WARPS + warp;
    if (p >= P) return;                          // whole warps
    const int n2 = 2 * NKW, nw = kl_words(NKW);
    uint32_t* words = kl_smem + (size_t)warp * nw;
    const int64_t base = 2 * p * NKW;            // the pair's two rows
    // the first sweep: masked found out, its ballot words kept, each
    // mate's count (lanes below NKW - 32 c are mate 0's)
    int cnt0 = 0, cnt1 = 0;
    for (int c = 0; c < nw; ++c) {
        const int j = 32 * c + lane;
        bool f = false;
        if (j < n2) {
            f = found[base + j] != 0 && kvalid[base + j] != 0;
            found_out[base + j] = f;
        }
        const unsigned b = __ballot_sync(KL_FULL, f);
        const int m0 = NKW - 32 * c;             // mate 0's lanes
        const unsigned lo = m0 >= 32 ? KL_FULL
                                     : (m0 <= 0 ? 0u : (1u << m0) - 1u);
        cnt0 += __popc(b & lo);
        cnt1 += __popc(b & ~lo);
        if (lane == 0) words[c] = b;
    }
    __syncwarp();
    const int nk0 = nk[2 * p], nk1 = nk[2 * p + 1];
    bool sub_pass = true;
    if (nf != 0 && nmf != 0) {
        // sample i of mate m: i S (floor division, as torch's //) or, the
        // last, nk - 1, clamped into the row
        const int64_t d = nf - 1 > 1 ? nf - 1 : 1;
        int64_t hits[2] = {0, 0};
        for (int m = 0; m < 2; ++m) {
            const int64_t n = m ? nk1 : nk0;
            const int64_t S = n >= 0 ? n / d : -((-n + d - 1) / d);
            for (int64_t i0 = 0; i0 < nf; i0 += 32) {
                const int64_t i = i0 + lane;
                bool h = false;
                if (i < nf) {
                    int64_t idx = i != nf - 1 ? i * S : n - 1;
                    idx = idx < 0 ? 0 : (idx > NKW - 1 ? NKW - 1 : idx);
                    const int pos = m * NKW + (int)idx;
                    h = (words[pos >> 5] >> (pos & 31)) & 1u;
                }
                hits[m] += __popc(__ballot_sync(KL_FULL, h));
            }
        }
        sub_pass = hits[0] >= nmf && hits[1] >= nmf;
    }
    const bool nonshort =
        any_valid[2 * p] != 0 && any_valid[2 * p + 1] != 0 && live[p] != 0;
    const bool pair_sub = nonshort && sub_pass;
    const int kf0 = cnt0 < cth, kf1 = cnt1 < cth;
    const bool pair_kf = pair_sub && !(kf0 == 1 && kf1 == 1);
    if (lane < 2) kf_out[2 * p + lane] = lane ? kf1 : kf0;
    if (lane == 0) {
        nonshort_out[p] = nonshort;
        sub_drop_out[p] = nonshort && !pair_sub;
        pair_kf_out[p] = pair_kf;
    }
    // the second sweep: use from the kept words
    for (int c = 0; c < nw; ++c) {
        const int j = 32 * c + lane;
        if (j < n2)
            use_out[base + j] = pair_kf && (j < NKW ? kf0 : kf1) == 0 &&
                                ((words[c] >> lane) & 1u);
    }
}

__global__ void __launch_bounds__(KLD_THREADS)
prefilter_decide_kernel(const uint8_t* __restrict__ found,
                        const uint8_t* __restrict__ valid,
                        const uint8_t* __restrict__ nonshort,
                        const uint8_t* __restrict__ live, int64_t P, int nf,
                        int64_t nmf, uint8_t* __restrict__ survive) {
    const int64_t p = (int64_t)blockIdx.x * KLD_THREADS + threadIdx.x;
    if (p >= P) return;
    bool ok = live[p] != 0 && nonshort[2 * p] != 0 &&
              nonshort[2 * p + 1] != 0;
    for (int m = 0; m < 2 && ok; ++m) {
        const int64_t r = (2 * p + m) * nf;
        int64_t hits = 0;
        for (int j = 0; j < nf; ++j)
            hits += found[r + j] != 0 && valid[r + j] != 0;
        ok = hits >= nmf;
    }
    survive[p] = ok;
}

// found (2P, NKW) bool (KB's dbi probe, before the kvalid mask), kvalid
// (2P, NKW) bool, nk (2P,) int32, any_valid (2P,) bool, live (P,) bool ->
// found_out and use (2P, NKW) bool, kf (2P,) int32, nonshort, sub_drop
// and pair_kf (P,) bool.
DTK_EXPORT int dtk_pair_filter(const void* found, const void* kvalid,
                               const void* nk, const void* any_valid,
                               const void* live, int64_t P, int64_t NKW,
                               int64_t nf, int64_t nmf, int64_t cth,
                               void* found_out, void* kf, void* nonshort,
                               void* sub_drop, void* pair_kf, void* use,
                               void* stream) {
    if (NKW < 1 || NKW > (1 << 24)) return (int)cudaErrorInvalidValue;
    if (((uintptr_t)nk & 3) || ((uintptr_t)kf & 3))
        return (int)cudaErrorMisalignedAddress;
    const size_t smem = (size_t)KL_WARPS * kl_words((int)NKW) * 4;
    if (smem > KL_SMEM_MAX) return (int)cudaErrorInvalidValue;
    if (P <= 0) return (int)cudaGetLastError();
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            pair_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const unsigned blocks = (unsigned)((P + KL_WARPS - 1) / KL_WARPS);
    pair_filter_kernel<<<blocks, KL_WARPS * 32, smem,
                         (cudaStream_t)stream>>>(
        (const uint8_t*)found, (const uint8_t*)kvalid, (const int32_t*)nk,
        (const uint8_t*)any_valid, (const uint8_t*)live, P, (int)NKW, nf,
        nmf, cth, (uint8_t*)found_out, (int32_t*)kf, (uint8_t*)nonshort,
        (uint8_t*)sub_drop, (uint8_t*)pair_kf, (uint8_t*)use);
    return (int)cudaGetLastError();
}

// found and valid (2P, nf) bool, nonshort (2P,) bool, live (P,) bool ->
// survive (P,) bool.
DTK_EXPORT int dtk_prefilter_decide(const void* found, const void* valid,
                                    const void* nonshort, const void* live,
                                    int64_t P, int64_t nf, int64_t nmf,
                                    void* survive, void* stream) {
    if (nf < 0 || nf > (1 << 20)) return (int)cudaErrorInvalidValue;
    if (P <= 0) return (int)cudaGetLastError();
    prefilter_decide_kernel<<<dtk_grid(P, KLD_THREADS), KLD_THREADS, 0,
                              (cudaStream_t)stream>>>(
        (const uint8_t*)found, (const uint8_t*)valid,
        (const uint8_t*)nonshort, (const uint8_t*)live, P, (int)nf, nmf,
        (uint8_t*)survive);
    return (int)cudaGetLastError();
}
