// KM step_tail: the counting step's per-pair tail and its read statistics.
//
// Replaces K8's read statistics, danbing_tk_tpu/engine/device_align.py
// :1193-1208 (nine int64 counters added into state["stats"]), and the
// per-pair planes around them: hf (:971-972, the locus-assignment
// failures), counted, nmate and dest (:1137-1139; in threading mode
// :1176-1179, where only pairs whose walk is clean are counted).  The
// arithmetic is engine/device_align.py's step_tail_plain, with referee =
// pack & 1 and pair_sub = nonshort & !sub_drop:
//   hf[r] = pair_kf & !vote_pass & !referee & kf[r] == 0;
//   counted = dev_pair & !(rm of both mates == 1), nmate = counted ? 2 -
//   rm0 - rm1 : 0; threading: counted = dev_pair & clean_pair, nmate =
//   counted ? nmate : 0; dest = counted ? dst0 : nloci;
//   stats += [2 (live & !referee), live & !nonshort, 2 sub_drop,
//             (pair_sub & !referee) ? kf0 + kf1 : 0, hf0 + hf1,
//             2 dev_pair, nmate, qc_drop ? 2 - kf0 - kf1 : 0,
//             (bf0 != 0 & kf0 == 0) + (bf1 != 0 & kf1 == 0)].
//
// Bound on the H100: bytes.  A pair reads 8 B of u8 planes (9 with
// clean_pair), 24 B of kf, bf and rm and 8 B of dst0, and writes 8 B of
// hf, 1 of counted and 8 of dest: 57 B, and the counters' 72 B are read
// and written once (233,616 B at P = 4096: 0.07 us); the launch is what
// it costs.  A thread takes a pair (256 a block), a warp adds each
// counter with a shuffle tree, and a block adds its warps' sums in shared
// memory and then makes one 64-bit atomic a counter into stats.  Integer
// sums do not depend on their order, so the counters are exact.
#include "common.cuh"

constexpr int KM_THREADS = 256;          // threads a block, a thread a pair
constexpr int KM_NSTAT = 9;              // the read statistics
constexpr unsigned KM_FULL = 0xFFFFFFFFu;

__global__ void __launch_bounds__(KM_THREADS)
step_tail_kernel(const uint8_t* __restrict__ live,
                 const uint8_t* __restrict__ nonshort,
                 const uint8_t* __restrict__ sub_drop,
                 const uint8_t* __restrict__ pair_kf,
                 const uint8_t* __restrict__ vote_pass,
                 const uint8_t* __restrict__ pack,
                 const uint8_t* __restrict__ dev_pair,
                 const uint8_t* __restrict__ qc_drop,
                 const int32_t* __restrict__ kf,
                 const int32_t* __restrict__ bf,
                 const int32_t* __restrict__ rm,
                 const int64_t* __restrict__ dst0,
                 const uint8_t* __restrict__ clean_pair, int64_t P,
                 int64_t nloci, int32_t* __restrict__ hf,
                 uint8_t* __restrict__ counted, int64_t* __restrict__ dest,
                 unsigned long long* __restrict__ stats) {
    __shared__ long long part[KM_THREADS / 32][KM_NSTAT];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t p = (int64_t)blockIdx.x * KM_THREADS + threadIdx.x;
    long long s[KM_NSTAT] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    if (p < P) {
        const bool lv = live[p] != 0, ns = nonshort[p] != 0,
                   sd = sub_drop[p] != 0, pk = pair_kf[p] != 0,
                   vp = vote_pass[p] != 0, ref = (pack[p] & 1) != 0,
                   dp = dev_pair[p] != 0, qd = qc_drop[p] != 0;
        const int k0 = kf[2 * p], k1 = kf[2 * p + 1], b0 = bf[2 * p],
                  b1 = bf[2 * p + 1], r0 = rm[2 * p], r1 = rm[2 * p + 1];
        const bool h = pk && !vp && !ref;
        const int h0 = h && k0 == 0, h1 = h && k1 == 0;
        bool cnt = dp && !(r0 == 1 && r1 == 1);
        long long nmate = cnt ? 2 - (long long)r0 - r1 : 0;
        if (clean_pair != nullptr) {
            cnt = dp && clean_pair[p] != 0;
            nmate = cnt ? nmate : 0;
        }
        hf[2 * p] = h0;
        hf[2 * p + 1] = h1;
        counted[p] = cnt;
        dest[p] = cnt ? dst0[p] : nloci;
        s[0] = 2 * (lv && !ref);
        s[1] = lv && !ns;
        s[2] = 2 * sd;
        s[3] = ns && !sd && !ref ? (long long)k0 + k1 : 0;
        s[4] = h0 + h1;
        s[5] = 2 * dp;
        s[6] = nmate;
        s[7] = qd ? 2 - (long long)k0 - k1 : 0;
        s[8] = (b0 != 0 && k0 == 0) + (b1 != 0 && k1 == 0);
    }
#pragma unroll
    for (int i = 0; i < KM_NSTAT; ++i) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            s[i] += __shfl_xor_sync(KM_FULL, s[i], o);
        if (lane == 0) part[warp][i] = s[i];
    }
    __syncthreads();
    if (threadIdx.x < KM_NSTAT) {
        long long t = 0;
        for (int w = 0; w < KM_THREADS / 32; ++w) t += part[w][threadIdx.x];
        if (t != 0)
            atomicAdd(stats + threadIdx.x, (unsigned long long)t);
    }
}

// live, nonshort, sub_drop, pair_kf, vote_pass, dev_pair, qc_drop (P,)
// bool, pack (P,) u8, kf, bf, rm (2P,) int32, dst0 (P,) int64, clean_pair
// (P,) bool or null (threading) -> hf (2P,) int32, counted (P,) bool,
// dest (P,) int64; adds the nine counters into stats (9,) int64.
DTK_EXPORT int dtk_step_tail(const void* live, const void* nonshort,
                             const void* sub_drop, const void* pair_kf,
                             const void* vote_pass, const void* pack,
                             const void* dev_pair, const void* qc_drop,
                             const void* kf, const void* bf, const void* rm,
                             const void* dst0, const void* clean_pair,
                             int64_t P, int64_t nloci, void* hf,
                             void* counted, void* dest, void* stats,
                             void* stream) {
    if (((uintptr_t)kf & 3) || ((uintptr_t)bf & 3) || ((uintptr_t)rm & 3) ||
        ((uintptr_t)hf & 3) || ((uintptr_t)dst0 & 7) ||
        ((uintptr_t)dest & 7) || ((uintptr_t)stats & 7))
        return (int)cudaErrorMisalignedAddress;
    if (P <= 0) return (int)cudaGetLastError();
    step_tail_kernel<<<dtk_grid(P, KM_THREADS), KM_THREADS, 0,
                       (cudaStream_t)stream>>>(
        (const uint8_t*)live, (const uint8_t*)nonshort,
        (const uint8_t*)sub_drop, (const uint8_t*)pair_kf,
        (const uint8_t*)vote_pass, (const uint8_t*)pack,
        (const uint8_t*)dev_pair, (const uint8_t*)qc_drop,
        (const int32_t*)kf, (const int32_t*)bf, (const int32_t*)rm,
        (const int64_t*)dst0, (const uint8_t*)clean_pair, P, nloci,
        (int32_t*)hf, (uint8_t*)counted,
        (int64_t*)dest, (unsigned long long*)stats);
    return (int)cudaGetLastError();
}
