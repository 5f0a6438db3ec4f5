// KK prefilter_sample: the nf evenly spaced canonical k-mers of each read
// of a padded batch, the queries of the sampled-k-mer prefilter.
//
// Replaces K3's sampler, danbing_tk_tpu/engine/device_align.py:343
// prefilter_sample (the TPU extracts every window's k-mer, K1, and gathers
// the nf sampled ones with a one-hot matmul).  Here only the sampled
// windows are read.  The arithmetic is ops/kmers_np.py's
// sample_subfilter_queries (the reference subfilter,
// aQueryFasta_thread.cpp:172-188):
//   nk = max(rlen - k + 1, 0), S = nk / (nf - 1),
//   start j = j * S for j < nf - 1 and nk - 1 for the last sample,
//   clipped to [0, L - k];
//   valid: no code 255 in the window, start + k <= rlen, start < nk;
//   q = min(forward, reverse complement) of the window's k 2-bit codes,
//   EMPTY (-1) where not valid.
// With nf = 1 the one start is nk - 1 (S is never read: no division).
//
// Bound on the H100: bytes.  Each input read once (B L code bytes and 4 B
// of rlen a read) and each output written once (8 B of q and 1 B of valid
// a sample, 4 B of nk a read); the arithmetic is O(k) a sample:
//   * a thread a (read, sample): B nf threads, 256 a block; consecutive
//     threads take consecutive samples of a read, so each store of the
//     q and valid planes is contiguous across a warp;
//   * the k code bytes of the window come from one row (L bytes), read
//     through the read-only cache; the nf windows of a read share its
//     row's sectors;
//   * the sample j = 0 thread writes the read's nk, so every output byte
//     is the kernel's (no fill launch).
#include "common.cuh"

constexpr int KK_THREADS = 256;          // threads a block

__global__ void __launch_bounds__(KK_THREADS)
prefilter_sample_kernel(const uint8_t* __restrict__ codes,
                        const int32_t* __restrict__ rlen, int64_t B, int L,
                        int k, int nf, int64_t* __restrict__ q,
                        uint8_t* __restrict__ valid,
                        int32_t* __restrict__ nk_out) {
    const int64_t t = (int64_t)blockIdx.x * KK_THREADS + threadIdx.x;
    if (t >= B * nf) return;
    const int64_t r = t / nf;
    const int j = (int)(t - r * nf);
    const int rl = rlen[r];
    const int nk = rl - k + 1 > 0 ? rl - k + 1 : 0;
    if (j == 0) nk_out[r] = nk;
    int s = j == nf - 1 ? nk - 1 : j * (nk / (nf - 1));
    const int last = L - k;
    s = s < 0 ? 0 : (s > last ? last : s);
    bool ok = s + k <= rl && s < nk;
    uint64_t fwd = 0, rc = 0;
    const uint8_t* w = codes + r * L + s;
    for (int i = 0; i < k && ok; ++i) {
        const uint32_t b = __ldg(w + i);
        ok = b <= 3u;
        fwd = (fwd << 2) | (b & 3u);
        rc |= (uint64_t)(3u - (b & 3u)) << (2 * i);
    }
    q[t] = ok ? (int64_t)(rc < fwd ? rc : fwd) : -1;
    valid[t] = ok;
}

// q (B, nf) int64, valid (B, nf) bool, nk (B,) int32.  A code is 0-3 or
// 255; any other byte invalidates its window too (as 255 does).
DTK_EXPORT int dtk_prefilter_sample(const void* codes, const void* rlen,
                                    int64_t B, int64_t L, int64_t k,
                                    int64_t nf, void* q, void* valid,
                                    void* nk, void* stream) {
    if (k < 1 || k > 31 || L < k || nf < 1)
        return (int)cudaErrorInvalidValue;
    if ((uintptr_t)q & 7) return (int)cudaErrorMisalignedAddress;
    if (B <= 0) return (int)cudaGetLastError();
    const int64_t n = B * nf;
    prefilter_sample_kernel<<<(unsigned)((n + KK_THREADS - 1) / KK_THREADS),
                              KK_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, (const int32_t*)rlen, B, (int)L, (int)k,
        (int)nf, (int64_t*)q, (uint8_t*)valid, (int32_t*)nk);
    return (int)cudaGetLastError();
}
