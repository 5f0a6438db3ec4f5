// KH bias_correct: danbing-tk pred's bias correction, in place.
//
// Replaces K16, danbing_tk_tpu/analysis/pred.py:99 bias_correction_jax: the
// per-sample invariant-k-mer ratios gt[:, iki] / ikc, their segment mean per
// locus (a scatter-add), the normalisation of each locus's bias to mean 1
// over samples, and the division of every locus's column block by its
// sample's bias.  On the TPU it was four XLA passes over (ns, nk) planes,
// with a (ns, nk) division plane gathered from bias[:, col_locus].
//
// Three launches on the caller's stream:
// nk_cum, nik_cum and iki come as ikmer.meta holds them, u32; ikc u8.
//   (a) kh_locus_sums, one thread per (sample, locus), samples fastest so
//       a warp's iki and ikc loads are one broadcast: the sum of
//       gt[s, iki[j]] / ikc[j] over the locus's invariant k-mers in file
//       order, then / their count.
//   (b) kh_normalise, one thread per locus: m = the mean of (a) over
//       samples in sample order; a locus is active when it has k-mers,
//       invariant k-mers and m != 0; bias = (a) / m, 0 when not active.
//   (c) kh_divide, one block per (locus, chunk of KH_SCHUNK samples),
//       threads over the locus's contiguous column segment so loads and
//       stores coalesce: gt[s, c] /= bias[s, t] on active loci only, with
//       64-bit offsets (ns * nk passes 2^31 at scale).  A thread issues
//       its column's loads of all the chunk's samples before it divides,
//       so KH_SCHUNK loads are in flight per thread, and moves 16 B a load
//       where the rows are 16 B aligned (nk % 4 == 0).
// Every sum is sequential and every quotient IEEE (__fadd_rn, __fdiv_rn;
// built without fast math, never a reciprocal), which is numpy's order, so
// the result is bit-equal to the JAX package's bias_correction_np; every
// NaN is written with the host's bits (nan_bits, 0xFFC00000 on x86), since
// a CUDA 0/0 is 0x7FFFFFFF.  A locus's invariant k-mers must lie in its
// own column block (the caller checks): (c) runs after all of (a).
//
// Bound on the H100: bytes.  Each column of an active locus read and
// written once (8 B per sample), the invariant-k-mer columns of skipped
// loci read once, iki and ikc (5 B per invariant k-mer), nk_cum and
// nik_cum (8 B per locus) and the bias written (4 B per sample and
// locus).  (c) moves almost all of it, as long coalesced runs; the
// gathers of (a) are ~1/30 of the columns at the scale layout.
#include "common.cuh"

constexpr int KH_THREADS = 256;
constexpr int KH_SCHUNK = 8;

__device__ __forceinline__ float kh_canon(float x, uint32_t nan_bits) {
    return isnan(x) ? __uint_as_float(nan_bits) : x;
}

__global__ void kh_locus_sums(int64_t ns, int64_t nk, int64_t n_tr,
                              const float* __restrict__ gt,
                              const uint32_t* __restrict__ nik_cum,
                              const uint32_t* __restrict__ iki,
                              const uint8_t* __restrict__ ikc,
                              float* __restrict__ bias) {
    // sample-fastest: a warp's lanes share their locus's iki and ikc loads
    const int64_t i = (int64_t)blockIdx.x * KH_THREADS + threadIdx.x;
    if (i >= ns * n_tr) return;
    const int64_t t = i / ns, s = i - t * ns;
    const int64_t b = t ? nik_cum[t - 1] : 0, e = nik_cum[t];
    float acc = 0.f;
    if (e > b) {
        const float* row = gt + s * nk;
        acc = __fdiv_rn(row[iki[b]], (float)ikc[b]);
        for (int64_t j = b + 1; j < e; ++j)
            acc = __fadd_rn(acc, __fdiv_rn(row[iki[j]], (float)ikc[j]));
        acc = __fdiv_rn(acc, (float)(e - b));
    }
    bias[s * n_tr + t] = acc;
}

__global__ void kh_normalise(int64_t ns, int64_t n_tr,
                             const uint32_t* __restrict__ nk_cum,
                             const uint32_t* __restrict__ nik_cum,
                             float* __restrict__ bias,
                             uint8_t* __restrict__ active,
                             uint32_t nan_bits) {
    const int64_t t = (int64_t)blockIdx.x * KH_THREADS + threadIdx.x;
    if (t >= n_tr) return;
    const bool has = nk_cum[t] > (t ? nk_cum[t - 1] : 0) &&
                     nik_cum[t] > (t ? nik_cum[t - 1] : 0);
    float m = 0.f;
    if (has) {
        m = bias[t];
        for (int64_t s = 1; s < ns; ++s) m = __fadd_rn(m, bias[s * n_tr + t]);
        m = __fdiv_rn(m, (float)ns);
    }
    const bool act = has && m != 0.f;
    active[t] = act;
    for (int64_t s = 0; s < ns; ++s) {
        float* b = bias + s * n_tr + t;
        *b = act ? kh_canon(__fdiv_rn(*b, m), nan_bits) : 0.f;
    }
}

// gt[s0 + k, c] /= b[k] for the chunk's ks samples at one column c.
__device__ __forceinline__ void kh_div_col(float* base, int64_t nk,
                                           int64_t c, int ks, const float* b,
                                           uint32_t nan_bits) {
    float x[KH_SCHUNK];
#pragma unroll
    for (int k = 0; k < KH_SCHUNK; ++k)
        if (k < ks) x[k] = base[k * nk + c];
#pragma unroll
    for (int k = 0; k < KH_SCHUNK; ++k)
        if (k < ks)
            base[k * nk + c] = kh_canon(__fdiv_rn(x[k], b[k]), nan_bits);
}

__device__ __forceinline__ float4 kh_div4(float4 v, float b, uint32_t nb) {
    v.x = kh_canon(__fdiv_rn(v.x, b), nb);
    v.y = kh_canon(__fdiv_rn(v.y, b), nb);
    v.z = kh_canon(__fdiv_rn(v.z, b), nb);
    v.w = kh_canon(__fdiv_rn(v.w, b), nb);
    return v;
}

// kVec (nk % 4 == 0, so every row starts 16 B aligned): the 4-aligned
// columns of the segment move as float4, the at most 3 + 3 at its ends
// one by one.
template <bool kVec>
__global__ void kh_divide(int64_t ns, int64_t nk, int64_t n_tr,
                          float* __restrict__ gt,
                          const uint32_t* __restrict__ nk_cum,
                          const float* __restrict__ bias,
                          const uint8_t* __restrict__ active,
                          uint32_t nan_bits) {
    const int64_t t = blockIdx.x;
    if (!active[t]) return;                     // block-uniform
    const int64_t c0 = t ? nk_cum[t - 1] : 0, c1 = nk_cum[t];
    const int64_t s0 = (int64_t)blockIdx.y * KH_SCHUNK;
    const int ks = ns - s0 < KH_SCHUNK ? (int)(ns - s0) : KH_SCHUNK;
    float b[KH_SCHUNK];
#pragma unroll
    for (int k = 0; k < KH_SCHUNK; ++k)
        b[k] = k < ks ? bias[(s0 + k) * n_tr + t] : 1.f;
    float* base = gt + s0 * nk;
    // a thread issues its column's loads of all the chunk's samples before
    // it divides: KH_SCHUNK loads in flight a thread
    const int64_t v0 = kVec ? (c0 + 3) & ~3ll : c1;
    const int64_t v1 = kVec && (c1 & ~3ll) > v0 ? c1 & ~3ll : v0;
    for (int64_t c = c0 + threadIdx.x; c < (v0 < c1 ? v0 : c1);
         c += KH_THREADS)
        kh_div_col(base, nk, c, ks, b, nan_bits);
    for (int64_t c = v1 + threadIdx.x; c < c1; c += KH_THREADS)
        kh_div_col(base, nk, c, ks, b, nan_bits);
    if (!kVec) return;
    float4* vb = reinterpret_cast<float4*>(base);
    const int64_t nk4 = nk >> 2;
    for (int64_t q = (v0 >> 2) + threadIdx.x; q < (v1 >> 2); q += KH_THREADS) {
        float4 x[KH_SCHUNK];
#pragma unroll
        for (int k = 0; k < KH_SCHUNK; ++k)
            if (k < ks) x[k] = vb[k * nk4 + q];
#pragma unroll
        for (int k = 0; k < KH_SCHUNK; ++k)
            if (k < ks) vb[k * nk4 + q] = kh_div4(x[k], b[k], nan_bits);
    }
}

DTK_EXPORT int dtk_bias_correct(int64_t ns, int64_t nk, int64_t n_tr,
                                void* gt, const void* nk_cum,
                                const void* nik_cum, const void* iki,
                                const void* ikc, void* bias, void* active,
                                int64_t nan_bits, void* stream) {
    if (ns <= 0 || n_tr <= 0) return (int)cudaGetLastError();
    if ((ns + KH_SCHUNK - 1) / KH_SCHUNK > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const uint32_t nb = (uint32_t)nan_bits;
    kh_locus_sums<<<dtk_grid(ns * n_tr, KH_THREADS), KH_THREADS, 0, st>>>(
        ns, nk, n_tr, (const float*)gt, (const uint32_t*)nik_cum,
        (const uint32_t*)iki, (const uint8_t*)ikc, (float*)bias);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    kh_normalise<<<dtk_grid(n_tr, KH_THREADS), KH_THREADS, 0, st>>>(
        ns, n_tr, (const uint32_t*)nk_cum, (const uint32_t*)nik_cum,
        (float*)bias, (uint8_t*)active, nb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)n_tr,
                    (unsigned)((ns + KH_SCHUNK - 1) / KH_SCHUNK));
    if (nk % 4 == 0 && ((uintptr_t)gt & 15) == 0)
        kh_divide<true><<<grid, KH_THREADS, 0, st>>>(
            ns, nk, n_tr, (float*)gt, (const uint32_t*)nk_cum,
            (const float*)bias, (const uint8_t*)active, nb);
    else
        kh_divide<false><<<grid, KH_THREADS, 0, st>>>(
            ns, nk, n_tr, (float*)gt, (const uint32_t*)nk_cum,
            (const float*)bias, (const uint8_t*)active, nb);
    return (int)cudaGetLastError();
}
