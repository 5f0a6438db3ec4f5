// KA extract_kmers: canonical k-mers, forward k-mers and canonical
// (k+1)-mer edges of a padded read batch.
//
// Replaces K1, danbing_tk_tpu/ops/kmers_jax.py:63 extract_kmers_edges (the
// TPU builds (lo, hi) u32 planes with k shifted ORs per plane).  Here a
// k-mer is one uint64_t.
//
// Bound on the H100: bytes.  Per window the counting instance writes 8 B
// of k-mer and 1 B of validity (the forward k-mer adds 8 B, the edge plane
// 9 B more) and reads ~1 code byte; the arithmetic is O(1) a window:
//   * a warp a read (KA_WARPS reads a block): the read's L code bytes are
//     loaded once (16-B loads where the row is aligned) and packed in
//     shared memory into three streams over Lp = L rounded up to 32: the
//     2-bit forward codes (position p at bits 2p.. from a word's top), the
//     2-bit reverse complement (stream position q is the complement of
//     code Lp - 1 - q), and a 1-bit N mask (code 255);
//   * a window w is then two funnel shifts of three forward words (its
//     k-mer, and its (k+1)-mer edge), the same of the reverse stream at
//     Lp - w - k (and Lp - w - k - 1 for the edge), and one funnel shift
//     of two N words; valid is "no N bit in [w, w + k)" and w + k <= rlen;
//   * lane i takes windows i, i + 32, ..., so each store instruction of
//     the warp writes 32 adjacent elements of a plane (256 B of an int64
//     plane).  16-B stores of window pairs measured slower (PERF.md): they
//     held 40 registers a thread against 32, so 8,192 warps took 1.3
//     waves of the card instead of one;
//   * nk is written by lane 0 and any_valid from one __any_sync, so every
//     output byte is the kernel's (no fill launch).
// One template instance per plane set: the counting and sharded steps
// write kmer, kvalid, nk and any_valid (9 B a window), threading adds nc,
// bubbles the edges.
#include "common.cuh"

constexpr int KA_WARPS = 8;              // reads a block (ops/kmers.py)

// Words of one warp's streams: forward and reverse (n16 + 2 each, the
// spare words read past the last window) and the N mask (n16 / 2 + 1).
__host__ __device__ inline int ka_n16(int L) { return (L + 31) / 32 * 2; }
__host__ __device__ inline int ka_words(int L) {
    return 2 * (ka_n16(L) + 2) + ka_n16(L) / 2 + 1;
}

// 4 code bytes (position 4j + t in byte t) -> their 2-bit codes, the first
// position in the top two bits of the byte.
__device__ __forceinline__ uint32_t ka_pack4(uint32_t x) {
    uint32_t y = __byte_perm(x & 0x03030303u, 0, 0x0123);
    y = (y | (y >> 6)) & 0x000F000Fu;
    return (y | (y >> 12)) & 0xFFu;
}

// 4 code bytes -> 4 N bits (bit t: byte t is 255).
__device__ __forceinline__ uint32_t ka_n4(uint32_t x) {
    const uint32_t e = __vcmpeq4(x, 0xFFFFFFFFu) & 0x01010101u;
    return (e | (e >> 7) | (e >> 14) | (e >> 21)) & 0xFu;
}

// The 2k bits from 2-bit stream position q (k <= 32): the top 64 of the
// 96 bits of words q / 16 .. q / 16 + 2 after a left shift by 2 (q % 16),
// shifted down to 2k bits.
__device__ __forceinline__ uint64_t ka_window(const uint32_t* s, int q,
                                              int k) {
    const int i = q >> 4;
    const uint32_t sh = (uint32_t)(2 * (q & 15));
    const uint32_t a = s[i], b = s[i + 1], c = s[i + 2];
    const uint64_t x = ((uint64_t)__funnelshift_l(b, a, sh) << 32) |
                       __funnelshift_l(c, b, sh);
    return x >> (64 - 2 * k);
}

// One window's canonical k-mer, forward k-mer and validity.
struct KaWin {
    uint64_t ca, f;
    bool v;
};

__device__ __forceinline__ KaWin ka_kmer(const uint32_t* F, const uint32_t* R,
                                         const uint32_t* N, int w, int k,
                                         int Lp, int rl, uint32_t kbits) {
    KaWin o;
    o.f = ka_window(F, w, k);
    const uint64_t rc = ka_window(R, Lp - w - k, k);
    o.ca = rc < o.f ? rc : o.f;
    const uint32_t nb = __funnelshift_r(N[w >> 5], N[(w >> 5) + 1], w & 31);
    o.v = (nb & kbits) == 0 && w + k <= rl;
    return o;
}

// One window's canonical (k+1)-mer edge, compared as unsigned (64 bits at
// k = 31), and its validity.
__device__ __forceinline__ int64_t ka_edge(const uint32_t* F,
                                           const uint32_t* R,
                                           const uint32_t* N, int w, int k,
                                           int Lp, int rl, uint32_t ebits,
                                           bool* v) {
    const uint64_t ef = ka_window(F, w, k + 1);
    const uint64_t er = ka_window(R, Lp - w - k - 1, k + 1);
    const uint32_t nb = __funnelshift_r(N[w >> 5], N[(w >> 5) + 1], w & 31);
    *v = (nb & ebits) == 0 && w + k + 1 <= rl;
    return *v ? (int64_t)(er < ef ? er : ef) : -1;
}

template <bool kNc, bool kEdge>
__global__ void __launch_bounds__(KA_WARPS * 32)
extract_kmers_kernel(const uint8_t* __restrict__ codes,
                     const int32_t* __restrict__ rlen, int64_t B, int L,
                     int k, int64_t* __restrict__ kmer,
                     int64_t* __restrict__ fwd_out,
                     uint8_t* __restrict__ kvalid,
                     int64_t* __restrict__ edge,
                     uint8_t* __restrict__ evalid,
                     int32_t* __restrict__ nk,
                     uint8_t* __restrict__ any_valid) {
    extern __shared__ uint32_t ka_smem[];
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int64_t r = (int64_t)blockIdx.x * KA_WARPS + wid;
    if (r >= B) return;                      // warp-uniform
    const int n16 = ka_n16(L), Lp = n16 * 16;
    uint32_t* F = ka_smem + (size_t)wid * ka_words(L);
    uint32_t* R = F + n16 + 2;
    uint32_t* N = R + n16 + 2;
    const uint8_t* row = codes + r * L;
    const bool vec = ((uintptr_t)row & 15) == 0;
    // pack: lane i takes positions 16 i .. 16 i + 15 (255 past L)
    for (int i = lane; i < n16; i += 32) {
        uint32_t x[4];
        if (vec && 16 * i + 16 <= L) {
            const uint4 v = __ldg((const uint4*)(row + 16 * i));
            x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                uint32_t u = 0;
#pragma unroll
                for (int t = 0; t < 4; ++t) {
                    const int p = 16 * i + 4 * j + t;
                    u |= (uint32_t)(p < L ? __ldg(row + p) : 255) << (8 * t);
                }
                x[j] = u;
            }
        }
        uint32_t f = 0, nm = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            f = (f << 8) | ka_pack4(x[j]);
            nm |= ka_n4(x[j]) << (4 * j);
        }
        F[i] = f;
        // reverse the 16 2-bit codes and complement them: stream word
        // n16 - 1 - i of the reverse complement
        uint32_t b = __brev(f);
        b = ((b >> 1) & 0x55555555u) | ((b & 0x55555555u) << 1);
        R[n16 - 1 - i] = ~b;
        ((uint16_t*)N)[i] = (uint16_t)nm;
    }
    if (lane < 2) {
        F[n16 + lane] = 0;
        R[n16 + lane] = 0;
    }
    if (lane == 0) N[n16 / 2] = 0xFFFFFFFFu;
    __syncwarp();

    const int rl = rlen[r];
    const int NKW = L - k + 1, NE = L - k;
    const uint32_t kbits = (1u << k) - 1u;
    const uint32_t ebits = k == 31 ? 0xFFFFFFFFu : (1u << (k + 1)) - 1u;
    bool any = false;
    // lane i takes windows i, i + 32, ...: each plane store of the warp is
    // 32 adjacent elements
    const int64_t o = r * NKW;
    for (int w = lane; w < NKW; w += 32) {
        const KaWin a = ka_kmer(F, R, N, w, k, Lp, rl, kbits);
        any |= a.v;
        kmer[o + w] = a.v ? (int64_t)a.ca : -1;
        if constexpr (kNc) fwd_out[o + w] = a.v ? (int64_t)a.f : -1;
        kvalid[o + w] = a.v;
    }
    if constexpr (kEdge) {
        const int64_t oe = r * NE;
        for (int w = lane; w < NE; w += 32) {
            bool v;
            edge[oe + w] = ka_edge(F, R, N, w, k, Lp, rl, ebits, &v);
            evalid[oe + w] = v;
        }
    }
    any = __any_sync(0xFFFFFFFFu, any);
    if (lane == 0) {
        const int n = rl - k + 1;
        nk[r] = n > 0 ? n : 0;
        any_valid[r] = any;
    }
}

template <bool kNc, bool kEdge>
static cudaError_t ka_launch(const void* codes, const void* rlen, int64_t B,
                             int L, int k, void* kmer, void* fwd,
                             void* kvalid, void* edge, void* evalid,
                             void* nk, void* any_valid,
                             cudaStream_t stream) {
    auto kernel = extract_kmers_kernel<kNc, kEdge>;
    const size_t smem = (size_t)KA_WARPS * ka_words(L) * sizeof(uint32_t);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    kernel<<<(unsigned)((B + KA_WARPS - 1) / KA_WARPS), KA_WARPS * 32, smem,
             stream>>>((const uint8_t*)codes, (const int32_t*)rlen, B, L, k,
                       (int64_t*)kmer, (int64_t*)fwd, (uint8_t*)kvalid,
                       (int64_t*)edge, (uint8_t*)evalid, (int32_t*)nk,
                       (uint8_t*)any_valid);
    return cudaGetLastError();
}

// fwd null: no forward plane; edge null (evalid with it): no edge planes.
// The int64 planes must start on an 8-B boundary (torch allocations do).
DTK_EXPORT int dtk_extract_kmers(const void* codes, const void* rlen,
                                 int64_t B, int64_t L, int64_t k,
                                 void* kmer, void* fwd, void* kvalid,
                                 void* edge, void* evalid, void* nk,
                                 void* any_valid, void* stream) {
    if (k < 1 || k > 31 || L < k || (edge == nullptr) != (evalid == nullptr))
        return (int)cudaErrorInvalidValue;
    if (((uintptr_t)kmer | (uintptr_t)fwd | (uintptr_t)edge) & 7)
        return (int)cudaErrorMisalignedAddress;
    if (B <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
#define KA_ARGS codes, rlen, B, (int)L, (int)k, kmer, fwd, kvalid, edge, \
    evalid, nk, any_valid, s
    cudaError_t e;
    if (fwd != nullptr)
        e = edge != nullptr ? ka_launch<true, true>(KA_ARGS)
                            : ka_launch<true, false>(KA_ARGS);
    else
        e = edge != nullptr ? ka_launch<false, true>(KA_ARGS)
                            : ka_launch<false, false>(KA_ARGS);
#undef KA_ARGS
    return (int)e;
}
