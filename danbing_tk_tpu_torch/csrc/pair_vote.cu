// KC pair_vote: the per-pair locus vote of the counting step.
//
// Replaces K5, danbing_tk_tpu/engine/device_align.py:618-970 (make_step's
// vote: lax.sort dedupe, one-hot MXU gathers for the split CSR expansion,
// a second lax.sort by (locus, -nm), associative scans for segment totals
// and the scan-order tie census).  On the TPU every one of those was a
// full-width pass over (P, W) or (P, E, W) planes in HBM.
//
// Here one block owns one pair and keeps the whole vote in shared memory:
//   1. bitonic sort of the W = 2 * NKW entries by k-mer (unused entries
//      carry UINT64_MAX and sort last; order within equal keys does not
//      matter, every downstream value is invariant to it);
//   2. fwd/rev run counts at run starts; vv nmapped for odd (vv) runs;
//   3. exclusive prefix sum of the odd demand -> expansion starts, total,
//      overflow (total > E);
//   4. the W + E event plane in the JAX slot layout: W-plane events for
//      single-locus runs at their run position, vv runs expanded into the
//      E plane at their CSR start;
//   5. bitonic sort of the events by (locus ascending, nm descending) as
//      one uint64 key (invalid events are all ones and sort last);
//   6. segment totals, top / tie, the candidate level m, winner1;
//   7. the candidate census over event-SLOT order (exclusive prefix sum of
//      the candidate flags), ok_counts and the first-candidate loci;
//   8. test1/test2, the referee bits and dst0.
//
// Bound on the H100: operations and latency, not bytes.  A pair reads
// W * 17 B of input and writes 10 B; the two bitonic sorts cost
// O(n log^2 n) shared-memory compare-exchanges with a barrier per pass.
// The design keeps every intermediate in shared memory (nothing of the
// (P, E, W) planes exists) and sizes it for the launch's (W, E).
//
// Large-E mode (the retry ladder's E = 4096 tier, whose arrays pass a
// block's 227 KB): the same kernel, instantiated with kGlobal, carves the
// same arrays out of the pair's own slice of a global workspace (P slices
// of the same layout, allocated by the wrapper) instead of dynamic shared
// memory.  The slices stay in L2 while their block runs (132 blocks of
// ~300 KB); __syncthreads orders a block's global accesses as it orders
// its shared ones, so every step above runs unchanged.  The wrapper picks
// the mode from the shape before the launch.
#include "common.cuh"

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr long long BIGI = 0x7FFFFFF0LL;

struct MaxOp { __device__ long long operator()(long long a, long long b) const { return a > b ? a : b; } };
struct MinOp { __device__ long long operator()(long long a, long long b) const { return a < b ? a : b; } };
struct SumOp { __device__ long long operator()(long long a, long long b) const { return a + b; } };

// Every thread gets the block-wide reduction of v.
template <typename Op>
__device__ long long block_reduce(long long v, Op op, long long* scratch) {
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(FULL, v, o));
    const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
    __syncthreads();
    if (l == 0) scratch[w] = v;
    __syncthreads();
    v = scratch[0];
    for (int i = 1; i < (int)(blockDim.x >> 5); ++i) v = op(v, scratch[i]);
    return v;
}

// out[0..n] = exclusive prefix sums of in[0..n), out[n] = total.  Each
// thread scans one contiguous chunk; thread 0 scans the chunk sums.
template <typename T, typename U>
__device__ void block_exclusive_scan(const T* in, U* out, int n,
                                     long long* scratch) {
    const int T_ = blockDim.x;
    const int chunk = (n + T_ - 1) / T_;
    const int b = threadIdx.x * chunk;
    const int e = min(b + chunk, n);
    long long s = 0;
    for (int i = b; i < e; ++i) s += (long long)in[i];
    __syncthreads();
    scratch[threadIdx.x] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
        long long acc = 0;
        for (int i = 0; i < T_; ++i) {
            long long t = scratch[i];
            scratch[i] = acc;
            acc += t;
        }
        scratch[T_] = acc;
    }
    __syncthreads();
    long long acc = scratch[threadIdx.x];
    for (int i = b; i < e; ++i) {
        long long t = (long long)in[i];
        out[i] = (U)acc;
        acc += t;
    }
    if (threadIdx.x == 0) out[n] = (U)scratch[T_];
    __syncthreads();
}

// Ascending bitonic sort of n (a power of 2) keys with a payload.
template <typename P>
__device__ void bitonic_sort(uint64_t* key, P* pay, int n) {
    for (int k = 2; k <= n; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int i = threadIdx.x; i < n; i += blockDim.x) {
                int ixj = i ^ j;
                if (ixj > i) {
                    bool asc = (i & k) == 0;
                    uint64_t a = key[i], b = key[ixj];
                    if ((a > b) == asc) {
                        key[i] = b;
                        key[ixj] = a;
                        P t = pay[i];
                        pay[i] = pay[ixj];
                        pay[ixj] = t;
                    }
                }
            }
            __syncthreads();
        }
    }
}

__device__ __forceinline__ uint32_t vv_at(const int32_t* vv, int64_t nvv,
                                          long long pos) {
    if (pos < 0) pos = 0;
    if (pos > nvv - 1) pos = nvv - 1;
    return (uint32_t)vv[pos];
}

__device__ __forceinline__ char* carve(char*& p, size_t bytes) {
    char* r = p;
    p += (bytes + 15) & ~(size_t)15;
    return r;
}

template <bool kGlobal>
__global__ void pair_vote_kernel(const int64_t* __restrict__ kmer,
                                 const int64_t* __restrict__ val,
                                 const uint8_t* __restrict__ use,
                                 const uint8_t* __restrict__ pair_kf,
                                 int NKW, const int32_t* __restrict__ vv,
                                 int64_t nvv, int E, int cth,
                                 int64_t* __restrict__ dst0_out,
                                 uint8_t* __restrict__ vote_out,
                                 uint8_t* __restrict__ pack_out,
                                 char* ws, int64_t ws_stride) {
    extern __shared__ __align__(16) char smem[];
    const int p = blockIdx.x;
    const int tid = threadIdx.x, T = blockDim.x;
    const int W = 2 * NKW;
    int WP = 1;
    while (WP < W) WP <<= 1;
    const int EV = W + E;
    int EVP = 1;
    while (EVP < EV) EVP <<= 1;

    char* sp = kGlobal ? ws + (size_t)p * (size_t)ws_stride : smem;
    uint64_t* wkey = (uint64_t*)carve(sp, WP * 8);
    uint64_t* wpay = (uint64_t*)carve(sp, WP * 8);
    int32_t* fcnt = (int32_t*)carve(sp, W * 4);
    int32_t* rcnt = (int32_t*)carve(sp, W * 4);
    uint32_t* nmap = (uint32_t*)carve(sp, W * 4);    // run's nmapped
    uint32_t* nmx = (uint32_t*)carve(sp, W * 4);     // odd demand
    int32_t* starts = (int32_t*)carve(sp, (W + 1) * 4);
    uint32_t* ev_loc = (uint32_t*)carve(sp, EV * 4);
    int32_t* ev_f = (int32_t*)carve(sp, EV * 4);
    int32_t* ev_r = (int32_t*)carve(sp, EV * 4);
    uint32_t* ev_nm = (uint32_t*)carve(sp, EV * 4);
    int32_t* ev_st = (int32_t*)carve(sp, EV * 4);
    int32_t* ev_rn = (int32_t*)carve(sp, EV * 4);
    uint64_t* gkey = (uint64_t*)carve(sp, EVP * 8);
    int32_t* gidx = (int32_t*)carve(sp, EVP * 4);
    int32_t* seg_f = (int32_t*)carve(sp, EVP * 4);
    int32_t* seg_r = (int32_t*)carve(sp, EVP * 4);
    int32_t* ccum = (int32_t*)carve(sp, (EV + 1) * 4);
    uint8_t* ecand = (uint8_t*)carve(sp, EV);
    long long* scratch = (long long*)carve(sp, (T + 64) * 8);

    const bool kf_ok = pair_kf[p] != 0;

    // ---- 1. entries of both mates, sorted by k-mer ----
    for (int t = tid; t < WP; t += T) {
        uint64_t k = ~0ull, pay = 0;
        if (t < W) {
            int64_t o = (int64_t)(2 * p + (t >= NKW)) * NKW + (t % NKW);
            if (use[o]) k = (uint64_t)kmer[o];
            pay = ((uint64_t)(uint32_t)val[o] << 1) | (uint64_t)(t >= NKW);
        }
        wkey[t] = k;
        wpay[t] = pay;
    }
    __syncthreads();
    bitonic_sort(wkey, wpay, WP);

    // ---- 2. run statistics at run starts ----
    for (int t = tid; t < W; t += T) {
        uint64_t k = wkey[t];
        bool newrun = k != ~0ull && (t == 0 || wkey[t - 1] != k);
        int f = 0, r = 0;
        uint32_t nm = 0, nx = 0;
        if (newrun) {
            for (int j = t; j < W && wkey[j] == k; ++j) {
                if (wpay[j] & 1) ++r; else ++f;
            }
            uint32_t rv = (uint32_t)(wpay[t] >> 1);
            bool odd = rv & 1;
            nm = odd ? vv_at(vv, nvv, rv >> 1) : 1u;
            nx = odd ? nm : 0u;
        }
        fcnt[t] = f;
        rcnt[t] = r;
        nmap[t] = nm;
        nmx[t] = nx;
    }
    __syncthreads();

    // ---- 3. CSR starts of the odd (vv) runs ----
    block_exclusive_scan(nmx, starts, W, scratch);
    const long long total = starts[W];
    const bool overflow = total > E;

    // ---- 4. the W + E event plane ----
    for (int t = tid; t < EV; t += T) {
        if (t < W) {
            uint64_t k = wkey[t];
            bool newrun = k != ~0ull && (t == 0 || wkey[t - 1] != k);
            uint32_t rv = (uint32_t)(wpay[t] >> 1);
            bool even = newrun && !(rv & 1);
            ev_loc[t] = even ? (rv >> 1) : DTK_NAN32;
            ev_f[t] = even ? fcnt[t] : 0;
            ev_r[t] = even ? rcnt[t] : 0;
            ev_nm[t] = even ? 1u : 0u;
            ev_st[t] = t;
            ev_rn[t] = 1;
        } else {
            ev_loc[t] = DTK_NAN32;
            ev_f[t] = ev_r[t] = 0;
            ev_nm[t] = 0;
            ev_st[t] = W;
            ev_rn[t] = 0;
        }
    }
    __syncthreads();
    for (int t = tid; t < W; t += T) {
        uint32_t nm = nmx[t];
        if (nm == 0) continue;
        uint32_t rv = (uint32_t)(wpay[t] >> 1);
        long long st = starts[t];
        for (long long o = 0; o < nm && st + o < E; ++o) {
            int e = W + (int)(st + o);
            ev_loc[e] = vv_at(vv, nvv, (long long)(rv >> 1) + 1 + o);
            ev_f[e] = fcnt[t];
            ev_r[e] = rcnt[t];
            ev_nm[e] = nm;
            ev_st[e] = W + (int)st;
            ev_rn[e] = (int)nm;
        }
    }
    __syncthreads();

    // ---- 5. events sorted by (locus asc, nm desc) ----
    for (int v = tid; v < EVP; v += T) {
        if (v < EV) {
            gkey[v] = ((uint64_t)ev_loc[v] << 32) |
                      (uint64_t)(0xFFFFFFFFu - ev_nm[v]);
        } else {
            gkey[v] = ~0ull;
        }
        gidx[v] = v;
    }
    for (int v = tid; v < EV; v += T) ecand[v] = 0;
    __syncthreads();
    bitonic_sort(gkey, gidx, EVP);

    // ---- 6. segment totals, top / tie ----
    long long l_top = -1, l_has = 0;
    for (int g = tid; g < EVP; g += T) {
        uint32_t loc = (uint32_t)(gkey[g] >> 32);
        bool segnew = loc != DTK_NAN32 &&
                      (g == 0 || (uint32_t)(gkey[g - 1] >> 32) != loc);
        int sf = 0, sr = 0;
        if (segnew) {
            for (int j = g; j < EVP && (uint32_t)(gkey[j] >> 32) == loc; ++j) {
                sf += ev_f[gidx[j]];
                sr += ev_r[gidx[j]];
            }
            l_top = max(l_top, (long long)(sf + sr));
            l_has = 1;
        }
        seg_f[g] = sf;
        seg_r[g] = sr;
    }
    const long long top_tot = block_reduce(l_top, MaxOp(), scratch);
    const bool has_entries = block_reduce(l_has, MaxOp(), scratch) != 0;

    long long l_ntop = 0, l_topseg = EV, l_mlvl = BIGI;
    for (int g = tid; g < EVP; g += T) {
        uint32_t loc = (uint32_t)(gkey[g] >> 32);
        bool segnew = loc != DTK_NAN32 &&
                      (g == 0 || (uint32_t)(gkey[g - 1] >> 32) != loc);
        if (segnew && seg_f[g] + seg_r[g] == top_tot) {
            ++l_ntop;
            l_topseg = min(l_topseg, (long long)g);
            long long nm = 0xFFFFFFFFu - (uint32_t)gkey[g];
            l_mlvl = min(l_mlvl, nm);
        }
    }
    const long long n_top = block_reduce(l_ntop, SumOp(), scratch);
    const long long top_seg = block_reduce(l_topseg, MinOp(), scratch);
    const long long m_lvl = block_reduce(l_mlvl, MinOp(), scratch);
    const bool tie = n_top > 1 && has_entries;

    long long l_nc = 0, l_win1 = DTK_NAN32;
    for (int g = tid; g < EVP; g += T) {
        uint32_t loc = (uint32_t)(gkey[g] >> 32);
        bool segnew = loc != DTK_NAN32 &&
                      (g == 0 || (uint32_t)(gkey[g - 1] >> 32) != loc);
        long long nm = 0xFFFFFFFFu - (uint32_t)gkey[g];
        if (segnew && seg_f[g] + seg_r[g] == top_tot && nm == m_lvl) {
            ++l_nc;
            l_win1 = min(l_win1, (long long)loc);
            // candidate events: this segment's events at level m
            for (int j = g; j < EVP && (uint32_t)(gkey[j] >> 32) == loc; ++j) {
                long long nmj = 0xFFFFFFFFu - (uint32_t)gkey[j];
                if (nmj == m_lvl) ecand[gidx[j]] = 1;
            }
        }
    }
    const long long nC = block_reduce(l_nc, SumOp(), scratch);
    const long long winner1 = block_reduce(l_win1, MinOp(), scratch);

    // ---- 7. candidate census over event-slot order ----
    block_exclusive_scan(ecand, ccum, EV, scratch);
    long long l_bad = 0, l_fmin = DTK_NAN32, l_fmax = 0;
    for (int v = tid; v < EV; v += T) {
        if (!ecand[v]) continue;
        int cs_i = ev_st[v] < 0 ? 0 : (ev_st[v] > EV ? EV : ev_st[v]);
        int re = min(ev_st[v] + ev_rn[v], EV);
        int cs = ccum[cs_i];
        if (ccum[re] - cs != nC) l_bad = 1;
        if (ccum[v] - cs == 0) {
            l_fmin = min(l_fmin, (long long)ev_loc[v]);
            l_fmax = max(l_fmax, (long long)ev_loc[v]);
        }
    }
    const bool ok_counts = block_reduce(l_bad, MaxOp(), scratch) == 0;
    const long long floc_min = block_reduce(l_fmin, MinOp(), scratch);
    const long long floc_max = block_reduce(l_fmax, MaxOp(), scratch);
    const bool multi_ok = ok_counts && floc_min == floc_max &&
                          floc_min != DTK_NAN32;
    const bool tie_res = tie && (nC == 1 || multi_ok);
    const long long win_loc = nC == 1 ? winner1 : floc_min;
    const bool use_win = tie && tie_res;

    long long l_wseg = EV;
    if (use_win) {
        for (int g = tid; g < EVP; g += T) {
            uint32_t loc = (uint32_t)(gkey[g] >> 32);
            bool segnew = loc != DTK_NAN32 &&
                          (g == 0 || (uint32_t)(gkey[g - 1] >> 32) != loc);
            if (segnew && (long long)loc == win_loc)
                l_wseg = min(l_wseg, (long long)g);
        }
    }
    const long long wseg = block_reduce(l_wseg, MinOp(), scratch);

    // ---- 8. accept tests, referee bits, dst0 ----
    if (tid == 0) {
        // an absent segment index clamps to the last slot, as in JAX
        const int ts = (int)min(top_seg, (long long)(EV - 1));
        long long top_loc = (uint32_t)(gkey[ts] >> 32);
        long long top_f = seg_f[ts], top_r = seg_r[ts];
        if (use_win) {
            const int ws = (int)min(wseg, (long long)(EV - 1));
            top_loc = win_loc;
            top_f = seg_f[ws];
            top_r = seg_r[ws];
        }
        const bool test1 = top_f >= cth && top_r >= cth;
        const bool test2 = top_f + top_r >= 2LL * cth;
        const bool vote_pass = (test1 || test2) && has_entries && kf_ok;
        const bool r_tie = kf_ok && tie && !tie_res;
        const bool r_ovf = kf_ok && overflow;
        const bool r_t2 = kf_ok && !test1 && test2;
        const bool referee = r_tie || r_ovf || r_t2;
        dst0_out[p] = has_entries ? top_loc : (long long)DTK_NAN32;
        vote_out[p] = vote_pass;
        pack_out[p] = (uint8_t)(referee | (r_tie << 1) | (r_ovf << 2) |
                                (r_t2 << 3));
    }
}

DTK_EXPORT int dtk_pair_vote(const void* kmer, const void* val,
                             const void* use, const void* pair_kf,
                             int64_t P, int64_t NKW, const void* vv,
                             int64_t nvv, int64_t E, int64_t cth,
                             int64_t smem, void* dst0, void* vote_pass,
                             void* pack, void* stream) {
    const int threads = 256;
    cudaError_t err = cudaFuncSetAttribute(
        pair_vote_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (P > 0)
        pair_vote_kernel<false><<<(unsigned)P, threads, (size_t)smem,
                                  (cudaStream_t)stream>>>(
            (const int64_t*)kmer, (const int64_t*)val, (const uint8_t*)use,
            (const uint8_t*)pair_kf, (int)NKW, (const int32_t*)vv, nvv,
            (int)E, (int)cth, (int64_t*)dst0, (uint8_t*)vote_pass,
            (uint8_t*)pack, nullptr, 0);
    return (int)cudaGetLastError();
}

// Large-E mode: ws holds P slices of ws_stride bytes (a multiple of 256,
// at least the shared-memory mode's layout for this (W, E)).
DTK_EXPORT int dtk_pair_vote_global(const void* kmer, const void* val,
                                    const void* use, const void* pair_kf,
                                    int64_t P, int64_t NKW, const void* vv,
                                    int64_t nvv, int64_t E, int64_t cth,
                                    void* ws, int64_t ws_stride, void* dst0,
                                    void* vote_pass, void* pack,
                                    void* stream) {
    const int threads = 256;
    if (P > 0)
        pair_vote_kernel<true><<<(unsigned)P, threads, 0,
                                 (cudaStream_t)stream>>>(
            (const int64_t*)kmer, (const int64_t*)val, (const uint8_t*)use,
            (const uint8_t*)pair_kf, (int)NKW, (const int32_t*)vv, nvv,
            (int)E, (int)cth, (int64_t*)dst0, (uint8_t*)vote_pass,
            (uint8_t*)pack, (char*)ws, ws_stride);
    return (int)cudaGetLastError();
}
