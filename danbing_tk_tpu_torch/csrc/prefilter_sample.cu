// KK prefilter_sample: the sampled-k-mer prefilter of a padded batch of
// read pairs, in three instances.
//
// Replaces K3's sampler, danbing_tk_tpu/engine/device_align.py:343
// prefilter_sample (the TPU extracts every window's k-mer, K1, and gathers
// the nf sampled ones with a one-hot matmul), and on the device-sampled
// paths also K3's member probe and decision (:371 prefilter_decide, :379
// make_prefilter_step).  Only the sampled windows are read.  The
// arithmetic is ops/kmers_np.py's sample_subfilter_queries (the reference
// subfilter, aQueryFasta_thread.cpp:172-188):
//   nk = max(rlen - k + 1, 0), S = nk / (nf - 1),
//   start j = j * S for j < nf - 1 and nk - 1 for the last sample,
//   clipped to [0, L - k];
//   valid: no code above 3 (255 is N) in the window, start + k <=
//   rlen, start < nk;
//   q = min(forward, reverse complement) of the window's k 2-bit codes,
//   EMPTY (-1) where not valid.
// With nf = 1 the one start is nk - 1 (S is never read: no division).
//
// The fused instance (dtk_prefilter_fused, "KK"): the whole dispatch in
// one launch whose only output is survive (P,) bool: a pair survives when
// it is live and each mate has nk > 0 and >= nmf valid sampled k-mers in
// the member table (the dbi table where the index has none).
//
// Bound on the H100: bytes.  Each input read once: 2 P L code bytes, 8 P
// of rlen, P of live; P bytes of survive written; and each distinct table
// row the decision probes (64 B at the member table's W = 2, 128 B at the
// dbi's W = 4: level 0 for every valid query of a live pair with nonshort
// mates, level l only for a miss at every level < l).  At the smoke's
// dispatch (P = 16,384, L = 160, nf = 4) that is 5.41 MB of codes, rlen,
// live and survive and ~13-20 MB of member rows: ~0.006-0.008 ms.  The
// design keeps everything between the codes and the decision out of
// device memory:
//   * a warp takes 4 pairs (8 warps a block) and stages their 8 L code
//     bytes into shared memory with 16-byte loads across its lanes (from
//     the 16-B boundary below them to the one above), issued with their
//     rlen and live loads, so the windows are built from shared memory
//     and the rows arrive in one coalesced pass;
//   * the warp's 8 nf queries (query w: pair w / 2 nf, u = w % 2 nf, mate
//     u & 1, sample u / 2) are built by blocks of lpq lanes, the most
//     that fit them in 32 lanes (one lane a query from nf = 3, tiles of 32
//     queries from nf = 5), as the forward word alone (the reverse
//     complement is its complement bit-reversed);
//   * a ballot compacts a tile's valid queries, which one round probes
//     with group_probe.cuh's layout (8 lanes a query, dtk_slot_match's one
//     vector load a slot, bucket.cuh's salted hash), 8 queries a group in
//     flight, so a tile's rows at each level are read at once;
//   * the decision stays on the chip: shared counters of each (pair,
//     mate)'s hits, read once every tile is probed.  A dead pair, a short
//     mate or an nmf out of reach is decided before any row is probed;
//   * why 4 pairs a warp: at a warp a pair (16,384 warps at the smoke's
//     dispatch) each warp's fixed instructions (setup, staging,
//     compaction, bookkeeping) held the kernel more than its windows or
//     its probes did (PERF.md, Findings);
//   * no q, valid, nk, found or value plane touches device memory; lane pp
//     writes pair pp's byte.
//
// The host-sampled instance (dtk_prefilter_fused_q, "KK[q]") replaces
// K3's member probe and decision on the single-card default path (the
// host sampler's queries, :415 make_prefilter_step_q): it reads q (2P,
// nf) int64, valid (2P, nf) and nonshort (2P,) in place of the code rows
// and runs the same probe round and decision in one launch.  Bound: bytes,
// 9 B a query, 3 B a pair of nonshort and live, 1 B of survive and the
// distinct rows probed (1.25 MB of planes and the same ~13-20 MB of
// member rows at the smoke's dispatch).
//
// The sample-only instance (dtk_prefilter_sample, "KK[sample]") writes
// q (B, nf) int64, valid and nk for a probe that must run elsewhere: the
// sharded prefilter's collective probe over the ranks' row blocks
// (KI[count]).  Bound: B L code bytes and 4 B of rlen a read in, 9 B a
// sample and 4 B of nk a read out (6.68 MB at the sharded prefilter's
// dispatch of 32,768 reads, L = 160, nf = 4: 0.0020 ms).  It is the fused
// kernel's front end without the probe (prefilter_fused_kernel<0,
// false>): a warp takes 2 KKF_PPW consecutive reads (8 warps a block),
// stages their rows through shared memory with 16-byte loads, builds each
// window with kk_window's lpq lanes, and the first lane of each query
// writes its q and valid (the warp's queries in (read, sample) order, so
// a tile's stores are contiguous), one lane a read its nk.  Its first
// design, a thread a (read, sample) reading its window's k code bytes
// with k dependent byte loads (a warp's load spread over 8 rows of 160 B,
// never one coalesced pass), took 0.0045 ms in a CUDA graph (PERF.md,
// Findings).
#include "group_probe.cuh"

// ---------------------------------------------------------------------------
// The fused instance and the sample-only instance (its front end)
// ---------------------------------------------------------------------------

constexpr int KKF_WARPS = 8;             // warps a block
constexpr int KKF_PPW = 4;               // pairs a warp
constexpr int KKF_FLIGHT = 8;            // queries a group probes at once
constexpr size_t KKF_SMEM_MAX = 232448;  // a block's shared memory

// Shared bytes a warp takes: its pairs' 2 KKF_PPW L code bytes with the
// 16-B boundaries around them (up to 15 bytes each side), then 32 B of
// compacted query lanes, 32 B of their (pair, mate) and 8 hit counters.
__host__ __device__ inline int kkf_warp_bytes(int L) {
    return ((2 * KKF_PPW * L + 47) & ~15) + 96;
}

// Copies the n bytes at g (of a tensor that ends at end) into sw; returns
// where they start there.  With vec (the tensor starts on a 16-B
// boundary) lane c loads the 16-B chunks c, c + 32, ... that cover them,
// byte by byte only past the tensor's end, KKF_STAGE chunks a lane in
// flight before any is stored (a load then its store, chunk by chunk,
// costs a round trip to device memory each: at L = 160 three in turn).
constexpr int KKF_STAGE = 4;

__device__ __forceinline__ const uint8_t* kkf_stage(
    const uint8_t* __restrict__ g, const uint8_t* end, int n, bool vec,
    uint8_t* sw, int lane) {
    if (!vec) {
#pragma unroll 8
        for (int i = lane; i < n; i += 32) sw[i] = __ldg(g + i);
        return sw;
    }
    const int off = (int)((uintptr_t)g & 15);
    const uint8_t* a = g - off;
    const int nch = (off + n + 15) >> 4;
    if (a + 16 * nch <= end) {                   // every warp's but the last
        for (int c0 = lane; c0 < nch; c0 += 32 * KKF_STAGE) {
            uint4 v[KKF_STAGE];
#pragma unroll
            for (int u = 0; u < KKF_STAGE; ++u)
                if (c0 + 32 * u < nch)
                    v[u] = __ldg((const uint4*)(a + 16 * (c0 + 32 * u)));
#pragma unroll
            for (int u = 0; u < KKF_STAGE; ++u)
                if (c0 + 32 * u < nch)
                    *(uint4*)(sw + 16 * (c0 + 32 * u)) = v[u];
        }
        return sw + off;
    }
    for (int c0 = lane; c0 < nch; c0 += 32 * KKF_STAGE) {
        uint4 v[KKF_STAGE];
#pragma unroll
        for (int u = 0; u < KKF_STAGE; ++u) {
            const int c = c0 + 32 * u;
            if (c < nch && a + 16 * c + 16 <= end)
                v[u] = __ldg((const uint4*)(a + 16 * c));
        }
#pragma unroll
        for (int u = 0; u < KKF_STAGE; ++u) {
            const int c = c0 + 32 * u;
            const uint8_t* x = a + 16 * c;
            if (c >= nch) break;
            if (x + 16 <= end) {
                *(uint4*)(sw + 16 * c) = v[u];
            } else {
                for (int b = 0; b < 16 && x + b < end; ++b)
                    sw[16 * c + b] = __ldg(x + b);
            }
        }
    }
    return sw + off;
}

// The canonical k-mer of a window's forward 2-bit word (first code
// highest): its reverse complement is the complement with the bits
// reversed and each code's two bits put back in order.
__device__ __forceinline__ uint64_t kk_canonical(uint64_t fwd, int k) {
    uint64_t x = __brevll(~fwd);
    x = ((x >> 1) & 0x5555555555555555ull) |
        ((x & 0x5555555555555555ull) << 1);
    const uint64_t rc = x >> (64 - 2 * k);
    return rc < fwd ? rc : fwd;
}

// The n (0 to 31) codes from byte p of the staged rows, as a 2-bit word
// (first code highest); clears *ok where a code exceeds 3 (255 is N).  It
// reads the 4-byte-aligned words over them (the bytes before p and past
// p + n masked to 0), and a word's four codes pack into 8 bits with one
// multiply: x * 0x40100401 moves byte i's two bits to bits 31 - 2i and
// 30 - 2i, the cross terms landing below bit 24 without carries while
// every byte is <= 3 (a larger one has cleared *ok).  A code a byte took
// 7 instructions and a load; a word of four takes 6.
__device__ __forceinline__ uint64_t kk_codes(const uint8_t* p, int n,
                                             bool* ok) {
    constexpr uint32_t PACK = 0x40100401u, HIGH = 0xFCFCFCFCu;
    if (n <= 0) return 0;
    const int lead = (int)((uintptr_t)p & 3);
    const uint32_t* w = (const uint32_t*)(p - lead);
    const int last = (lead + n - 1) >> 2;        // the last word
    const int tail = lead + n - 4 * last;        // its codes' end, 1 to 4
    uint32_t x = w[0] & (DTK_FULL << (8 * lead));
    if (last == 0) x &= DTK_FULL >> (32 - 8 * tail);
    uint32_t bad = x;
    uint64_t f = (x * PACK) >> (24 + 2 * (4 - (last == 0 ? tail : 4)));
    for (int j = 1; j < last; ++j) {
        x = w[j];
        bad |= x;
        f = (f << 8) | ((x * PACK) >> 24);
    }
    if (last > 0) {
        x = w[last] & (DTK_FULL >> (32 - 8 * tail));
        bad |= x;
        f = (f << (2 * tail)) | ((x * PACK) >> (24 + 2 * (4 - tail)));
    }
    *ok = *ok && (bad & HIGH) == 0;
    return f;
}

// The front end's shape, set once a launch by the host: L, k, nf, lsh
// (lpq = 2^lsh lanes build a query: the most that fit the warp's 2
// KKF_PPW nf queries in 32 lanes, 1 from nf = 3) and the float
// reciprocals of nf, 2 nf and nf - 1 (0 at nf = 1) for kk_div.
struct KkShape {
    int L, k, nf, lsh;
    float rnf, rnq, rnf1;
};

// floor(n / d) for 0 <= n < 2^22 from r = 1 / d rounded to float: (n +
// 0.5) / d lies at least 0.5 / d from any integer and (n + 0.5) r is
// within (n + 0.5) / d * 2^-23 of it, less than that.  Four instructions
// where an integer division by a value known only at run time takes ~20
// (the front end did three a query).
__device__ __forceinline__ int kk_div(int n, float r) {
    return (int)__fmul_rn(__fadd_rn((float)n, 0.5f), r);
}

// Sample j of a read from its staged row (the arithmetic above), built by
// the lpq lanes of its query, a 2^n-lane block of the warp: lane seg of
// them reads the window's codes [seg sl, (seg + 1) sl), sl = ceil(k /
// lpq), and xor-shuffles merge the parts.  Every lane of the warp calls
// it (have: the lane's query exists).  Returns whether the window is
// valid, with *key its canonical k-mer in every lane of the query.  With
// nf = 1 the start is nk - 1 and S is not used (rnf1 = 0: no division).
__device__ __forceinline__ bool kk_window(const uint8_t* row, int rl, int nk,
                                          const KkShape& sh, int j,
                                          bool have, int seg,
                                          uint64_t* key) {
    const int k = sh.k, lpq = 1 << sh.lsh;
    int s = j == sh.nf - 1 ? nk - 1 : j * kk_div(nk, sh.rnf1);
    const int last = sh.L - k;
    s = s < 0 ? 0 : (s > last ? last : s);
    bool ok = have && s + k <= rl && s < nk;
    const int sl = (k + lpq - 1) >> sh.lsh;
    const int a = min(seg * sl, k), e = min(a + sl, k);
    uint64_t f = 0;
    if (ok) f = kk_codes(row + s + a, e - a, &ok) << (2 * (k - e));
    for (int o = 1; o < lpq; o <<= 1) {
        f |= __shfl_xor_sync(DTK_FULL, f, o);
        ok = __shfl_xor_sync(DTK_FULL, (int)ok, o) && ok;
    }
    *key = kk_canonical(f, k);
    return ok;
}

// One group's probe of a key: whether slot s of its row at level l holds
// it (no value planes are read).
template <int VW>
__device__ __forceinline__ bool kkf_match(const DtkLevels& lv, int l, int W,
                                          int s, uint64_t key) {
    const uint32_t lo = (uint32_t)key, hi = (uint32_t)(key >> 32);
    uint32_t va, vb;
    return dtk_slot_match<VW>(lv.t[l],
                              dtk_bucket(lv.salt[l], lv.mask[l], 0, lo, hi,
                                         0u),
                              s, W, 0, 0, lo, hi, 0u, &va, &vb);
}

// One round of a warp's probe (every lane calls it): the nv <= 32
// compacted valid queries of a tile, query c's key held by lane ul[c] and
// counted for (pair, mate) upm[c] of the warp.  Group g of 8 lanes (lane
// s of it reading slot s of a row) takes queries g + 4 f, KKF_FLIGHT in
// flight, level by level until each hits or the levels end, so a tile's
// rows at a level are read at once; lane 8 g adds its group's hits.
template <int VW>
__device__ __forceinline__ void kkf_probe_round(const DtkLevels& lv, int W,
                                                uint64_t key, int nv,
                                                const uint8_t* ul,
                                                const uint8_t* upm,
                                                int* hits, int g, int s) {
    uint64_t kq[KKF_FLIGHT];
    unsigned act = 0;
#pragma unroll
    for (int f = 0; f < KKF_FLIGHT; ++f) {
        const int c = g + 4 * f;
        kq[f] = __shfl_sync(DTK_FULL, key, c < nv ? ul[c] : 0);
        act |= (unsigned)(c < nv) << f;
    }
    unsigned hit = 0;
    for (int l = 0; l < lv.n && __any_sync(DTK_FULL, act != 0); ++l) {
        unsigned x = 0;
#pragma unroll
        for (int f = 0; f < KKF_FLIGHT; ++f)
            if (act >> f & 1u)
                x |= (unsigned)kkf_match<VW>(lv, l, W, s, kq[f]) << f;
#pragma unroll
        for (int f = 0; f < KKF_FLIGHT; ++f) {
            const unsigned h =
                __ballot_sync(DTK_FULL, x >> f & 1u) >> (g * 8);
            if ((act >> f & 1u) && (h & 0xFFu)) {
                hit |= 1u << f;
                act &= ~(1u << f);
            }
        }
    }
    if (s == 0) {
#pragma unroll
        for (int f = 0; f < KKF_FLIGHT; ++f)
            if (hit >> f & 1u) atomicAdd(&hits[upm[g + 4 * f]], 1);
    }
}

// The front end of KK's fused launch and of its sample-only instance.  A
// warp takes the 2 KKF_PPW consecutive reads from r0 of R (KKF_PPW pairs
// when PROBE) and stages their rows.  PROBE: the probe round and the
// decision, survive (R / 2,) its only output; else each query's q and
// valid and each read's nk.
template <int VW, bool PROBE>
__global__ void __launch_bounds__(KKF_WARPS * 32)
prefilter_fused_kernel(const uint8_t* __restrict__ codes,
                       const int32_t* __restrict__ rlen,
                       const uint8_t* __restrict__ live, int64_t R,
                       KkShape sh, int nmf, DtkLevels lv, int W, bool vec,
                       uint8_t* __restrict__ survive,
                       int64_t* __restrict__ q, uint8_t* __restrict__ valid,
                       int32_t* __restrict__ nk_out) {
    extern __shared__ __align__(16) uint8_t kkf_smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t r0 =
        ((int64_t)blockIdx.x * KKF_WARPS + warp) * 2 * KKF_PPW;
    if (r0 >= R) return;                         // whole warps
    const int nr = (int)(R - r0 < 2 * KKF_PPW ? R - r0 : 2 * KKF_PPW);
    // the reads' row bytes are loaded with their rlen (and live): lane
    // r holds read r's rlen (read (pp, m) = 2 pp + m), lane pp pair pp's
    // live
    const int L = sh.L, k = sh.k, nf = sh.nf;
    const int rl = lane < nr ? rlen[r0 + lane] : 0;
    const bool lp = PROBE && lane < nr / 2 && live[r0 / 2 + lane] != 0;
    const int wb = kkf_warp_bytes(L);
    uint8_t* sw = kkf_smem + warp * wb;
    const uint8_t* rows = kkf_stage(codes + r0 * L, codes + R * L, nr * L,
                                    vec, sw, lane);
    // query w of the warp: its lpq = 2^lsh lanes, qt queries a tile
    const int nw = 2 * KKF_PPW * nf, lsh = sh.lsh;
    const int qt = 32 >> lsh, ntile = (nw + qt - 1) >> (5 - lsh);
    const int seg = lane & ((1 << lsh) - 1), qi = lane >> lsh;
    if constexpr (!PROBE) {
        // query w: read w / nf, sample w % nf, at q[r0 nf + w]
        if (lane < nr) nk_out[r0 + lane] = rl - k + 1 > 0 ? rl - k + 1 : 0;
        __syncwarp();                            // the staged rows
        const int nwr = nr * nf;
        for (int t = 0; t < ntile; ++t) {
            const int w = qt * t + qi, r = kk_div(w, sh.rnf);
            const int rlq = __shfl_sync(DTK_FULL, rl, r < 32 ? r : 31);
            const bool have = w < nwr;
            uint64_t key;
            const bool ok = kk_window(rows + (have ? r : 0) * L, rlq,
                                      max(rlq - k + 1, 0), sh, w - r * nf,
                                      have, seg, &key);
            if (have && seg == 0) {
                q[r0 * nf + w] = ok ? (int64_t)key : -1;
                valid[r0 * nf + w] = ok;
            }
        }
    } else {
        // query w: pair w / nq, u = w % nq = 2 j + mate
        const int64_t p0 = r0 / 2;
        const int np = nr / 2, nq = 2 * nf;
        uint8_t* ul = sw + wb - 96;              // compacted query lanes
        uint8_t* upm = ul + 32;                  // their 2 pair + mate
        int* hits = (int*)(upm + 32);            // of each (pair, mate)
        if (lane < 2 * KKF_PPW) hits[lane] = 0;
        const unsigned ns = __ballot_sync(DTK_FULL, rl - k + 1 > 0);
        const unsigned lpm = __ballot_sync(DTK_FULL, lp);
        unsigned alive = 0;                      // live, both mates nonshort
#pragma unroll
        for (int pp = 0; pp < KKF_PPW; ++pp)
            if ((lpm >> pp & 1u) && (ns >> (2 * pp) & 3u) == 3u)
                alive |= 1u << pp;
        // decided before any row is probed: nmf <= 0 passes a live pair
        // with nonshort mates, nmf > nf cannot be reached, a dead pair
        // fails
        if (nmf <= 0 || nmf > nf || !alive) {
            if (lane < np)
                survive[p0 + lane] = nmf <= 0 && (alive >> lane & 1u);
            return;
        }
        __syncwarp();
        const int g = lane >> 3, s = lane & 7;
        for (int t = 0; t < ntile; ++t) {
            const int w = qt * t + qi, pp = kk_div(w, sh.rnq);
            const int u = w - pp * nq;
            const int pm = 2 * pp + (u & 1);
            const int rlq = __shfl_sync(DTK_FULL, rl, pm < 32 ? pm : 31);
            const bool have = w < nw && (alive >> pp & 1u);
            uint64_t key;
            const bool ok = kk_window(rows + (have ? pm : 0) * L, rlq,
                                      max(rlq - k + 1, 0), sh, u >> 1, have,
                                      seg, &key) && seg == 0;
            const unsigned vb = __ballot_sync(DTK_FULL, ok);
            __syncwarp();                        // the last tile's reads
            if (ok) {
                const int r = __popc(vb & ((1u << lane) - 1u));
                ul[r] = (uint8_t)lane;
                upm[r] = (uint8_t)pm;
            }
            __syncwarp();
            const int nv = __popc(vb);
            if (nv == 0) continue;
            kkf_probe_round<VW>(lv, W, key, nv, ul, upm, hits, g, s);
        }
        __syncwarp();
        if (lane < np)
            survive[p0 + lane] = (alive >> lane & 1u) &&
                                 hits[2 * lane] >= nmf &&
                                 hits[2 * lane + 1] >= nmf;
    }
}

// Launches prefilter_fused_kernel<VW, PROBE> over R reads.
template <int VW, bool PROBE>
static cudaError_t kkf_launch(const uint8_t* codes, const int32_t* rlen,
                              const uint8_t* live, int64_t R, int L, int k,
                              int nf, int nmf, const DtkLevels& lv, int W,
                              uint8_t* survive, int64_t* q, uint8_t* valid,
                              int32_t* nk, cudaStream_t st) {
    const size_t smem = (size_t)KKF_WARPS * kkf_warp_bytes(L);
    auto kernel = prefilter_fused_kernel<VW, PROBE>;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    KkShape sh{L, k, nf, 0, 1.0f / (float)nf, 1.0f / (float)(2 * nf),
               nf > 1 ? 1.0f / (float)(nf - 1) : 0.0f};
    while (sh.lsh < 5 && ((2 * KKF_PPW * nf) << (sh.lsh + 1)) <= 32)
        ++sh.lsh;
    const int64_t per_block = (int64_t)KKF_WARPS * 2 * KKF_PPW;
    const unsigned blocks = (unsigned)((R + per_block - 1) / per_block);
    const bool vec = ((uintptr_t)codes & 15) == 0;
    kernel<<<blocks, KKF_WARPS * 32, smem, st>>>(codes, rlen, live, R, sh,
                                                 nmf, lv, W, vec, survive,
                                                 q, valid, nk);
    return cudaGetLastError();
}

// Whether the front end takes these shapes (its shared memory included;
// nf <= 2^16 keeps every kk_div operand below 2^22).
static bool kkf_shapes_ok(int64_t L, int64_t k, int64_t nf) {
    return k >= 1 && k <= 31 && L >= k && L <= (1 << 20) && nf >= 1 &&
           nf <= (1 << 16) &&
           (size_t)KKF_WARPS * kkf_warp_bytes((int)L) <= KKF_SMEM_MAX;
}

// q (B, nf) int64, valid (B, nf) bool, nk (B,) int32 from codes (B, L) u8
// and rlen (B,) int32.  A code is 0-3 or 255; any other byte invalidates
// its window too (as 255 does).
DTK_EXPORT int dtk_prefilter_sample(const void* codes, const void* rlen,
                                    int64_t B, int64_t L, int64_t k,
                                    int64_t nf, void* q, void* valid,
                                    void* nk, void* stream) {
    if (!kkf_shapes_ok(L, k, nf)) return (int)cudaErrorInvalidValue;
    if ((uintptr_t)q & 7) return (int)cudaErrorMisalignedAddress;
    if (B <= 0) return (int)cudaGetLastError();
    DtkLevels none{};
    return (int)kkf_launch<0, false>(
        (const uint8_t*)codes, (const int32_t*)rlen, nullptr, B, (int)L,
        (int)k, (int)nf, 0, none, 0, nullptr, (int64_t*)q, (uint8_t*)valid,
        (int32_t*)nk, (cudaStream_t)stream);
}

// survive (P,) bool from codes (2P, L) u8, rlen (2P,) int32 and live (P,)
// bool, probing a non-composite table of W u32 a slot (the member table,
// W = 2, or the dbi, W = 4) given as bucket.cuh's dtk_levels arrays.
DTK_EXPORT int dtk_prefilter_fused(const void* codes, const void* rlen,
                                   const void* live, int64_t P, int64_t L,
                                   int64_t k, int64_t nf, int64_t nmf,
                                   const void* tabs, const void* nbs,
                                   const void* salts, int64_t nlev,
                                   int64_t W, void* survive, void* stream) {
    DtkLevels lv;
    if (!kkf_shapes_ok(L, k, nf) || W < 2 ||
        !dtk_levels(&lv, tabs, nbs, salts, nlev))
        return (int)cudaErrorInvalidValue;
    if (P <= 0) return (int)cudaGetLastError();
    // nmf only compares with counts in [0, nf]
    const int m = (int)(nmf < 0 ? 0 : (nmf > nf + 1 ? nf + 1 : nmf));
    const int VW = dtk_vector_width(lv, (int)W);
#define DTK_KKF_LAUNCH(V)                                                   \
    kkf_launch<V, true>((const uint8_t*)codes, (const int32_t*)rlen,        \
                        (const uint8_t*)live, 2 * P, (int)L, (int)k,        \
                        (int)nf, m, lv, (int)W, (uint8_t*)survive, nullptr, \
                        nullptr, nullptr, (cudaStream_t)stream)
    if (VW == 4) return (int)DTK_KKF_LAUNCH(4);
    if (VW == 2) return (int)DTK_KKF_LAUNCH(2);
    return (int)DTK_KKF_LAUNCH(0);
#undef DTK_KKF_LAUNCH
}

// ---------------------------------------------------------------------------
// The host-sampled instance
// ---------------------------------------------------------------------------

// The fused launch over the host sampler's queries ("KK[q]"): q and valid
// (2P, nf) and nonshort (2P,) take the place of the code rows, so no row
// is staged and no window built.  A warp takes KKF_PPW pairs as above;
// their 2 KKF_PPW nf queries are contiguous in q, and a tile of 32 is one
// coalesced load of keys (lane i query 32 t + i, its read i / nf of the
// warp's); then the same compaction, probe round and decision.
template <int VW>
__global__ void __launch_bounds__(KKF_WARPS * 32)
prefilter_fused_q_kernel(const int64_t* __restrict__ q,
                         const uint8_t* __restrict__ valid,
                         const uint8_t* __restrict__ nonshort,
                         const uint8_t* __restrict__ live, int64_t P, int nf,
                         int nmf, DtkLevels lv, int W,
                         uint8_t* __restrict__ survive) {
    __shared__ uint8_t kkq_ul[KKF_WARPS][32], kkq_upm[KKF_WARPS][32];
    __shared__ int kkq_hits[KKF_WARPS][2 * KKF_PPW];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t p0 =
        ((int64_t)blockIdx.x * KKF_WARPS + warp) * KKF_PPW;
    if (p0 >= P) return;                         // whole warps
    const int np = (int)(P - p0 < KKF_PPW ? P - p0 : KKF_PPW);
    uint8_t* ul = kkq_ul[warp];
    uint8_t* upm = kkq_upm[warp];
    int* hits = kkq_hits[warp];
    // lane 2 pp + m holds read (pp, m)'s nonshort, lane pp pair pp's live
    const bool ns = lane < 2 * np && nonshort[2 * p0 + lane] != 0;
    const bool lp = lane < np && live[p0 + lane] != 0;
    if (lane < 2 * KKF_PPW) hits[lane] = 0;
    const unsigned nsm = __ballot_sync(DTK_FULL, ns);
    const unsigned lpm = __ballot_sync(DTK_FULL, lp);
    unsigned alive = 0;                          // live, both mates nonshort
#pragma unroll
    for (int pp = 0; pp < KKF_PPW; ++pp)
        if ((lpm >> pp & 1u) && (nsm >> (2 * pp) & 3u) == 3u)
            alive |= 1u << pp;
    if (nmf <= 0 || nmf > nf || !alive) {
        if (lane < np)
            survive[p0 + lane] = nmf <= 0 && (alive >> lane & 1u);
        return;
    }
    __syncwarp();
    const int nw = 2 * np * nf;                  // the warp's queries
    const int64_t qb = 2 * p0 * nf;
    const int g = lane >> 3, s = lane & 7;
    for (int t = 0; 32 * t < nw; ++t) {
        const int w = 32 * t + lane, pm = w / nf;
        const bool ok = w < nw && (alive >> (pm >> 1) & 1u) &&
                        valid[qb + w] != 0;
        const uint64_t key = ok ? (uint64_t)q[qb + w] : 0ull;
        const unsigned vb = __ballot_sync(DTK_FULL, ok);
        __syncwarp();                            // the last tile's reads
        if (ok) {
            const int r = __popc(vb & ((1u << lane) - 1u));
            ul[r] = (uint8_t)lane;
            upm[r] = (uint8_t)pm;
        }
        __syncwarp();
        const int nv = __popc(vb);
        if (nv == 0) continue;
        kkf_probe_round<VW>(lv, W, key, nv, ul, upm, hits, g, s);
    }
    __syncwarp();
    if (lane < np)
        survive[p0 + lane] = (alive >> lane & 1u) && hits[2 * lane] >= nmf &&
                             hits[2 * lane + 1] >= nmf;
}

// survive (P,) bool from q (2P, nf) int64, valid (2P, nf) bool, nonshort
// (2P,) bool and live (P,) bool, probing a non-composite table of W u32 a
// slot given as bucket.cuh's dtk_levels arrays.
DTK_EXPORT int dtk_prefilter_fused_q(const void* q, const void* valid,
                                     const void* nonshort, const void* live,
                                     int64_t P, int64_t nf, int64_t nmf,
                                     const void* tabs, const void* nbs,
                                     const void* salts, int64_t nlev,
                                     int64_t W, void* survive,
                                     void* stream) {
    DtkLevels lv;
    if (nf < 1 || nf > (1 << 20) || W < 2 ||
        !dtk_levels(&lv, tabs, nbs, salts, nlev))
        return (int)cudaErrorInvalidValue;
    if ((uintptr_t)q & 7) return (int)cudaErrorMisalignedAddress;
    if (P <= 0) return (int)cudaGetLastError();
    const int m = (int)(nmf < 0 ? 0 : (nmf > nf + 1 ? nf + 1 : nmf));
    const int VW = dtk_vector_width(lv, (int)W);
    const int64_t per_block = (int64_t)KKF_WARPS * KKF_PPW;
    const unsigned blocks = (unsigned)((P + per_block - 1) / per_block);
    const cudaStream_t st = (cudaStream_t)stream;
#define DTK_KKQ_LAUNCH(V)                                                   \
    prefilter_fused_q_kernel<V><<<blocks, KKF_WARPS * 32, 0, st>>>(         \
        (const int64_t*)q, (const uint8_t*)valid, (const uint8_t*)nonshort, \
        (const uint8_t*)live, P, (int)nf, m, lv, (int)W, (uint8_t*)survive)
    if (VW == 4) DTK_KKQ_LAUNCH(4);
    else if (VW == 2) DTK_KKQ_LAUNCH(2);
    else DTK_KKQ_LAUNCH(0);
#undef DTK_KKQ_LAUNCH
    return (int)cudaGetLastError();
}
