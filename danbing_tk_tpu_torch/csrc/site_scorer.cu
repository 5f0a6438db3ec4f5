// KJ site_scorer: the bounded-edit error-correction scorer of the threading
// walk's failure sites.
//
// Replaces K13, danbing_tk_tpu/ops/correct_jax.py:268 make_site_scorer (the
// batch body at :316): per site, 21 mask probes of the composite graph
// table (node, its 4 children, their 16 children) and the 62 hypothesis
// chains of 8 families, each probed at all k steps (21 + 62 k probes, 1,323
// at k = 21) and scored by a prefix-AND with the stale-mask forward fill.
// The TPU probed every chain k-mer because it cannot branch per lane.
//
// One warp per site, the reference's serial early exit
// (aQueryFasta_thread.cpp:898-1106, ops/correct.py score_site_np), which is
// exact: once a chain's step fails it stays dead, so stopping there changes
// no counter.  The mask probes go in three rounds (the node, the children
// its mask allows, the grandchildren theirs allow); a lane walks a chain,
// counting each step, the mask overwritten only where the step's k-mer is
// found (getNextNucs' stale-mask quirk, `if (f) m = v`).
// A site where good[0..2] are all false (a pad row, nkrem = 0) opens no
// gate: it writes zeros without a probe.
//
// Every query of a site is at one locus, loc[s], so the warp probes its
// keys as tile_probe.cuh's tiles are probed: the active keys are compacted
// (ballot and popc) into the warp's shared bytes, a group of 8 lanes takes
// one key a pass (lane s loads slot s of the row as one uint4, ballots give
// the group its matches and its occupied slots), and a key stops at a row
// with an empty slot (the level stop: a level passes on only a full
// bucket's overflow).  The answer of staged key u lands at the shared slot
// of the lane and step it came from, where a probe of each lane's key
// alone (bucket.cuh dtk_probe) would make up to 24 scalar loads a row and
// read every level on a miss.
//
// What holds a site is its longest chain: its steps' probes depend on each
// other, and every step of the walk costs the warp its instructions
// whatever number of chains still live.  So the chains that the gates and
// masks leave alive (a few of the 62) are compacted into the low lanes
// first, and a site with at most 32 of them walks one chain a lane.  A
// chain's k-mers for the next steps are fixed by the read alone (only the
// mask depends on a probe), so a round stages KJ_AHEAD steps of every live
// chain whose first step passes its mask: steps t..t+D-1 are probed
// together and then replayed one by one against the answers, a chain that
// dies at step t + d leaving its later probes unread.  That trades probes
// for rounds.  Registers are capped at 40 (__launch_bounds__(256, 6)): at
// 32 (8,192 sites resident in one wave) the walk spilled 24-32 B and ran
// slower, at 48 it gained 1% on the scale sites and lost 6% on the golden
// ones.  PERF.md §6 gives the sweep: D = 1-4, 1, 2 or
// 4 keys a group a pass, 32, 40, 48 or 55 registers, and probing a
// round's repeated keys once with __match_any_sync, which cost more than
// it saved on both the scale and the golden sites.
//
// Bound on the H100: bytes.  The distinct 128-B rows of the 8.86 GB graph
// table that the needed probes read (the probes of the serial early exit,
// at the levels they need under the level stop), plus the sites' k-mer
// windows, nkrem and loc in and the counters out, over 3.35 TB/s.  The
// golden sites, whose table sits in L2, take as long as the scale ones:
// the warp's instructions a step, not the rows, hold the kernel.
#include "tile_probe.cuh"

constexpr int KJ_WARPS = 8;        // sites a block
constexpr int KJ_MIN_BLOCKS = 6;   // 40 registers, no spill
constexpr int KJ_AHEAD = 4;        // chain steps a probe round stages (D)
constexpr int KJ_KEYS = 1;         // keys a probe group takes a pass
constexpr int KJ_NCH = 62;
constexpr int KJ_MAXJ = 34;        // k + 2 for k <= 32
constexpr int KJ_SLOTS = 64 * KJ_AHEAD;  // (step d, chain half i, lane)
static_assert(KJ_SLOTS <= 256, "slots are u8");

// FAMILIES of ops/correct.py: nem1 4, ned1 4, nei1 1, nem2 16, nemd 16,
// ned2 16, nemi 4, nei2 1 chains from chain 0, 4, 8, 9, 25, 41, 57 and 61;
// a chain of family f at step t reads the read's nucleotide
// rnt[t + joff[f]] while t + joff[f] < min(k + joff[f] + 1, nkrem), with
// joff + 1 = 1, 0, 1, 2, 1, 0, 2, 2: two bits a family in KJ_JOFF1.  The
// lanes of a warp take different families, so these are literals, not a
// table a lane indexes.
constexpr uint32_t KJ_JOFF1 = 0xA191u;

__device__ __forceinline__ int kj_family(int c) {
    return (c >= 4) + (c >= 8) + (c >= 9) + (c >= 25) + (c >= 41) +
           (c >= 57) + (c >= 61);
}

__device__ __forceinline__ int kj_family_start(int fam) {
    return fam == 0 ? 0 : fam == 1 ? 4 : fam == 2 ? 8 : fam == 3 ? 9
         : fam == 4 ? 25 : fam == 5 ? 41 : fam == 6 ? 57 : 61;
}

// One warp's shared scratch (2.9 KB at D = 4).
// Only a value's low 4 bits are read (the chains test bits 0-3 of a mask),
// so an answer is one byte.
struct KjWarp {
    uint64_t q[KJ_SLOTS];     // staged key u; the live chains' k-mers
    uint32_t st[64];          // a live chain's c | joff + 1 << 8 | jm << 16
                              // | m << 24
    uint8_t r[KJ_SLOTS];      // slot p's answer: bit 7 found, bits 0-3 mask
    uint8_t at[KJ_SLOTS];     // staged key u -> the slot it answers
    uint8_t cnt[64];          // chain c's counter
    uint8_t rnt[KJ_MAXJ];     // the read's nucleotides w[1 + j] & 3
};

struct KjChain {
    uint64_t km;
    uint32_t m;
    int cnt, joff, jm, c;
    bool alive;
};

// Stages this lane's key for slot base + lane where act; *n counts the
// staged keys (warp-uniform).  Every lane of the warp calls it.
__device__ __forceinline__ void kj_stage(KjWarp& w, bool act, uint64_t key,
                                         int base, int* n) {
    const int lane = threadIdx.x & 31;
    const unsigned am = __ballot_sync(DTK_FULL, act);
    if (act) {
        const int u = *n + __popc(am & ((1u << lane) - 1u));
        w.q[u] = key;
        w.at[u] = (uint8_t)(base + lane);
    }
    *n += __popc(am);
}

// Probes the n staged keys at loc, groups of 8 lanes a key, KJ_KEYS keys a
// group a pass, the level stop on every key; every lane calls it.
template <int VW>
__device__ __forceinline__ void kj_probe(const DtkLevels& lv, KjWarp& w,
                                         int n, uint32_t loc) {
    const int lane = threadIdx.x & 31, g = lane >> 3, sl = lane & 7;
    const unsigned sh = 8 * g;
    __syncwarp();
#pragma unroll 1
    for (int base = 0; base < n; base += 4 * KJ_KEYS) {
        uint32_t lo[KJ_KEYS], hi[KJ_KEYS], v[KJ_KEYS];
        bool need[KJ_KEYS], f[KJ_KEYS];
#pragma unroll
        for (int j = 0; j < KJ_KEYS; ++j) {
            const int u = base + j * 4 + g;
            need[j] = u < n;
            const uint64_t q = need[j] ? w.q[u] : 0ull;
            lo[j] = (uint32_t)q;
            hi[j] = (uint32_t)(q >> 32);
            f[j] = false;
            v[j] = 0;
        }
        for (int l = 0; l < lv.n; ++l) {
            bool any = false;
#pragma unroll
            for (int j = 0; j < KJ_KEYS; ++j) any |= need[j];
            if (!__any_sync(DTK_FULL, any)) break;
            bool m[KJ_KEYS], occ[KJ_KEYS];
            uint32_t x[KJ_KEYS];
#pragma unroll
            for (int j = 0; j < KJ_KEYS; ++j) {
                m[j] = occ[j] = false;
                x[j] = 0;
                if (need[j])
                    dtk_stop_slot<VW>(lv, l, lo[j], hi[j], loc, sl, &m[j],
                                      &occ[j], &x[j]);
            }
#pragma unroll
            for (int j = 0; j < KJ_KEYS; ++j) {
                const unsigned hit =
                    (__ballot_sync(DTK_FULL, m[j]) >> sh) & 0xFFu;
                const unsigned full =
                    (__ballot_sync(DTK_FULL, occ[j]) >> sh) & 0xFFu;
                const uint32_t xm = dtk_group_max(x[j]);
                if (need[j] && hit) {
                    f[j] = true;
                    v[j] = xm;
                }
                need[j] = need[j] && !hit && full == 0xFFu;
            }
        }
#pragma unroll
        for (int j = 0; j < KJ_KEYS; ++j) {
            const int u = base + j * 4 + g;
            if (sl == 0 && u < n)
                w.r[w.at[u]] = f[j] ? (uint8_t)(0x80u | (v[j] & 15u)) : 0;
        }
    }
    __syncwarp();
}

// Slot p's answer: whether its key was found, and the mask's low 4 bits
// (0 when not found).
__device__ __forceinline__ uint32_t kj_answer(const KjWarp& w, int p,
                                              bool* found) {
    const uint32_t r = w.r[p];
    *found = r >> 7;
    return r & 15u;
}

template <int VW>
__global__ void __launch_bounds__(KJ_WARPS * 32, KJ_MIN_BLOCKS)
site_scorer_kernel(int64_t B, int k, int mes, const int64_t* __restrict__ w,
                   const int32_t* __restrict__ nkrem,
                   const int32_t* __restrict__ loc, DtkLevels g,
                   int32_t* __restrict__ out) {
    __shared__ KjWarp s_w[KJ_WARPS];
    const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t s = (int64_t)blockIdx.x * KJ_WARPS + wid;
    if (s >= B) return;                         // warp-uniform
    KjWarp& sw = s_w[wid];
    const int64_t* ws = w + s * (k + 3);
    const int nk = nkrem[s];
    const uint32_t lc = (uint32_t)loc[s];
    const uint64_t rmask = (1ull << (2 * (k - 1))) - 1;
    int32_t* o = out + s * KJ_NCH;

    // rnt[j] = w[1 + j] & 3; good[j] = w[1 + j] != NAN64 && j < nkrem
    uint64_t good = 0;
    for (int j0 = 0; j0 < k + 2; j0 += 32) {
        const int j = j0 + lane;
        bool gj = false;
        if (j < k + 2) {
            const uint64_t x = (uint64_t)ws[1 + j];
            sw.rnt[j] = (uint8_t)(x & 3);
            gj = x != ~0ull && j < nk;
        }
        good |= (uint64_t)__ballot_sync(DTK_FULL, gj) << j0;
    }
    sw.cnt[lane] = sw.cnt[lane + 32] = 0;
    __syncwarp();
    if (!(good & 7)) {                          // every gate closed
        for (int c = lane; c < KJ_NCH; c += 32) o[c] = 0;
        return;
    }

    // ---- mask probes: node, children, grandchildren ----
    bool f;
    const uint64_t node = (uint64_t)ws[0];
    int n = 0;
    kj_stage(sw, lane == 0, node, 0, &n);
    kj_probe<VW>(g, sw, n, lc);
    const uint32_t nb = kj_answer(sw, 0, &f);
    __syncwarp();
    const uint64_t cbase = (node & rmask) << 2;
    const bool c_on = lane < 4 && ((nb >> lane) & 1);   // child lane
    n = 0;
    kj_stage(sw, c_on, cbase | (uint64_t)lane, 0, &n);
    kj_probe<VW>(g, sw, n, lc);
    const uint32_t cb = c_on ? kj_answer(sw, lane, &f) : 0u;
    __syncwarp();
    const int gb_b = (lane >> 2) & 3, gb_b1 = lane & 3;
    const uint32_t cb_of = __shfl_sync(DTK_FULL, cb, gb_b);
    const bool g_on = lane < 16 && ((cb_of >> gb_b1) & 1);  // lane 4 b + b1
    n = 0;
    kj_stage(sw, g_on,
             (((cbase | (uint64_t)gb_b) & rmask) << 2) | (uint64_t)gb_b1, 0,
             &n);
    kj_probe<VW>(g, sw, n, lc);
    const uint32_t gb = g_on ? kj_answer(sw, lane, &f) : 0u;
    __syncwarp();
    const uint32_t nts0 = nb & 15;
    const uint32_t nts1 = __reduce_or_sync(DTK_FULL, lane < 4 ? cb & 15 : 0);
    const uint32_t nts2 = __reduce_or_sync(DTK_FULL, lane < 16 ? gb & 15 : 0);
    // bit 4 b + b1: grandchild (b, b1) has an out-edge; or1m[b] its nibble
    const uint32_t or1 = __ballot_sync(DTK_FULL, lane < 16 && (gb & 15));

    // ---- family gates (nem1-elif-nem2 exclusive) ----
    const int r0 = sw.rnt[0], r1 = sw.rnt[1], r2 = sw.rnt[2];
    const bool g0 = good & 1, g1 = (good >> 1) & 1, g2 = (good >> 2) & 1;
    const bool m2 = mes >= 2;
    const bool gate1 = nk > 1 && ((nts1 >> r1) & 1) && g1;
    const uint32_t gates =                      // bit f: family f's gate
        (uint32_t)gate1 |                                        // nem1
        (uint32_t)(((nts1 >> r0) & 1) && g0) << 1 |              // ned1
        (uint32_t)(nk > 1 && ((nts0 >> r1) & 1) && g1) << 2 |    // nei1
        (uint32_t)(!gate1 && nk > 2 && ((nts2 >> r2) & 1) && m2 && g2)
            << 3 |                                               // nem2
        (uint32_t)(nk > 1 && ((nts2 >> r1) & 1) && m2 && g1) << 4 |  // nemd
        (uint32_t)(((nts2 >> r0) & 1) && m2 && g0) << 5 |        // ned2
        (uint32_t)(nk > 2 && ((nts1 >> r2) & 1) && m2 && g2) << 6 |  // nemi
        (uint32_t)(nk > 2 && ((nts0 >> r2) & 1) && m2 && g2) << 7;   // nei2

    // ---- chain inits: chains c = lane and lane + 32; the live ones go
    // to shared memory in rank order ----
    const uint64_t w1 = (uint64_t)ws[1];
    unsigned live[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int c = lane + 32 * i;
        const int fam = kj_family(c);
        const int idx = c - kj_family_start(fam);
        const int nt0 = (fam >= 3 && fam <= 5) ? idx >> 2 : idx;
        const uint32_t or1m = (or1 >> (4 * (nt0 & 3))) & 15;
        // g3m[nt0][nt1] lives in lane idx (gb); every lane shuffles
        const uint32_t g3m =
            __shfl_sync(DTK_FULL, gb, (fam >= 3 && fam <= 5) ? idx : 0) & 15;
        const uint64_t x0 = (w1 & ~3ull) | (uint64_t)(nt0 & 3);
        uint64_t km;
        uint32_t m;
        bool en;
        if (fam == 2 || fam == 7) {             // nei1, nei2
            km = node;
            m = nts0;
            en = true;
        } else if (fam >= 3 && fam <= 5) {      // nem2, nemd, ned2
            const int nt1 = idx & 3;
            km = ((x0 & rmask) << 2) | (uint64_t)nt1;
            m = g3m;
            en = ((nts0 >> nt0) & 1) && ((or1m >> nt1) & 1);
        } else {                                // nem1, ned1, nemi
            km = x0;
            m = or1m;
            en = (nts0 >> nt0) & 1;
        }
        const bool alive = c < KJ_NCH && en && ((gates >> fam) & 1);
        live[i] = __ballot_sync(DTK_FULL, alive);
        if (alive) {
            const int rk = (i ? __popc(live[0]) : 0) +
                           __popc(live[i] & ((1u << lane) - 1u));
            const int joff1 = (KJ_JOFF1 >> (2 * fam)) & 3;
            sw.q[rk] = km;
            sw.st[rk] = (uint32_t)c | (uint32_t)joff1 << 8 |
                        (uint32_t)min(k + joff1, nk) << 16 | m << 24;
        }
    }
    // the live chains, compacted: rank r in lane r & 31 of half r >> 5
    const int nlive = __popc(live[0]) + __popc(live[1]);
    const int halves = nlive > 32 ? 2 : 1;      // warp-uniform
    __syncwarp();
    KjChain ch[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int rk = lane + 32 * i;
        KjChain& x = ch[i];
        x.alive = rk < nlive;
        const uint32_t st = x.alive ? sw.st[rk] : 0u;
        x.km = x.alive ? sw.q[rk] : 0ull;
        x.c = st & 0xFF;
        x.joff = (int)((st >> 8) & 0xFF) - 1;
        x.jm = (st >> 16) & 0xFF;
        x.m = st >> 24;
        x.cnt = 0;
    }
    __syncwarp();

    // ---- the walks: rounds of KJ_AHEAD steps ----
    for (int t0 = 1; t0 <= k && __any_sync(DTK_FULL, ch[0].alive ||
                                                      ch[1].alive);
         t0 += KJ_AHEAD) {
        // stage: steps t0 + d of each live chain whose step t0 passes,
        // where the step reads the next step's mask (slot (2 d + i) 32)
        n = 0;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            if (i >= halves) break;
            const KjChain& x = ch[i];
            uint64_t y = x.km;
            bool go = x.alive;
#pragma unroll
            for (int d = 0; d < KJ_AHEAD; ++d) {
                const int t = t0 + d, j = t + x.joff;
                go = go && t <= k && j < x.jm && ((good >> j) & 1);
                if (go) y = ((y & rmask) << 2) | (uint64_t)sw.rnt[j];
                if (d == 0) go = go && ((x.m >> (y & 3)) & 1);
                kj_stage(sw, go && t < k && j + 1 < x.jm &&
                                 ((good >> (j + 1)) & 1),
                         y, (2 * d + i) * 32, &n);
                if (!__any_sync(DTK_FULL, go)) break;
            }
        }
        kj_probe<VW>(g, sw, n, lc);
        // replay: count each step, the mask from the step's answer
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            if (i >= halves) break;
            KjChain& x = ch[i];
#pragma unroll
            for (int d = 0; d < KJ_AHEAD; ++d) {
                const int t = t0 + d, j = t + x.joff;
                if (!x.alive || t > k) break;
                if (j >= x.jm || !((good >> j) & 1)) {
                    x.alive = false;
                    break;
                }
                x.km = ((x.km & rmask) << 2) | (uint64_t)sw.rnt[j];
                if (!((x.m >> (x.km & 3)) & 1)) {
                    x.alive = false;
                    break;
                }
                ++x.cnt;
                if (t < k && j + 1 < x.jm && ((good >> (j + 1)) & 1)) {
                    const uint32_t v = kj_answer(sw, (2 * d + i) * 32 + lane,
                                                 &f);
                    if (f) x.m = v;             // stale-mask quirk
                }
            }
        }
        __syncwarp();                 // the next round rewrites the slots
    }
    // every counter to its chain's place; chains dead at the start keep 0
#pragma unroll
    for (int i = 0; i < 2; ++i)
        if (lane + 32 * i < nlive) sw.cnt[ch[i].c] = (uint8_t)ch[i].cnt;
    __syncwarp();
    o[lane] = sw.cnt[lane];
    if (lane + 32 < KJ_NCH) o[lane + 32] = sw.cnt[lane + 32];
}

// The lookahead and keys a group a pass this build was made with, for the
// A/B tool's report: D | KEYS << 8.
DTK_EXPORT int dtk_site_scorer_config() { return KJ_AHEAD | KJ_KEYS << 8; }

DTK_EXPORT int dtk_site_scorer(int64_t B, int64_t k, int64_t mes,
                               const void* w, const void* nkrem,
                               const void* loc, const void* gtabs,
                               const void* gnbs, const void* gsalts,
                               int64_t gnlev, void* out, void* stream) {
    DtkLevels g;
    if (!dtk_levels(&g, gtabs, gnbs, gsalts, gnlev) || k <= 16 || k > 32)
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaGetLastError();
    auto kernel = dtk_vector_width(g, 4) == 4 ? site_scorer_kernel<4>
                                              : site_scorer_kernel<0>;
    kernel<<<dtk_grid(B, KJ_WARPS), KJ_WARPS * 32, 0, (cudaStream_t)stream>>>(
        B, (int)k, (int)mes, (const int64_t*)w, (const int32_t*)nkrem,
        (const int32_t*)loc, g, (int32_t*)out);
    return (int)cudaGetLastError();
}
