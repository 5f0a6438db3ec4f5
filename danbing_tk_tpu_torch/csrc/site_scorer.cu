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
// no counter.  Lanes 0, 0-3 and 0-15 make the mask probes in three rounds
// (node, the children its mask allows, the grandchildren theirs allow),
// shuffled to every lane; lane c walks chains c and c + 32 side by side,
// with native uint64_t shifts, counting each step and probing its k-mer
// only where the next step reads the mask; the mask is overwritten only on
// a hit (getNextNucs).  A site where good[0..2] are all false (a pad row,
// nkrem = 0) opens no gate: it writes zeros without a probe.  Every probe
// goes through bucket.cuh's dtk_probe, the one KB, KF, KG and KI use.
//
// Bound on the H100: the distinct 128 B rows of the 8.86 GB graph table
// that the live probes read, plus the sites' k-mers in and the counters
// out, over 3.35 TB/s.  The rows are read one dependent, uncoalesced probe
// after another along each chain, so latency and not bandwidth holds it:
// the early exit cuts the probes to those that can change a counter, and
// a warp keeps up to 62 chains' probes in flight.
#include "bucket.cuh"

constexpr int KJ_THREADS = 256;
constexpr int KJ_WARPS = KJ_THREADS / 32;
constexpr int KJ_NCH = 62;
constexpr int KJ_MAXJ = 34;                // k + 2 for k <= 32
constexpr unsigned KJ_FULL = 0xFFFFFFFFu;

// FAMILIES of ops/correct.py: nem1 4, ned1 4, nei1 1, nem2 16, nemd 16,
// ned2 16, nemi 4, nei2 1; a chain of family f at step t reads the read's
// nucleotide rnt[t + joff[f]] while t + joff[f] < min(k + jmo[f], nkrem)
__constant__ int kj_off[9] = {0, 4, 8, 9, 25, 41, 57, 61, 62};
__constant__ int kj_joff[8] = {0, -1, 0, 1, 0, -1, 1, 1};
__constant__ int kj_jmo[8] = {1, 0, 1, 2, 1, 0, 2, 2};

struct KjChain {
    uint64_t km;
    uint32_t m;
    int cnt, joff, jm;
    bool alive;
};

__device__ __forceinline__ uint32_t kj_mask(const DtkLevels& g, uint64_t km,
                                            uint32_t loc, bool* found) {
    uint32_t v, v2;
    *found = dtk_probe(g, 4, 1, 1, km, loc, &v, &v2);
    return v;
}

__global__ void site_scorer_kernel(int64_t B, int k, int mes,
                                   const int64_t* __restrict__ w,
                                   const int32_t* __restrict__ nkrem,
                                   const int32_t* __restrict__ loc,
                                   DtkLevels g, int32_t* __restrict__ out) {
    __shared__ uint8_t s_rnt[KJ_WARPS][KJ_MAXJ];
    const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t s = (int64_t)blockIdx.x * KJ_WARPS + wid;
    if (s >= B) return;                         // warp-uniform
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
            s_rnt[wid][j] = (uint8_t)(x & 3);
            gj = x != ~0ull && j < nk;
        }
        good |= (uint64_t)__ballot_sync(KJ_FULL, gj) << j0;
    }
    __syncwarp();
    if (!(good & 7)) {                          // every gate closed
        for (int c = lane; c < KJ_NCH; c += 32) o[c] = 0;
        return;
    }

    // ---- mask probes: node, children, grandchildren ----
    bool f;
    const uint64_t node = (uint64_t)ws[0];
    uint32_t nb = 0;
    if (lane == 0) nb = kj_mask(g, node, lc, &f);
    nb = __shfl_sync(KJ_FULL, nb, 0);
    const uint64_t cbase = (node & rmask) << 2;
    uint32_t cb = 0;                            // lane b < 4: child b
    if (lane < 4 && ((nb >> lane) & 1))
        cb = kj_mask(g, cbase | (uint64_t)lane, lc, &f);
    const int gb_b = (lane >> 2) & 3, gb_b1 = lane & 3;
    const uint32_t cb_of = __shfl_sync(KJ_FULL, cb, gb_b);
    uint32_t gb = 0;                            // lane 4 b + b1 < 16
    if (lane < 16 && ((cb_of >> gb_b1) & 1))
        gb = kj_mask(g, (((cbase | (uint64_t)gb_b) & rmask) << 2) |
                            (uint64_t)gb_b1, lc, &f);
    const uint32_t nts0 = nb & 15;
    const uint32_t nts1 = __reduce_or_sync(KJ_FULL, lane < 4 ? cb & 15 : 0);
    const uint32_t nts2 = __reduce_or_sync(KJ_FULL, lane < 16 ? gb & 15 : 0);
    // bit 4 b + b1: grandchild (b, b1) has an out-edge; or1m[b] its nibble
    const uint32_t or1 = __ballot_sync(KJ_FULL, lane < 16 && (gb & 15));

    // ---- family gates (nem1-elif-nem2 exclusive) ----
    const int r0 = s_rnt[wid][0], r1 = s_rnt[wid][1], r2 = s_rnt[wid][2];
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

    // ---- chain inits: lane's chains c and c + 32 ----
    const uint64_t w1 = (uint64_t)ws[1];
    KjChain ch[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int c = lane + 32 * i;
        int fam = 0;
        while (fam < 7 && c >= kj_off[fam + 1]) ++fam;
        const int idx = c - kj_off[fam];
        const int nt0 = (fam >= 3 && fam <= 5) ? idx >> 2 : idx;
        const uint32_t or1m = (or1 >> (4 * (nt0 & 3))) & 15;
        // g3m[nt0][nt1] lives in lane idx (gb); every lane shuffles
        const uint32_t g3m =
            __shfl_sync(KJ_FULL, gb, (fam >= 3 && fam <= 5) ? idx : 0) & 15;
        KjChain& x = ch[i];
        x.cnt = 0;
        x.joff = kj_joff[fam];
        x.jm = min(k + kj_jmo[fam], nk);
        const uint64_t x0 = (w1 & ~3ull) | (uint64_t)(nt0 & 3);
        bool en;
        if (fam == 2 || fam == 7) {             // nei1, nei2
            x.km = node;
            x.m = nts0;
            en = true;
        } else if (fam >= 3 && fam <= 5) {      // nem2, nemd, ned2
            const int nt1 = idx & 3;
            x.km = ((x0 & rmask) << 2) | (uint64_t)nt1;
            x.m = g3m;
            en = ((nts0 >> nt0) & 1) && ((or1m >> nt1) & 1);
        } else {                                // nem1, ned1, nemi
            x.km = x0;
            x.m = or1m;
            en = (nts0 >> nt0) & 1;
        }
        x.alive = c < KJ_NCH && en && ((gates >> fam) & 1);
    }

    // ---- the walks: count each step, probe where the next step reads ----
    for (int t = 1; t <= k && (ch[0].alive || ch[1].alive); ++t) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            KjChain& x = ch[i];
            if (!x.alive) continue;
            const int j = t + x.joff;
            if (j >= x.jm || !((good >> j) & 1)) {
                x.alive = false;
                continue;
            }
            x.km = ((x.km & rmask) << 2) | (uint64_t)s_rnt[wid][j];
            if (!((x.m >> (x.km & 3)) & 1)) {
                x.alive = false;
                continue;
            }
            ++x.cnt;
            if (t < k && j + 1 < x.jm && ((good >> (j + 1)) & 1)) {
                const uint32_t v = kj_mask(g, x.km, lc, &f);
                if (f) x.m = v;                 // stale-mask quirk
            }
        }
    }
    o[lane] = ch[0].cnt;
    if (lane + 32 < KJ_NCH) o[lane + 32] = ch[1].cnt;
}

DTK_EXPORT int dtk_site_scorer(int64_t B, int64_t k, int64_t mes,
                               const void* w, const void* nkrem,
                               const void* loc, const void* gtabs,
                               const void* gnbs, const void* gsalts,
                               int64_t gnlev, void* out, void* stream) {
    DtkLevels g;
    if (!dtk_levels(&g, gtabs, gnbs, gsalts, gnlev) || k <= 16 || k > 32)
        return (int)cudaErrorInvalidValue;
    if (B > 0)
        site_scorer_kernel<<<dtk_grid(B, KJ_WARPS), KJ_THREADS, 0,
                             (cudaStream_t)stream>>>(
            B, (int)k, (int)mes, (const int64_t*)w, (const int32_t*)nkrem,
            (const int32_t*)loc, g, (int32_t*)out);
    return (int)cudaGetLastError();
}
