// KC pair_vote: the per-pair locus vote of the counting step.
//
// Replaces K5, danbing_tk_tpu/engine/device_align.py:618-970 (make_step's
// vote: lax.sort dedupe, one-hot MXU gathers for the split CSR expansion,
// a second lax.sort by (locus, -nm), associative scans for segment totals
// and the scan-order tie census).  On the TPU every one of those was a
// full-width pass over (P, W) or (P, E, W) planes in HBM.
//
// Bound on the H100: latency, not bytes.  A pair reads W * 17 B and writes
// 10 B, so the 4,096 pairs of a step move 6 MB (2 us of HBM time); what
// costs is each pair's chain of dependent shared-memory steps and the
// barriers between its phases, hidden only by how many pairs an SM holds
// at once (measured on the card: the time scales as 1 / blocks per SM).
// The first design (one 256-thread block per pair, two bitonic sorts at
// the padded widths W -> 512 and W + E -> 1,024 keys, 100
// barrier-separated passes, thread 0 scanning chunk sums, serial walks of
// runs and segments, 64-bit arithmetic) spent ~100 us per block and, at
// E = 4096, 300 KB of global workspace per pair.
//
// This design sizes the work to what the pair holds and sorts nothing but
// the few vv-listed k-mers.  Everything the vote decides is a function of
// per-locus aggregates; only the E-plane cut and the tie census need an
// order, and only among the odd (vv-listed) runs:
//   1. the entries are loaded while the tables are cleared; the used ones
//      (use && kmer != INT64_MAX, pair_vote_plain's filler) go into an
//      open-addressing table keyed by k-mer (a 64-bit CAS claims a slot):
//      one run per k-mer, fwd / rev counts by atomicAdd, and the smallest
//      entry index, whose value is the stable sort's run start;
//   2. each run: an even value is one W-plane event, added to a second
//      table keyed by locus (f, r summed, nm max; the lanes of a warp that
//      share a locus sum first, __match_any_sync + redux, since a TR
//      read's runs mostly share one); an odd value joins the odd list;
//   3. the odd runs are ranked by signed k-mer (the plain version's
//      stable sort order; a count of smaller keys, no barrier passes);
//      one warp scans their vv counts (shuffle scan): CSR starts, total,
//      overflow = total > E counted before the cut;
//   4. the min(total, E) expansion slots: each finds its covering run by
//      binary search over the inclusive starts and adds its vv locus (a
//      dead NAN32 locus adds its counts to the largest live locus, whose
//      segment the plain version's scan extends over the dead events);
//   5. u32 block reductions (redux, one barrier each) over the distinct
//      loci: top total, the top count, the smallest top locus (the first
//      top segment in (locus, -nm) order), the candidate level m = min
//      over top loci of their max nm (clamped to the plain BIGI), and with
//      a tie the candidates;
//   6. only with a tie of nC != 1 candidates, the census over event-slot
//      order: a W-plane candidate event is a run of one slot (never nC);
//      an odd run's candidate events are counted per run (atomicAdd) and
//      its first slot kept (atomicMin), whose locus is the run's first
//      candidate;
//   7. test1 / test2, the referee bits and dst0 from the chosen locus's
//      totals (0 / 0 when the pair has no event, as the clamped gather of
//      the plain version reads).
// A pair's tables live in shared memory (32,512 B at W = 280, E = 512, so
// six 128-thread blocks an SM; 111,360 B at E = 4096, two 512-thread
// blocks, the retry tier's instance "KC[large-E]").  Only an E whose
// tables pass a block's 227 KB carves them from the pair's slice of a
// global workspace (kGlobal: a fence before each barrier, since atomics
// live in L2).
#include "common.cuh"

typedef unsigned long long ull;

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr ull KEMPTY = 0x7FFFFFFFFFFFFFFFull;   // INT64_MAX: no k-mer
constexpr uint32_t BIGI = 0x7FFFFFF0u;          // pair_vote_plain's BIGI
constexpr uint32_t FREE = 0xFFFFFFFFu;           // an idx of no entry

struct EntryRec {           // one run (distinct used k-mer)
    ull key;
    uint32_t fr;            // fwd count | rev count << 16
    uint32_t idx;           // smallest entry index of the run
};
struct LocusRec {           // one segment (distinct live locus)
    uint32_t loc;
    uint32_t nm;            // max nm of its events
    uint32_t f, r;          // summed fwd / rev counts
};

// The per-pair layout (bytes from the start of the pair's memory).  The
// wrapper's kc_smem_bytes (engine/device_align.py) repeats this formula.
struct KcLayout {
    int64_t ce, cl, etab, ltab, llist, okey, oaux, obase, onm, ofr, bytes;
};

__host__ __device__ inline int64_t kc_take(int64_t& o, int64_t b) {
    const int64_t r = o;
    o += (b + 15) & ~(int64_t)15;
    return r;
}

__host__ __device__ inline KcLayout kc_layout(int64_t W, int64_t E) {
    KcLayout L;
    const int64_t EV = W + E;
    L.ce = (3 * W / 2 + 31) / 32 * 32;      // > W runs
    L.cl = (EV + EV / 8 + 31) / 32 * 32;    // > W + E loci
    int64_t o = 0;
    L.etab = kc_take(o, 16 * L.ce);
    L.ltab = kc_take(o, 16 * L.cl);
    L.llist = kc_take(o, 4 * EV);
    L.okey = kc_take(o, 8 * W);     // odd keys; then census counts + mins
    L.oaux = kc_take(o, 8 * W);     // odd fr | base; then inclusive starts
    L.obase = kc_take(o, 4 * W);
    L.onm = kc_take(o, 4 * W);
    L.ofr = kc_take(o, 4 * W);
    L.bytes = o;
    return L;
}

// Reads of words other threads update atomically: volatile, so neither
// the compiler nor (in global mode, where atomics live in L2) L1 keeps a
// stale copy (__ldcv reads gave wrong counts in global mode on the card).
template <typename X>
__device__ __forceinline__ X ld(const X* p) {
    return *(const volatile X*)p;
}

// A block barrier; in global mode the block's stores reach L2 first, so
// the atomics after it (performed in L2) see them.
template <bool kG>
__device__ __forceinline__ void bar() {
    if constexpr (kG) __threadfence();
    __syncthreads();
}

__device__ __forceinline__ uint32_t slot_of(uint32_t h, int64_t cap) {
    return (uint32_t)(((ull)h * (ull)cap) >> 32);
}

__device__ __forceinline__ uint32_t vv_at(const int32_t* vv, int64_t nvv,
                                          long long pos) {
    if (pos < 0) pos = 0;
    if (pos > nvv - 1) pos = nvv - 1;
    return (uint32_t)__ldg(vv + pos);
}

// The k-mer table slot of key, claimed with a 64-bit CAS if new.
template <bool kG>
__device__ __forceinline__ uint32_t entry_slot(EntryRec* et, int64_t ce,
                                               ull key) {
    uint32_t i = slot_of(dtk_mix32((uint32_t)key ^
                                   dtk_mix32((uint32_t)(key >> 32))), ce);
    while (true) {
        const ull cur = ld(&et[i].key);
        if (cur == key) return i;
        if (cur == KEMPTY) {
            const ull prev = atomicCAS(&et[i].key, KEMPTY, key);
            if (prev == KEMPTY || prev == key) return i;
        }
        if (++i == ce) i = 0;
    }
}

// Adds one event (or a W-plane run) of locus loc to the locus table.
template <bool kG>
__device__ __forceinline__ void add_event(LocusRec* lt, int64_t cl,
                                          uint32_t* llist, uint32_t* nloc,
                                          uint32_t loc, uint32_t f,
                                          uint32_t r, uint32_t nm) {
    uint32_t i = slot_of(dtk_mix32(loc), cl);
    while (true) {
        const uint32_t cur = ld(&lt[i].loc);
        if (cur == loc) break;
        if (cur == DTK_NAN32) {
            const uint32_t prev = atomicCAS(&lt[i].loc, DTK_NAN32, loc);
            if (prev == DTK_NAN32) {
                llist[atomicAdd(nloc, 1u)] = i;
                break;
            }
            if (prev == loc) break;
        }
        if (++i == cl) i = 0;
    }
    if (f) atomicAdd(&lt[i].f, f);
    if (r) atomicAdd(&lt[i].r, r);
    if (ld(&lt[i].nm) < nm) atomicMax(&lt[i].nm, nm);
}

// add_event for the lanes of a converged warp that hold an event (live):
// lanes of one locus first sum their counts (__match_any_sync, redux), so
// a locus takes one insert and one atomic per warp, not one per event.
template <bool kG>
__device__ __forceinline__ void add_events_warp(LocusRec* lt, int64_t cl,
                                                uint32_t* llist,
                                                uint32_t* nloc, bool live,
                                                uint32_t loc, uint32_t f,
                                                uint32_t r, uint32_t nm) {
    const unsigned act = __ballot_sync(FULL, live);
    if (!live) return;
    const unsigned m = __match_any_sync(act, loc);
    const uint32_t fs = __reduce_add_sync(m, f);
    const uint32_t rs = __reduce_add_sync(m, r);
    const uint32_t nx = __reduce_max_sync(m, nm);
    if ((int)(threadIdx.x & 31) == __ffs(m) - 1)
        add_event<kG>(lt, cl, llist, nloc, loc, fs, rs, nx);
}

// The record of a locus known to be in the table (nullptr if absent).
template <bool kG>
__device__ __forceinline__ const LocusRec* find_locus(const LocusRec* lt,
                                                      int64_t cl,
                                                      uint32_t loc) {
    uint32_t i = slot_of(dtk_mix32(loc), cl);
    while (true) {
        const uint32_t cur = ld(&lt[i].loc);
        if (cur == loc) return lt + i;
        if (cur == DTK_NAN32) return nullptr;
        if (++i == cl) i = 0;
    }
}

// Block-wide reduction of three u32 values (op 0 sum, 1 min, 2 max);
// every thread gets the results.  One barrier: calls alternate between
// the two halves of red, so a half is rewritten only after every thread
// has passed the barrier of the call between.
template <int T>
__device__ void block_reduce3(uint32_t v[3], const int op[3],
                              uint32_t (*red)[3][32], int& half) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < 3; ++k)
        v[k] = op[k] == 0 ? __reduce_add_sync(FULL, v[k])
             : op[k] == 1 ? __reduce_min_sync(FULL, v[k])
                          : __reduce_max_sync(FULL, v[k]);
    uint32_t (*r)[32] = red[half];
    half ^= 1;
    if (lane == 0)
#pragma unroll
        for (int k = 0; k < 3; ++k) r[k][wid] = v[k];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        uint32_t x = r[k][0];
        for (int w = 1; w < T / 32; ++w) {
            const uint32_t y = r[k][w];
            x = op[k] == 0 ? x + y : op[k] == 1 ? min(x, y) : max(x, y);
        }
        v[k] = x;
    }
}

__device__ __forceinline__ int64_t entry_offset(int p, int NKW, int t) {
    return (int64_t)(2 * p + (t >= NKW)) * NKW + (t >= NKW ? t - NKW : t);
}

// The covering odd run of expansion slot e < total: the first j with
// inclusive start ocs[j] > e.
__device__ __forceinline__ int cover(const ull* ocs, int nodd, int e) {
    int lo = 0, hi = nodd - 1;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (ocs[mid] > (ull)e) hi = mid;
        else lo = mid + 1;
    }
    return lo;
}

template <int T, bool kG>
__global__ void __launch_bounds__(T)
pair_vote_kernel(const int64_t* __restrict__ kmer,
                 const int64_t* __restrict__ val,
                 const uint8_t* __restrict__ use,
                 const uint8_t* __restrict__ pair_kf, int NKW,
                 const int32_t* __restrict__ vv, int64_t nvv, int E,
                 long long cth, int64_t* __restrict__ dst0_out,
                 uint8_t* __restrict__ vote_out,
                 uint8_t* __restrict__ pack_out, char* ws,
                 int64_t ws_stride) {
    extern __shared__ __align__(16) char smem[];
    __shared__ uint32_t red[2][3][32];
    __shared__ uint32_t s_nodd, s_nloc, s_deadf, s_deadr;
    __shared__ ull s_total;
    const int p = blockIdx.x, tid = threadIdx.x;
    const int W = 2 * NKW;
    const KcLayout Lo = kc_layout(W, E);
    const int64_t CE = Lo.ce, CL = Lo.cl;
    char* base = kG ? ws + (size_t)p * (size_t)ws_stride : smem;
    EntryRec* et = (EntryRec*)(base + Lo.etab);
    LocusRec* lt = (LocusRec*)(base + Lo.ltab);
    uint32_t* llist = (uint32_t*)(base + Lo.llist);
    ull* okey = (ull*)(base + Lo.okey);
    uint32_t* ocnt = (uint32_t*)(base + Lo.okey);        // census, later
    uint32_t* omin = ocnt + W;
    uint32_t* ofru = (uint32_t*)(base + Lo.oaux);
    uint32_t* obu = ofru + W;
    ull* ocs = (ull*)(base + Lo.oaux);                   // after ranking
    uint32_t* obase = (uint32_t*)(base + Lo.obase);
    uint32_t* onm = (uint32_t*)(base + Lo.onm);
    uint32_t* ofr = (uint32_t*)(base + Lo.ofr);
    ull* skey = okey;               // the entries' keys, until phase 2
    uint32_t* sval = obase;         // their values, until phase 3
    int half = 0;                                        // of red

    // the entries (KEMPTY where unused), loaded before the tables are
    // cleared so the loads overlap the clearing
#pragma unroll 4
    for (int t = tid; t < W; t += T) {
        const int64_t o = entry_offset(p, NKW, t);
        const ull key = (ull)kmer[o];
        skey[t] = use[o] ? key : KEMPTY;
        sval[t] = (uint32_t)val[o];
    }
    for (int64_t i = tid; i < CE; i += T)
        et[i] = EntryRec{KEMPTY, 0u, FREE};
    for (int64_t i = tid; i < CL; i += T)
        lt[i] = LocusRec{DTK_NAN32, 0u, 0u, 0u};
    if (tid == 0) {
        s_nodd = s_nloc = s_deadf = s_deadr = 0;
    }
    bar<kG>();

    // ---- 1. runs: the used entries by k-mer ----
    int mine = 0;
    for (int t = tid; t < W; t += T) {
        const ull key = skey[t];          // this thread's own store
        if (key == KEMPTY) continue;
        mine = 1;
        const uint32_t i = entry_slot<kG>(et, CE, key);
        atomicAdd(&et[i].fr, t >= NKW ? 0x10000u : 1u);
        if (ld(&et[i].idx) > (uint32_t)t)
            atomicMin(&et[i].idx, (uint32_t)t);
    }
    if constexpr (kG) __threadfence();
    if (!__syncthreads_or(mine)) {     // no entries: no event, no overflow
        if (tid == 0) {
            dst0_out[p] = (int64_t)DTK_NAN32;
            vote_out[p] = 0;
            pack_out[p] = 0;
        }
        return;
    }

    // ---- 2. W-plane events of even runs; the odd list ----
    for (int64_t i = tid; i < CE; i += T) {     // CE: a multiple of 32
        const uint32_t t = ld(&et[i].idx);
        uint32_t fr = 0, rv = 0;
        if (t != FREE) {
            fr = ld(&et[i].fr);
            rv = sval[t];
            if (rv & 1u) {
                const uint32_t n = atomicAdd(&s_nodd, 1u);
                okey[n] = ld(&et[i].key);
                ofru[n] = fr;
                obu[n] = rv >> 1;
            }
        }
        add_events_warp<kG>(lt, CL, llist, &s_nloc, t != FREE && !(rv & 1u),
                            rv >> 1, fr & 0xFFFFu, fr >> 16, 1u);
    }
    bar<kG>();
    const int nodd = (int)s_nodd;

    int nslot = 0;
    ull total = 0;
    if (nodd > 0) {
        // ---- 3. odd runs in k-mer order (signed, as the plain sort) ----
        for (int i = tid; i < nodd; i += T) {
            const long long ki = (long long)okey[i];
            int rank = 0;
            for (int j = 0; j < nodd; ++j)
                rank += (long long)okey[j] < ki;
            const uint32_t b = obu[i];
            obase[rank] = b;
            onm[rank] = vv_at(vv, nvv, b);
            ofr[rank] = ofru[i];
        }
        bar<kG>();
        if (tid < 32) {
            ull carry = 0;
            for (int b = 0; b < nodd; b += 32) {
                const int i = b + tid;
                ull v = i < nodd ? (ull)onm[i] : 0ull;
#pragma unroll
                for (int d = 1; d < 32; d <<= 1) {
                    const ull u = __shfl_up_sync(FULL, v, d);
                    if (tid >= d) v += u;
                }
                if (i < nodd) ocs[i] = carry + v;
                carry += __shfl_sync(FULL, v, 31);
            }
            if (tid == 0) s_total = carry;
        }
        bar<kG>();
        total = s_total;
        nslot = (int)(total < (ull)E ? total : (ull)E);

        // ---- 4. the expansion slots ----
        for (int e = tid; e < nslot; e += T) {
            const int j = cover(ocs, nodd, e);
            const ull st = ocs[j] - onm[j];
            const uint32_t loc = vv_at(vv, nvv, (long long)obase[j] + 1 +
                                                    (long long)(e - st));
            const uint32_t fr = ofr[j];
            if (loc == DTK_NAN32) {                  // a dead event
                atomicAdd(&s_deadf, fr & 0xFFFFu);
                atomicAdd(&s_deadr, fr >> 16);
            } else {
                add_event<kG>(lt, CL, llist, &s_nloc, loc, fr & 0xFFFFu,
                              fr >> 16, onm[j]);
            }
        }
        bar<kG>();
    }
    const int nloc = (int)s_nloc;
    const bool overflow = total > (ull)E;
    const bool has_entries = nloc > 0;

    // ---- 5. top total; then the top loci's count, first locus, level ----
    // (every total fits u32: check_vote_shape bounds (W + E) * W)
    auto tot_of = [](const LocusRec* r) {
        return ld(&r->f) + ld(&r->r);
    };
    const int op_max[3] = {2, 2, 2};
    uint32_t v[3] = {0, 0, 0};
    if ((s_deadf | s_deadr) != 0 && has_entries) {
        // dead events (a vv locus of NAN32) sort right after the last live
        // segment, and the plain version's segment sums run over them into
        // it: they add to the largest live locus's totals
        for (int i = tid; i < nloc; i += T)
            v[0] = max(v[0], ld(&lt[llist[i]].loc));
        block_reduce3<T>(v, op_max, red, half);
        if (tid == 0) {
            LocusRec* r = const_cast<LocusRec*>(
                find_locus<kG>(lt, CL, v[0]));
            atomicAdd(&r->f, s_deadf);
            atomicAdd(&r->r, s_deadr);
        }
        bar<kG>();
        v[0] = 0;
    }
    for (int i = tid; i < nloc; i += T)
        v[0] = max(v[0], tot_of(lt + llist[i]));
    block_reduce3<T>(v, op_max, red, half);
    const uint32_t top_tot = v[0];
    const int op_top[3] = {0, 1, 1};
    v[0] = 0;
    v[1] = DTK_NAN32;
    v[2] = BIGI;
    for (int i = tid; i < nloc; i += T) {
        const LocusRec* r = lt + llist[i];
        if (tot_of(r) != top_tot) continue;
        v[0] += 1;
        v[1] = min(v[1], ld(&r->loc));
        v[2] = min(v[2], ld(&r->nm));
    }
    block_reduce3<T>(v, op_top, red, half);
    const uint32_t n_top = v[0], top_loc0 = v[1], m_lvl = v[2];
    const bool tie = n_top > 1 && has_entries;

    bool use_win = false, tie_res = false;
    uint32_t win_loc = 0;
    if (tie) {
        // the candidates: top loci whose max nm is the level m
        const int op_c[3] = {0, 1, 2};
        v[0] = 0;
        v[1] = DTK_NAN32;
        v[2] = 0;
        for (int i = tid; i < nloc; i += T) {
            const LocusRec* r = lt + llist[i];
            if (tot_of(r) != top_tot || ld(&r->nm) != m_lvl) continue;
            v[0] += 1;
            v[1] = min(v[1], ld(&r->loc));
        }
        block_reduce3<T>(v, op_c, red, half);
        const uint32_t nC = v[0], winner1 = v[1];
        bool multi_ok = false;
        uint32_t floc_min = DTK_NAN32;
        if (nC != 1) {
            // ---- 6. the census over event-slot order ----
            uint32_t bad = 0;
            for (int j = tid; j < nodd; j += T) {
                ocnt[j] = 0;
                omin[j] = 0xFFFFFFFFu;
            }
            if (m_lvl == 1) {       // a W-plane candidate: a run of 1 != nC
                for (int64_t i = tid; i < CE; i += T) {
                    const uint32_t t = ld(&et[i].idx);
                    if (t == FREE) continue;
                    const uint32_t rv =
                        (uint32_t)val[entry_offset(p, NKW, (int)t)];
                    if (rv & 1u) continue;
                    const LocusRec* r = find_locus<kG>(lt, CL, rv >> 1);
                    if (r && tot_of(r) == top_tot && ld(&r->nm) == 1u)
                        bad = 1;
                }
            }
            bar<kG>();
            for (int e = tid; e < nslot; e += T) {
                const int j = cover(ocs, nodd, e);
                if (onm[j] != m_lvl) continue;
                const ull st = ocs[j] - onm[j];
                const uint32_t loc = vv_at(
                    vv, nvv, (long long)obase[j] + 1 + (long long)(e - st));
                if (loc == DTK_NAN32) continue;
                const LocusRec* r = find_locus<kG>(lt, CL, loc);
                if (!r || tot_of(r) != top_tot || ld(&r->nm) != m_lvl)
                    continue;
                atomicAdd(&ocnt[j], 1u);
                atomicMin(&omin[j], (uint32_t)e);
            }
            bar<kG>();
            const int op_f[3] = {2, 1, 2};
            v[0] = bad;
            v[1] = DTK_NAN32;
            v[2] = 0;
            for (int j = tid; j < nodd; j += T) {
                const uint32_t c = ld(&ocnt[j]);
                if (c == 0) continue;
                if (c != nC) v[0] = 1;
                const ull st = ocs[j] - onm[j];
                const uint32_t loc = vv_at(
                    vv, nvv, (long long)obase[j] + 1 +
                                 (long long)(ld(&omin[j]) - st));
                v[1] = min(v[1], loc);
                v[2] = max(v[2], loc);
            }
            block_reduce3<T>(v, op_f, red, half);
            floc_min = v[1];
            multi_ok = v[0] == 0 && v[1] == v[2] && v[1] != DTK_NAN32;
        }
        tie_res = nC == 1 || multi_ok;
        win_loc = nC == 1 ? winner1 : floc_min;
        use_win = tie_res;
    }

    // ---- 7. accept tests, referee bits, dst0 ----
    if (tid == 0) {
        const bool kf_ok = pair_kf[p] != 0;
        long long top_f = 0, top_r = 0;
        const uint32_t top_loc = use_win ? win_loc : top_loc0;
        if (has_entries) {
            const LocusRec* r = find_locus<kG>(lt, CL, top_loc);
            if (r) {
                top_f = (long long)ld(&r->f);
                top_r = (long long)ld(&r->r);
            }
        }
        const bool test1 = top_f >= cth && top_r >= cth;
        const bool test2 = top_f + top_r >= 2LL * cth;
        const bool vote_pass = (test1 || test2) && has_entries && kf_ok;
        const bool r_tie = kf_ok && tie && !tie_res;
        const bool r_ovf = kf_ok && overflow;
        const bool r_t2 = kf_ok && !test1 && test2;
        const bool referee = r_tie || r_ovf || r_t2;
        dst0_out[p] = has_entries ? (int64_t)top_loc : (int64_t)DTK_NAN32;
        vote_out[p] = vote_pass;
        pack_out[p] = (uint8_t)(referee | (r_tie << 1) | (r_ovf << 2) |
                                (r_t2 << 3));
    }
}

template <int T, bool kG>
static int launch(const void* kmer, const void* val, const void* use,
                  const void* pair_kf, int64_t P, int64_t NKW,
                  const void* vv, int64_t nvv, int64_t E, int64_t cth,
                  int64_t smem, void* ws, int64_t ws_stride, void* dst0,
                  void* vote_pass, void* pack, void* stream) {
    if (!kG) {
        // the opt-in is per device; raise it only when a launch needs more
        static int64_t opted[64] = {0};
        int d = 0;
        cudaError_t err = cudaGetDevice(&d);
        if (err != cudaSuccess) return (int)err;
        if (d >= 64 || smem > opted[d]) {
            err = cudaFuncSetAttribute(
                pair_vote_kernel<T, kG>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (err != cudaSuccess) return (int)err;
            if (d < 64) opted[d] = smem;
        }
    }
    if (P > 0)
        pair_vote_kernel<T, kG><<<(unsigned)P, T, (size_t)smem,
                                  (cudaStream_t)stream>>>(
            (const int64_t*)kmer, (const int64_t*)val, (const uint8_t*)use,
            (const uint8_t*)pair_kf, (int)NKW, (const int32_t*)vv, nvv,
            (int)E, (long long)cth, (int64_t*)dst0, (uint8_t*)vote_pass,
            (uint8_t*)pack, (char*)ws, ws_stride);
    return (int)cudaGetLastError();
}

// The bytes of one pair's tables at (NKW, E) (the wrapper checks its
// kc_smem_bytes against this).
DTK_EXPORT int64_t dtk_pair_vote_bytes(int64_t NKW, int64_t E) {
    return kc_layout(2 * NKW, E).bytes;
}

// mode 0: 128 threads a pair, tables in `smem` bytes of shared memory (the
// main path's E); mode 1: 512 threads, shared memory (the retry tier,
// "KC[large-E]"); mode 2: 512 threads, tables in ws (P slices of
// ws_stride bytes, a multiple of 256).
DTK_EXPORT int dtk_pair_vote(const void* kmer, const void* val,
                             const void* use, const void* pair_kf,
                             int64_t P, int64_t NKW, const void* vv,
                             int64_t nvv, int64_t E, int64_t cth,
                             int64_t mode, int64_t smem, void* ws,
                             int64_t ws_stride, void* dst0, void* vote_pass,
                             void* pack, void* stream) {
    const int64_t need = kc_layout(2 * NKW, E).bytes;
    if (mode == 0 || mode == 1) {
        if (smem < need) return (int)cudaErrorInvalidValue;
        return mode == 0
            ? launch<128, false>(kmer, val, use, pair_kf, P, NKW, vv, nvv,
                                 E, cth, smem, nullptr, 0, dst0, vote_pass,
                                 pack, stream)
            : launch<512, false>(kmer, val, use, pair_kf, P, NKW, vv, nvv,
                                 E, cth, smem, nullptr, 0, dst0, vote_pass,
                                 pack, stream);
    }
    if (mode != 2 || ws_stride < need || ws_stride % 256)
        return (int)cudaErrorInvalidValue;
    return launch<512, true>(kmer, val, use, pair_kf, P, NKW, vv, nvv, E,
                             cth, 0, ws, ws_stride, dst0, vote_pass, pack,
                             stream);
}
