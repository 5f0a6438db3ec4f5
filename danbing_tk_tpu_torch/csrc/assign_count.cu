// KD assign_count: TR/flank annotation, the assignTRkmc scan and the count
// scatter of the counting step.
//
// Replaces K6-K8, danbing_tk_tpu/engine/device_align.py:1031-1057 (the
// annotation combine), :1063-1131 (assignTRkmc as associative scans over
// (2P, NKW) planes) and :1135-1191 (scatter-adds into counts / nmapread /
// kmc).
//
// Bound on the H100: bytes.  Each position reads 27 B of planes (found,
// val, annv, kvalid, afound_t, aval_t) once; the count atomics scatter
// into a table of up to 0.5 GB, far past L2, and cost a 32 B sector
// read-modify-write each: in the counting instance they take about as
// long as everything else together.  The first design ran one thread per
// read: 64 blocks of 4 warps at P = 4096 (most SMs idle), every plane load
// strided by NKW (1 B used of each 32 B sector for a u8 plane), and every
// plane read twice (the scan, then the count pass), in a loop bound by
// each load's latency.
//
// Here a warp takes one read, lane i position 32 c + i of chunk c, so
// every plane load and store is coalesced and P = 4096 gives 8,192 warps
// (registers capped at 64 a thread, so an SM holds 4 blocks of 8 warps).
//   1. The lanes load the read's first KD_RC chunks at once (predicated,
//      so every load is in flight together) and keep each position's
//      annotation (ann = aval & 3, from the single-locus dbi value at dst0
//      or the trfl probe) and slot rank (aval >> 3) in one register per
//      chunk; a longer read re-reads its later chunks in step 3.
//   2. The sequential state machine of the reference (last known
//      annotation, the first two transitions, the first known value, the
//      TR count) runs as a warp scan over the chunks: ballots of the known
//      and the transition positions, the last known lane below each lane
//      from __clz on the known mask (or the carry from the last chunk),
//      the first transitions from __ffs, the counts from __popc.  Every
//      lane ends with the same af / rm / nt / bs / ti / si / ei / si_ /
//      ei_, and lanes 0-8 store the nine fields.
//   3. The two mates of a pair (neighbouring warps of one block) meet in
//      shared memory to decide whether the pair is counted; each TR
//      position of a counted mate adds 1 to counts[slot] with unsigned
//      atomics (u32 wrap, as the JAX scatter), lanes of one slot in a
//      chunk adding once (__match_any_sync).  A tandem repeat whose period
//      is under 32 puts positions of one chunk on one slot: on the golden
//      panel's reads 73% of the adds share their slot so, and on an H100
//      the aggregation takes KD on that counting step from 0.0248 to
//      0.0202 ms (it costs 5% on random loci, where nothing shares).  Every
//      other position goes to the trash slot counts[nslots], one atomic
//      per block.  The even warp adds nmate and the segment length into
//      nmapread / kmc at dst0 (clamped to [0, nloci] as the plain version
//      does).
//
// The counting and okam instances also run the step's per-pair tail (KM,
// step_tail.cuh) where the mates meet in step 3: lane 0 of the even warp
// writes the pair's hf, counted and dest and leaves its nine read
// statistics in shared memory beside s_trash, and nine threads of the block
// add them into stats, one 64-bit atomic a counter (1,024 blocks x 9 at P =
// 4096), as thread 0 adds the trash slot.  dtk_assign_count runs no tail
// (a null stats pointer); dtk_assign_count_tail takes its planes.
//
// A bait-filtered pair (KF's bf_pair, null without bait) enters as
// rm_entry = (kf == 1) | bf_pair (device_align.py:1088): both mates are
// removed, so the pair is not counted.  With kAnnot (okam steps) step 1
// also writes the ann plane ((2P, NKW) u8, :1236-1237) for .kam rows.
//
// Threading mode (the graph-threading step, device_align.py:1143-1191)
// stops after step 2: step 1 writes the tr_member plane (u8, ((ann == 2) |
// in_tr) & kvalid with in_tr = afound & ((aval >> 2) & 1)) and the slot
// plane, and counts / nmapread / kmc are left to KE (csrc/thread_walk.cu),
// which counts only the pairs whose walk is clean.
#include "step_tail.cuh"

constexpr unsigned KD_FULL = 0xFFFFFFFFu;
constexpr int KD_WARPS = 8;   // reads (4 pairs) a block
constexpr int KD_RC = 8;      // chunks of 32 positions kept in registers
constexpr int KD_MIN_BLOCKS = 4;   // 64 registers a thread: 32 warps an SM

struct KdIn {
    const uint8_t* found;
    const int64_t* val;
    const int64_t* annv;
    const uint8_t* kvalid;
    const uint8_t* afound_t;
    const int64_t* aval_t;
};

// Annotation of position o (0 where !ok): returns ann, writes the slot
// rank and the tr_member bit.  The value planes hold u32 values, so only
// their low words are loaded.
__device__ __forceinline__ int kd_ann(const KdIn& in, int64_t o, bool ok,
                                      int64_t dst, bool dev, uint32_t* rank,
                                      bool* trm) {
    uint32_t f = 0, kv = 0, at = 0, v = 0, an = 0, avt = 0;
    if (ok) {
        f = __ldg(in.found + o);
        kv = __ldg(in.kvalid + o);
        at = __ldg(in.afound_t + o);
        v = __ldg((const uint32_t*)(in.val + o));
        an = __ldg((const uint32_t*)(in.annv + o));
        avt = __ldg((const uint32_t*)(in.aval_t + o));
    }
    const bool ev_hit = f && !(v & 1u) && (int64_t)(v >> 1) == dst;
    const bool af = (at || ev_hit) && kv && dev;
    const uint32_t av = ev_hit ? an : avt;
    *rank = av >> 3;
    *trm = af && ((av & 3u) == 2u || ((av >> 2) & 1u));
    return af ? (int)(av & 3u) : 0;
}

// The reference's per-read state, carried from chunk to chunk; every lane
// holds the same copy.
struct KdScan {
    int lk, lki, prv, nt, ti1, ti2, prev1, p1, prev2, p2, bs, ntr;
};

// One chunk of 32 positions (a: this lane's annotation, 0 past NKW).
__device__ __forceinline__ void kd_scan(KdScan& s, int a, int i0,
                                        int lane) {
    const bool known = a > 0;
    const unsigned km = __ballot_sync(KD_FULL, known);
    // the last known position before this lane: in the chunk, else the
    // carry
    const unsigned mb = km & ((1u << lane) - 1u);
    const int j = mb ? 31 - __clz(mb) : 0;
    const int ja = __shfl_sync(KD_FULL, a, j);
    const int lk = mb ? ja : s.lk;
    const int lki = mb ? i0 + j : s.lki;
    const int up = __shfl_up_sync(KD_FULL, a, 1);
    const int prev = lane ? up : s.prv;           // the annotation at i - 1
    const unsigned tm = __ballot_sync(KD_FULL, known && lk > 0 && a != lk);
    if (tm) {                                     // warp-uniform
        if (s.nt < 2) {
            const int l1 = __ffs(tm) - 1;
            const unsigned t2 = tm & (tm - 1u);
            const int l2 = t2 ? __ffs(t2) - 1 : 0;
            const int pv1 = __shfl_sync(KD_FULL, prev, l1);
            const int pp1 = __shfl_sync(KD_FULL, lki, l1) + 1;
            const int pv2 = __shfl_sync(KD_FULL, prev, l2);
            const int pp2 = __shfl_sync(KD_FULL, lki, l2) + 1;
            if (s.nt == 1) {
                s.ti2 = i0 + l1; s.prev2 = pv1; s.p2 = pp1;
            } else {
                s.ti1 = i0 + l1; s.prev1 = pv1; s.p1 = pp1;
                if (t2) { s.ti2 = i0 + l2; s.prev2 = pv2; s.p2 = pp2; }
            }
        }
        s.nt += __popc(tm);
    }
    if (km) {                                     // warp-uniform
        if (s.lki < 0) s.bs = __shfl_sync(KD_FULL, a, __ffs(km) - 1);
        const int jl = 31 - __clz(km);
        s.lk = __shfl_sync(KD_FULL, a, jl);
        s.lki = i0 + jl;
    }
    s.ntr += __popc(__ballot_sync(KD_FULL, a == 2));
    s.prv = __shfl_sync(KD_FULL, a, 31);
}

// counts[slot] += 1 for each lane with add, once per distinct slot (a
// slot that adds is at most nslots, so its low word identifies it).
__device__ __forceinline__ void kd_count(unsigned int* counts, int64_t slot,
                                         bool add, int lane) {
    const unsigned am = __ballot_sync(KD_FULL, add);
    if (!am) return;
    if (add) {
        const unsigned peers = __match_any_sync(am, (unsigned)slot);
        if (lane == __ffs(peers) - 1)
            atomicAdd(counts + slot, (unsigned int)__popc(peers));
    }
}

// kThreading and kAnnot are template parameters so the counting
// instantiation carries none of the other modes' plane writes.
template <bool kThreading, bool kAnnot>
__global__ void __launch_bounds__(KD_WARPS * 32, KD_MIN_BLOCKS)
assign_count_kernel(int64_t P, int NKW, KdIn in,
                    const int64_t* __restrict__ dst0,
                    const uint8_t* __restrict__ dev_pair,
                    const uint8_t* __restrict__ bf_pair,
                    const int32_t* __restrict__ kf,
                    const int32_t* __restrict__ nk,
                    const int64_t* __restrict__ loff, int64_t nloci,
                    int64_t nslots, int nm_tr, DtkTail tail,
                    unsigned int* __restrict__ counts,
                    unsigned int* __restrict__ nmapread,
                    unsigned int* __restrict__ kmc,
                    int32_t* __restrict__ out,
                    uint8_t* __restrict__ tr_member,
                    int64_t* __restrict__ slot_out,
                    uint8_t* __restrict__ ann_out) {
    __shared__ int s_rm[KD_WARPS], s_seg[KD_WARPS];
    __shared__ unsigned int s_trash[KD_WARPS];
    __shared__ long long s_stat[KD_WARPS / 2][DTK_NSTAT];
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t R = 2 * P;
    const int64_t r = (int64_t)blockIdx.x * KD_WARPS + w;
    const bool active = r < R;                    // warp-uniform
    const int64_t p = r >> 1;
    const int nch = (NKW + 31) >> 5;
    int rm = 1, seglen = 0;
    bool dev = false;
    int64_t dst = 0, dcl = 0, base = 0, row = 0;
    uint32_t pk[KD_RC];           // a position's slot rank << 2 | ann
    if (active) {
        dst = dst0[p];
        dev = dev_pair[p] != 0;
        const bool rm_entry = kf[r] == 1 || (bf_pair != nullptr && bf_pair[p]);
        dcl = dst < 0 ? 0 : dst > nloci ? nloci : dst;
        base = loff[dcl];
        row = r * NKW;
        // ---- 1. annotations of the register chunks, all loads at once
#pragma unroll
        for (int c = 0; c < KD_RC; ++c) {
            const int i = c * 32 + lane;
            uint32_t rank;
            bool trm;
            const int a = kd_ann(in, row + i, i < NKW, dst, dev, &rank, &trm);
            pk[c] = rank << 2 | (uint32_t)a;
            if (i < NKW) {
                if constexpr (kThreading) {
                    tr_member[row + i] = trm;
                    slot_out[row + i] = base + (int64_t)rank;
                }
                if constexpr (kAnnot) ann_out[row + i] = (uint8_t)a;
            }
        }
        // ---- 2. the state machine as a warp scan over the chunks
        KdScan s{0, -1, 0, 0, NKW, NKW, 0, 0, 0, 0, 0, 0};
#pragma unroll
        for (int c = 0; c < KD_RC; ++c)
            if (c < nch) kd_scan(s, (int)(pk[c] & 3u), c * 32, lane);
        for (int c = KD_RC; c < nch; ++c) {
            const int i = c * 32 + lane;
            uint32_t rank;
            bool trm;
            const int a = kd_ann(in, row + i, i < NKW, dst, dev, &rank, &trm);
            if (i < NKW) {
                if constexpr (kThreading) {
                    tr_member[row + i] = trm;
                    slot_out[row + i] = base + (int64_t)rank;
                }
                if constexpr (kAnnot) ann_out[row + i] = (uint8_t)a;
            }
            kd_scan(s, a, c * 32, lane);
        }
        const int nt = s.nt, bs = s.bs, ti1 = s.ti1, ti2 = s.ti2;
        const bool adj1 = nt >= 1 && s.prev1 == 0;
        const int si1 = adj1 ? s.p1 : -1, ei1 = adj1 ? ti1 : -1;
        const bool adj2 = nt >= 2 && s.prev2 == 0;
        const int si2 = adj2 ? s.p2 : -1, ei2 = adj2 ? ti2 : -1;
        const int nt_rec = (bs == 2 && nt >= 2) ? 2
                         : (bs == 1 && nt >= 3) ? 3 : nt;
        const bool af_early = (bs == 2 && nt >= 2) || (bs == 1 && nt >= 3);
        const bool af_nt0 = nt == 0 && bs != 2;
        const bool af_nt2 = nt == 2 && bs == 1 && s.ntr < nm_tr;
        const int af = (!rm_entry && (af_early || af_nt0 || af_nt2) && dev);
        rm = dev ? (int)(rm_entry || af) : 1;
        const bool ok = !af && !rm_entry && dev;
        const int nkr = nk[r];
        const int mid1 = si1 >= 0 ? (si1 + ei1) / 2 : ti1;
        const int mid2 = si2 >= 0 ? (si2 + ei2) / 2 : ti2;
        int si, ei, si_, ei_;
        if (nt == 0) {
            si = 0; ei = nkr; si_ = 0; ei_ = nkr;
        } else if (nt == 1) {
            si = bs == 1 ? mid1 : 0;
            ei = bs == 1 ? nkr : mid1;
            si_ = bs == 1 ? (si1 >= 0 ? ei1 : ti1) : 0;
            ei_ = bs == 1 ? nkr : (si1 >= 0 ? si1 : ti1);
        } else {
            si = mid1; ei = mid2;
            si_ = ei1 >= 0 ? ei1 : ti1;
            ei_ = si2 >= 0 ? si2 : ti2;
        }
        if (!ok) { si = ei = si_ = ei_ = -1; }
        const bool rmd = rm_entry && dev;
        // lane k stores field k
        const int v = lane == 0 ? rm
                    : lane == 1 ? af
                    : lane == 2 ? (rmd ? -1 : nt_rec)
                    : lane == 3 ? (rmd ? -1 : bs)
                    : lane == 4 ? (rmd ? -1 : (nt >= 1 ? ti1 : -1))
                    : lane == 5 ? si
                    : lane == 6 ? ei
                    : lane == 7 ? si_ : ei_;
        if (lane < 9) out[lane * R + r] = v;
        seglen = ei - si > 0 ? ei - si : 0;
    }
    if constexpr (kThreading) return;
    // ---- 3. the counted decision and the count scatter
    if (lane == 0) {
        s_rm[w] = rm;
        s_seg[w] = seglen;
    }
    __syncthreads();
    unsigned int trash = 0;
    if (active) {
        const int mw = w & ~1;                    // mates 2p, 2p + 1
        const int rm0 = s_rm[mw], rm1 = s_rm[mw + 1];
        const bool counted = dev && !(rm0 && rm1);
        if (counted && rm == 0) {
#pragma unroll
            for (int c = 0; c < KD_RC; ++c) {
                const int i = c * 32 + lane;
                const bool tr = (pk[c] & 3u) == 2u;
                const int64_t slot = base + (int64_t)(pk[c] >> 2);
                kd_count(counts, slot, tr && slot >= 0 && slot <= nslots,
                         lane);
                trash += __popc(__ballot_sync(KD_FULL, i < NKW && !tr));
            }
            for (int c = KD_RC; c < nch; ++c) {
                const int i = c * 32 + lane;
                uint32_t rank;
                bool trm;
                const bool tr = kd_ann(in, row + i, i < NKW, dst, dev, &rank,
                                       &trm) == 2;
                const int64_t slot = base + (int64_t)rank;
                kd_count(counts, slot, tr && slot >= 0 && slot <= nslots,
                         lane);
                trash += __popc(__ballot_sync(KD_FULL, i < NKW && !tr));
            }
        } else {
            trash = (unsigned int)NKW;
        }
        if (lane == 0 && (w & 1) == 0) {
            if (counted) {
                atomicAdd(nmapread + dcl, (unsigned int)(2 - rm0 - rm1));
                atomicAdd(kmc + dcl,
                          (unsigned int)(s_seg[mw] + s_seg[mw + 1]));
            }
            // ---- the pair's tail (KM): counted as above, nmate its
            // mates not removed
            if (tail.stats != nullptr)
                dtk_pair_tail(tail, p, dev, counted,
                              counted ? 2 - rm0 - rm1 : 0, kf[r], kf[r + 1],
                              dst, nloci, s_stat[w >> 1]);
        }
    } else if (lane == 0 && (w & 1) == 0) {
        for (int i = 0; i < DTK_NSTAT; ++i) s_stat[w >> 1][i] = 0;
    }
    if (lane == 0) s_trash[w] = trash;
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned int t = 0;
        for (int k = 0; k < KD_WARPS; ++k) t += s_trash[k];
        if (t) atomicAdd(counts + nslots, t);
    } else if (tail.stats != nullptr && threadIdx.x >= 32 &&
               threadIdx.x < 32 + DTK_NSTAT) {
        dtk_tail_flush(s_stat, KD_WARPS / 2, tail.stats, threadIdx.x - 32);
    }
}

// Reads (warps) a block of assign_count_kernel: the launch is
// ceil(2P / this) blocks, one warp a read.
DTK_EXPORT int dtk_assign_count_block_warps() { return KD_WARPS; }

static int kd_launch(int64_t P, int64_t NKW, const void* found,
                     const void* val, const void* annv, const void* kvalid,
                     const void* afound_t, const void* aval_t,
                     const void* dst0, const void* dev_pair,
                     const void* bf_pair, const void* kf, const void* nk,
                     const void* loff, int64_t nloci, int64_t nslots,
                     int64_t nm_tr, int64_t threading, int64_t annot,
                     const DtkTail& tail, void* counts, void* nmapread,
                     void* kmc, void* out, void* tr_member, void* slot,
                     void* ann, void* stream) {
    KdIn in{(const uint8_t*)found, (const int64_t*)val,
            (const int64_t*)annv, (const uint8_t*)kvalid,
            (const uint8_t*)afound_t, (const int64_t*)aval_t};
    if (P <= 0) return (int)cudaGetLastError();
    auto kernel = threading ? (annot ? assign_count_kernel<true, true>
                                     : assign_count_kernel<true, false>)
                            : (annot ? assign_count_kernel<false, true>
                                     : assign_count_kernel<false, false>);
    kernel<<<dtk_grid(2 * P, KD_WARPS), KD_WARPS * 32, 0,
             (cudaStream_t)stream>>>(
        P, (int)NKW, in, (const int64_t*)dst0, (const uint8_t*)dev_pair,
        (const uint8_t*)bf_pair, (const int32_t*)kf, (const int32_t*)nk,
        (const int64_t*)loff, nloci, nslots, (int)nm_tr, tail,
        (unsigned int*)counts, (unsigned int*)nmapread, (unsigned int*)kmc,
        (int32_t*)out, (uint8_t*)tr_member, (int64_t*)slot, (uint8_t*)ann);
    return (int)cudaGetLastError();
}

DTK_EXPORT int dtk_assign_count(int64_t P, int64_t NKW, const void* found,
                                const void* val, const void* annv,
                                const void* kvalid, const void* afound_t,
                                const void* aval_t, const void* dst0,
                                const void* dev_pair, const void* bf_pair,
                                const void* kf, const void* nk,
                                const void* loff,
                                int64_t nloci, int64_t nslots, int64_t nm_tr,
                                int64_t threading, int64_t annot,
                                void* counts, void* nmapread, void* kmc,
                                void* out, void* tr_member, void* slot,
                                void* ann, void* stream) {
    const DtkTail none{};
    return kd_launch(P, NKW, found, val, annv, kvalid, afound_t, aval_t,
                     dst0, dev_pair, bf_pair, kf, nk, loff, nloci, nslots,
                     nm_tr, threading, annot, none, counts, nmapread, kmc,
                     out, tr_member, slot, ann, stream);
}

// dtk_assign_count with the step's tail (counting and okam instances):
// live, nonshort, sub_drop, pair_kf, vote_pass, qc_drop (P,) bool, pack
// (P,) u8, bf (2P,) int32 -> hf (2P,) int32, counted (P,) bool, dest (P,)
// int64; adds the nine counters into stats (9,) int64.
DTK_EXPORT int dtk_assign_count_tail(
    int64_t P, int64_t NKW, const void* found, const void* val,
    const void* annv, const void* kvalid, const void* afound_t,
    const void* aval_t, const void* dst0, const void* dev_pair,
    const void* bf_pair, const void* kf, const void* nk, const void* loff,
    int64_t nloci, int64_t nslots, int64_t nm_tr, int64_t annot,
    const void* live, const void* nonshort, const void* sub_drop,
    const void* pair_kf, const void* vote_pass, const void* pack,
    const void* qc_drop, const void* bf, void* counts, void* nmapread,
    void* kmc, void* out, void* ann, void* hf, void* counted, void* dest,
    void* stats, void* stream) {
    const DtkTail tail{(const uint8_t*)live, (const uint8_t*)nonshort,
                       (const uint8_t*)sub_drop, (const uint8_t*)pair_kf,
                       (const uint8_t*)vote_pass, (const uint8_t*)pack,
                       (const uint8_t*)qc_drop, (const int32_t*)bf,
                       (int32_t*)hf, (uint8_t*)counted, (int64_t*)dest,
                       (unsigned long long*)stats};
    if (stats == nullptr) return (int)cudaErrorInvalidValue;
    if ((uintptr_t)kf & 3) return (int)cudaErrorMisalignedAddress;
    if (const int e = dtk_tail_check(tail)) return e;
    return kd_launch(P, NKW, found, val, annv, kvalid, afound_t, aval_t,
                     dst0, dev_pair, bf_pair, kf, nk, loff, nloci, nslots,
                     nm_tr, 0, annot, tail, counts, nmapread, kmc, out,
                     nullptr, nullptr, ann, stream);
}
