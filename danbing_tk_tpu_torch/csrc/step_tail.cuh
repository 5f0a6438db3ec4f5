// KM, the counting step's per-pair tail and its read statistics, run at
// the pair meeting of KD (assign_count.cu, counting and okam steps) and of
// KE (thread_walk.cu, threading steps), where a pair's counted decision is
// made.
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
//   counted ? nmate : 0 (nmate taken from KD's rm first); dest = counted ?
//   dst0 : nloci;
//   stats += [2 (live & !referee), live & !nonshort, 2 sub_drop,
//             (pair_sub & !referee) ? kf0 + kf1 : 0, hf0 + hf1,
//             2 dev_pair, nmate, qc_drop ? 2 - kf0 - kf1 : 0,
//             (bf0 != 0 & kf0 == 0) + (bf1 != 0 & kf1 == 0)].
//
// Bound on the H100: bytes.  A pair reads 8 B of u8 planes (9 with
// clean_pair), 24 B of kf, bf and rm and 8 B of dst0, and writes 8 B of
// hf, 1 of counted and 8 of dest: 57 B, and the counters' 72 B are read
// and written once (233,616 B at P = 4096: 0.07 us).  As a kernel of its
// own its launch was all it cost; here the thread that makes a pair's
// decision (lane 0 of the pair's even warp) runs its tail, the block's
// pairs leave their counters in shared memory, and nine threads of the
// block make one 64-bit atomic a counter into stats.
// Integer sums do not depend on their order, so the counters are exact.
#pragma once

#include "common.cuh"

constexpr int DTK_NSTAT = 9;             // the read statistics

// The tail's planes beyond what KD and KE read for their own work; a null
// stats pointer runs no tail.
struct DtkTail {
    const uint8_t* live;
    const uint8_t* nonshort;
    const uint8_t* sub_drop;
    const uint8_t* pair_kf;
    const uint8_t* vote_pass;
    const uint8_t* pack;
    const uint8_t* qc_drop;
    const int32_t* bf;
    int32_t* hf;
    uint8_t* counted;
    int64_t* dest;
    unsigned long long* stats;
};

// Pair p's tail: writes hf (both reads), counted and dest, and its nine
// counters into part.  dp is dev_pair, cnt the pair's counted decision and
// nmate its mates counted, k0 and k1 the mates' kf.
__device__ __forceinline__ void dtk_pair_tail(const DtkTail& t, int64_t p,
                                              bool dp, bool cnt,
                                              long long nmate, int k0,
                                              int k1, int64_t dst0,
                                              int64_t nloci,
                                              long long* part) {
    const bool lv = t.live[p] != 0, ns = t.nonshort[p] != 0,
               sd = t.sub_drop[p] != 0, pk = t.pair_kf[p] != 0,
               vp = t.vote_pass[p] != 0, ref = (t.pack[p] & 1) != 0,
               qd = t.qc_drop[p] != 0;
    const int b0 = t.bf[2 * p], b1 = t.bf[2 * p + 1];
    const bool h = pk && !vp && !ref;
    const int h0 = h && k0 == 0, h1 = h && k1 == 0;
    t.hf[2 * p] = h0;
    t.hf[2 * p + 1] = h1;
    t.counted[p] = cnt;
    t.dest[p] = cnt ? dst0 : nloci;
    part[0] = 2 * (lv && !ref);
    part[1] = lv && !ns;
    part[2] = 2 * sd;
    part[3] = ns && !sd && !ref ? (long long)k0 + k1 : 0;
    part[4] = h0 + h1;
    part[5] = 2 * dp;
    part[6] = nmate;
    part[7] = qd ? 2 - (long long)k0 - k1 : 0;
    part[8] = (b0 != 0 && k0 == 0) + (b1 != 0 && k1 == 0);
}

// Counter i of a block's n pair rows into stats: one 64-bit atomic, none
// when the sum is 0.
__device__ __forceinline__ void dtk_tail_flush(
    const long long (*part)[DTK_NSTAT], int n, unsigned long long* stats,
    int i) {
    long long s = 0;
    for (int k = 0; k < n; ++k) s += part[k][i];
    if (s != 0) atomicAdd(stats + i, (unsigned long long)s);
}

// The tail's checks of the wrapper's pointers (0 when they hold).
inline int dtk_tail_check(const DtkTail& t) {
    if (((uintptr_t)t.bf & 3) || ((uintptr_t)t.hf & 3) ||
        ((uintptr_t)t.dest & 7) || ((uintptr_t)t.stats & 7))
        return (int)cudaErrorMisalignedAddress;
    return 0;
}
