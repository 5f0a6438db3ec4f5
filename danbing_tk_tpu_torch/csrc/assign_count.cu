// KD assign_count: TR/flank annotation, the assignTRkmc scan and the count
// scatter of the counting step.
//
// Replaces K6-K8, danbing_tk_tpu/engine/device_align.py:1031-1057 (the
// annotation combine), :1063-1131 (assignTRkmc as associative scans over
// (2P, NKW) planes) and :1135-1191 (scatter-adds into counts / nmapread /
// kmc).  The TPU needed log-depth scans because it has no cheap sequential
// lanes; here the reference's own sequential scan is the cheapest form.
//
// One thread per read:
//   1. per k-mer position: ev_hit (a single-locus dbi value at dst0) or
//      the trfl probe result (KB at (kmer, dst0)), ann = aval & 3 and
//      slot = loff[dst0] + (aval >> 3);
//   2. one pass that tracks the last known annotation, the first two
//      transitions, the first known value and the TR count, then the
//      af / rm / nt / bs / ti / si / ei / si_ / ei_ fields;
//   3. the two mates meet in shared memory to decide whether the pair is
//      counted; a second pass adds 1 to counts[slot] for each TR k-mer of
//      a counted mate with unsigned atomics (u32 wrap, as the JAX scatter);
//      every other position adds to the trash slot counts[nslots], summed
//      per thread into one atomic.  The even thread adds nmate and the
//      segment length into nmapread / kmc at dst0.
//
// A bait-filtered pair (KF's bf_pair, null without bait) enters as
// rm_entry = (kf == 1) | bf_pair (device_align.py:1088): both mates are
// removed, so the pair is not counted.  With kAnnot (okam steps) the first
// pass also writes the ann plane ((2P, NKW) u8, :1236-1237) for .kam rows.
//
// Threading mode (the graph-threading step, device_align.py:1143-1191)
// stops after step 2: it writes the tr_member plane (u8, ((ann == 2) |
// in_tr) & kvalid with in_tr = afound & ((aval >> 2) & 1)) and the slot
// plane, and leaves counts / nmapread / kmc to KE (csrc/thread_walk.cu),
// which counts only the pairs whose walk is clean.
//
// Bound on the H100: bytes.  Each position reads ~35 B of planes twice
// (found, val, annv, kvalid, afound, aval); the count atomics scatter into
// a table of up to 0.5 GB and cost one 32 B sector each.  Neighbouring
// threads are neighbouring reads, so a thread's plane reads are strided
// by NKW; a later PR can stage a warp's rows through shared memory.
#include "common.cuh"

constexpr int KD_THREADS = 128;

struct KdIn {
    const uint8_t* found;
    const int64_t* val;
    const int64_t* annv;
    const uint8_t* kvalid;
    const uint8_t* afound_t;
    const int64_t* aval_t;
};

// Annotation of one position: returns ann, writes the slot rank and
// whether the k-mer is in the locus's TR set (the in_tr bit).
__device__ __forceinline__ int kd_ann(const KdIn& in, int64_t o,
                                      uint32_t dst, bool dev,
                                      uint32_t* rank, bool* in_tr) {
    uint32_t v = (uint32_t)in.val[o];
    bool ev_hit = in.found[o] && !(v & 1u) && (v >> 1) == dst;
    bool af = (in.afound_t[o] || ev_hit) && in.kvalid[o] && dev;
    uint32_t av = ev_hit ? (uint32_t)in.annv[o] : (uint32_t)in.aval_t[o];
    *rank = av >> 3;
    *in_tr = af && ((av >> 2) & 1u);
    return af ? (int)(av & 3u) : 0;
}

// kThreading and kAnnot are template parameters so the counting
// instantiation carries none of the other modes' plane writes.
template <bool kThreading, bool kAnnot>
__global__ void assign_count_kernel(int64_t P, int NKW, KdIn in,
                                    const int64_t* __restrict__ dst0,
                                    const uint8_t* __restrict__ dev_pair,
                                    const uint8_t* __restrict__ bf_pair,
                                    const int32_t* __restrict__ kf,
                                    const int32_t* __restrict__ nk,
                                    const int64_t* __restrict__ loff,
                                    int64_t nloci, int64_t nslots,
                                    int nm_tr,
                                    unsigned int* __restrict__ counts,
                                    unsigned int* __restrict__ nmapread,
                                    unsigned int* __restrict__ kmc,
                                    int32_t* __restrict__ out,
                                    uint8_t* __restrict__ tr_member,
                                    int64_t* __restrict__ slot_out,
                                    uint8_t* __restrict__ ann_out) {
    __shared__ int s_rm[KD_THREADS];
    __shared__ int s_seg[KD_THREADS];
    const int64_t R = 2 * P;
    const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const bool active = r < R;
    const int64_t p = r >> 1;
    uint32_t dst = 0;
    bool dev = false, rm_entry = false;
    int64_t base = 0;
    int rm = 1, seglen = 0;
    if (active) {
        dst = (uint32_t)dst0[p];
        dev = dev_pair[p] != 0;
        rm_entry = kf[r] == 1 || (bf_pair != nullptr && bf_pair[p]);
        base = loff[dst < (uint64_t)nloci ? dst : (uint32_t)nloci];
        const int64_t row = r * NKW;
        int lk = 0, lki = -1, prev = 0;
        int nt = 0, ti1 = NKW, ti2 = NKW, bs = 0, ntr = 0;
        bool have_fk = false;
        int prev1 = 0, p1 = 0, prev2 = 0, p2 = 0;
        for (int i = 0; i < NKW; ++i) {
            uint32_t rank;
            bool in_tr;
            int a = kd_ann(in, row + i, dst, dev, &rank, &in_tr);
            if constexpr (kThreading) {
                tr_member[row + i] = (a == 2 || in_tr) && in.kvalid[row + i];
                slot_out[row + i] = base + (int64_t)rank;
            }
            if constexpr (kAnnot) ann_out[row + i] = (uint8_t)a;
            bool known = a > 0;
            if (known && lk > 0 && a != lk) {
                ++nt;
                if (nt == 1) { ti1 = i; prev1 = prev; p1 = lki + 1; }
                if (nt == 2) { ti2 = i; prev2 = prev; p2 = lki + 1; }
            }
            if (known && !have_fk) { have_fk = true; bs = a; }
            if (a == 2) ++ntr;
            if (known) { lk = a; lki = i; }
            prev = a;
        }
        const bool adj1 = nt >= 1 && prev1 == 0;
        const int si1 = adj1 ? p1 : -1, ei1 = adj1 ? ti1 : -1;
        const bool adj2 = nt >= 2 && prev2 == 0;
        const int si2 = adj2 ? p2 : -1, ei2 = adj2 ? ti2 : -1;
        const int nt_rec = (bs == 2 && nt >= 2) ? 2
                         : (bs == 1 && nt >= 3) ? 3 : nt;
        const bool af_early = (bs == 2 && nt >= 2) || (bs == 1 && nt >= 3);
        const bool af_nt0 = nt == 0 && bs != 2;
        const bool af_nt2 = nt == 2 && bs == 1 && ntr < nm_tr;
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
        out[0 * R + r] = rm;
        out[1 * R + r] = af;
        out[2 * R + r] = rmd ? -1 : nt_rec;
        out[3 * R + r] = rmd ? -1 : bs;
        out[4 * R + r] = rmd ? -1 : (nt >= 1 ? ti1 : -1);
        out[5 * R + r] = si;
        out[6 * R + r] = ei;
        out[7 * R + r] = si_;
        out[8 * R + r] = ei_;
        seglen = ei - si > 0 ? ei - si : 0;
    }
    if constexpr (kThreading) return;
    s_rm[threadIdx.x] = rm;
    s_seg[threadIdx.x] = seglen;
    __syncthreads();
    if (!active) return;
    // mates 2p and 2p+1 sit in neighbouring threads of one block
    const int mate0 = threadIdx.x & ~1;
    const int rm0 = s_rm[mate0], rm1 = s_rm[mate0 + 1];
    const bool counted = dev && !(rm0 && rm1);
    unsigned int trash = 0;
    if (counted && rm == 0) {
        const int64_t row = r * NKW;
        for (int i = 0; i < NKW; ++i) {
            uint32_t rank;
            bool in_tr;
            int a = kd_ann(in, row + i, dst, dev, &rank, &in_tr);
            int64_t slot = base + (int64_t)rank;
            if (a == 2) {
                if (slot >= 0 && slot <= nslots) atomicAdd(counts + slot, 1u);
            } else {
                ++trash;
            }
        }
    } else {
        trash = (unsigned int)NKW;
    }
    if (trash) atomicAdd(counts + nslots, trash);
    if ((threadIdx.x & 1) == 0 && counted) {
        atomicAdd(nmapread + dst, (unsigned int)(2 - rm0 - rm1));
        atomicAdd(kmc + dst,
                  (unsigned int)(s_seg[mate0] + s_seg[mate0 + 1]));
    }
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
    KdIn in{(const uint8_t*)found, (const int64_t*)val,
            (const int64_t*)annv, (const uint8_t*)kvalid,
            (const uint8_t*)afound_t, (const int64_t*)aval_t};
    if (P <= 0) return (int)cudaGetLastError();
    auto kernel = threading ? (annot ? assign_count_kernel<true, true>
                                     : assign_count_kernel<true, false>)
                            : (annot ? assign_count_kernel<false, true>
                                     : assign_count_kernel<false, false>);
    kernel<<<dtk_grid(2 * P, KD_THREADS), KD_THREADS, 0,
             (cudaStream_t)stream>>>(
        P, (int)NKW, in, (const int64_t*)dst0, (const uint8_t*)dev_pair,
        (const uint8_t*)bf_pair, (const int32_t*)kf, (const int32_t*)nk,
        (const int64_t*)loff, nloci, nslots, (int)nm_tr,
        (unsigned int*)counts, (unsigned int*)nmapread, (unsigned int*)kmc,
        (int32_t*)out, (uint8_t*)tr_member, (int64_t*)slot, (uint8_t*)ann);
    return (int)cudaGetLastError();
}
