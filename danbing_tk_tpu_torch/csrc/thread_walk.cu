// KE thread_walk: the threading step's graph probe, its DFA walk and its
// TR-member count scatter, in one launch.
//
// Replaces K12, danbing_tk_tpu/engine/device_align.py:1145-1181: the graph
// table probed at every (forward k-mer nc, dst0) position of the (2P, NKW)
// plane (gfound, gmask), then a mate is "clean" when its whole forward
// k-mer stream follows out-edges of its locus graph from position 0 (every
// in-read position a valid k-mer that is a graph node at dst0, no
// homopolymer stall nc[j] == nc[j-1], every transition's edge bit
// (gmask[j] >> (nc[j+1] & 3)) set) with nk > 0 on a device-resolved pair;
// such walks are exactly isThreadFeasible's no-correction path.  Both
// mates clean make the pair device-threaded: each in-read TR-member
// position adds 1 to counts[slot] (u32, out-of-range slots dropped); every
// other position of the plane adds to the trash slot counts[nslots], as
// the JAX scatter's mode="drop" row does, so the state stays byte-equal.
// The TPU probed every position and evaluated the walk as full-plane masks
// and all-reductions.
//
// What a verdict needs is each device-resolved mate's positions up to its
// first failure, so the probe is folded into the walk and reads nothing
// else.  A warp takes a mate (8 warps, 4 pairs, a block); a mate of a pair
// that is not dev_pair (or with nk <= 0) reads dev_pair and nk and is not
// clean.  Otherwise the walk goes in chunks of 32 positions, lane i at
// position 32c + i:
//   1. one coalesced load each of nc and kvalid (the next chunk's are
//      loaded before this chunk's probe, so they are in flight with it);
//      the previous and next positions' nc come by __shfl (the chunk's
//      last lane takes the next chunk's first, the first lane the carry);
//   2. a ballot of the failures that need no probe (an N, a homopolymer
//      stall) gives the first one; the in-read positions before it are
//      probed on the graph table through tile_probe.cuh (compacted, 8
//      lanes a key with a uint4 slot a lane, a key stops at a row with an
//      empty slot); the probe's value is the edge mask.  A k-mer repeated
//      in a chunk is probed again: finding repeats (__match_any_sync) on
//      every chunk cost more than it saved, on the golden panel's tandem
//      repeats too;
//   3. a missing node or edge bit is a failure too; a warp vote ends the
//      walk at the first chunk with a failure.
// The pair's two warps meet in shared memory.  A clean pair adds its TR
// members with KD's slot aggregation (lanes of one slot in a chunk add
// once, __match_any_sync); a member at slot == nslots and every other
// position of the plane go to the trash count, summed per block into one
// atomic.
//
// With dtk_thread_walk_graph_tail the pair meeting also runs the step's
// per-pair tail (KM, step_tail.cuh) with counted = dev_pair & clean_pair
// and nmate from KD's rm (taken before the walk replaces counted): lane 0
// of the even warp writes hf, counted and dest and leaves the pair's nine
// read statistics in shared memory, and nine threads of the block add them
// into stats, one 64-bit atomic a counter.
//
// Bound on the H100: bytes.  9 B (nc, kvalid) per position a walk reads,
// the distinct graph rows its probes read at the levels they need (random
// 128-B rows of a table far past L2), and for a clean pair 1 B of
// tr_member per in-read position, 8 B of slot per TR member and a 32-B
// atomic sector per slot it adds to; plus nk, dev_pair and dst0 in, clean
// and clean_pair out.
#include "step_tail.cuh"
#include "tile_probe.cuh"

constexpr int KE_WARPS = 8;       // mates (4 pairs) a block
constexpr int KE_KEYS = 2;        // keys a probe group takes a pass
constexpr int KE_MIN_BLOCKS = 8;  // 32 registers: a P = 4096 step resident

template <int VW>
__global__ void __launch_bounds__(KE_WARPS * 32, KE_MIN_BLOCKS)
thread_walk_graph_kernel(int64_t P, int NKW,
                         const int64_t* __restrict__ nc,
                         const int64_t* __restrict__ dst0,
                         const uint8_t* __restrict__ kvalid,
                         const int32_t* __restrict__ nk,
                         const uint8_t* __restrict__ dev_pair,
                         const uint8_t* __restrict__ tr_member,
                         const int64_t* __restrict__ slot, int64_t nslots,
                         DtkLevels graph, const int32_t* __restrict__ kf,
                         const int32_t* __restrict__ rm, int64_t nloci,
                         DtkTail tail, unsigned int* __restrict__ counts,
                         uint8_t* __restrict__ clean_out,
                         uint8_t* __restrict__ clean_pair_out) {
    __shared__ DtkTile s_tile[KE_WARPS];
    __shared__ int s_clean[KE_WARPS];
    __shared__ unsigned int s_trash[KE_WARPS];
    __shared__ long long s_stat[KE_WARPS / 2][DTK_NSTAT];
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t r = (int64_t)blockIdx.x * KE_WARPS + w;
    const bool active = r < 2 * P;              // warp-uniform; pairs whole
    const int64_t p = r >> 1, row = r * NKW;
    int n = 0;
    bool clean = false;
    if (active) {
        n = nk[r];
        if (dev_pair[p] != 0 && n > 0) {
            const int nin = n < NKW ? n : NKW;
            const uint32_t loc = (uint32_t)dst0[p];
            bool ok = true;
            int64_t carry = 0;                  // nc at the chunk's start - 1
            bool inr = lane < nin;
            int64_t x = inr ? nc[row + lane] : 0;
            bool kv = inr && kvalid[row + lane] != 0;
            for (int c0 = 0; c0 < nin && ok; c0 += 32) {
                const int j = c0 + lane;
                // the next chunk's loads, in flight with this chunk's probe
                const bool inr_n = j + 32 < nin;
                const int64_t xn = inr_n ? nc[row + j + 32] : 0;
                const bool kv_n = inr_n && kvalid[row + j + 32] != 0;
                int64_t prv = __shfl_up_sync(DTK_FULL, x, 1);
                if (lane == 0) prv = carry;
                int64_t nxt = __shfl_down_sync(DTK_FULL, x, 1);
                const int64_t xn0 = __shfl_sync(DTK_FULL, xn, 0);
                if (lane == 31) nxt = xn0;
                carry = __shfl_sync(DTK_FULL, x, 31);
                const bool cheap = inr && (!kv || (j > 0 && x == prv));
                const unsigned cb = __ballot_sync(DTK_FULL, cheap);
                const int fc = cb ? __ffs(cb) - 1 : 32;
                const bool on = inr && lane < fc;
                uint32_t gm;
                const bool gf = dtk_tile_probe<VW, KE_KEYS, true, false>(
                    graph, on, (uint64_t)x, loc, &s_tile[w], &gm);
                const bool bad =
                    cheap || (on && (!gf || (j + 1 < nin &&
                                             !((gm >> (nxt & 3)) & 1u))));
                ok = !__any_sync(DTK_FULL, bad);
                x = xn;
                kv = kv_n;
                inr = inr_n;
            }
            clean = ok;
        }
        if (lane == 0) {
            s_clean[w] = clean;
            clean_out[r] = clean;
        }
    }
    __syncthreads();
    unsigned int trash = 0;
    if (active) {
        const int mw = w & ~1;
        const bool pair_clean = s_clean[mw] && s_clean[mw + 1];
        if (lane == 0 && w == mw) {
            clean_pair_out[p] = pair_clean;
            if (tail.stats != nullptr) {
                // ---- the pair's tail (KM): KD's nmate, then the walk's
                // counted
                const int r0 = rm[2 * p], r1 = rm[2 * p + 1];
                const bool dp = dev_pair[p] != 0;
                const bool cnt = dp && pair_clean;
                const long long nmate =
                    cnt && !(r0 == 1 && r1 == 1) ? 2 - (long long)r0 - r1
                                                 : 0;
                dtk_pair_tail(tail, p, dp, cnt, nmate, kf[2 * p],
                              kf[2 * p + 1], dst0[p], nloci, s_stat[w >> 1]);
            }
        }
        if (pair_clean) {                       // dev_pair, n > 0
            const int nin = n < NKW ? n : NKW;
            trash = (unsigned int)(NKW - nin);  // past the read
            for (int c0 = 0; c0 < nin; c0 += 32) {
                const int j = c0 + lane;
                const bool mem = j < nin && tr_member[row + j] != 0;
                const int64_t s = mem ? slot[row + j] : 0;
                const bool add = mem && s >= 0 && s < nslots;
                const unsigned am = __ballot_sync(DTK_FULL, add);
                if (add) {
                    const unsigned peers = __match_any_sync(am, (unsigned)s);
                    if (lane == __ffs(peers) - 1)
                        atomicAdd(counts + s, (unsigned int)__popc(peers));
                }
                trash += __popc(
                    __ballot_sync(DTK_FULL, j < nin && (!mem || s == nslots)));
            }
        } else {
            trash = (unsigned int)NKW;
        }
    } else if (lane == 0 && (w & 1) == 0) {
        for (int i = 0; i < DTK_NSTAT; ++i) s_stat[w >> 1][i] = 0;
    }
    if (lane == 0) s_trash[w] = trash;
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned int t = 0;
        for (int k = 0; k < KE_WARPS; ++k) t += s_trash[k];
        if (t) atomicAdd(counts + nslots, t);
    } else if (tail.stats != nullptr && threadIdx.x >= 32 &&
               threadIdx.x < 32 + DTK_NSTAT) {
        dtk_tail_flush(s_stat, KE_WARPS / 2, tail.stats, threadIdx.x - 32);
    }
}

// Mates (warps) a block of thread_walk_graph_kernel: the launch is
// ceil(2P / this) blocks, one warp a mate.
DTK_EXPORT int dtk_thread_walk_block_warps() { return KE_WARPS; }

static int ke_launch(int64_t P, int64_t NKW, const void* nc,
                     const void* dst0, const void* kvalid, const void* nk,
                     const void* dev_pair, const void* tr_member,
                     const void* slot, int64_t nslots, const void* gtabs,
                     const void* gnbs, const void* gsalts, int64_t gnlev,
                     const void* kf, const void* rm, int64_t nloci,
                     const DtkTail& tail, void* counts, void* clean,
                     void* clean_pair, void* stream) {
    DtkLevels graph;
    if (!dtk_levels(&graph, gtabs, gnbs, gsalts, gnlev))
        return (int)cudaErrorInvalidValue;
    if (P <= 0) return (int)cudaGetLastError();
    auto kernel = dtk_vector_width(graph, 4) == 4
                      ? thread_walk_graph_kernel<4>
                      : thread_walk_graph_kernel<0>;
    kernel<<<dtk_grid(2 * P, KE_WARPS), KE_WARPS * 32, 0,
             (cudaStream_t)stream>>>(
        P, (int)NKW, (const int64_t*)nc, (const int64_t*)dst0,
        (const uint8_t*)kvalid, (const int32_t*)nk,
        (const uint8_t*)dev_pair, (const uint8_t*)tr_member,
        (const int64_t*)slot, nslots, graph, (const int32_t*)kf,
        (const int32_t*)rm, nloci, tail, (unsigned int*)counts,
        (uint8_t*)clean, (uint8_t*)clean_pair);
    return (int)cudaGetLastError();
}

DTK_EXPORT int dtk_thread_walk_graph(int64_t P, int64_t NKW, const void* nc,
                                     const void* dst0, const void* kvalid,
                                     const void* nk, const void* dev_pair,
                                     const void* tr_member, const void* slot,
                                     int64_t nslots, const void* gtabs,
                                     const void* gnbs, const void* gsalts,
                                     int64_t gnlev, void* counts, void* clean,
                                     void* clean_pair, void* stream) {
    const DtkTail none{};
    return ke_launch(P, NKW, nc, dst0, kvalid, nk, dev_pair, tr_member, slot,
                     nslots, gtabs, gnbs, gsalts, gnlev, nullptr, nullptr, 0,
                     none, counts, clean, clean_pair, stream);
}

// dtk_thread_walk_graph with the step's tail: kf and rm (KD's) (2P,)
// int32, live, nonshort, sub_drop, pair_kf, vote_pass, qc_drop (P,) bool,
// pack (P,) u8, bf (2P,) int32 -> hf (2P,) int32, counted (P,) bool, dest
// (P,) int64; adds the nine counters into stats (9,) int64.
DTK_EXPORT int dtk_thread_walk_graph_tail(
    int64_t P, int64_t NKW, const void* nc, const void* dst0,
    const void* kvalid, const void* nk, const void* dev_pair,
    const void* tr_member, const void* slot, int64_t nslots,
    const void* gtabs, const void* gnbs, const void* gsalts, int64_t gnlev,
    const void* kf, const void* rm, int64_t nloci, const void* live,
    const void* nonshort, const void* sub_drop, const void* pair_kf,
    const void* vote_pass, const void* pack, const void* qc_drop,
    const void* bf, void* counts, void* clean, void* clean_pair, void* hf,
    void* counted, void* dest, void* stats, void* stream) {
    const DtkTail tail{(const uint8_t*)live, (const uint8_t*)nonshort,
                       (const uint8_t*)sub_drop, (const uint8_t*)pair_kf,
                       (const uint8_t*)vote_pass, (const uint8_t*)pack,
                       (const uint8_t*)qc_drop, (const int32_t*)bf,
                       (int32_t*)hf, (uint8_t*)counted, (int64_t*)dest,
                       (unsigned long long*)stats};
    if (stats == nullptr) return (int)cudaErrorInvalidValue;
    if (((uintptr_t)kf & 3) || ((uintptr_t)rm & 3))
        return (int)cudaErrorMisalignedAddress;
    if (const int e = dtk_tail_check(tail)) return e;
    return ke_launch(P, NKW, nc, dst0, kvalid, nk, dev_pair, tr_member, slot,
                     nslots, gtabs, gnbs, gsalts, gnlev, kf, rm, nloci, tail,
                     counts, clean, clean_pair, stream);
}
