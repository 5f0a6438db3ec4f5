// KG novel_edges: the bubble (novel-edge) plane of the counting step.
//
// Replaces K11, danbing_tk_tpu/engine/device_align.py:1238-1250: a probe of
// the composite tre table at every ((k+1)-mer edge, dst0) position of the
// (2P, NE) plane, the novel mask ~found & evalid & si_ <= pos < ei_ - 1 &
// rm == 0 & counted, and np.packbits of it into (2P, ceil(NE / 8)) bytes
// for the host.  The TPU probed every position.
//
// A warp takes a read (8 warps, 4 pairs, a block) and its positions in
// tiles of 32.  The read's 13 B of fields (counted, rm, si_, ei_, dst0)
// give its segment [si_, ei_ - 1), empty for a mate that is not counted
// or removed; a tile outside it writes its zero bytes without a load.
// Inside, a lane reads its position's 1-B evalid, and only an active
// position (in the segment, evalid set) loads its 8-B edge.  The active
// edges are probed through tile_probe.cuh: compacted, a repeated edge once
// (the locus is the read's; without it the golden -bu step's tandem
// repeats ran 1.34x slower), 8 lanes a key with a uint4 slot a lane, KG_KEYS
// keys a group a pass, and a key that misses a row with an empty slot
// stops there (only a miss on a full row reads the next level).  A ballot
// gathers the tile's 32 novel bits and lanes 0-3 write its four bytes in
// np.packbits' big-endian bit order (position 8j + t is bit 7 - t of byte
// j), zeros past NE.
//
// Bound on the H100: bytes.  8 B of edge and 1 B of evalid per probed
// position, the distinct tre rows those probes read at the levels they
// need, 13 B of per-read fields and the packed output.  The rows are
// random 128-B reads of a table far past L2; their number is what the
// level stop and the per-tile dedup cut.
#include "tile_probe.cuh"

constexpr int KG_WARPS = 8;       // reads (4 pairs) a block
constexpr int KG_KEYS = 2;        // keys a probe group takes a pass
constexpr int KG_MIN_BLOCKS = 8;  // 32 registers: a P = 4096 step resident

template <int VW>
__global__ void __launch_bounds__(KG_WARPS * 32, KG_MIN_BLOCKS)
novel_edges_kernel(int64_t R, int NE, int NB,
                   const int64_t* __restrict__ edge,
                   const uint8_t* __restrict__ evalid,
                   const int32_t* __restrict__ si_,
                   const int32_t* __restrict__ ei_,
                   const int32_t* __restrict__ rm,
                   const uint8_t* __restrict__ counted,
                   const int64_t* __restrict__ dst0, DtkLevels tre,
                   uint8_t* __restrict__ out) {
    __shared__ DtkTile s_tile[KG_WARPS];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int64_t r = (int64_t)blockIdx.x * KG_WARPS + w;
    if (r >= R) return;                         // warp-uniform
    const int64_t p = r >> 1;
    const bool act = counted[p] != 0 && rm[r] == 0;
    // the segment [lo, hi), clipped to the plane
    const int64_t lo64 = act ? max((int64_t)si_[r], (int64_t)0) : 0;
    const int64_t hi64 =
        act ? min((int64_t)ei_[r] - 1, (int64_t)NE) : 0;
    const int lo = (int)lo64, hi = hi64 > lo64 ? (int)hi64 : lo;
    const uint32_t loc = act ? (uint32_t)dst0[p] : 0u;
    const int64_t row = r * NE;
    uint8_t* o = out + r * NB;
    for (int base = 0; base < NE; base += 32) {
        unsigned m = 0;
        if (base + 32 > lo && base < hi) {      // warp-uniform
            const int pos = base + lane;
            const bool on = pos >= lo && pos < hi && evalid[row + pos] != 0;
            const uint64_t e = on ? (uint64_t)edge[row + pos] : 0ull;
            uint32_t v;
            const bool found = dtk_tile_probe<VW, KG_KEYS, false, true>(
                tre, on, e, loc, &s_tile[w], &v);
            m = __ballot_sync(DTK_FULL, on && !found);
        }
        const int byte = (base >> 3) + lane;
        if (lane < 4 && byte < NB)
            o[byte] = (uint8_t)((__brev(m) >> (24 - 8 * lane)) & 0xFFu);
    }
}

DTK_EXPORT int dtk_novel_edges(int64_t P, int64_t NE, const void* edge,
                               const void* evalid, const void* si_,
                               const void* ei_, const void* rm,
                               const void* counted, const void* dst0,
                               const void* ttabs, const void* tnbs,
                               const void* tsalts, int64_t tnlev, void* out,
                               void* stream) {
    DtkLevels tre;
    if (!dtk_levels(&tre, ttabs, tnbs, tsalts, tnlev))
        return (int)cudaErrorInvalidValue;
    const int64_t R = 2 * P;
    const int NB = (int)((NE + 7) / 8);
    if (R <= 0 || NB <= 0) return (int)cudaGetLastError();
    auto kernel = dtk_vector_width(tre, 4) == 4 ? novel_edges_kernel<4>
                                                : novel_edges_kernel<0>;
    kernel<<<dtk_grid(R, KG_WARPS), KG_WARPS * 32, 0, (cudaStream_t)stream>>>(
        R, (int)NE, NB, (const int64_t*)edge, (const uint8_t*)evalid,
        (const int32_t*)si_, (const int32_t*)ei_, (const int32_t*)rm,
        (const uint8_t*)counted, (const int64_t*)dst0, tre, (uint8_t*)out);
    return (int)cudaGetLastError();
}
