// KG novel_edges: the bubble (novel-edge) plane of the counting step.
//
// Replaces K11, danbing_tk_tpu/engine/device_align.py:1238-1250: a probe of
// the composite tre table at every ((k+1)-mer edge, dst0) position of the
// (2P, NE) plane, the novel mask ~found & evalid & si_ <= pos < ei_ - 1 &
// rm == 0 & counted, and np.packbits of it into (2P, ceil(NE / 8)) bytes
// for the host.  The TPU probed every position.
//
// One warp per read, 32 edge positions per pass: a lane probes tre only
// where the position can be novel (a counted, unremoved mate, inside its
// segment, a valid edge), through the shared bucket.cuh probe; every other
// position is false without a load.  __ballot_sync gathers the pass's 32
// bits and lanes 0-3 write its four bytes in np.packbits' big-endian bit
// order (position 8j + t is bit 7 - t of byte j), zeros past NE.
//
// Bound on the H100: bytes.  8 B of edge (and 1 B of evalid) per probed
// position, the distinct tre rows those probes read, 13 B of per-read
// fields and the packed output.  The design touches nothing else: a mate
// that is not counted reads its 13 B and writes its zero bytes.
#include "bucket.cuh"

constexpr int KG_THREADS = 256;
constexpr unsigned KG_FULL = 0xFFFFFFFFu;

__global__ void novel_edges_kernel(int64_t R, int NE, int NB,
                                   const int64_t* __restrict__ edge,
                                   const uint8_t* __restrict__ evalid,
                                   const int32_t* __restrict__ si_,
                                   const int32_t* __restrict__ ei_,
                                   const int32_t* __restrict__ rm,
                                   const uint8_t* __restrict__ counted,
                                   const int64_t* __restrict__ dst0,
                                   DtkLevels tre, uint8_t* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int64_t r =
        (int64_t)blockIdx.x * (KG_THREADS / 32) + (threadIdx.x >> 5);
    if (r >= R) return;                         // warp-uniform
    const int64_t p = r >> 1;
    const bool act = counted[p] != 0 && rm[r] == 0;
    const int lo = act ? si_[r] : 0, hi = act ? ei_[r] - 1 : 0;
    const uint32_t loc = (uint32_t)dst0[p];
    uint8_t* o = out + r * NB;
    for (int base = 0; base < NE; base += 32) {
        const int pos = base + lane;
        bool nov = false;
        if (pos < NE && pos >= lo && pos < hi) {
            const int64_t e = r * NE + pos;
            uint32_t v, v2;
            nov = evalid[e] &&
                  !dtk_probe(tre, 4, 1, 1, (uint64_t)edge[e], loc, &v, &v2);
        }
        const unsigned m = __ballot_sync(KG_FULL, nov);
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
    if (R > 0 && NB > 0)
        novel_edges_kernel<<<dtk_grid(R, KG_THREADS / 32), KG_THREADS, 0,
                             (cudaStream_t)stream>>>(
            R, (int)NE, NB, (const int64_t*)edge, (const uint8_t*)evalid,
            (const int32_t*)si_, (const int32_t*)ei_, (const int32_t*)rm,
            (const uint8_t*)counted, (const int64_t*)dst0, tre,
            (uint8_t*)out);
    return (int)cudaGetLastError();
}
