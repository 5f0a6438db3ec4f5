// KE thread_walk: the threading DFA walk of the graph-threading step and
// its TR-member count scatter.
//
// Replaces K12, danbing_tk_tpu/engine/device_align.py:1145-1181: a mate is
// "clean" when its whole forward (non-canonical) k-mer stream follows
// out-edges of its locus graph from position 0 (every in-read position a
// valid k-mer that is a graph node at dst0, no homopolymer stall
// nc[j] == nc[j-1], every transition's edge bit (gmask[j] >> (nc[j+1] & 3))
// set) with nk > 0 on a device-resolved pair; such walks are exactly
// isThreadFeasible's no-correction path.  Both mates clean make the pair
// device-threaded: each in-read TR-member position adds 1 to counts[slot]
// (u32 atomics, out-of-range slots dropped); every other position of the
// (2P, NKW) plane adds to the trash slot counts[nslots], as the JAX
// scatter's mode="drop" row does, so the state stays byte-equal.  The
// graph probe itself is KB on the graph table at (nc, dst0).  The TPU
// evaluated the walk as full-plane masks and all-reductions; here one warp
// walks one mate and a warp vote ends it.
//
// One block of 64 threads per pair: warp w walks mate 2p + w with lanes
// striding the positions, votes with __any_sync, the two warps meet in
// shared memory, then scatter.  The trash count is summed per block into
// one atomic.
//
// Bound on the H100: bytes.  Each position reads nc (8 B), gfound (1 B),
// gmask (8 B), kvalid (1 B), tr_member (1 B) and slot (8 B) once; a
// counted k-mer costs one 32 B atomic sector in a table of up to 0.5 GB.
// Lanes read neighbouring positions, so the plane reads coalesce.
#include "common.cuh"

constexpr int KE_THREADS = 64;

__global__ void thread_walk_kernel(int64_t P, int NKW,
                                   const int64_t* __restrict__ nc,
                                   const uint8_t* __restrict__ gfound,
                                   const int64_t* __restrict__ gmask,
                                   const uint8_t* __restrict__ kvalid,
                                   const int32_t* __restrict__ nk,
                                   const uint8_t* __restrict__ dev_pair,
                                   const uint8_t* __restrict__ tr_member,
                                   const int64_t* __restrict__ slot,
                                   int64_t nslots,
                                   unsigned int* __restrict__ counts,
                                   uint8_t* __restrict__ clean_out,
                                   uint8_t* __restrict__ clean_pair_out) {
    __shared__ int s_clean[2];
    __shared__ unsigned int s_trash[2];
    const int64_t p = blockIdx.x;
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t r = 2 * p + w;
    const int64_t row = r * NKW;
    const int n = nk[r];
    const int nin = n < NKW ? n : NKW;   // in-read positions
    const bool dev = dev_pair[p] != 0;

    bool bad = false;
    for (int j = lane; j < nin; j += 32) {
        const int64_t o = row + j;
        if (!kvalid[o] || !gfound[o]) bad = true;
        if (j > 0 && nc[o] == nc[o - 1]) bad = true;
        if (j + 1 < nin) {
            const uint32_t nb = (uint32_t)(nc[o + 1] & 3);
            if (!(((uint64_t)gmask[o] >> nb) & 1u)) bad = true;
        }
    }
    const bool clean = !__any_sync(0xffffffffu, bad) && n > 0 && dev;
    if (lane == 0) {
        s_clean[w] = clean;
        clean_out[r] = clean;
    }
    __syncthreads();
    const bool pair_clean = s_clean[0] && s_clean[1];
    if (threadIdx.x == 0) clean_pair_out[p] = pair_clean;
    const bool thr_dev = dev && pair_clean;

    unsigned int trash = 0;
    if (thr_dev) {
        for (int j = lane; j < NKW; j += 32) {
            const int64_t o = row + j;
            if (j < n && tr_member[o]) {
                const int64_t s = slot[o];
                if (s >= 0 && s <= nslots) atomicAdd(counts + s, 1u);
            } else {
                ++trash;
            }
        }
    } else if (lane == 0) {
        trash = (unsigned int)NKW;
    }
    for (int off = 16; off; off >>= 1)
        trash += __shfl_down_sync(0xffffffffu, trash, off);
    if (lane == 0) s_trash[w] = trash;
    __syncthreads();
    if (threadIdx.x == 0) {
        const unsigned int t = s_trash[0] + s_trash[1];
        if (t) atomicAdd(counts + nslots, t);
    }
}

DTK_EXPORT int dtk_thread_walk(int64_t P, int64_t NKW, const void* nc,
                               const void* gfound, const void* gmask,
                               const void* kvalid, const void* nk,
                               const void* dev_pair, const void* tr_member,
                               const void* slot, int64_t nslots,
                               void* counts, void* clean, void* clean_pair,
                               void* stream) {
    if (P > 0)
        thread_walk_kernel<<<(unsigned int)P, KE_THREADS, 0,
                             (cudaStream_t)stream>>>(
            P, (int)NKW, (const int64_t*)nc, (const uint8_t*)gfound,
            (const int64_t*)gmask, (const uint8_t*)kvalid,
            (const int32_t*)nk, (const uint8_t*)dev_pair,
            (const uint8_t*)tr_member, (const int64_t*)slot, nslots,
            (unsigned int*)counts, (uint8_t*)clean, (uint8_t*)clean_pair);
    return (int)cudaGetLastError();
}
