// KB bucket_lookup: probe a bucketized multi-level hash table.
//
// Replaces K2, danbing_tk_tpu/index/device_table.py:336 bucket_index_jax +
// :356 lookup_bucket_jax (one row gather per level on the TPU, where the
// gather unit's per-row cost bound every probe stage).
//
// Bound on the H100: bytes.  Each query moves one 8-slot row (8 * W u32:
// 128 B at W = 4, 64 B for the member table's W = 2) from HBM for level 0,
// plus one more row only for misses and second-level keys; the rows land
// in random places, so nothing coalesces across queries, and what the card
// gives for random rows is set by how many are in flight.  The first
// design had one thread per query compare its 8 slots with up to 32
// dependent scalar loads, so a few sectors were in flight per thread and
// the probe ran at a third of the bytes' time.
//
// Here the probe is group_probe.cuh's: 8 lanes a query, one coalesced row
// load, a tile of 32 queries a warp with its repeated queries probed once
// (KI launches the same probe for a row block that holds every row).  The
// hash is bucket.cuh's dtk_bucket, shared with KF, KG, KI and KJ, whose
// own per-thread probe (dtk_probe) is unchanged.
#include "group_probe.cuh"

template <int VW>
__global__ void __launch_bounds__(DTK_PROBE_THREADS)
bucket_lookup_kernel(const int64_t* __restrict__ q,
                     const int64_t* __restrict__ qloc, int64_t n,
                     DtkLevels lv, int W, int composite, int nval,
                     uint8_t* __restrict__ found, int64_t* __restrict__ val,
                     int64_t* __restrict__ val2) {
    __shared__ uint8_t ulane[DTK_PROBE_THREADS / 32][32];
    const int64_t base =
        (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * 32;
    if (base >= n) return;                       // whole warps
    dtk_group_probe<VW>(q, qloc, n, base, lv, W, composite, nval, found, val,
                        val2, ulane[threadIdx.x >> 5]);
}

DTK_EXPORT int dtk_bucket_lookup(const void* q, const void* qloc, int64_t n,
                                 const void* tabs, const void* nbs,
                                 const void* salts, int64_t nlev,
                                 int64_t composite, int64_t nval,
                                 void* found, void* val, void* val2,
                                 void* stream) {
    DtkLevels lv;
    if (!dtk_levels(&lv, tabs, nbs, salts, nlev))
        return (int)cudaErrorInvalidValue;
    const int W = 2 + (int)composite + (int)nval;
    // the vector loads need every level's rows aligned to a slot
    const int VW = dtk_vector_width(lv, W);
    const unsigned blocks =
        (unsigned)((n + DTK_PROBE_THREADS - 1) / DTK_PROBE_THREADS);
    const cudaStream_t st = (cudaStream_t)stream;
    if (n > 0) {
#define DTK_KB_LAUNCH(V)                                                  \
    bucket_lookup_kernel<V><<<blocks, DTK_PROBE_THREADS, 0, st>>>(        \
        (const int64_t*)q, (const int64_t*)qloc, n, lv, W, (int)composite, \
        (int)nval, (uint8_t*)found, (int64_t*)val, (int64_t*)val2)
        if (VW == 4) DTK_KB_LAUNCH(4);
        else if (VW == 2) DTK_KB_LAUNCH(2);
        else DTK_KB_LAUNCH(0);
#undef DTK_KB_LAUNCH
    }
    return (int)cudaGetLastError();
}
