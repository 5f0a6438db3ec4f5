// KB bucket_lookup: probe a bucketized multi-level hash table.
//
// Replaces K2, danbing_tk_tpu/index/device_table.py:336 bucket_index_jax +
// :356 lookup_bucket_jax (one row gather per level on the TPU, where the
// gather unit's per-row cost bound every probe stage).  One thread per
// query: it hashes with the same salted mix32 in uint32_t, then walks the
// levels in order, reading its 8-slot row (8 * W u32, 128 B at W = 4) and
// comparing (lo, hi[, locus]); the first level that hits wins, so the
// thread stops there.
//
// Bound on the H100: bytes.  Each query moves one row (four 32 B sectors
// at W = 4) from HBM for level 0, plus one more row only for misses and
// second-level keys; the rows land in random places, so nothing coalesces
// across threads.  The design reads the row through the read-only cache
// (one sector per slot pair) and writes three coalesced outputs.  The
// single per-query probe body lives in bucket.cuh, shared with KF and KG.
#include "bucket.cuh"

__global__ void bucket_lookup_kernel(const int64_t* __restrict__ q,
                                     const int64_t* __restrict__ qloc,
                                     int64_t n, DtkLevels lv, int W,
                                     int composite, int nval,
                                     uint8_t* __restrict__ found,
                                     int64_t* __restrict__ val,
                                     int64_t* __restrict__ val2) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t loc = composite ? (uint32_t)qloc[i] : 0u;
    uint32_t v, v2;
    bool f = dtk_probe(lv, W, composite, nval, (uint64_t)q[i], loc, &v, &v2);
    found[i] = f;
    val[i] = v;
    val2[i] = v2;
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
    const int threads = 256;
    if (n > 0)
        bucket_lookup_kernel<<<dtk_grid(n, threads), threads, 0,
                               (cudaStream_t)stream>>>(
            (const int64_t*)q, (const int64_t*)qloc, n, lv, W,
            (int)composite, (int)nval, (uint8_t*)found, (int64_t*)val,
            (int64_t*)val2);
    return (int)cudaGetLastError();
}
