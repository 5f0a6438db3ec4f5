// KI sharded_lookup: probe the rows of a bucket table that one rank owns.
//
// Replaces K14's probe, danbing_tk_tpu/parallel/sharded_index.py:53
// lookup_bucket_sharded (inside shard_map: all_gather the queries, probe
// the chip's 1/D row block of every level with a bucket-range mask, then
// psum_scatter the int32 found/val/val2 planes).  The collectives stay in
// torch.distributed (parallel/sharded_index.py); this kernel is the
// middle step.  One thread per gathered query: per level it hashes with
// the FULL level's bucket count (the block's own row count would send
// every probe to the wrong row), skips the level unless the bucket lies in
// [off, off + rows), and compares the 8 slots of the local row
// b - off.  The probe stops at the first owned hit in level order, which
// sets val/val2 (JAX probes every level, as shard_map runs them data-
// parallel, and keeps the first hit's values: the same answer).
// found/val/val2 come out as int32 planes, zero where this rank owns no
// matching bucket, so the sum over ranks is the whole table's answer (a
// real key lives in one bucket of one level, which exactly one rank
// owns).
//
// Bound on the H100: bytes.  Each gathered query is read once (8 B, 16
// with a locus), each owned (query, level) up to the query's first hit
// reads one 8-slot row (128 B at W = 4) from a random place, and three
// int32 planes are written.  The design reads rows through the read-only
// cache and writes coalesced outputs; the row compare is bucket.cuh's,
// shared with KB, KF and KG.
#include "bucket.cuh"

// A rank's row block of each level: the block's rows, the full level's
// bucket mask and salt, and the block's first bucket and row count.
struct DtkBlock {
    const uint32_t* t[DTK_MAXLEV];
    uint32_t mask[DTK_MAXLEV];
    uint32_t salt[DTK_MAXLEV];
    int64_t off[DTK_MAXLEV];
    int64_t rows[DTK_MAXLEV];
    int n;
};

__global__ void sharded_lookup_kernel(const int64_t* __restrict__ q,
                                      const int64_t* __restrict__ qloc,
                                      int64_t n, DtkBlock bl, int W,
                                      int composite, int nval,
                                      int32_t* __restrict__ found,
                                      int32_t* __restrict__ val,
                                      int32_t* __restrict__ val2) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const uint64_t key = (uint64_t)q[i];
    const uint32_t lo = (uint32_t)key, hi = (uint32_t)(key >> 32);
    const uint32_t loc = composite ? (uint32_t)qloc[i] : 0u;
    bool f = false;
    uint32_t a = 0, b2 = 0;
    for (int l = 0; l < bl.n && !f; ++l) {
        const int64_t b = dtk_bucket(bl.salt[l], bl.mask[l], composite, lo,
                                     hi, loc);
        if (b < bl.off[l] || b >= bl.off[l] + bl.rows[l]) continue;
        f = dtk_row_match(bl.t[l] + (size_t)(b - bl.off[l]) * 8 * W, W,
                          composite, nval, lo, hi, loc, &a, &b2);
    }
    found[i] = f;
    val[i] = (int32_t)a;
    val2[i] = (int32_t)b2;
}

DTK_EXPORT int dtk_sharded_lookup(const void* q, const void* qloc, int64_t n,
                                  const void* tabs, const void* nbs,
                                  const void* salts, const void* offs,
                                  const void* rows, int64_t nlev,
                                  int64_t composite, int64_t nval,
                                  void* found, void* val, void* val2,
                                  void* stream) {
    if (nlev > DTK_MAXLEV) return (int)cudaErrorInvalidValue;
    DtkBlock bl;
    bl.n = (int)nlev;
    for (int l = 0; l < bl.n; ++l) {
        bl.t[l] = ((const uint32_t* const*)tabs)[l];
        bl.mask[l] = (uint32_t)(((const int64_t*)nbs)[l] - 1);
        bl.salt[l] = (uint32_t)((const int64_t*)salts)[l];
        bl.off[l] = ((const int64_t*)offs)[l];
        bl.rows[l] = ((const int64_t*)rows)[l];
    }
    const int W = 2 + (int)composite + (int)nval;
    const int threads = 256;
    if (n > 0)
        sharded_lookup_kernel<<<dtk_grid(n, threads), threads, 0,
                                (cudaStream_t)stream>>>(
            (const int64_t*)q, (const int64_t*)qloc, n, bl, W,
            (int)composite, (int)nval, (int32_t*)found, (int32_t*)val,
            (int32_t*)val2);
    return (int)cudaGetLastError();
}
