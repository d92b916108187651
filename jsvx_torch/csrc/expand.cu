// Expansion of one GOP's compact coefficient wire, CUDA C++ for Hopper
// (sm_90a).
//
// It computes what the JAX package compiles into its GOP program
// (decode_gop_scan_wire, jsvx/pipeline/gop.py): jsvx/kernels/expand.py::
// expand_levels and ::expand_compact_gop, XLA ops with no Pallas kernel (a
// scatter-add + cumsum rank of each entry's block, then one scatter into
// zeroed planes).  One launch expands every component (Y, Cb, Cr and, in
// YUVA, A) of every frame of a GOP into:
//   * levels, int16 (n, H, W), every element written (no zero fill first):
//     wire entry (spatial_pos:6 << 10) | (level + 512) puts level at that
//     position of its block;
//   * lnz, uint8 64 for every block (the planes are exact);
//   * for Y and A, the per-MB q, intra, rep_add and mv repeated over the
//     MB's four blocks (a chroma block is an MB: its grids stay the wire's).
// The plain version is jsvx_torch/kernels/expand.py::
// expand_compact_gop_plain; the two are bit-equal.
//
// Which entries a block owns, jsvx's rule kept exactly: the wire holds the
// entries of the blocks in (frame, MB raster, block in MB) order, `counts`
// each block's number, so block b owns [start_b, start_b + counts_b), with
// start_b the exclusive prefix of counts over the flattened (frame, block)
// order.  Entries at or past n (the bucket's padding) are dropped; entries
// in [sum(counts), n) go to the last block, as jsvx's rank clamps them
// there.  Within a block the later entry in wire order wins a repeated
// position.
//
// What bounds it: bytes.  Per 1080p GOP of 4 frames it must write 25.07 MB
// of levels and 1.1 MB of per-block sideband, and read 2 B per entry
// (5.6 MB for the fixture's 0.70 M entries a frame), the counts (0.2 MB)
// and the per-MB sideband (0.2 MB): 32.2 MB, 9.6 us at 3.35 TB/s
// (chip_smoke.py::expand_work counts it on the fixture).  There is no
// arithmetic to speak of.  The design, simple and exact first:
//   * a thread per 8x8 block, a CTA per tile of kTileBlocks consecutive
//     blocks of one component in wire order; the components' CTAs follow
//     one another, and a CTA finds its component from the prefix of CTA
//     counts, as the picture kernels find their plane
//     (picture_layout.cuh);
//   * the prefix takes no second launch: a CTA sums the counts before its
//     tile (16-byte loads of uint8 from L2, at most n * 32640 B for 1080p
//     luma) and scans its own tile's counts in shared memory;
//   * a thread zeroes its block in shared memory (rows of 144 B per
//     thread: 16-byte accesses free of bank conflicts), writes its entries
//     in wire order and stores the block as eight 16-byte rows;
//   * luma threads take a tile's 64 MBs in row order (the top blocks of
//     each, then the bottom ones), so a warp's 32 threads store 32
//     neighbouring 16-byte segments of one pixel row, and neighbouring
//     bytes of the per-block sideband;
//   * n stays on the card: the kernel reads it, the host never does.
// What it accepts for now: the prefix sums re-read the counts from L2
// (37 MB of L2 reads per 1080p GOP, most by the last luma tiles), and a
// thread reads its entries two bytes at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxComps = 4;
constexpr int kTileBlocks = 256;           // blocks per CTA, a thread each
constexpr int kThreads = kTileBlocks;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockStride = 9;            // uint4 a block: 8 rows + pad
constexpr int kMaxBlocks = (1 << 30);      // index math in int

struct CompArgs {
    const uint16_t* cpk;                   // (n_ent,)
    const int32_t* n_coef;                 // one int32 on the card
    const uint8_t* counts;                 // (n_frames, n_blocks)
    int16_t* levels;                       // (n_frames, hb * 8, wb * 8)
    uint8_t* lnz;                          // (n_frames, hb, wb) or null
    uint8_t* q;                            // per-block grids (luma-like):
    uint8_t* intra;                        // all four set, or all null
    uint8_t* rep_add;
    uint32_t* mv;                          // int16 pairs
    int n_ent, n_blocks, n_total, mb_w, hb, wb, luma_like, cta_begin;
};

struct ExpandArgs {
    CompArgs comp[kMaxComps];
    const uint8_t* mb_q;                   // (n_frames, mb_h, mb_w)
    const uint8_t* mb_intra;
    const uint8_t* mb_rep_add;
    const uint32_t* mb_mv;                 // int16 pairs
    int n_comps;
};

__global__ void __launch_bounds__(kThreads)
expand_gop_kernel(const __grid_constant__ ExpandArgs a) {
    __shared__ __align__(16) uint4 s_blk[kThreads * kBlockStride];
    __shared__ uint32_t s_start[kThreads + 1];
    __shared__ uint32_t s_tile[kWarps];
    __shared__ uint32_t s_before[kWarps];

    int ci = 0;
#pragma unroll
    for (int i = 1; i < kMaxComps; ++i) {
        if (i < a.n_comps && (int)blockIdx.x >= a.comp[i].cta_begin) ci = i;
    }
    const CompArgs& C = a.comp[ci];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int t0 = ((int)blockIdx.x - C.cta_begin) * kTileBlocks;

    // ---- the entries of every block before the tile ----
    uint32_t before = 0;
    const uint4* c4 = reinterpret_cast<const uint4*>(C.counts);
#pragma unroll 4
    for (int i = tid; i < (t0 >> 4); i += kThreads) {
        const uint4 v = __ldg(c4 + i);
        before = __dp4a(v.x, 0x01010101u, before);
        before = __dp4a(v.y, 0x01010101u, before);
        before = __dp4a(v.z, 0x01010101u, before);
        before = __dp4a(v.w, 0x01010101u, before);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        before += __shfl_xor_sync(0xffffffffu, before, off);
    }

    // ---- the tile's own counts, scanned in wire order ----
    const uint32_t cnt = t0 + tid < C.n_total ? __ldg(C.counts + t0 + tid)
                                              : 0u;
    uint32_t incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const uint32_t v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
    }
    if (lane == 0) s_before[warp] = before;
    if (lane == 31) s_tile[warp] = incl;
    __syncthreads();
    uint32_t base = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        base += s_before[w];
        if (w < warp) base += s_tile[w];
    }
    s_start[tid] = base + incl - cnt;
    if (tid == kThreads - 1) s_start[kThreads] = base + incl;
    __syncthreads();

    // ---- this thread's block ----
    int wl = tid;                          // its block of the tile, wire order
    if (C.luma_like) {
        // 64 whole MBs: threads 0-127 their top blocks, 128-255 the bottom
        const int k = tid & 127;
        wl = (k >> 1) * 4 + (tid >> 7) * 2 + (k & 1);
    }
    const int wb = t0 + wl;
    if (wb >= C.n_total) return;
    const int frame = wb / C.n_blocks;
    const int r = wb - frame * C.n_blocks;
    int mb, by, bx;
    if (C.luma_like) {
        mb = r >> 2;
        const int mby = mb / C.mb_w;
        by = mby * 2 + ((r >> 1) & 1);
        bx = (mb - mby * C.mb_w) * 2 + (r & 1);
    } else {
        mb = r;
        by = r / C.mb_w;
        bx = r - by * C.mb_w;
    }

    // entries [lo, hi): past n dropped, [sum(counts), n) to the last block;
    // lo is held in [0, limit] so that no wire, however wrong its counts,
    // reads outside cpk
    const int limit = min(__ldg(C.n_coef), C.n_ent);
    const int lo = (int)min(s_start[wl], (uint32_t)max(limit, 0));
    const int hi = wb == C.n_total - 1 ? limit
                                       : min((int)s_start[wl + 1], limit);
    uint4* blk = s_blk + tid * kBlockStride;
#pragma unroll
    for (int row = 0; row < 8; ++row) blk[row] = make_uint4(0u, 0u, 0u, 0u);
    int16_t* v = reinterpret_cast<int16_t*>(blk);
    for (int i = lo; i < hi; ++i) {
        const uint32_t e = __ldg(C.cpk + i);
        v[e >> 10] = (int16_t)((int)(e & 1023u) - 512);
    }
    const size_t w = (size_t)C.wb * 8;
    int16_t* out = C.levels + ((size_t)frame * C.hb + by) * 8 * w
                   + (size_t)bx * 8;
#pragma unroll
    for (int row = 0; row < 8; ++row) {
        *reinterpret_cast<uint4*>(out + row * w) = blk[row];
    }

    // ---- the block's sideband ----
    const size_t cell = ((size_t)frame * C.hb + by) * C.wb + bx;
    if (C.lnz) C.lnz[cell] = 64;
    if (C.q) {
        const size_t m = (size_t)frame * (C.n_blocks >> 2) + mb;
        C.q[cell] = __ldg(a.mb_q + m);
        C.intra[cell] = __ldg(a.mb_intra + m);
        C.rep_add[cell] = __ldg(a.mb_rep_add + m);
        C.mv[cell] = __ldg(a.mb_mv + m);
    }
}

}  // namespace

// Plain C entry point (bound with ctypes): expand the n_comps components of
// one GOP in one launch.  Per component c: ptrs[9c .. 9c+8] = cpk, n,
// counts, levels, lnz, q, intra, rep_add, mv (device pointers; counts and
// levels 16-byte aligned, mv 4-byte; cpk may be null when n_ent is 0, lnz
// may be null; q, intra, rep_add and mv all null, or all set for a
// luma-like component, and then mb's four pointers too); dims[6c .. 6c+5]
// = n_frames, mb_h, mb_w, luma_like, n_ent (cpk's length) and the
// component's first CTA, which must be the prefix sum of the components'
// CTA counts (ctas is the total, at least 1).  mb
// holds the GOP's per-MB q, intra, rep_add (uint8) and mv (int16 pairs,
// 4-byte aligned), each (n_frames, mb_h, mb_w[, 2]).  Launches on `stream`
// without synchronising and returns the cudaError_t of the launch (0 =
// success).
extern "C" int jsvx_expand_gop(int n_comps, const void* const* ptrs,
                               const int* dims, int ctas,
                               const void* const* mb, int device,
                               void* stream) {
    if (n_comps < 1 || n_comps > kMaxComps || ctas < 1) {
        return (int)cudaErrorInvalidValue;
    }
    ExpandArgs a = {};
    bool grids = false;
    int begin = 0;
    for (int c = 0; c < n_comps; ++c) {
        const void* const* p = ptrs + 9 * c;
        const int* d = dims + 6 * c;
        const int n = d[0], mb_h = d[1], mb_w = d[2], luma = d[3];
        const int rep = luma ? 2 : 1;
        const long long total = (long long)n * mb_h * mb_w * rep * rep;
        const bool with_grids = p[5] || p[6] || p[7] || p[8];
        if (n < 0 || mb_h < 1 || mb_w < 1 || (luma != 0 && luma != 1)
                || d[4] < 0 || d[5] != begin || total > kMaxBlocks
                || (!p[0] && d[4] > 0) || !p[1] || !p[2] || !p[3]
                || ((uintptr_t)p[2] & 15) || ((uintptr_t)p[3] & 15)
                || (with_grids && (!luma || !p[5] || !p[6] || !p[7] || !p[8]
                                   || ((uintptr_t)p[8] & 3)))) {
            return (int)cudaErrorInvalidValue;
        }
        grids = grids || with_grids;
        CompArgs& C = a.comp[c];
        C.cpk = (const uint16_t*)p[0];
        C.n_coef = (const int32_t*)p[1];
        C.counts = (const uint8_t*)p[2];
        C.levels = (int16_t*)p[3];
        C.lnz = (uint8_t*)p[4];
        C.q = (uint8_t*)p[5];
        C.intra = (uint8_t*)p[6];
        C.rep_add = (uint8_t*)p[7];
        C.mv = (uint32_t*)p[8];
        C.n_ent = d[4];
        C.n_blocks = mb_h * mb_w * rep * rep;
        C.n_total = (int)total;
        C.mb_w = mb_w;
        C.hb = mb_h * rep;
        C.wb = mb_w * rep;
        C.luma_like = luma;
        C.cta_begin = begin;
        begin += (int)((total + kTileBlocks - 1) / kTileBlocks);
    }
    if (begin != ctas) return (int)cudaErrorInvalidValue;
    if (grids) {
        if (!mb[0] || !mb[1] || !mb[2] || !mb[3] || ((uintptr_t)mb[3] & 3)) {
            return (int)cudaErrorInvalidValue;
        }
        a.mb_q = (const uint8_t*)mb[0];
        a.mb_intra = (const uint8_t*)mb[1];
        a.mb_rep_add = (const uint8_t*)mb[2];
        a.mb_mv = (const uint32_t*)mb[3];
    }
    a.n_comps = n_comps;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    expand_gop_kernel<<<ctas, kThreads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
