// Reconstruction of every plane of one picture from its prediction planes,
// CUDA C++ for Hopper (sm_90a): the second kernel of the two-kernel route.
//
// It computes, for the 3 planes of a picture (4 with YUVA alpha), what the
// JAX package's TPU kernel jsvx/kernels/pallas_decode.py::_recon_kernel
// computes for one plane: integer dequantisation, the 8x8 IDCT, the add of
// an externally computed prediction (mc.cu's int16 output), rounding and
// the clamp to a byte.  It reads the dequantisation sideband per block:
// lnz, q and intra per 8x8 block, with the quant matrices and the scan
// order from the launch, as the fused kernel reads them.  The plain version
// is jsvx_torch/kernels/recon.py::recon_plane_blocks (recon_plane on
// recon.py::expand_sideband's per-pixel planes); the output is bit-equal to
// it and to the fused kernel.
//
// Why not the TPU kernel's per-pixel interface (`mult` = q * M and
// `flags`): those planes exist because a TPU lane needs a per-pixel operand
// (pallas_decode.py:179-210).  Without parser sideband the first design
// had them built on the card by expand_sideband, about 15 torch
// elementwise launches per plane, some with int64 temporaries, that wrote
// and read 3 B per pixel: most of the route's device time (PERF.md).  One
// thread per block row reads a block's sideband once, so the expansion
// folds into this launch and the route on the card runs none of it.  A
// frame that carries the parser's `mult`/`flags` carries the per-block
// grids as well, and this kernel reads those: the same bits, fewer bytes.
//
// Two differences from the TPU kernel:
//   * mismatch control follows the spec (sign(d), jsvx/tools/refmath.py),
//     where _recon_kernel subtracts sign(level); they differ only when a
//     custom quant matrix with small entries takes a non-zero level to 0;
//   * the IDCT sums in the fused kernel's fixed order (block_math.cuh),
//     not as (8,8)x(8,TW) and block-diagonal (TW,TW) MXU matmuls: the
//     block-diagonal matrix exists to feed a 128-wide matrix unit and
//     would be 16x wasted multiplies here.
// `is_p` is one int32 on the card: an I picture reads no prediction.
//
// What bounds it: per 1080p 4:2:0 P picture it must read 2 B of levels per
// pixel of a coded block, 2 B of pred per pixel and 3 B of sideband per
// block, and write 1 B per pixel: about 15.8 MB, 4.7 us at 3.35 TB/s.  Its
// 31 rounded f32 operations per pixel of a coded block take about 1.4 us
// at 67 TFLOP/s, but each of them and the dequantisation around them takes
// an issue slot, as in the fused kernel.  The first design
// (PR 2's kernel) ran one launch per plane (3.66 us of launch floor
// for a 1080p grid, three times a picture) on the per-pixel planes, one
// thread per pixel with 1-2 byte loads, a shared copy of the basis behind
// a barrier, both IDCT passes through shared memory with two barriers, and
// no skip of uncoded blocks.  The design answer, the fused kernel's:
//   * one launch per picture, CTAs finding their plane from the prefix of
//     CTA counts (picture_layout.cuh);
//   * one thread per 8-pixel row of a block: the block's lnz, q and intra
//     are read once, the row's levels and pred are one 16-byte load each;
//     the row is dequantised in registers (block_math.cuh::
//     dequant_block_row), transposed through shared memory once each way,
//     and both IDCT passes run in registers with the basis as
//     kernel-parameter operands (block_math.cuh::idct_block_row); the row
//     is stored with one 8-byte store;
//   * uncoded blocks are skipped: a warp whose four blocks have lnz == 0
//     and are not intra runs no IDCT and writes clamp(pred), or 0 on an I
//     picture: exact, since an IDCT of zeros is +-0.
// Tensor cores are ruled out: they round to TF32 and sum in their own
// order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_math.cuh"
#include "picture_layout.cuh"

namespace {

using jsvx::kBlocksPerWarp;
using jsvx::kMaxPlanes;
using jsvx::kThreads;
using jsvx::kTile;
using jsvx::kWarps;

struct ReconPlane {
    const int16_t* levels;                 // (h, w)
    const uint8_t* lnz;                    // (h/8, w/8)
    const uint8_t* qscale;                 // (h/8, w/8)
    const uint8_t* intra;                  // (h/8, w/8)
    const int16_t* pred;                   // (h, w)
    uint8_t* out;                          // (h, w)
    jsvx::PlaneLayout L;
};

struct ReconArgs {
    ReconPlane plane[kMaxPlanes];
    const int32_t* is_p;                   // one int32 on the card
    jsvx::BlockTables t;
    int n_planes;
};

// Value j of eight int16 held in four words, low half first.
__device__ __forceinline__ int half16(const uint32_t (&v)[4], int j) {
    return (int16_t)(v[j >> 1] >> (16 * (j & 1)));
}

template <bool kQuirk>
__global__ void __launch_bounds__(kThreads)
recon_picture_kernel(const __grid_constant__ ReconArgs a) {
    __shared__ __align__(16) float s_t[kWarps][kBlocksPerWarp * kTile];

    const ReconPlane& P = a.plane[jsvx::cta_plane(a.plane, a.n_planes)];
    jsvx::RowTask k;
    if (!jsvx::row_task(P.L, k)) return;   // the whole warp: past the plane
    const int w = P.L.w, r = k.r;
    const bool live = k.live;              // the row's blocks end mid-warp
    const size_t pix = (size_t)(k.by * 8 + r) * w + (size_t)k.bx * 8;

    // ---- the block's sideband and the row's levels ----
    int lnz = 0, q = 0;
    bool intra = false;
    if (live) {
        const int blk = k.by * (w >> 3) + k.bx;
        lnz = P.lnz[blk];
        q = P.qscale[blk];
        intra = P.intra[blk] != 0;
    }
    const bool coded = live && (lnz > 0 || intra);
    uint4 lv4 = make_uint4(0, 0, 0, 0);
    if (coded) lv4 = *reinterpret_cast<const uint4*>(P.levels + pix);

    // ---- the row's prediction; none on an I picture ----
    uint4 p4 = make_uint4(0, 0, 0, 0);
    if (live && *a.is_p != 0) {
        p4 = *reinterpret_cast<const uint4*>(P.pred + pix);
    }
    const uint32_t pw[4] = {p4.x, p4.y, p4.z, p4.w};
    float pf[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) pf[j] = __int2float_rn(half16(pw, j));

    if (!__any_sync(0xFFFFFFFFu, coded)) { // four uncoded blocks
        if (live) {
            *reinterpret_cast<uint2*>(P.out + pix) = make_uint2(
                jsvx::round_pack4(pf[0], pf[1], pf[2], pf[3]),
                jsvx::round_pack4(pf[4], pf[5], pf[6], pf[7]));
        }
        return;
    }

    // ---- dequantise the row (decode.py::dequant_plane) ----
    float f[8];
    jsvx::dequant_block_row<kQuirk>(a.t, lv4, q, lnz, intra, live, r, f);

    // ---- IDCT: transpose, column pass, transpose back, row pass ----
    float res[8];
    jsvx::idct_block_row(a.t.c, f, &s_t[k.warp][k.b * kTile], r, res);

    // ---- add, round, clamp, one 8-byte store ----
    if (!live) return;
    float s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = __fadd_rn(pf[j], res[j]);
    *reinterpret_cast<uint2*>(P.out + pix) = make_uint2(
        jsvx::round_pack4(s[0], s[1], s[2], s[3]),
        jsvx::round_pack4(s[4], s[5], s[6], s[7]));
}

}  // namespace

// Plain C entry point (bound with ctypes): reconstruct the n_planes planes
// of one picture in one launch.  Per plane p: ptrs[6p .. 6p+5] = levels,
// lnz, qscale, intra, pred, out (device pointers; levels and pred 16-byte,
// out 8-byte aligned).  dims[4p .. 4p+3] = h, w, is_chroma and the plane's
// first CTA, which must be the prefix sum of the planes' CTA counts (ctas
// is the total).  qtab (192 ints: intra and non-intra matrix, scan position
// of each spatial position) and c_basis (the IDCT basis, 64 floats,
// row-major) are on the host and travel with the launch.  Launches on
// `stream` without synchronising and returns the cudaError_t of the launch
// (0 = success).
extern "C" int jsvx_recon_picture(int n_planes, const void* const* ptrs,
                                  const int* dims, int ctas,
                                  const void* is_p, const int* qtab,
                                  const float* c_basis, int quirk,
                                  int device, void* stream) {
    if (n_planes < 1 || n_planes > kMaxPlanes) {
        return (int)cudaErrorInvalidValue;
    }
    ReconArgs a = {};
    int begin = 0;
    for (int p = 0; p < n_planes; ++p) {
        const void* const* q = ptrs + 6 * p;
        ReconPlane& P = a.plane[p];
        if (!jsvx::set_plane_layout(P.L, dims + 4 * p, begin)
                || !q[1] || !q[2] || !q[3]
                || ((uintptr_t)q[0] & 15) || ((uintptr_t)q[4] & 15)
                || ((uintptr_t)q[5] & 7)) {
            return (int)cudaErrorInvalidValue;
        }
        P.levels = (const int16_t*)q[0];
        P.lnz = (const uint8_t*)q[1];
        P.qscale = (const uint8_t*)q[2];
        P.intra = (const uint8_t*)q[3];
        P.pred = (const int16_t*)q[4];
        P.out = (uint8_t*)q[5];
    }
    if (begin != ctas) return (int)cudaErrorInvalidValue;
    a.n_planes = n_planes;
    a.is_p = (const int32_t*)is_p;
    jsvx::set_block_tables(a.t, qtab, c_basis);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const cudaStream_t s = (cudaStream_t)stream;
    if (quirk) {
        recon_picture_kernel<true><<<ctas, kThreads, 0, s>>>(a);
    } else {
        recon_picture_kernel<false><<<ctas, kThreads, 0, s>>>(a);
    }
    return (int)cudaGetLastError();
}
