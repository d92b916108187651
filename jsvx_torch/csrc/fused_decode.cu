// Fused decode of every plane of one picture, CUDA C++ for Hopper (sm_90a).
//
// One launch computes, for the 3 planes of a picture (4 with YUVA alpha),
// what the JAX package's TPU kernel
// jsvx/kernels/pallas_fused.py::_fused_kernel computes for one plane:
// half-pel motion compensation from the previous plane, integer
// dequantisation with mismatch control, the 8x8 IDCT, the prediction add,
// rounding and the clamp to a byte.  The plain PyTorch version is
// jsvx_torch/kernels/decode.py::decode_frame_plane, per plane; the two are
// bit-equal.
//
// What bounds it: per 1080p 4:2:0 picture it must read 2 B of levels and
// 1 B of reference per pixel, write 1 B, and read 8 B of sideband per 8x8
// block: 12.93 MB, 3.86 us at 3.35 TB/s.  The exactness contract fixes
// the arithmetic at 30 rounded f32 operations per pixel (1.4 us at 67
// TFLOP/s), but each of them, and each dequantisation, tap and pack step
// around them, takes an issue slot, and the card issues one warp
// instruction per clock per scheduler: the kernel is bound by instruction
// issue (about 3.2 us for the IDCT's operations alone), not by bytes.
// The first design spent about 21 shared-memory instructions per pixel
// and one launch per plane (a 0.5 MB chroma plane cannot approach any
// bound alone).  The design answer:
//   * one launch per picture: a by-value descriptor per plane, and each
//     CTA finds its plane from the prefix of CTA counts; the quant
//     matrices, the scan order and the basis travel with the launch, so
//     there is no table prologue and no barrier;
//   * one thread per 8-pixel row of a block: the row's eight levels come in
//     as one 16-byte load and are dequantised in registers, the block's
//     sideband is read once per thread, the block is transposed through
//     shared memory once each way (conflict-free padded tiles, 2.5
//     shared-memory instructions per pixel), and both IDCT passes run in
//     registers with the basis as kernel-parameter operands (no load);
//   * the reference taps of a row come from two aligned 8-byte loads and
//     funnel shifts (clamped byte loads only where the window crosses the
//     plane's edge), averaged four bytes at a time; rounding and the clamp
//     are one round-to-nearest conversion per pixel and saturating byte
//     packs; the row is stored with one 8-byte store;
//   * a block with lnz == 0 that is not intra reads no levels, and a warp
//     whose four blocks are all such runs no IDCT: its output is the
//     prediction itself (an IDCT of zeros is +-0, which leaves the rounded
//     sum unchanged).
// Tensor cores are ruled out: they round to TF32 and sum in their own
// order.

// Layout (picture_layout.cuh, shared with mc.cu and recon.cu): a warp
// covers four 8x8 blocks side by side in one block row, lane = 8 * block +
// row (row of the block in the dequantisation and row passes, column in
// the column pass); a CTA is four warps over four consecutive warp tasks
// of its plane, numbered along block rows.
//
// Exactness: the row dequantisation and the IDCT come from block_math.cuh,
// shared with recon.cu and mc.cu; each 1-D pass is the explicit sum
// c[x,0]*f[0] + ... + c[x,7]*f[7], left to right, never contracted into a
// fused multiply-add.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_math.cuh"
#include "picture_layout.cuh"

namespace {

using jsvx::kMaxPlanes;
using jsvx::kThreads;
using jsvx::kWarps;
using jsvx::kBlocksPerWarp;
using jsvx::kTile;

struct PlaneArgs {
    const int16_t* levels;                 // (h, w)
    const uint8_t* lnz;                    // (h/8, w/8)
    const uint8_t* qscale;                 // (h/8, w/8)
    const uint8_t* intra;                  // (h/8, w/8)
    const int16_t* mv;                     // (h/8, w/8, 2)
    const uint8_t* rep_add;                // (h/8, w/8)
    const uint8_t* ref;                    // (h, w)
    uint8_t* out;                          // (h, w)
    jsvx::PlaneLayout L;
};

struct PictureArgs {
    PlaneArgs plane[kMaxPlanes];
    const int32_t* is_p;                   // one int32 on the card
    jsvx::BlockTables t;
    int n_planes;
};

template <bool kQuirk>
__global__ void __launch_bounds__(kThreads)
fused_decode_picture_kernel(const __grid_constant__ PictureArgs a) {
    __shared__ __align__(16) float s_t[kWarps][kBlocksPerWarp * kTile];

    const PlaneArgs& P = a.plane[jsvx::cta_plane(a.plane, a.n_planes)];
    jsvx::RowTask k;
    if (!jsvx::row_task(P.L, k)) return;   // the whole warp: past the plane
    const int h = P.L.h, w = P.L.w;
    const int r = k.r, bx = k.bx;
    const bool live = k.live;              // the row's blocks end mid-warp
    const int blk = k.by * (w >> 3) + bx;
    const int y = k.by * 8 + r;
    const size_t pix = (size_t)y * w + (size_t)bx * 8;

    // ---- the block's sideband, once per thread ----
    const bool is_p = *a.is_p != 0;
    int lnz = 0, q = 0, mvy = 0, mvx = 0;
    bool intra = false, rep = true;
    if (live) {
        lnz = P.lnz[blk];
        q = P.qscale[blk];
        intra = P.intra[blk] != 0;
        rep = P.rep_add[blk] != 0;
        const uint32_t mvw = reinterpret_cast<const uint32_t*>(P.mv)[blk];
        mvy = (int16_t)(mvw & 0xFFFFu);
        mvx = (int16_t)(mvw >> 16);
    }
    const bool coded = live && (lnz > 0 || intra);

    // the row's levels, loaded ahead of the reference taps
    uint4 lv4 = make_uint4(0, 0, 0, 0);
    if (coded) lv4 = *reinterpret_cast<const uint4*>(P.levels + pix);

    // ---- half-pel prediction of the row (decode.py::predict_plane) ----
    uint32_t p0 = 0, p1 = 0;
    if (live && !rep && is_p) {
        if (P.L.is_chroma) {               // truncation toward zero
            mvy /= 2;
            mvx /= 2;
        }
        const int y0 = jsvx::clampi(y + (mvy >> 1), 0, h - 1);
        const int y1 = jsvx::clampi(y + (mvy >> 1) + 1, 0, h - 1);
        jsvx::halfpel_row8(P.ref, w, y0, y1, bx * 8 + (mvx >> 1),
                           (mvy & 1) != 0, (mvx & 1) != 0, p0, p1);
    }

    if (!__any_sync(0xFFFFFFFFu, coded)) { // four uncoded blocks
        if (live) {
            *reinterpret_cast<uint2*>(P.out + pix) = make_uint2(p0, p1);
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
    for (int j = 0; j < 8; ++j) {
        const uint32_t pj = ((j < 4 ? p0 : p1) >> (8 * (j & 3))) & 0xFFu;
        s[j] = __fadd_rn(__uint2float_rn(pj), res[j]);
    }
    *reinterpret_cast<uint2*>(P.out + pix) = make_uint2(
        jsvx::round_pack4(s[0], s[1], s[2], s[3]),
        jsvx::round_pack4(s[4], s[5], s[6], s[7]));
}

}  // namespace

// Plain C entry point (bound with ctypes): decode the n_planes planes of
// one picture in one launch.  Per plane p: ptrs[8p .. 8p+7] = levels, lnz,
// qscale, intra, mv, rep_add, ref, out (device pointers; levels 16-byte,
// ref and out 8-byte, mv 4-byte aligned); dims[4p .. 4p+3] = h, w,
// is_chroma and the plane's first CTA, which must be the prefix sum of
// the planes' CTA counts (ctas is the total).  qtab (192 ints: intra and
// non-intra matrix, scan position of each spatial position) and c_basis
// (the IDCT basis, 64 floats, row-major) are on the host and travel with
// the launch.  Launches on `stream` without
// synchronising and returns the cudaError_t of the launch (0 = success).
extern "C" int jsvx_fused_decode_picture(
        int n_planes, const void* const* ptrs, const int* dims, int ctas,
        const void* is_p, const int* qtab, const float* c_basis, int quirk,
        int device, void* stream) {
    if (n_planes < 1 || n_planes > kMaxPlanes) {
        return (int)cudaErrorInvalidValue;
    }
    PictureArgs a = {};
    int begin = 0;
    for (int p = 0; p < n_planes; ++p) {
        const void* const* q = ptrs + 8 * p;
        PlaneArgs& P = a.plane[p];
        if (!jsvx::set_plane_layout(P.L, dims + 4 * p, begin)
                || ((uintptr_t)q[0] & 15) || ((uintptr_t)q[4] & 3)
                || ((uintptr_t)q[6] & 7) || ((uintptr_t)q[7] & 7)) {
            return (int)cudaErrorInvalidValue;
        }
        P.levels = (const int16_t*)q[0];
        P.lnz = (const uint8_t*)q[1];
        P.qscale = (const uint8_t*)q[2];
        P.intra = (const uint8_t*)q[3];
        P.mv = (const int16_t*)q[4];
        P.rep_add = (const uint8_t*)q[5];
        P.ref = (const uint8_t*)q[6];
        P.out = (uint8_t*)q[7];
    }
    if (begin != ctas) return (int)cudaErrorInvalidValue;
    a.n_planes = n_planes;
    a.is_p = (const int32_t*)is_p;
    jsvx::set_block_tables(a.t, qtab, c_basis);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (quirk) {
        fused_decode_picture_kernel<true>
            <<<ctas, kThreads, 0, (cudaStream_t)stream>>>(a);
    } else {
        fused_decode_picture_kernel<false>
            <<<ctas, kThreads, 0, (cudaStream_t)stream>>>(a);
    }
    return (int)cudaGetLastError();
}
