// Half-pel motion-compensated prediction of every plane of one picture,
// CUDA C++ for Hopper (sm_90a): the first kernel of the two-kernel route.
//
// It computes, for the 3 planes of a picture (4 with YUVA alpha), the
// prediction plane that the JAX package's TPU kernel
// jsvx/kernels/pallas_mc.py::_mc_kernel computes for one plane: for each
// pixel, the four half-pel taps at (y + (mvy >> 1), x + (mvx >> 1)) of the
// previous plane, each index clamped to the plane (CLAMP_TO_EDGE),
// combined with MPEG-1's rounding for the four half-pel cases; chroma
// vectors are halved toward zero first; 0 where `rep_add` is set (intra
// macroblocks of a P picture).  The output is int16, as the TPU kernel's.
// The plain PyTorch version is jsvx_torch/kernels/decode.py::predict_plane,
// per plane; the two are bit-equal.
//
// It reads per-block vectors.  The TPU kernel's distinct-vector table,
// window DMAs, edge-padded reference copy, row-band index bounds and
// 255-entry cap exist because per-pixel gathers are scalar loops on a TPU;
// here a row's taps are two vector loads, so none of them has a
// counterpart.  Streams with more than 255 distinct vectors, where jsvx
// drops to the XLA gather, go through this kernel too.
//
// What bounds it: per 1080p 4:2:0 picture it must write 2 B per pixel,
// read the union of the taps' windows (about the plane once) and 5 B of
// sideband per block: about 9.6 MB, 2.9 us at 3.35 TB/s.  Below that sits
// the launch itself: an empty body on the same 3060-CTA grid takes 3.66 us
// per launch back to back (PERF.md), so the kernel cannot beat the launch
// floor, and the design spends as little as it can above it.  The first
// design (PR 2's kernel) ran one launch per plane, one thread per pixel:
// it read the block's vector and rep_add again for every pixel, gathered
// up to four clamped single-byte taps per pixel and stored 2 B per thread.
// The design answer:
//   * one launch per picture: a by-value descriptor per plane, and each
//     CTA finds its plane from the prefix of CTA counts
//     (picture_layout.cuh, the fused kernel's layout);
//   * one thread per 8-pixel row of a block: the block's vector is one
//     4-byte load and rep_add one byte, once per thread; a block with
//     rep_add set stores zeros and reads no reference;
//   * the row's taps come from two aligned 8-byte loads and funnel shifts
//     (clamped byte loads only where the window crosses the plane's edge),
//     averaged four bytes at a time (block_math.cuh::halfpel_row8, shared
//     with the fused kernel); the eight bytes widen to eight int16 in
//     registers and leave in one 16-byte store.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_math.cuh"
#include "picture_layout.cuh"

namespace {

using jsvx::kMaxPlanes;
using jsvx::kThreads;

struct McPlane {
    const uint8_t* ref;                    // (h, w), the previous plane
    const int16_t* mv;                     // (h/8, w/8, 2)
    const uint8_t* rep_add;                // (h/8, w/8)
    int16_t* out;                          // (h, w)
    jsvx::PlaneLayout L;
};

struct McArgs {
    McPlane plane[kMaxPlanes];
    int n_planes;
};

__global__ void __launch_bounds__(kThreads)
mc_picture_kernel(const __grid_constant__ McArgs a) {
    const McPlane& P = a.plane[jsvx::cta_plane(a.plane, a.n_planes)];
    jsvx::RowTask k;
    if (!jsvx::row_task(P.L, k) || !k.live) return;
    const int h = P.L.h, w = P.L.w;
    const int blk = k.by * (w >> 3) + k.bx;
    const int y = k.by * 8 + k.r;

    uint4 o = make_uint4(0, 0, 0, 0);
    if (P.rep_add[blk] == 0) {
        const uint32_t mvw = reinterpret_cast<const uint32_t*>(P.mv)[blk];
        int mvy = (int16_t)(mvw & 0xFFFFu);
        int mvx = (int16_t)(mvw >> 16);
        if (P.L.is_chroma) {               // truncation toward zero
            mvy /= 2;
            mvx /= 2;
        }
        const int y0 = jsvx::clampi(y + (mvy >> 1), 0, h - 1);
        const int y1 = jsvx::clampi(y + (mvy >> 1) + 1, 0, h - 1);
        uint32_t p0, p1;
        jsvx::halfpel_row8(P.ref, w, y0, y1, k.bx * 8 + (mvx >> 1),
                           (mvy & 1) != 0, (mvx & 1) != 0, p0, p1);
        // bytes b0 b1 b2 b3 -> int16 pairs (b0, b1), (b2, b3)
        o = make_uint4(__byte_perm(p0, 0u, 0x4140),
                       __byte_perm(p0, 0u, 0x4342),
                       __byte_perm(p1, 0u, 0x4140),
                       __byte_perm(p1, 0u, 0x4342));
    }
    *reinterpret_cast<uint4*>(P.out + (size_t)y * w + (size_t)k.bx * 8) = o;
}

}  // namespace

// Plain C entry point (bound with ctypes): the prediction planes of the
// n_planes planes of one picture in one launch.  Per plane p:
// ptrs[4p .. 4p+3] = ref, mv, rep_add, out (device pointers; ref 8-byte,
// mv 4-byte, out 16-byte aligned); dims[4p .. 4p+3] = h, w, is_chroma and
// the plane's first CTA, which must be the prefix sum of the planes' CTA
// counts (ctas is the total).  Launches on `stream` without synchronising
// and returns the cudaError_t of the launch (0 = success).
extern "C" int jsvx_mc_picture(int n_planes, const void* const* ptrs,
                               const int* dims, int ctas, int device,
                               void* stream) {
    if (n_planes < 1 || n_planes > kMaxPlanes) {
        return (int)cudaErrorInvalidValue;
    }
    McArgs a = {};
    int begin = 0;
    for (int p = 0; p < n_planes; ++p) {
        const void* const* q = ptrs + 4 * p;
        McPlane& P = a.plane[p];
        if (!jsvx::set_plane_layout(P.L, dims + 4 * p, begin)
                || ((uintptr_t)q[0] & 7) || ((uintptr_t)q[1] & 3)
                || ((uintptr_t)q[3] & 15)) {
            return (int)cudaErrorInvalidValue;
        }
        P.ref = (const uint8_t*)q[0];
        P.mv = (const int16_t*)q[1];
        P.rep_add = (const uint8_t*)q[2];
        P.out = (int16_t*)q[3];
    }
    if (begin != ctas) return (int)cudaErrorInvalidValue;
    a.n_planes = n_planes;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    mc_picture_kernel<<<ctas, kThreads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
