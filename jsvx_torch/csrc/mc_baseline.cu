// The first design of the motion-compensation kernel, one launch per
// plane, kept unchanged as the baseline that chip_smoke.py times in
// turns with mc.cu and holds bit-equal to it.  Nothing on the
// port's paths launches it.
//
// Half-pel motion-compensated prediction of one plane, CUDA C++ for Hopper
// (sm_90a): the first kernel of the two-kernel route.
//
// It computes the prediction plane that the JAX package's TPU kernel
// jsvx/kernels/pallas_mc.py::_mc_kernel computes: for each pixel, the four
// half-pel taps at (y + (mvy >> 1), x + (mvx >> 1)) of the previous plane,
// each index clamped to the plane (CLAMP_TO_EDGE), combined with MPEG-1's
// rounding for the four half-pel cases; chroma vectors are halved toward
// zero first; 0 where `rep_add` is set (intra macroblocks of a P
// picture).  The output is int16, as the TPU kernel's.  The plain PyTorch
// version is jsvx_torch/kernels/decode.py::predict_plane; the two are
// bit-equal.
//
// It reads per-block vectors, one thread per pixel.  The TPU kernel's
// distinct-vector table, window DMAs, edge-padded reference copy, row-band
// index bounds and 255-entry cap exist because per-pixel gathers are
// scalar loops on a TPU; here a gather is one load per tap, so none of
// them has a counterpart.  Streams with more than 255 distinct vectors,
// where jsvx drops to the XLA gather, go through this kernel too.  It is
// exact for every in-range vector, like jsvx's gather predict_plane;
// jsvx's table route equals it only while a full-pel shift stays under
// its pad (72).
//
// What bounds it: device memory.  Per pixel it writes 2 B and reads 1-4
// reference taps; neighbouring threads read neighbouring taps, so the
// reads are mostly served from L1 and L2 and device memory sees about the
// plane once.  The design answer: coalesced rows (a warp covers 32
// adjacent pixels of one row, which share one block row's vectors), no
// padded copy of the reference, no shared memory, no barrier.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_math.cuh"

namespace {

constexpr int kCtaW = 32;   // one warp per row
constexpr int kCtaH = 8;    // one block row

__global__ void __launch_bounds__(kCtaW * kCtaH)
mc_kernel(const uint8_t* __restrict__ ref,      // (h, w)
          const int16_t* __restrict__ mv,       // (h/8, w/8, 2)
          const uint8_t* __restrict__ rep_add,  // (h/8, w/8)
          int16_t* __restrict__ out,            // (h, w)
          int h, int w, int is_chroma) {
    const int x = blockIdx.x * kCtaW + threadIdx.x;
    const int y = blockIdx.y * kCtaH + threadIdx.y;
    if (x >= w || y >= h) return;
    const int blk = (y >> 3) * (w >> 3) + (x >> 3);
    int pred = 0;
    if (rep_add[blk] == 0) {
        pred = jsvx::halfpel_predict(ref, h, w, y, x, mv[2 * blk],
                                     mv[2 * blk + 1], is_chroma != 0);
    }
    out[(size_t)y * w + x] = (int16_t)pred;
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream` without
// synchronising and returns the cudaError_t of the launch (0 = success).
extern "C" int jsvx_mc_plane_baseline(const void* ref, const void* mv,
                                      const void* rep_add, void* out, int h,
                                      int w, int is_chroma, int device,
                                      void* stream) {
    if (h <= 0 || w <= 0 || (h & 7) || (w & 7) || h / kCtaH > 65535) {
        return (int)cudaErrorInvalidValue;
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((w + kCtaW - 1) / kCtaW, h / kCtaH);
    const dim3 block(kCtaW, kCtaH);
    mc_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)ref, (const int16_t*)mv, (const uint8_t*)rep_add,
        (int16_t*)out, h, w, is_chroma);
    return (int)cudaGetLastError();
}
