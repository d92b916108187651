// The first design of the reconstruction kernel, one launch per
// plane, kept unchanged as the baseline that chip_smoke.py times in
// turns with recon.cu and holds bit-equal to it.  Nothing on the
// port's paths launches it.
//
// Reconstruction of one plane from a prediction plane, CUDA C++ for Hopper
// (sm_90a): the second kernel of the two-kernel route.
//
// It computes what the JAX package's TPU kernel
// jsvx/kernels/pallas_decode.py::_recon_kernel computes: integer
// dequantisation from the per-pixel sideband (`mult` = q * M; `flags` bit0
// non-intra, bit1 inside the coded scan, bit2 intra DC), the 8x8 IDCT, the
// add of an externally computed prediction, rounding and the clamp to a
// byte.  The plain PyTorch version is
// jsvx_torch/kernels/recon.py::recon_plane; the two are bit-equal.  Two
// differences from the TPU kernel:
//   * mismatch control follows the spec (sign(d), jsvx/tools/refmath.py),
//     where _recon_kernel subtracts sign(level); they differ only when a
//     custom quant matrix with small entries takes a non-zero level to 0;
//   * the IDCT sums in the fused kernel's fixed order (block_math.cuh),
//     not as (8,8)x(8,TW) and block-diagonal (TW,TW) MXU matmuls: the
//     block-diagonal matrix exists to feed a 128-wide matrix unit and
//     would be 16x wasted multiplies here.
// It takes the prediction as int16 (mc.cu's output) and zeroes it itself
// for an I picture (`is_p` is one int32 on the card), so no host sync or
// extra torch multiply is needed.
//
// What bounds it: device memory.  Per pixel it reads 7 B (levels 2, mult
// 2, flags 1, pred 2) and writes 1 B: about 25 MB for a 1080p 4:2:0 frame,
// against 16 multiply-adds of arithmetic per pixel.  The design answer:
// every input is read once, coalesced (a warp reads one 32-pixel row of
// each plane), and the coefficients and the column-pass intermediate stay
// in shared memory.
//
// Layout: the fused kernel's -- a CTA of 32 x 8 threads over a strip of
// four 8x8 blocks, one thread per pixel.  Vectorised loads, more blocks
// per CTA and TMA are left for the speed work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_math.cuh"

namespace {

constexpr int kBlocksPerCta = 4;
constexpr int kCtaW = 8 * kBlocksPerCta;   // 32 pixels: one warp per row

__global__ void __launch_bounds__(kCtaW * 8)
recon_kernel(const int16_t* __restrict__ levels,   // (h, w)
             const int16_t* __restrict__ mult,     // (h, w) q * M
             const uint8_t* __restrict__ flags,    // (h, w)
             const int16_t* __restrict__ pred,     // (h, w)
             const int32_t* __restrict__ is_p,     // scalar
             const float* __restrict__ c_basis,    // (8, 8)
             uint8_t* __restrict__ out,            // (h, w)
             int h, int w, int quirk) {
    __shared__ float s_c[64];
    __shared__ float s_f[8][kCtaW];      // dequantised coefficients
    __shared__ float s_col[8][kCtaW];    // after the column pass

    const int tx = threadIdx.x;          // column within the strip
    const int ty = threadIdx.y;          // row within the block
    const int tid = ty * kCtaW + tx;
    if (tid < 64) s_c[tid] = c_basis[tid];

    const int bx = blockIdx.x * kBlocksPerCta + (tx >> 3);
    const bool live = bx < (w >> 3);     // ragged right edge of the plane
    const int y = blockIdx.y * 8 + ty;
    const int x = bx * 8 + (tx & 7);
    const size_t pix = (size_t)y * w + x;
    __syncthreads();

    // ---- dequantise (jsvx_torch/kernels/recon.py::recon_plane) ----
    float f = 0.0f;
    if (live) {
        const int lv = levels[pix];
        const int fl = flags[pix];
        int d = jsvx::dequant_coef(lv, mult[pix], (fl & 1) != 0,
                                   quirk != 0);
        if (!(fl & 2)) d = 0;            // outside the coded scan
        if (fl & 4) d = 8 * lv;          // intra DC
        f = (float)d;
    }
    const float res = jsvx::idct_strip<kCtaW>(f, s_c, s_f, s_col, tx, ty);
    if (!live) return;

    const int p = (*is_p != 0) ? (int)pred[pix] : 0;
    const float v = rintf(__fadd_rn((float)p, res));
    out[pix] = (uint8_t)fminf(fmaxf(v, 0.0f), 255.0f);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream` without
// synchronising and returns the cudaError_t of the launch (0 = success).
extern "C" int jsvx_recon_plane_baseline(
        const void* levels, const void* mult, const void* flags,
        const void* pred, const void* is_p, const void* c_basis, void* out,
        int h, int w, int quirk, int device, void* stream) {
    if (h <= 0 || w <= 0 || (h & 7) || (w & 7) || (h >> 3) > 65535) {
        return (int)cudaErrorInvalidValue;
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(((w >> 3) + kBlocksPerCta - 1) / kBlocksPerCta, h >> 3);
    const dim3 block(kCtaW, 8);
    recon_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int16_t*)levels, (const int16_t*)mult, (const uint8_t*)flags,
        (const int16_t*)pred, (const int32_t*)is_p, (const float*)c_basis,
        (uint8_t*)out, h, w, quirk);
    return (int)cudaGetLastError();
}
