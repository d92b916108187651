// The first design of the fused decode kernel, kept unchanged as the
// baseline that chip_smoke.py times in turns with fused_decode.cu and
// holds bit-equal to it.  Nothing on the port's paths launches it.
//
// Fused decode of one plane of one picture, CUDA C++ for Hopper (sm_90a).
//
// One pass computes what the JAX package's TPU kernel
// jsvx/kernels/pallas_fused.py::_fused_kernel computes: half-pel motion
// compensation from the previous plane, integer dequantisation with
// mismatch control, the 8x8 IDCT, the prediction add, rounding and the
// clamp to a byte.  The plain PyTorch version of the same function is
// jsvx_torch/kernels/decode.py::decode_frame_plane; the two are bit-equal.
//
// What bounds it: device memory.  Per pixel it reads 2 B of levels and at
// most 4 reference taps (1 B each, mostly served from L1/L2 because
// neighbouring threads read neighbouring taps) and writes 1 B, about
// 16 MB for a 1080p 4:2:0 frame; the arithmetic (16 multiply-adds per
// pixel) is far below the card's rate.  The design answer: each input is
// read once, and the coefficients, the IDCT intermediate and the
// prediction never leave registers or shared memory.
//
// Layout: a CTA of 32 x 8 threads covers one strip of four 8x8 blocks side
// by side, one thread per pixel, so each warp reads one 32-pixel row of
// every plane (coalesced).  The dequantised block goes to shared memory,
// then the column pass, then the row pass.
//
// Exactness: the dequantisation core, both IDCT passes and the half-pel
// taps come from block_math.cuh, shared with recon.cu and mc.cu.  Each 1-D
// pass is the explicit sum c[x,0]*f[0] + ... + c[x,7]*f[7], left to right,
// never contracted into a fused multiply-add; the plain version sums in
// the same order with separate torch multiplies and adds.  rintf rounds
// half to even, as torch.round does.
//
// Motion compensation reads the four half-pel taps straight from the
// reference with each index clamped to the plane (CLAMP_TO_EDGE), per
// block vector; the TPU kernel's distinct-vector table, window DMA and
// edge-padded reference copy exist because per-pixel gathers are scalar
// loops on a TPU, and have no counterpart here (nor its 255-vector cap).
//
// Speed work (TMA, vectorised loads, one CTA over many blocks, a CUDA
// graph over the GOP) is left for later.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_math.cuh"

namespace {

constexpr int kBlocksPerCta = 4;
constexpr int kCtaW = 8 * kBlocksPerCta;   // 32 pixels: one warp per row

__global__ void __launch_bounds__(kCtaW * 8)
fused_decode_kernel(const int16_t* __restrict__ levels,   // (h, w)
                    const uint8_t* __restrict__ lnz,      // (h/8, w/8)
                    const uint8_t* __restrict__ qscale,   // (h/8, w/8)
                    const uint8_t* __restrict__ intra,    // (h/8, w/8)
                    const int16_t* __restrict__ mv,       // (h/8, w/8, 2)
                    const uint8_t* __restrict__ rep_add,  // (h/8, w/8)
                    const uint8_t* __restrict__ ref,      // (h, w)
                    const int32_t* __restrict__ is_p,     // scalar
                    const int32_t* __restrict__ qtab,     // (3, 64)
                    const float* __restrict__ c_basis,    // (8, 8)
                    uint8_t* __restrict__ out,            // (h, w)
                    int h, int w, int is_chroma, int quirk) {
    // qtab rows: intra matrix, non-intra matrix, scan position (spatial)
    __shared__ int s_q[192];
    __shared__ float s_c[64];
    __shared__ float s_f[8][kCtaW];      // dequantised coefficients
    __shared__ float s_col[8][kCtaW];    // after the column pass

    const int tx = threadIdx.x;          // column within the strip
    const int ty = threadIdx.y;          // row within the block
    const int tid = ty * kCtaW + tx;
    if (tid < 192) {
        s_q[tid] = qtab[tid];
    } else {
        s_c[tid - 192] = c_basis[tid - 192];
    }

    const int wb = w >> 3;
    const int bx = blockIdx.x * kBlocksPerCta + (tx >> 3);
    const bool live = bx < wb;           // ragged right edge of the plane
    const int blk = blockIdx.y * wb + bx;
    const int pos = ty * 8 + (tx & 7);   // spatial position in the block
    const int y = blockIdx.y * 8 + ty;
    const int x = bx * 8 + (tx & 7);
    const size_t pix = (size_t)y * w + x;
    __syncthreads();

    // ---- dequantise (integer; jsvx/kernels/decode.py::dequant_plane) ----
    float f = 0.0f;
    if (live) {
        const int lv = levels[pix];
        const bool is_intra = intra[blk] != 0;
        const int m = is_intra ? s_q[pos] : s_q[64 + pos];
        int d = jsvx::dequant_coef(lv, (int)qscale[blk] * m, !is_intra,
                                   quirk != 0);
        if (s_q[128 + pos] >= (int)lnz[blk]) d = 0;     // outside the scan
        if (pos == 0 && is_intra) d = 8 * lv;           // intra DC
        f = (float)d;
    }
    const float res = jsvx::idct_strip<kCtaW>(f, s_c, s_f, s_col, tx, ty);
    if (!live) return;

    // ---- half-pel prediction (jsvx/kernels/decode.py::predict_plane) ----
    int pred = 0;
    if (*is_p != 0 && rep_add[blk] == 0) {
        pred = jsvx::halfpel_predict(ref, h, w, y, x, mv[2 * blk],
                                     mv[2 * blk + 1], is_chroma != 0);
    }

    const float v = rintf(__fadd_rn((float)pred, res));
    out[pix] = (uint8_t)fminf(fmaxf(v, 0.0f), 255.0f);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream` without
// synchronising and returns the cudaError_t of the launch (0 = success).
extern "C" int jsvx_fused_decode_plane_baseline(
        const void* levels, const void* lnz, const void* qscale,
        const void* intra, const void* mv, const void* rep_add,
        const void* ref, const void* is_p, const void* qtab,
        const void* c_basis, void* out, int h, int w, int is_chroma,
        int quirk, int device, void* stream) {
    if (h <= 0 || w <= 0 || (h & 7) || (w & 7) || (h >> 3) > 65535) {
        return (int)cudaErrorInvalidValue;
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(((w >> 3) + kBlocksPerCta - 1) / kBlocksPerCta, h >> 3);
    const dim3 block(kCtaW, 8);
    fused_decode_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int16_t*)levels, (const uint8_t*)lnz, (const uint8_t*)qscale,
        (const uint8_t*)intra, (const int16_t*)mv, (const uint8_t*)rep_add,
        (const uint8_t*)ref, (const int32_t*)is_p, (const int32_t*)qtab,
        (const float*)c_basis, (uint8_t*)out, h, w, is_chroma, quirk);
    return (int)cudaGetLastError();
}
