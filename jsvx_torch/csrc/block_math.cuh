// The per-pixel arithmetic the port's decode kernels share, CUDA C++ for
// Hopper (sm_90a): the integer dequantisation core, the two fixed-order
// passes of the 8x8 IDCT over a strip of blocks in shared memory, and the
// half-pel motion-compensation taps.  fused_decode.cu, recon.cu and mc.cu
// all include it, so the three kernels cannot drift apart; the plain
// PyTorch versions (jsvx_torch/kernels/decode.py) compute the same steps
// in the same order.
//
// Exactness: each 1-D IDCT output is c[x,0]*f[0] + c[x,1]*f[1] + ... +
// c[x,7]*f[7], summed left to right with __fmul_rn/__fadd_rn, so it is
// never contracted into a fused multiply-add (the build passes -fmad=false
// as well).

#pragma once

#include <stdint.h>

namespace jsvx {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return min(max(v, lo), hi);
}

// Dequantise one coefficient: x2 (+sign for non-intra), x (q * M), / 16
// with floor, mismatch control, clamp to [-2048, 2047].  `mult` is q * M.
// Mismatch control follows ISO 11172-2 (jsvx/tools/refmath.py): an even
// result moves one step toward zero by sign(d).  The caller applies the
// coded-scan mask and the intra DC override.
__device__ __forceinline__ int dequant_coef(int lv, int mult, bool nonintra,
                                            bool quirk) {
    const int sgn = (lv > 0) - (lv < 0);
    const int pre_sign = quirk ? (lv < 0 ? -1 : 1) : sgn;
    const int pre = nonintra ? 2 * lv + pre_sign : 2 * lv;
    int d = (pre * mult) >> 4;                       // floor(x / 16)
    const bool even = (d & 1) == 0;
    if (quirk) {
        if (even) d -= (d > 0) ? 1 : -1;
    } else if (even && lv != 0) {
        d -= (d > 0) - (d < 0);                      // toward zero
    }
    return clampi(d, -2048, 2047);
}

// c_row[0] * f[0] + c_row[1] * f[stride] + ... + c_row[7] * f[7 * stride],
// left to right, every product and partial sum rounded to f32.
__device__ __forceinline__ float dot8(const float* c_row, const float* f,
                                      int stride) {
    float acc = __fmul_rn(c_row[0], f[0]);
#pragma unroll
    for (int k = 1; k < 8; ++k) {
        acc = __fadd_rn(acc, __fmul_rn(c_row[k], f[k * stride]));
    }
    return acc;
}

// 8x8 IDCT of a strip of 8x8 blocks side by side, one thread per pixel:
// thread (tx, ty) holds coefficient F[ty][tx] of its block in `f` and gets
// back spatial value (ty, tx & 7) of the same block.  s_c is the basis
// C (spatial = C @ F @ C.T); s_f and s_col are (8, kCtaW) scratch.  Every
// thread of the CTA must call it (it holds two barriers).
template <int kCtaW>
__device__ __forceinline__ float idct_strip(float f, const float* s_c,
                                            float (*s_f)[kCtaW],
                                            float (*s_col)[kCtaW], int tx,
                                            int ty) {
    s_f[ty][tx] = f;
    __syncthreads();
    // column pass: cols[x][l] = sum_u C[x][u] * F[u][l]
    s_col[ty][tx] = dot8(&s_c[ty * 8], &s_f[0][tx], kCtaW);
    __syncthreads();
    // row pass: rows[x][y] = sum_v C[y][v] * cols[x][v]
    return dot8(&s_c[(tx & 7) * 8], &s_col[ty][tx & ~7], 1);
}

// Half-pel prediction of pixel (y, x) of an (h, w) plane from `ref`, with
// the block's vector (mvy, mvx) in luma half-pel units; chroma vectors are
// halved toward zero first.  Each tap index is clamped to the plane
// (CLAMP_TO_EDGE), and each half-pel case rounds as MPEG-1 does.
__device__ __forceinline__ int halfpel_predict(const uint8_t* __restrict__ ref,
                                               int h, int w, int y, int x,
                                               int mvy, int mvx,
                                               bool is_chroma) {
    if (is_chroma) {                     // truncation toward zero
        mvy /= 2;
        mvx /= 2;
    }
    const int oy = mvy & 1, ox = mvx & 1;
    const int y0 = clampi(y + (mvy >> 1), 0, h - 1);     // >> floors
    const int x0 = clampi(x + (mvx >> 1), 0, w - 1);
    const int y1 = clampi(y + (mvy >> 1) + 1, 0, h - 1);
    const int x1 = clampi(x + (mvx >> 1) + 1, 0, w - 1);
    const int a = ref[(size_t)y0 * w + x0];
    if (!oy && !ox) return a;
    if (!oy) return (a + ref[(size_t)y0 * w + x1] + 1) >> 1;
    if (!ox) return (a + ref[(size_t)y1 * w + x0] + 1) >> 1;
    return (a + ref[(size_t)y0 * w + x1] + ref[(size_t)y1 * w + x0]
            + ref[(size_t)y1 * w + x1] + 2) >> 2;
}

}  // namespace jsvx
