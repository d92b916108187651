// The arithmetic the port's decode kernels share, CUDA C++ for Hopper
// (sm_90a): the integer dequantisation core, the 8x8 IDCT in two
// fixed-order passes, and the half-pel motion-compensation taps.
// fused_decode.cu, recon.cu and mc.cu all include it, so the three kernels
// cannot drift apart; the plain PyTorch versions
// (jsvx_torch/kernels/decode.py) compute the same steps in the same order.
// Each step takes one thread per 8-pixel row of a block, in registers
// (dequant_block_row, idct_block_row, idct8, halfpel_row8, round_pack4).
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

// ---------------------------------------------------------------------------
// One thread per 8-pixel row of a block, everything in registers.

// The IDCT basis, the quant matrices and the scan order of a picture,
// passed with a launch (no table prologue, no barrier).
struct BlockTables {
    float c[64];                           // IDCT basis: spatial = C F C^T
    alignas(16) int qm[2][64];             // intra, non-intra matrix
    alignas(8) uint8_t scan[64];           // scan position of each position
};

// Host: the tables from qtab (192 ints: intra matrix, non-intra matrix,
// scan position of each spatial position) and the basis (64 floats,
// row-major).
inline void set_block_tables(BlockTables& t, const int* qtab,
                             const float* c_basis) {
    for (int i = 0; i < 64; ++i) {
        t.c[i] = c_basis[i];
        t.qm[0][i] = qtab[i];
        t.qm[1][i] = qtab[64 + i];
        t.scan[i] = (uint8_t)qtab[128 + i];
    }
}

// One row's eight levels (int16 pairs in lv4) -> dequantised f32 values
// (decode.py::dequant_plane).  m holds the row's quant-matrix entries,
// sc the scan positions as bytes; kMask = false skips the scan mask, for a
// warp whose live blocks all have lnz == 64 (the compact wire's).
template <bool kQuirk, bool kMask>
__device__ __forceinline__ void dequant_row(uint4 lv4, const int (&m)[8],
                                            uint2 sc, int q, int lnz,
                                            bool intra, int r, float (&f)[8]) {
    const uint32_t lvw[4] = {lv4.x, lv4.y, lv4.z, lv4.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int lv = (int16_t)(lvw[j >> 1] >> (16 * (j & 1)));
        int d = dequant_coef(lv, q * m[j], !intra, kQuirk);
        if (kMask) {
            const int scan = ((j < 4 ? sc.x : sc.y) >> (8 * (j & 3))) & 0xFF;
            if (scan >= lnz) d = 0;                  // outside the scan
        }
        if (j == 0 && r == 0 && intra) d = 8 * lv;   // intra DC
        f[j] = __int2float_rn(d);
    }
}

// Row r of a block from its per-block sideband (q, lnz, intra): the row's
// quant-matrix entries from the launch's tables, then dequant_row, without
// the scan mask where every live block of the warp has lnz >= 64.  Every
// lane of the warp must call it.
template <bool kQuirk>
__device__ __forceinline__ void dequant_block_row(const BlockTables& t,
                                                  uint4 lv4, int q, int lnz,
                                                  bool intra, bool live,
                                                  int r, float (&f)[8]) {
    const int4* mrow =
        reinterpret_cast<const int4*>(&t.qm[intra ? 0 : 1][8 * r]);
    const int4 m0 = mrow[0], m1 = mrow[1];
    const int m[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
    if (__all_sync(0xFFFFFFFFu, !live || lnz >= 64)) {
        dequant_row<kQuirk, false>(lv4, m, make_uint2(0, 0), q, lnz, intra,
                                   r, f);
    } else {
        const uint2 sc = *reinterpret_cast<const uint2*>(&t.scan[8 * r]);
        dequant_row<kQuirk, true>(lv4, m, sc, q, lnz, intra, r, f);
    }
}

// Four sums s[0..3] of (float)prediction + residual -> four bytes
// min(max(rintf(s), 0), 255), byte 0 first: one round-to-nearest-even
// conversion per value (as rintf rounds; the sums are far inside int
// range) and two saturating packs (cvt.pack.sat: d = (c << 16) |
// sat_u8(a) << 8 | sat_u8(b)), which clamp as the byte cast after
// fminf/fmaxf does.
__device__ __forceinline__ uint32_t round_pack4(float s0, float s1, float s2,
                                                float s3) {
    uint32_t hi, word;
    asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, 0;"
        : "=r"(hi) : "r"(__float2int_rn(s3)), "r"(__float2int_rn(s2)));
    asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, %3;"
        : "=r"(word)
        : "r"(__float2int_rn(s1)), "r"(__float2int_rn(s0)), "r"(hi));
    return word;
}

// One 1-D pass of the IDCT over eight values in registers:
// out[x] = c[8x]*in[0] + c[8x+1]*in[1] + ... + c[8x+7]*in[7], left to
// right.  The column pass (in = column l of F, out = column l of C @ F)
// and the row pass (in = row x of C @ F, out = row x of C @ F @ C.T) are
// both this function.  With `c` a kernel
// parameter the indices are constants and each basis entry is an operand
// of its multiply, not a load.
__device__ __forceinline__ void idct8(const float* c, const float (&in)[8],
                                      float (&out)[8]) {
#pragma unroll
    for (int x = 0; x < 8; ++x) {
        float acc = __fmul_rn(c[8 * x], in[0]);
#pragma unroll
        for (int k = 1; k < 8; ++k) {
            acc = __fadd_rn(acc, __fmul_rn(c[8 * x + k], in[k]));
        }
        out[x] = acc;
    }
}

constexpr int kTileRow = 12;               // floats per tile row: 8 + pad
constexpr int kTile = 8 * kTileRow + 8;    // floats per block tile

// The 8x8 IDCT of a block, one thread per row: lane r holds row r of the
// dequantised block F in f and gets back row r of C F C^T in res.  The
// block goes through its shared-memory tile t (kTile floats; the pads make
// both transposes conflict-free) once each way: the column pass runs with
// a thread per column, the row pass with a thread per row, both through
// idct8 in registers.  Every lane of the warp must call it (it holds
// __syncwarp barriers).
__device__ __forceinline__ void idct_block_row(const float* c,
                                               const float (&f)[8], float* t,
                                               int r, float (&res)[8]) {
    *reinterpret_cast<float4*>(t + r * kTileRow) =
        make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<float4*>(t + r * kTileRow + 4) =
        make_float4(f[4], f[5], f[6], f[7]);
    __syncwarp();
    float col[8], g[8];                    // column r of F, of C F
#pragma unroll
    for (int u = 0; u < 8; ++u) col[u] = t[u * kTileRow + r];
    idct8(c, col, g);
    __syncwarp();
#pragma unroll
    for (int x = 0; x < 8; ++x) t[x * kTileRow + r] = g[x];
    __syncwarp();
    const float4 g0 = *reinterpret_cast<const float4*>(t + r * kTileRow);
    const float4 g1 = *reinterpret_cast<const float4*>(t + r * kTileRow + 4);
    const float row[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    idct8(c, row, res);                                 // row r of C F C^T
}

// The nine bytes row[x0 .. x0+8] of one reference row of width w, each
// column clamped to [0, w - 1] (CLAMP_TO_EDGE): bytes 0-3 in lo, 4-7 in
// hi, byte 8 in the low byte of e.  Where the first eight lie in the row,
// two aligned 8-byte loads and funnel shifts (row must be 8-byte aligned
// and w a multiple of 8; when the ninth is past the end, x0 is aligned and
// it clamps to byte 7); elsewhere one clamped load per byte.
__device__ __forceinline__ void window9(const uint8_t* __restrict__ row,
                                        int x0, int w, uint32_t& lo,
                                        uint32_t& hi, uint32_t& e) {
    if (x0 >= 0 && x0 + 8 <= w) {
        const int base = x0 & ~7;
        const uint2 a = *reinterpret_cast<const uint2*>(row + base);
        const uint2 b = x0 + 8 < w
            ? *reinterpret_cast<const uint2*>(row + base + 8)
            : make_uint2(a.y >> 24, 0u);
        const bool upper = (x0 & 4) != 0;
        const uint32_t w0 = upper ? a.y : a.x;
        const uint32_t w1 = upper ? b.x : a.y;
        const uint32_t w2 = upper ? b.y : b.x;
        const int k = (x0 & 3) * 8;
        lo = __funnelshift_r(w0, w1, k);
        hi = __funnelshift_r(w1, w2, k);
        e = w2 >> k;
    } else {
        uint32_t v[9];
#pragma unroll
        for (int j = 0; j < 9; ++j) v[j] = row[clampi(x0 + j, 0, w - 1)];
        lo = v[0] | (v[1] << 8) | (v[2] << 16) | (v[3] << 24);
        hi = v[4] | (v[5] << 8) | (v[6] << 16) | (v[7] << 24);
        e = v[8];
    }
}

// Per byte of four: (a + b + 1) >> 1, MPEG's two-tap half-pel rounding.
__device__ __forceinline__ uint32_t avg2_up(uint32_t a, uint32_t b) {
    return (a | b) - (((a ^ b) >> 1) & 0x7F7F7F7Fu);
}

// Per byte of four: (a + b + c + d + 2) >> 2, MPEG's four-tap rounding,
// in two 16-bit lanes for the even and the odd bytes (at most 1022 each).
__device__ __forceinline__ uint32_t avg4_round(uint32_t a, uint32_t b,
                                               uint32_t c, uint32_t d) {
    const uint32_t m = 0x00FF00FFu;
    const uint32_t ev = (a & m) + (b & m) + (c & m) + (d & m) + 0x00020002u;
    const uint32_t od = ((a >> 8) & m) + ((b >> 8) & m) + ((c >> 8) & m)
                        + ((d >> 8) & m) + 0x00020002u;
    return ((ev >> 2) & m) | (((od >> 2) & m) << 8);
}

// The half-pel prediction of one 8-pixel row, bytes 0-3 in p0 and 4-7 in
// p1: pixel k of the row predicts from columns x0 + k (+1 when ox) of rows
// y0 (and y1 when oy), each already clamped to the plane (CLAMP_TO_EDGE),
// rounded as MPEG-1 does.  `ref` must be 8-byte aligned.
__device__ __forceinline__ void halfpel_row8(const uint8_t* __restrict__ ref,
                                             int w, int y0, int y1, int x0,
                                             bool oy, bool ox, uint32_t& p0,
                                             uint32_t& p1) {
    uint32_t a0, a1, ae;
    window9(ref + (size_t)y0 * w, x0, w, a0, a1, ae);
    if (!oy && !ox) {
        p0 = a0;
        p1 = a1;
        return;
    }
    // b: the same row one column to the right
    const uint32_t b0 = __funnelshift_r(a0, a1, 8);
    const uint32_t b1 = __funnelshift_r(a1, ae, 8);
    if (!oy) {
        p0 = avg2_up(a0, b0);
        p1 = avg2_up(a1, b1);
        return;
    }
    uint32_t c0, c1, ce;
    window9(ref + (size_t)y1 * w, x0, w, c0, c1, ce);
    if (!ox) {
        p0 = avg2_up(a0, c0);
        p1 = avg2_up(a1, c1);
        return;
    }
    const uint32_t d0 = __funnelshift_r(c0, c1, 8);
    const uint32_t d1 = __funnelshift_r(c1, ce, 8);
    p0 = avg4_round(a0, b0, c0, d0);
    p1 = avg4_round(a1, b1, c1, d1);
}

}  // namespace jsvx
