// Display colour of one frame, CUDA C++ for Hopper (sm_90a).
//
// It computes what the JAX package compiles as one program and the
// Player calls once per displayed frame (jsvx/api/player.py, _to_rgb):
// jsvx/kernels/color.py::ycbcr_to_rgb_jit (ycbcr_to_rgb_jax, XLA ops with
// no Pallas kernel).  From a uint8 Y plane (h, w) and Cb, Cr planes
// covering (ceil(h/2), ceil(w/2)), each with its own row stride, it writes
// a contiguous uint8 (h, w, C) image: nearest 2x chroma upsample, scale to
// [0, 1], the BT.601 matrix plus offset, round(x * 255) half to even,
// clamp to [0, 255]; C = 3, or C = 4 with an opaque 255 or a uint8 alpha
// plane (its own stride) as the fourth channel.
//
// The plain version is jsvx_torch/kernels/color.py::ycbcr_to_rgb_plain;
// the two are bit-equal.  Per channel r the plain version computes, in
// float32, each operation rounded once:
//   s(v) = v / 255 (a true division, as torch divides by a tensor),
//   acc  = ((m[r][0] s(y) + m[r][1] s(cb)) + m[r][2] s(cr)) + off[r],
//   out  = clamp(rint(acc * 255), 0, 255)  (rint: half to even).
// The kernel gets the same bits with fewer instructions (-fmad=false for
// the build; every fma below is written out):
//   * v as a float: the byte put into the low mantissa bits of 2^23 (one
//     byte permute), minus 2^23: exact;
//   * s(v): q = RN(v r) with r = RN(1/255), then RN(q + RN(v - 255 q) r)
//     by two fmas.  For each of the 256 bytes this is the correctly
//     rounded quotient (tests/test_torch_color_plan.py checks all 256 in
//     exact rational arithmetic), so no division and no table;
//   * m[r][1] s(cb) and m[r][2] s(cr) once per chroma sample, for its
//     four pixels;
//   * clamp(rint(acc * 255), 0, 255) as rint(sat(acc) * 255): the offset
//     add saturates to [0, 1] (add.rn.sat.f32).  rint is monotonic and
//     keeps 0 and 255, and RN(255 x) is 255 at x = 1, so the byte is the
//     same.  The rint is an add of 1.5 * 2^23, rounded half to even; the
//     sum's low byte is the result, so no float-to-integer conversion.
// The nine matrix entries and three offsets come from the wrapper by
// value (refmath's float32 YCBCR_TO_RGB and YCBCR_OFFSET): this file
// holds no copy of them.
//
// What bounds it: bytes.  A 1080p display frame (1920x1080) reads 2.07 MB
// of luma and 1.04 MB of chroma and writes 6.22 MB of RGB: 9.33 MB, 2.79 us
// at 3.35 TB/s, less than the 3.66 us an empty launch takes on that card.
// Without fma contraction a pixel still takes about 33 instructions (the
// three channels' adds, multiplies and rint, the scaling, the packing),
// some 2 us of issue over 132 SMs: near the byte bound, so the arithmetic
// has to overlap the memory traffic for the bytes to bound it.
//
// The design.  What the first design (PR 12's kernel) spent its time on,
// and what this one does instead:
//   1. per-CTA setup before the first load (a 256-entry table of v / 255
//      and a barrier in each of 2,025 CTAs): no table, no barrier; a
//      thread's first instructions are its loads;
//   2. little in flight (a 32-bit luma load and byte chroma loads a
//      thread, each feeding a table lookup): a thread takes 16 columns
//      and loads them with one 16-byte load a luma (and alpha) row and one
//      8-byte load a chroma row;
//   3. chroma read twice (once by each luma row's thread): the unit is a
//      luma row pair over a segment of the width (the fewest equal
//      segments of at most kMaxSeg = 512 pixels, each a multiple of 32
//      wide so that its start keeps its row's alignment: 480 at 1920
//      wide), and a thread computes its 16 columns of both rows from the
//      8 chroma samples under them, loaded once;
//   4. narrow, misaligned stores (12 bytes a thread at a 12-byte pitch):
//      the warp stages its segment of both rows in shared memory (16-
//      byte stores at a 48-byte pitch, no bank conflict for C = 3) and
//      writes them out as 16-byte stores from consecutive lanes, 512
//      contiguous bytes a warp instruction.
// A CTA is one warp and one unit: it loads, computes, stages and stores
// with no barrier but __syncwarp, and the grid is one CTA a unit (2,160
// at 1080p, about 16 a SM, all resident at once), so one warp's
// arithmetic overlaps other warps' loads and stores.  Tried on the card:
// persistent CTAs walking row pairs through a shared-memory ring behind
// CTA-wide barriers ran slower than the first design (every CTA in
// step); CTAs walking several units ran slower; CTAs of four warps, one
// unit each, ran no faster than one warp.  Between builds of the same
// work, nvcc's schedule of the body moves the time by a few per cent.
// The plan (kernels/color.py::launch_plan) says which loads and stores
// are vector ones: a plane whose base and row stride are multiples of
// 16, and the output where its base and row length (w C) are; the rest,
// and a row's last partial 16 columns, go byte by byte.  Every case
// stays in the kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;               // threads a CTA: one warp
constexpr int kCols = 16;                  // luma columns a thread
constexpr int kItems = kCols / 4;          // chroma sample pairs a thread
constexpr int kChromaWords = kCols / 8;    // words of a chroma row a thread
constexpr int kMaxSeg = kThreads * kCols;  // luma columns a unit
// plan flags: 16-byte loads of a plane (8-byte for the chroma), 16-byte
// stores of the output rows
constexpr int kVecY = 1, kVecCb = 2, kVecCr = 4, kVecA = 8, kVecOut = 16;
// RN(1 / 255) as a float
constexpr float kRecip255 = 0x1.010102p-8f;

enum AlphaMode { kNoAlpha = 0, kOpaque = 1, kPlane = 2 };

struct ColourArgs {
    const uint8_t* y;
    const uint8_t* cb;
    const uint8_t* cr;
    const uint8_t* a;                      // the alpha plane, or null
    uint8_t* out;                          // (h, w, channels), contiguous
    long long y_stride, cb_stride, cr_stride, a_stride;   // bytes a row
    int h, w;
    int seg_w, n_segs, flags;              // the launch plan
    float m[9];                            // row-major 3x3
    float off[3];
};

struct Unit {
    int row0, rows, x0, n;                 // luma rows row0.., columns x0..
};

__device__ __forceinline__ Unit unit_at(const ColourArgs& a, int u) {
    const int p = u / a.n_segs;
    Unit t;
    t.row0 = 2 * p;
    t.rows = min(2, a.h - t.row0);
    t.x0 = (u - p * a.n_segs) * a.seg_w;
    t.n = min(a.seg_w, a.w - t.x0);
    return t;
}

// The first n of N consecutive bytes at p, byte k in byte k & 3 of word
// k >> 2 (the rest 0): one N-byte load where vec and n == N (p is then
// N-byte aligned), else byte loads.
template <int N>
__device__ __forceinline__ void load_bytes(uint32_t (&w)[N / 4],
                                           const uint8_t* p, int n,
                                           bool vec) {
    if (vec && n == N) {
        if constexpr (N == 16) {
            const uint4 v = __ldg((const uint4*)p);
            w[0] = v.x;
            w[1] = v.y;
            w[2] = v.z;
            w[3] = v.w;
        } else {
            const uint2 v = __ldg((const uint2*)p);
            w[0] = v.x;
            w[1] = v.y;
        }
        return;
    }
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
        uint32_t x = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            if (4 * i + k < n) x |= (uint32_t)__ldg(p + 4 * i + k) << (8 * k);
        }
        w[i] = x;
    }
}

// s(v) = RN(v / 255) of byte k of word (see the note at the top).
__device__ __forceinline__ float scaled(uint32_t word, int k) {
    const float f = __uint_as_float(__byte_perm(word, 0x4B000000u,
                                                0x7650 | k));
    const float v = __fsub_rn(f, 8388608.f);
    const float q = __fmul_rn(v, kRecip255);
    const float e = __fmaf_rn(-q, 255.f, v);
    return __fmaf_rn(e, kRecip255, q);
}

__device__ __forceinline__ float add_sat(float x, float y) {
    float r;
    asm("add.rn.sat.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
    return r;
}

// One channel of a pixel: its byte in the low byte of the result.
__device__ __forceinline__ uint32_t channel(const ColourArgs& a, int r,
                                            float ys, float pcb, float pcr) {
    float acc = __fmul_rn(a.m[3 * r], ys);
    acc = __fadd_rn(acc, pcb);
    acc = __fadd_rn(acc, pcr);
    acc = add_sat(acc, a.off[r]);
    return __float_as_uint(__fadd_rn(__fmul_rn(acc, 255.f), 12582912.f));
}

// The low bytes of b0..b3 as one word, b0 first.
__device__ __forceinline__ uint32_t pack4(uint32_t b0, uint32_t b1,
                                          uint32_t b2, uint32_t b3) {
    return __byte_perm(__byte_perm(b0, b1, 0x0040),
                       __byte_perm(b2, b3, 0x0040), 0x5410);
}

// A thread's kCols columns of both rows of a unit, into its staging bytes
// (st: row 0, st + kMaxSeg * C: row 1): kItems items, each a pair of
// chroma samples and the four columns of both rows under it.
template <int C, bool kAlphaPlane>
__device__ __forceinline__ void colour_thread(
        const ColourArgs& a, const uint32_t (&yw)[2][kItems],
        const uint32_t (&cbw)[kChromaWords],
        const uint32_t (&crw)[kChromaWords],
        const uint32_t (&aw)[2][kItems], uint8_t* st) {
    uint32_t o[2][kItems * C];             // per row: kCols pixels, C bytes
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
        float pcb[2][3], pcr[2][3];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const int k = 2 * (q & 1) + c;
            const float scb = scaled(cbw[q >> 1], k);
            const float scr = scaled(crw[q >> 1], k);
#pragma unroll
            for (int r = 0; r < 3; ++r) {
                pcb[c][r] = __fmul_rn(a.m[3 * r + 1], scb);
                pcr[c][r] = __fmul_rn(a.m[3 * r + 2], scr);
            }
        }
#pragma unroll
        for (int row = 0; row < 2; ++row) {
            uint32_t px[4][3];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const float ys = scaled(yw[row][q], k);
#pragma unroll
                for (int r = 0; r < 3; ++r) {
                    px[k][r] = channel(a, r, ys, pcb[k >> 1][r],
                                       pcr[k >> 1][r]);
                }
            }
            if constexpr (C == 3) {
                o[row][3 * q] = pack4(px[0][0], px[0][1], px[0][2], px[1][0]);
                o[row][3 * q + 1] = pack4(px[1][1], px[1][2], px[2][0],
                                          px[2][1]);
                o[row][3 * q + 2] = pack4(px[2][2], px[3][0], px[3][1],
                                          px[3][2]);
            } else {
                const uint32_t al = kAlphaPlane ? aw[row][q] : 0xFFFFFFFFu;
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    o[row][4 * q + k] = __byte_perm(
                        __byte_perm(px[k][0], px[k][1], 0x0040),
                        __byte_perm(px[k][2], al, (4 + k) << 4), 0x5410);
                }
            }
        }
    }
#pragma unroll
    for (int row = 0; row < 2; ++row) {
        uint4* d = (uint4*)(st + row * kMaxSeg * C);
#pragma unroll
        for (int i = 0; i < kItems * C / 4; ++i) {
            d[i] = make_uint4(o[row][4 * i], o[row][4 * i + 1],
                              o[row][4 * i + 2], o[row][4 * i + 3]);
        }
    }
}

// C output channels; kAlphaPlane: the fourth is read from the alpha plane
// (else 255).  CTA b takes unit b, lane l its columns 16 l .. 16 l + 15.
template <int C, bool kAlphaPlane>
__global__ void __launch_bounds__(kThreads)
colour_frame_kernel(const __grid_constant__ ColourArgs a) {
    __shared__ __align__(16) uint8_t stage[2][kMaxSeg * C];
    const int lane = threadIdx.x;
    const Unit t = unit_at(a, blockIdx.x);
    const int x = t.x0 + lane * kCols;     // the lane's first column
    const int tn = max(0, min(kCols, t.x0 + t.n - x));
    if (tn > 0) {
        uint32_t yw[2][kItems] = {}, aw[2][kItems] = {};
        uint32_t cbw[kChromaWords], crw[kChromaWords];
        const bool vy = a.flags & kVecY, va = a.flags & kVecA;
        const uint8_t* yp = a.y + (long long)t.row0 * a.y_stride + x;
        load_bytes<kCols>(yw[0], yp, tn, vy);
        if (t.rows > 1) load_bytes<kCols>(yw[1], yp + a.y_stride, tn, vy);
        const long long crow = t.row0 >> 1;
        const int cn = (tn + 1) >> 1;
        load_bytes<kCols / 2>(cbw, a.cb + crow * a.cb_stride + (x >> 1), cn,
                              a.flags & kVecCb);
        load_bytes<kCols / 2>(crw, a.cr + crow * a.cr_stride + (x >> 1), cn,
                              a.flags & kVecCr);
        if constexpr (kAlphaPlane) {
            const uint8_t* ap = a.a + (long long)t.row0 * a.a_stride + x;
            load_bytes<kCols>(aw[0], ap, tn, va);
            if (t.rows > 1) load_bytes<kCols>(aw[1], ap + a.a_stride, tn, va);
        }
        colour_thread<C, kAlphaPlane>(a, yw, cbw, crw, aw,
                                      &stage[0][lane * kCols * C]);
    }
    __syncwarp();
    // the staged rows out: 16-byte stores where the plan allows (every
    // such row start is then 16-byte aligned), else bytes
    const int nb = t.n * C;
    for (int r = 0; r < t.rows; ++r) {
        uint8_t* dst = a.out + ((long long)(t.row0 + r) * a.w + t.x0) * C;
        const uint8_t* src = stage[r];
        int i0 = 0;
        if (a.flags & kVecOut) {
            const int chunks = nb >> 4;
            for (int i = lane; i < chunks; i += 32) {
                ((uint4*)dst)[i] = ((const uint4*)src)[i];
            }
            i0 = chunks << 4;
        }
        for (int i = i0 + lane; i < nb; i += 32) dst[i] = src[i];
    }
}

}  // namespace

// Plain C entry point (bound with ctypes): the colour of one frame in one
// launch.  planes = y, cb, cr, alpha (device pointers; alpha non-null only
// for alpha_mode 2), strides = their row strides in bytes (y's and
// alpha's at least w, the chroma's at least ceil(w/2); the planes cover
// h x w, the chroma ceil(h/2) x ceil(w/2)); alpha_mode 0 writes 3
// channels, 1 four with alpha 255, 2 four with the alpha plane; coeffs =
// 12 floats in host memory (the 3x3 matrix row-major, then the 3
// offsets), copied into the launch's arguments; out = (h, w, channels)
// uint8, contiguous; plan = 2 ints from kernels/color.py::launch_plan,
// which owns the alignment decisions: the segment width (a multiple of
// 32, at most kMaxSeg) and the flags (kVec*: set only where the flagged
// plane's base and stride, and for kVecOut the output's base and
// w * channels, are multiples of 16).  One CTA a unit: ceil(h / 2) row
// pairs times the segments of a row.  h and w at least 1.  Launches on
// `stream` without synchronising and returns the cudaError_t of the
// launch (0 = success).
extern "C" int jsvx_colour_frame(const void* const* planes,
                                 const long long* strides, int h, int w,
                                 int alpha_mode, const float* coeffs,
                                 void* out, const int* plan, int device,
                                 void* stream) {
    const long long cw = (w + 1) / 2;
    if (h < 1 || w < 1 || alpha_mode < kNoAlpha || alpha_mode > kPlane
            || !planes[0] || !planes[1] || !planes[2] || !out || !coeffs
            || !plan || (alpha_mode == kPlane) != !!planes[3]
            || strides[0] < w || strides[1] < cw || strides[2] < cw
            || (alpha_mode == kPlane && strides[3] < w)) {
        return (int)cudaErrorInvalidValue;
    }
    const int seg_w = plan[0], flags = plan[1];
    if (seg_w < 32 || seg_w > kMaxSeg || seg_w % 32
            || (flags & ~(kVecY | kVecCb | kVecCr | kVecA | kVecOut))
            || ((flags & kVecA) && alpha_mode != kPlane)) {
        return (int)cudaErrorInvalidValue;
    }
    const int n_segs = (w + seg_w - 1) / seg_w;
    const long long units = (long long)((h + 1) / 2) * n_segs;
    if (units > 0x7fffffff) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)units;   // one CTA a unit
    ColourArgs a = {};
    a.y = (const uint8_t*)planes[0];
    a.cb = (const uint8_t*)planes[1];
    a.cr = (const uint8_t*)planes[2];
    a.a = (const uint8_t*)planes[3];
    a.out = (uint8_t*)out;
    a.y_stride = strides[0];
    a.cb_stride = strides[1];
    a.cr_stride = strides[2];
    a.a_stride = strides[3];
    a.h = h;
    a.w = w;
    a.seg_w = seg_w;
    a.n_segs = n_segs;
    a.flags = flags;
    for (int i = 0; i < 9; ++i) a.m[i] = coeffs[i];
    for (int i = 0; i < 3; ++i) a.off[i] = coeffs[9 + i];
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = (cudaStream_t)stream;
    if (alpha_mode == kNoAlpha) {
        colour_frame_kernel<3, false><<<grid, kThreads, 0, st>>>(a);
    } else if (alpha_mode == kOpaque) {
        colour_frame_kernel<4, false><<<grid, kThreads, 0, st>>>(a);
    } else {
        colour_frame_kernel<4, true><<<grid, kThreads, 0, st>>>(a);
    }
    return (int)cudaGetLastError();
}
