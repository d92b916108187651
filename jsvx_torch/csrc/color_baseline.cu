// Display colour of one frame, the first design, kept beside the
// redesigned kernel (color.cu) so that chip_smoke.py can time the two in
// turns and hold them bit-equal.  Nothing else launches it; it builds
// into the "baselines" library (kernels/build.py).
//
// CUDA C++ for Hopper (sm_90a).
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
// the two are bit-equal.  Per channel r the kernel does the plain
// version's float32 operations in its order, each rounded once (the _rn
// intrinsics, and -fmad=false for the build):
//   s(v) = v / 255 (a true division, as torch divides by a tensor),
//   acc  = ((m[r][0] s(y) + m[r][1] s(cb)) + m[r][2] s(cr)) + off[r],
//   out  = clamp(rint(acc * 255), 0, 255)  (rint: half to even, as
//          torch.round).
// The nine matrix entries and three offsets come from the wrapper by
// value (refmath's float32 YCBCR_TO_RGB and YCBCR_OFFSET): this file
// holds no copy of them.
//
// What bounds it: bytes.  A 1080p display frame (1920x1080) reads 2.07 MB
// of luma and 1.04 MB of chroma and writes 6.22 MB of RGB: 9.33 MB, 2.79 us
// at 3.35 TB/s, less than the 3.66 us an empty launch takes on that card.
// Its arithmetic, about 31 f32 operations a pixel, takes under 1 us at
// 67 TFLOP/s.  The design, simple and exact first:
//   * a thread per run of kRun = 4 consecutive pixels of one output row,
//     a CTA of 32 x 8 threads over 128 pixels of 8 rows (a 2-D grid:
//     columns of runs across, rows down), so a warp reads 128 contiguous
//     luma bytes and 64 of each chroma row, and writes 384 (or 512)
//     contiguous output bytes;
//   * a run shares its two chroma samples of each plane between its pixel
//     pairs;
//   * the 256 values v / 255 are a table in shared memory that each CTA
//     fills first (one division a thread), so a pixel divides nothing;
//   * a whole run loads its luma with one 32-bit load and stores its 12
//     or 16 bytes as 32-bit words where the addresses are 4-byte aligned,
//     and byte by byte otherwise (odd widths, strides and the row's end).
// What it accepts for now: no TMA or wider vectors; the launch floor
// dominates at 1080p anyway.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRun = 4;                    // pixels a thread
constexpr int kBlockX = 32;                // runs a CTA row
constexpr int kBlockY = 8;                 // rows a CTA
constexpr int kThreads = kBlockX * kBlockY;
static_assert(kThreads == 256, "one table entry a thread");

enum AlphaMode { kNoAlpha = 0, kOpaque = 1, kPlane = 2 };

struct ColourArgs {
    const uint8_t* y;
    const uint8_t* cb;
    const uint8_t* cr;
    const uint8_t* a;                      // the alpha plane, or null
    uint8_t* out;                          // (h, w, channels), contiguous
    long long y_stride, cb_stride, cr_stride, a_stride;   // bytes a row
    int h, w;
    float m[9];                            // row-major 3x3
    float off[3];
};

__device__ __forceinline__ uint8_t channel(const ColourArgs& a, int r,
                                           float ys, float cbs, float crs) {
    float acc = __fmul_rn(a.m[3 * r], ys);
    acc = __fadd_rn(acc, __fmul_rn(a.m[3 * r + 1], cbs));
    acc = __fadd_rn(acc, __fmul_rn(a.m[3 * r + 2], crs));
    acc = __fadd_rn(acc, a.off[r]);
    const float v = fminf(fmaxf(rintf(__fmul_rn(acc, 255.f)), 0.f), 255.f);
    return (uint8_t)(int)v;
}

// C output channels; kAlphaPlane: the fourth is read from the alpha plane
// (else 255).  Template parameters, so that the output bytes of a run
// stay in registers.
template <int C, bool kAlphaPlane>
__global__ void __launch_bounds__(kThreads)
colour_frame_kernel(const __grid_constant__ ColourArgs a) {
    __shared__ float s_scale[256];
    const int t = threadIdx.y * kBlockX + threadIdx.x;
    s_scale[t] = __fdiv_rn((float)t, 255.f);
    __syncthreads();

    const int row = blockIdx.y * kBlockY + threadIdx.y;
    const int x0 = (blockIdx.x * kBlockX + threadIdx.x) * kRun;
    if (row >= a.h || x0 >= a.w) return;
    const int n = min(kRun, a.w - x0);     // pixels of this run
    const bool whole = n == kRun;

    uint8_t yv[kRun] = {0, 0, 0, 0};
    const uint8_t* yp = a.y + (long long)row * a.y_stride + x0;
    if (whole && !((uintptr_t)yp & 3)) {
        const uint32_t v = *(const uint32_t*)yp;
#pragma unroll
        for (int k = 0; k < kRun; ++k) yv[k] = (uint8_t)(v >> (8 * k));
    } else {
#pragma unroll
        for (int k = 0; k < kRun; ++k) {
            if (k < n) yv[k] = yp[k];
        }
    }
    // chroma samples x0/2 and x0/2 + 1 (the second only if the run
    // reaches past its first pixel pair)
    const int crow = row >> 1, cx = x0 >> 1;
    const uint8_t* cbp = a.cb + (long long)crow * a.cb_stride + cx;
    const uint8_t* crp = a.cr + (long long)crow * a.cr_stride + cx;
    const float cbs[2] = {s_scale[cbp[0]], n > 2 ? s_scale[cbp[1]] : 0.f};
    const float crs[2] = {s_scale[crp[0]], n > 2 ? s_scale[crp[1]] : 0.f};
    uint8_t av[kRun] = {255, 255, 255, 255};
    if constexpr (kAlphaPlane) {
        const uint8_t* ap = a.a + (long long)row * a.a_stride + x0;
#pragma unroll
        for (int k = 0; k < kRun; ++k) {
            if (k < n) av[k] = ap[k];
        }
    }

    uint8_t o[kRun * C];
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
        const float ys = s_scale[yv[k]];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
            o[k * C + r] = channel(a, r, ys, cbs[k >> 1], crs[k >> 1]);
        }
        if constexpr (C == 4) o[k * C + 3] = av[k];
    }

    uint8_t* op = a.out + ((long long)row * a.w + x0) * C;
    if (whole && !((uintptr_t)op & 3)) {
        uint32_t* ow = (uint32_t*)op;      // kRun * C bytes = C words
#pragma unroll
        for (int j = 0; j < C; ++j) {
            ow[j] = (uint32_t)o[4 * j] | ((uint32_t)o[4 * j + 1] << 8)
                    | ((uint32_t)o[4 * j + 2] << 16)
                    | ((uint32_t)o[4 * j + 3] << 24);
        }
    } else {
#pragma unroll
        for (int i = 0; i < kRun * C; ++i) {
            if (i < n * C) op[i] = o[i];
        }
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
// uint8, contiguous.  h and w at least 1.  Launches on `stream` without
// synchronising and returns the cudaError_t of the launch (0 = success).
extern "C" int jsvx_colour_frame_baseline(const void* const* planes,
                                          const long long* strides, int h,
                                          int w, int alpha_mode,
                                          const float* coeffs, void* out,
                                          int device, void* stream) {
    const long long cw = (w + 1) / 2;
    const long long grid_y = ((long long)h + kBlockY - 1) / kBlockY;
    if (h < 1 || w < 1 || alpha_mode < kNoAlpha || alpha_mode > kPlane
            || grid_y > 65535 || !planes[0] || !planes[1] || !planes[2]
            || !out || !coeffs || (alpha_mode == kPlane) != !!planes[3]
            || strides[0] < w || strides[1] < cw || strides[2] < cw
            || (alpha_mode == kPlane && strides[3] < w)) {
        return (int)cudaErrorInvalidValue;
    }
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
    for (int i = 0; i < 9; ++i) a.m[i] = coeffs[i];
    for (int i = 0; i < 3; ++i) a.off[i] = coeffs[9 + i];
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int runs = (w + kRun - 1) / kRun;
    const dim3 grid((runs + kBlockX - 1) / kBlockX, (unsigned)grid_y);
    const dim3 block(kBlockX, kBlockY);
    cudaStream_t st = (cudaStream_t)stream;
    if (alpha_mode == kNoAlpha) {
        colour_frame_kernel<3, false><<<grid, block, 0, st>>>(a);
    } else if (alpha_mode == kOpaque) {
        colour_frame_kernel<4, false><<<grid, block, 0, st>>>(a);
    } else {
        colour_frame_kernel<4, true><<<grid, block, 0, st>>>(a);
    }
    return (int)cudaGetLastError();
}
