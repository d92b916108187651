// The launch layout the port's picture kernels share, CUDA C++ for Hopper
// (sm_90a): fused_decode.cu, mc.cu and recon.cu each decode every plane of
// one picture in one launch, with one thread per 8-pixel row of an 8x8
// block, and find their work the same way.
//
//   * A warp covers four 8x8 blocks side by side in one block row:
//     lane = 8 * block + row.  A warp task is such a group of four blocks;
//     a plane's tasks are numbered along block rows, groups = ceil(wb / 4)
//     per row, and the last group of a row may end mid-warp.
//   * A CTA is four warps over four consecutive tasks of one plane.  The
//     planes' CTAs follow one another: plane p's first CTA is the prefix
//     sum of the CTA counts before it, and a CTA finds its plane by that
//     prefix.
//
// The Python side of the same layout is jsvx_torch/kernels/fused.py
// (plane_ctas, picture_layout, plane_of_cta, cta_blocks), which the tests
// hold to cover every block exactly once.

#pragma once

#include <stdint.h>

namespace jsvx {

constexpr int kMaxPlanes = 4;
constexpr int kWarps = 4;                  // warps per CTA
constexpr int kBlocksPerWarp = 4;          // 8x8 blocks side by side
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxTasks = 1 << 22;         // exact float task division

// One plane's place in the launch; set on the host by set_plane_layout.
struct PlaneLayout {
    int h, w, is_chroma, cta_begin, groups;
    float inv_groups;                      // 1 / groups
};

inline int plane_groups(int w) {
    return ((w >> 3) + kBlocksPerWarp - 1) / kBlocksPerWarp;
}

// CTAs of one (h, w) plane: one warp task per four blocks of a block row.
inline int plane_ctas(int h, int w) {
    return ((h >> 3) * plane_groups(w) + kWarps - 1) / kWarps;
}

// Host: plane p of a launch from dims d = (h, w, is_chroma, first CTA).
// The first CTA must equal `begin`, the CTAs of the planes before it;
// `begin` moves past this plane.  False where the plane is not a positive
// multiple of 8 each way, the prefix is wrong or the plane has too many
// tasks for the kernels' index math.
inline bool set_plane_layout(PlaneLayout& L, const int* d, int& begin) {
    const int h = d[0], w = d[1];
    if (h <= 0 || w <= 0 || (h & 7) || (w & 7) || d[3] != begin
            || (long long)plane_ctas(h, w) * kWarps > kMaxTasks) {
        return false;
    }
    L.h = h;
    L.w = w;
    L.is_chroma = d[2];
    L.cta_begin = begin;
    L.groups = plane_groups(w);
    L.inv_groups = 1.0f / (float)L.groups;
    begin += plane_ctas(h, w);
    return true;
}

// The plane of this CTA: the last plane whose first CTA is at or before
// it.  `Plane` is a kernel's plane descriptor with its PlaneLayout in L.
template <class Plane>
__device__ __forceinline__ int cta_plane(const Plane (&planes)[kMaxPlanes],
                                         int n_planes) {
    int p = 0;
#pragma unroll
    for (int i = 1; i < kMaxPlanes; ++i) {
        if (i < n_planes && (int)blockIdx.x >= planes[i].L.cta_begin) p = i;
    }
    return p;
}

// What this thread decodes: row r of block (by, bx), block b of its warp.
struct RowTask {
    int warp, b, r, by, bx;
    bool live;                             // false past the row's last block
};

// This thread's task in plane L.  False where the whole warp lies past the
// plane (it has nothing to do; no lane of it does).
__device__ __forceinline__ bool row_task(const PlaneLayout& L, RowTask& t) {
    t.warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    t.b = lane >> 3;
    t.r = lane & 7;
    // warp task -> block row: task / groups by the reciprocal, corrected
    // by one step (exact: task < kMaxTasks)
    const int groups = L.groups;
    const int task = ((int)blockIdx.x - L.cta_begin) * kWarps + t.warp;
    int by = __float2int_rz(__int2float_rn(task) * L.inv_groups);
    const int rem = task - by * groups;
    by += (rem >= groups) - (rem < 0);
    t.by = by;
    t.bx = (task - by * groups) * kBlocksPerWarp + t.b;
    t.live = t.bx < (L.w >> 3);
    return by < (L.h >> 3);
}

}  // namespace jsvx
