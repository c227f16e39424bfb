// Closest hit and any hit of a ray wavefront against a dense triangle list.
//
// Replaces: flexlight_tpu/ops/intersect_kernel.py `_kernel` (launched by
// `_intersect_ft`, entry points traverse_kernel(_soa) / shadow_kernel(_soa)).
// Same arithmetic: Moeller-Trumbore in its bilinear form, four 16-term dot
// products per (ray, triangle) of the constant rows W[4, T, 16]
// (det, u*det, v*det, s*det; ops/intersect_kernel.py tri_rows) with the ray
// features f = [1, o, d, d (x) o], then the same accept window. Plain FP32,
// no bf16 limbs, no TF32. A strict `<` over triangles in ascending column
// order keeps the lowest column on ties, like the TPU kernel's argmin.
//
// What bounds it on the H100: arithmetic. A ray reads 28 bytes and writes
// 16, and does 64 multiply-adds per triangle; the triangle rows are the
// same for every ray. The design keeps the rows in shared memory (chunks
// of FL_TRI_CHUNK triangles, 16 KB, read as warp-wide broadcasts) and the
// ray features in registers, so the loop is pure FP32 math with no global
// traffic. The TPU's flag prepass, octant sort and ray/triangle tiles are
// MXU scheduling and are left out: a ray that is dead (max_len 0) can hit
// nothing and exits at once, and an any-hit ray leaves the loop at its
// first valid triangle. The traversal itself (fl_block_closest /
// fl_block_any) lives in trace.cuh, which PRE (fused.cu) shares.
#include "trace.cuh"

#define FL_RAY_BLOCK 128

__device__ __forceinline__ bool fl_load_ray(
    int i, const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ max_len, fl_ray& r) {
    fl_make_ray(fl_make3(ox[i], oy[i], oz[i]), fl_make3(dx[i], dy[i], dz[i]),
                max_len[i], r);
    return r.max_len > 0.0f;
}

__global__ void fl_closest_hit_kernel(
    const float* __restrict__ w4, int tp, const int* __restrict__ ids,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ max_len, float edge, int n,
    float* __restrict__ s_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ tri_out) {
    __shared__ float sw[4][FL_TRI_CHUNK][16];
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    fl_ray r;
    bool active = i < n && fl_load_ray(i, ox, oy, oz, dx, dy, dz, max_len, r);
    fl_hit h = fl_block_closest(w4, tp, sw, active, r, edge);
    if (i < n) {
        s_out[i] = h.s;
        u_out[i] = h.u;
        v_out[i] = h.v;
        tri_out[i] = h.col >= 0 ? ids[h.col] : -1;
    }
}

__global__ void fl_any_hit_kernel(
    const float* __restrict__ w4, int tp,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ max_len, int n, uint8_t* __restrict__ hit_out) {
    __shared__ float sw[4][FL_TRI_CHUNK][16];
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    fl_ray r;
    bool active = i < n && fl_load_ray(i, ox, oy, oz, dx, dy, dz, max_len, r);
    bool hit = fl_block_any(w4, tp, sw, active, r);
    if (i < n) hit_out[i] = hit ? 1 : 0;
}

FL_EXPORT int fl_closest_hit(const float* w4, int tp, const int* ids,
                             const float* ox, const float* oy, const float* oz,
                             const float* dx, const float* dy, const float* dz,
                             const float* max_len, float edge, int n,
                             float* s_out, float* u_out, float* v_out,
                             int* tri_out, void* stream) {
    if (n <= 0) return 0;
    FL_LAUNCH(fl_closest_hit_kernel, n, FL_RAY_BLOCK, stream, w4, tp, ids, ox,
              oy, oz, dx, dy, dz, max_len, edge, n, s_out, u_out, v_out,
              tri_out);
}

FL_EXPORT int fl_any_hit(const float* w4, int tp, const float* ox,
                         const float* oy, const float* oz, const float* dx,
                         const float* dy, const float* dz,
                         const float* max_len, int n, uint8_t* hit_out,
                         void* stream) {
    if (n <= 0) return 0;
    FL_LAUNCH(fl_any_hit_kernel, n, FL_RAY_BLOCK, stream, w4, tp, ox, oy, oz,
              dx, dy, dz, max_len, n, hit_out);
}
