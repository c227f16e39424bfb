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
// first valid triangle.
#include "common.cuh"

#define FL_TRI_CHUNK 64
#define FL_RAY_BLOCK 128

struct fl_ray {
    float f[16];
    float max_len;
};

__device__ __forceinline__ void fl_load_ray(
    int i, const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ max_len, fl_ray& r) {
    float o[3] = {ox[i], oy[i], oz[i]};
    float d[3] = {dx[i], dy[i], dz[i]};
    // zero directions become +z (ops/intersect_kernel.py _prep_soa)
    float norm2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    if (norm2 <= 0.0f) { d[0] = 0.0f; d[1] = 0.0f; d[2] = 1.0f; }
    r.f[0] = 1.0f;
    for (int k = 0; k < 3; ++k) r.f[1 + k] = o[k];
    for (int k = 0; k < 3; ++k) r.f[4 + k] = d[k];
    for (int c = 0; c < 3; ++c)
        for (int k = 0; k < 3; ++k) r.f[7 + 3 * c + k] = d[c] * o[k];
    r.max_len = max_len[i];
}

// Stage rows [c0, c0 + cnt) of W[4, tp, 16] into shared memory.
__device__ __forceinline__ void fl_stage(const float* __restrict__ w4, int tp,
                                         int c0, int cnt,
                                         float (*sw)[FL_TRI_CHUNK][16]) {
    for (int e = threadIdx.x; e < 4 * cnt * 16; e += blockDim.x) {
        int p = e / (cnt * 16);
        int rem = e - p * cnt * 16;
        int t = rem / 16;
        int k = rem - t * 16;
        sw[p][t][k] = w4[((size_t)p * tp + c0 + t) * 16 + k];
    }
}

__device__ __forceinline__ float fl_dot16(const float* w, const float* f) {
    float acc = w[0] * f[0];
    for (int k = 1; k < 16; ++k) acc = acc + w[k] * f[k];
    return acc;
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
    bool active = false;
    if (i < n) {
        fl_load_ray(i, ox, oy, oz, dx, dy, dz, max_len, r);
        active = r.max_len > 0.0f;
    }
    float best_s = FL_POW32, best_u = 0.0f, best_v = 0.0f;
    int best_col = -1;
    if (__syncthreads_or(active)) {
        for (int c0 = 0; c0 < tp; c0 += FL_TRI_CHUNK) {
            int cnt = tp - c0 < FL_TRI_CHUNK ? tp - c0 : FL_TRI_CHUNK;
            fl_stage(w4, tp, c0, cnt, sw);
            __syncthreads();
            if (active) {
                for (int t = 0; t < cnt; ++t) {
                    float det = fl_dot16(sw[0][t], r.f);
                    float udet = fl_dot16(sw[1][t], r.f);
                    float vdet = fl_dot16(sw[2][t], r.f);
                    float sdet = fl_dot16(sw[3][t], r.f);
                    float inv = 1.0f / det;
                    float u = udet * inv;
                    float v = vdet * inv;
                    float s = sdet * inv;
                    bool valid = fabsf(det) >= FL_BIAS;
                    valid = valid && (u >= edge) && (u <= 1.0f);
                    valid = valid && (v >= edge) && (u + v <= 1.0f);
                    valid = valid && (s > FL_BIAS) && (s <= r.max_len);
                    if (valid && s < best_s) {
                        best_s = s;
                        best_u = u;
                        best_v = v;
                        best_col = c0 + t;
                    }
                }
            }
            __syncthreads();
        }
    }
    if (i < n) {
        bool hit = best_col >= 0;
        s_out[i] = hit ? best_s : 0.0f;
        u_out[i] = hit ? best_u : 0.0f;
        v_out[i] = hit ? best_v : 0.0f;
        tri_out[i] = hit ? ids[best_col] : -1;
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
    bool active = false;
    if (i < n) {
        fl_load_ray(i, ox, oy, oz, dx, dy, dz, max_len, r);
        active = r.max_len > 0.0f;
    }
    bool hit = false;
    for (int c0 = 0; c0 < tp; c0 += FL_TRI_CHUNK) {
        // leave together once no ray of the block is still searching
        if (!__syncthreads_or(active && !hit)) break;
        int cnt = tp - c0 < FL_TRI_CHUNK ? tp - c0 : FL_TRI_CHUNK;
        fl_stage(w4, tp, c0, cnt, sw);
        __syncthreads();
        if (active && !hit) {
            for (int t = 0; t < cnt; ++t) {
                float det = fl_dot16(sw[0][t], r.f);
                float udet = fl_dot16(sw[1][t], r.f);
                float vdet = fl_dot16(sw[2][t], r.f);
                float sdet = fl_dot16(sw[3][t], r.f);
                float inv = 1.0f / det;
                float u = udet * inv;
                float v = vdet * inv;
                float s = sdet * inv;
                // front-face culled (glsl:143-158)
                bool valid = det >= FL_BIAS;
                valid = valid && (u >= FL_BIAS) && (u <= 1.0f);
                valid = valid && (v >= FL_BIAS) && (u + v <= 1.0f);
                valid = valid && (s > FL_BIAS) && (s <= r.max_len);
                if (valid) { hit = true; break; }
            }
        }
        __syncthreads();
    }
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
