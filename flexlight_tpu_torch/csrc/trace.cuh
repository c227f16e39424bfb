// Per-ray path-tracing arithmetic shared by the traversal kernels
// (intersect.cu) and the fused per-bounce kernels (fused.cu).
//
// Every function takes the float operations of its plain PyTorch
// counterpart in the same order, so that with --fmad=false (and
// -ffp-contract=off on the host) the kernels round exactly as the plain
// versions do:
//   vec3 helpers        ops/vec3.py
//   both noise hashes   ops/rng.py (noise4, noise4_counter)
//   the BRDF            ops/brdf.py (forward_trace_soa)
//   Moeller-Trumbore    ops/intersect_kernel.py (bilinear form, W[4, T, 16]),
//                       which the sparse worklist kernels (sparse.cu) share
// Constants are the float32 roundings of the Python doubles that torch
// casts them from, written as (float)<double>.
#pragma once

#include <string.h>

#include "common.cuh"

#define FL_TINY ((float)1e-30)
#define FL_PI ((float)3.141592653589793)
#define FL_INV_PI ((float)0.3183098861837907)
#define FL_PHI ((float)1.61803398874989484820459)
#define FL_TRI_CHUNK 64

// ---- comparisons as torch takes them (NaN propagates) ---------------------

// torch.clamp_min(x, lo)
__device__ __forceinline__ float fl_clamp_min(float x, float lo) {
    return x < lo ? lo : x;
}

// torch.clamp(x, lo, hi)
__device__ __forceinline__ float fl_clamp(float x, float lo, float hi) {
    if (x != x) return x;
    x = x < lo ? lo : x;
    return x > hi ? hi : x;
}

// torch.maximum / torch.minimum
__device__ __forceinline__ float fl_maximum(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return a > b ? a : b;
}

__device__ __forceinline__ float fl_minimum(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return a < b ? a : b;
}

// torch.sign: +0 for +-0 and NaN
__device__ __forceinline__ float fl_sign(float a) {
    return (float)((0.0f < a) - (a < 0.0f));
}

// ---- vec3 (ops/vec3.py) ------------------------------------------------

struct fl_v3 {
    float x, y, z;
};

__device__ __forceinline__ fl_v3 fl_make3(float x, float y, float z) {
    fl_v3 r;
    r.x = x;
    r.y = y;
    r.z = z;
    return r;
}

__device__ __forceinline__ fl_v3 fl_load3(const float* p, int stride, int i) {
    return fl_make3(p[i], p[stride + i], p[2 * (size_t)stride + i]);
}

__device__ __forceinline__ void fl_store3(float* p, int stride, int i, fl_v3 v) {
    p[i] = v.x;
    p[stride + i] = v.y;
    p[2 * (size_t)stride + i] = v.z;
}

__device__ __forceinline__ fl_v3 fl_add3(fl_v3 a, fl_v3 b) {
    return fl_make3(a.x + b.x, a.y + b.y, a.z + b.z);
}

__device__ __forceinline__ fl_v3 fl_sub3(fl_v3 a, fl_v3 b) {
    return fl_make3(a.x - b.x, a.y - b.y, a.z - b.z);
}

__device__ __forceinline__ fl_v3 fl_mul3(fl_v3 a, fl_v3 b) {
    return fl_make3(a.x * b.x, a.y * b.y, a.z * b.z);
}

__device__ __forceinline__ fl_v3 fl_scale3(fl_v3 a, float s) {
    return fl_make3(a.x * s, a.y * s, a.z * s);
}

__device__ __forceinline__ fl_v3 fl_neg3(fl_v3 a) { return fl_make3(-a.x, -a.y, -a.z); }

__device__ __forceinline__ float fl_dot3(fl_v3 a, fl_v3 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ fl_v3 fl_cross3(fl_v3 a, fl_v3 b) {
    return fl_make3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ float fl_norm3(fl_v3 a) { return sqrtf(fl_dot3(a, a)); }

__device__ __forceinline__ fl_v3 fl_normalize3(fl_v3 a) {
    float inv = 1.0f / fl_clamp_min(fl_norm3(a), FL_TINY);
    return fl_scale3(a, inv);
}

__device__ __forceinline__ fl_v3 fl_mix3(fl_v3 a, fl_v3 b, float t) {
    return fl_make3(a.x + (b.x - a.x) * t, a.y + (b.y - a.y) * t, a.z + (b.z - a.z) * t);
}

__device__ __forceinline__ fl_v3 fl_where3(bool m, fl_v3 a, fl_v3 b) { return m ? a : b; }

// m: 9 entries row-major; returns m @ v
__device__ __forceinline__ fl_v3 fl_matvec3(const float* m, fl_v3 v) {
    return fl_make3(m[0] * v.x + m[1] * v.y + m[2] * v.z,
                    m[3] * v.x + m[4] * v.y + m[5] * v.z,
                    m[6] * v.x + m[7] * v.y + m[8] * v.z);
}

// ---- noise (ops/rng.py) --------------------------------------------------

__device__ __forceinline__ float fl_fract(float x) { return x - floorf(x); }

// The GLSL hash: outputs c0 <= c < c1 of noise4(n0, n1, seed, random_seed).
__device__ __forceinline__ void fl_noise_hash(float n0, float n1, float seed,
                                              float random_seed, int c0, int c1,
                                              float* out) {
    const float offs[4] = {53.0f, 59.0f, 61.0f, 67.0f};
    float d = n0 * (float)12.9898 + n1 * (float)78.233;
    float t = seed + random_seed * FL_PHI;
    for (int c = c0; c < c1; ++c)
        out[c] = fl_fract(sinf(d + offs[c] * t) * (float)43758.5453) * 2.0f - 1.0f;
}

__device__ __forceinline__ uint32_t fl_mix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}

__device__ __forceinline__ uint32_t fl_bits(float x) {
    uint32_t u;
    memcpy(&u, &x, sizeof(u));
    return u;
}

// The counter hash: outputs c0 <= c < c1 of noise4_counter.
__device__ __forceinline__ void fl_noise_counter(float n0, float n1, float seed,
                                                 float random_seed, int c0, int c1,
                                                 float* out) {
    const uint32_t keys[4] = {0x9E3779B9u, 0x7F4A7C15u, 0x94D049BBu, 0xBF58476Du};
    uint32_t h = fl_mix32(fl_bits(n0));
    h = fl_mix32(h ^ fl_bits(n1));
    h = fl_mix32(h ^ fl_bits(seed));
    h = fl_mix32(h ^ fl_bits(random_seed));
    for (int c = c0; c < c1; ++c) {
        uint32_t u = fl_mix32(h ^ keys[c]) >> 8;
        out[c] = (float)u * (float)(1.0 / 8388608.0) - 1.0f;
    }
}

__device__ __forceinline__ void fl_noise(bool counter, float n0, float n1, float seed,
                                         float random_seed, int c0, int c1, float* out) {
    if (counter)
        fl_noise_counter(n0, n1, seed, random_seed, c0, c1, out);
    else
        fl_noise_hash(n0, n1, seed, random_seed, c0, c1, out);
}

// ---- BRDF (ops/brdf.py) -------------------------------------------------

__device__ __forceinline__ float fl_pow5(float x) {
    float x2 = x * x;
    return x * (x2 * x2);
}

__device__ __forceinline__ float fl_trowbridge_reitz(float alpha, float n_dot_h) {
    float num = alpha * alpha;
    float denom = n_dot_h * n_dot_h * (num - 1.0f) + 1.0f;
    return num / fl_clamp_min(FL_PI * denom * denom, FL_BIAS);
}

__device__ __forceinline__ float fl_schlick_beckmann(float alpha, float n_dot_x) {
    float k = alpha * 0.5f;
    float denom = fl_clamp_min(n_dot_x * (1.0f - k) + k, FL_BIAS);
    return n_dot_x / denom;
}

// Direct light of one light (glsl:304-334): light_dir unnormalized toward
// the light, n the shading normal, v the unit vector toward the viewer.
__device__ __forceinline__ fl_v3 fl_forward_trace(fl_v3 albedo, float rough, float metal,
                                                  fl_v3 light_dir, float strength,
                                                  fl_v3 n, fl_v3 v) {
    float len_p1 = 1.0f + fl_norm3(light_dir);
    float brightness = strength / (len_p1 * len_p1);
    fl_v3 l = fl_normalize3(light_dir);
    fl_v3 h = fl_normalize3(fl_add3(v, l));
    float v_dot_h = fl_clamp_min(fl_dot3(v, h), 0.0f);
    float n_dot_l = fl_clamp_min(fl_dot3(n, l), 0.0f);
    float n_dot_h = fl_clamp_min(fl_dot3(n, h), 0.0f);
    float n_dot_v = fl_clamp_min(fl_dot3(n, v), 0.0f);
    float alpha = rough * rough;
    float brdf = 1.0f + (n_dot_v - 1.0f) * metal;
    float one_m_theta5 = fl_pow5(1.0f - v_dot_h);
    float ct = (fl_trowbridge_reitz(alpha, n_dot_h)
                * (fl_schlick_beckmann(alpha, n_dot_v) * fl_schlick_beckmann(alpha, n_dot_l)))
               / fl_clamp_min(4.0f * n_dot_v * n_dot_l, FL_BIAS);
    float gain = n_dot_l * brightness;
    float c[3] = {albedo.x, albedo.y, albedo.z};
    float out[3];
    for (int k = 0; k < 3; ++k) {
        float f0 = c[k] * brdf;
        float ks = f0 + (1.0f - f0) * one_m_theta5;
        float kd = (1.0f - ks) * (1.0f - metal);
        out[k] = (kd * c[k] * FL_INV_PI + ks * ct) * gain;
    }
    return fl_make3(out[0], out[1], out[2]);
}

// ---- Moeller-Trumbore, bilinear form (ops/intersect_kernel.py) ----------

struct fl_ray {
    float f[16];
    float max_len;
};

// f = [1, o, d, vec(d (x) o)]; a zero direction becomes +z (_safe_dirs).
__device__ __forceinline__ void fl_make_ray(fl_v3 o3, fl_v3 d3, float max_len, fl_ray& r) {
    float o[3] = {o3.x, o3.y, o3.z};
    float d[3] = {d3.x, d3.y, d3.z};
    float norm2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    if (norm2 <= 0.0f) { d[0] = 0.0f; d[1] = 0.0f; d[2] = 1.0f; }
    r.f[0] = 1.0f;
    for (int k = 0; k < 3; ++k) r.f[1 + k] = o[k];
    for (int k = 0; k < 3; ++k) r.f[4 + k] = d[k];
    for (int c = 0; c < 3; ++c)
        for (int k = 0; k < 3; ++k) r.f[7 + 3 * c + k] = d[c] * o[k];
    r.max_len = max_len;
}

// Stage rows [c0, c0 + cnt) of W[4, tp, 16] into shared memory.
__device__ __forceinline__ void fl_stage(const float* __restrict__ w4, int tp, int c0,
                                         int cnt, float (*sw)[FL_TRI_CHUNK][16]) {
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

// The two-sided closest-hit test of staged triangle t against ray r
// (ops/intersect_kernel.py closest_hit_plain): s, u, v and whether the
// accept window takes it; `edge` is the u/v window's lower edge (-BIAS on
// primary casts, BIAS otherwise).
__device__ __forceinline__ bool fl_mt_closest(float (*sw)[FL_TRI_CHUNK][16], int t,
                                              const fl_ray& r, float edge, float& s,
                                              float& u, float& v) {
    float det = fl_dot16(sw[0][t], r.f);
    float udet = fl_dot16(sw[1][t], r.f);
    float vdet = fl_dot16(sw[2][t], r.f);
    float sdet = fl_dot16(sw[3][t], r.f);
    float inv = 1.0f / det;
    u = udet * inv;
    v = vdet * inv;
    s = sdet * inv;
    bool valid = fabsf(det) >= FL_BIAS;
    valid = valid && (u >= edge) && (u <= 1.0f);
    valid = valid && (v >= edge) && (u + v <= 1.0f);
    return valid && (s > FL_BIAS) && (s <= r.max_len);
}

// The front-face-culled any-hit test of staged triangle t (glsl:143-158,
// ops/intersect_kernel.py any_hit_plain).
__device__ __forceinline__ bool fl_mt_any(float (*sw)[FL_TRI_CHUNK][16], int t,
                                          const fl_ray& r) {
    float det = fl_dot16(sw[0][t], r.f);
    float udet = fl_dot16(sw[1][t], r.f);
    float vdet = fl_dot16(sw[2][t], r.f);
    float sdet = fl_dot16(sw[3][t], r.f);
    float inv = 1.0f / det;
    float u = udet * inv;
    float v = vdet * inv;
    float s = sdet * inv;
    bool valid = det >= FL_BIAS;
    valid = valid && (u >= FL_BIAS) && (u <= 1.0f);
    valid = valid && (v >= FL_BIAS) && (u + v <= 1.0f);
    return valid && (s > FL_BIAS) && (s <= r.max_len);
}

struct fl_hit {
    float s, u, v;
    int col;  // triangle column, -1 on a miss
};

// Closest hit over all tp triangles: every thread of the block calls it
// (the triangle rows pass through shared memory in chunks); only threads
// with `want` cast. Ties in s go to the lowest column. On a miss s, u, v
// are 0 and col is -1.
__device__ __forceinline__ fl_hit fl_block_closest(const float* __restrict__ w4, int tp,
                                                   float (*sw)[FL_TRI_CHUNK][16], bool want,
                                                   const fl_ray& r, float edge) {
    float best_s = FL_POW32, best_u = 0.0f, best_v = 0.0f;
    int best_col = -1;
    if (__syncthreads_or(want)) {
        for (int c0 = 0; c0 < tp; c0 += FL_TRI_CHUNK) {
            int cnt = tp - c0 < FL_TRI_CHUNK ? tp - c0 : FL_TRI_CHUNK;
            fl_stage(w4, tp, c0, cnt, sw);
            __syncthreads();
            if (want) {
                for (int t = 0; t < cnt; ++t) {
                    float s, u, v;
                    if (fl_mt_closest(sw, t, r, edge, s, u, v) && s < best_s) {
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
    fl_hit h;
    bool hit = best_col >= 0;
    h.s = hit ? best_s : 0.0f;
    h.u = hit ? best_u : 0.0f;
    h.v = hit ? best_v : 0.0f;
    h.col = best_col;
    return h;
}

// Front-face-culled any hit within r.max_len (glsl:143-158), block-wide as
// fl_block_closest; the block leaves the triangle loop together once no
// ray of it is still searching.
__device__ __forceinline__ bool fl_block_any(const float* __restrict__ w4, int tp,
                                             float (*sw)[FL_TRI_CHUNK][16], bool want,
                                             const fl_ray& r) {
    bool hit = false;
    for (int c0 = 0; c0 < tp; c0 += FL_TRI_CHUNK) {
        if (!__syncthreads_or(want && !hit)) break;
        int cnt = tp - c0 < FL_TRI_CHUNK ? tp - c0 : FL_TRI_CHUNK;
        fl_stage(w4, tp, c0, cnt, sw);
        __syncthreads();
        if (want && !hit) {
            for (int t = 0; t < cnt; ++t) {
                if (fl_mt_any(sw, t, r)) { hit = true; break; }
            }
        }
        __syncthreads();
    }
    return hit;
}
