// Per-ray path-tracing arithmetic shared by the traversal kernels
// (intersect.cu, sparse.cu), the fused per-bounce kernels (fused.cu) and
// the shading kernels (shade.cu).
//
// Every function takes the float operations of its plain PyTorch
// counterpart in the same order, so that with --fmad=false (and
// -ffp-contract=off on the host) the kernels round exactly as the plain
// versions do:
//   vec3 helpers        ops/vec3.py
//   both noise hashes   ops/rng.py (noise4, noise4_counter)
//   the BRDF            ops/brdf.py (forward_trace_soa)
//   Moeller-Trumbore    the 16-float triangle record of W[4, T, 16]'s
//                       bilinear form (ops/intersect_kernel.py), as
//                       ops/intersect_sparse_kernel.py record_products
//                       sums it: intersect.cu's casts, sparse.cu's
//                       worklist casts, PRE, POST and FRAME
//   bounce stages       ops/pathtrace.py bounce_pre, bounce_shade (with
//                       reservoir_select), bounce_apply, over the carry
//                       rows of a state block (ops/fused.py's layout)
//   the atlas fetch     ops/buffers.py fetch_tex_val_table
// Constants are the float32 roundings of the Python doubles that torch
// casts them from, written as (float)<double>.
#pragma once

#include <string.h>

#include "common.cuh"

#define FL_TINY ((float)1e-30)
#define FL_PI ((float)3.141592653589793)
#define FL_INV_PI ((float)0.3183098861837907)
#define FL_PHI ((float)1.61803398874989484820459)

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

#define FL_FLT_MIN 1.17549435e-38f  // the least normal float

// ops/vec3.py sign (jnp.sign on XLA's CPU): the signed zero of a for
// |a| < FL_FLT_MIN (+-0 and denormals), NaN for NaN, else +-1
__device__ __forceinline__ float fl_sign(float a) {
    if (fabsf(a) < FL_FLT_MIN) return a * 0.0f;
    if (a != a) return a;
    return a > 0.0f ? 1.0f : -1.0f;
}

// ops/vec3.py clamp_min0 (jnp.maximum(a, 0)): NaN stays NaN, -0 becomes +0
__device__ __forceinline__ float fl_clamp_min0(float a) {
    return fl_clamp_min(a, 0.0f) + 0.0f;
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

// ---- the 16-float triangle record (ops/intersect_sparse.py tri_record) ----
//
// n, v0.n, e2 x v0, v0 x e1, e2, e1: the distinct magnitudes of the 25
// non-zero terms of a triangle's 64-float W rows. A test sums only those
// terms, in W's k order, the signs as exact negations (24 multiplies, 21
// adds), so det, udet, vdet and sdet equal the 64-term sums of W's rows
// (ops/intersect_kernel.py closest_hit_plain, any_hit_plain) wherever W's
// zero products meet finite ray features (a zero may differ in sign). The
// traversal kernels (intersect.cu), the worklist casts (sparse.cu) and PRE,
// POST and FRAME (fused.cu) test it. Quads: a = (n, v0.n), b = (e2 x v0,
// (v0 x e1).x), c = ((v0 x e1).yz, e2.xy), e = (e2.z, e1).

// A ray of the record test: origin, direction (a zero direction becomes
// +z, as ops/intersect_kernel.py _safe_dirs) and the components of vec(d (x) o) that meet the
// record's non-zero terms (k = 8, 9, 10, 12, 13, 14 of ray_features).
struct fl_rray {
    float o[3], d[3];
    float f8, f9, f10, f12, f13, f14;
    float max_len;
};

__device__ __forceinline__ void fl_make_rray(fl_v3 o3, fl_v3 d3, float max_len, fl_rray& r) {
    float o[3] = {o3.x, o3.y, o3.z};
    float d[3] = {d3.x, d3.y, d3.z};
    float norm2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    if (norm2 <= 0.0f) { d[0] = 0.0f; d[1] = 0.0f; d[2] = 1.0f; }
    for (int k = 0; k < 3; ++k) {
        r.o[k] = o[k];
        r.d[k] = d[k];
    }
    r.f8 = d[0] * o[1];
    r.f9 = d[0] * o[2];
    r.f10 = d[1] * o[0];
    r.f12 = d[1] * o[2];
    r.f13 = d[2] * o[0];
    r.f14 = d[2] * o[1];
    r.max_len = max_len;
}

// The four products of a record with a ray: the non-zero terms of tri_rows
// in k order (ops/intersect_sparse_kernel.py record_products takes the same
// operations).
__device__ __forceinline__ float fl_rec_det(float4 a, const fl_rray& r) {
    return -((a.x * r.d[0] + a.y * r.d[1]) + a.z * r.d[2]);
}

__device__ __forceinline__ float fl_rec_sdet(float4 a, const fl_rray& r) {
    return ((a.x * r.o[0] - a.w) + a.y * r.o[1]) + a.z * r.o[2];
}

__device__ __forceinline__ float fl_rec_udet(float4 b, float4 c, float4 e, const fl_rray& r) {
    return -((b.x * r.d[0] + b.y * r.d[1]) + b.z * r.d[2]) - e.x * r.f8 + c.w * r.f9
           + e.x * r.f10 - c.z * r.f12 - c.w * r.f13 + c.z * r.f14;
}

__device__ __forceinline__ float fl_rec_vdet(float4 b, float4 c, float4 e, const fl_rray& r) {
    return -((b.w * r.d[0] + c.x * r.d[1]) + c.y * r.d[2]) + e.w * r.f8 - e.z * r.f9
           - e.w * r.f10 + e.y * r.f12 + e.z * r.f13 - e.y * r.f14;
}

// x non-zero with the sign of det (false for NaN)
__device__ __forceinline__ bool fl_sign_of(float x, bool det_pos) {
    return det_pos ? x > 0.0f : x < 0.0f;
}

// The two-sided closest-hit test of triangle t against ray r: the accept
// window of closest_hit_plain, after exact early rejects, each taking only
// pairs that the window rejects too (no comparison lets a NaN through):
// |det| < BIAS; sdet zero or of the other sign than det (s <= 0); and,
// with `cull_uv` (the window's u / v edge is above 0: bounce casts), udet
// or vdet zero or of the other sign (u <= 0 or v <= 0). A surviving pair
// takes 1 / det, u, v and s in the plain version's order. `q[p][t]` is
// quad p of triangle t's record (a staged tile of sparse.cu, or
// fl_rec_table).
template <typename Q>
__device__ __forceinline__ bool fl_rec_closest(const Q& q, int t, const fl_rray& r, float edge,
                                               bool cull_uv, float& s, float& u, float& v) {
    float4 a = q[0][t];
    float det = fl_rec_det(a, r);
    if (!(fabsf(det) >= FL_BIAS)) return false;
    bool pos = det > 0.0f;
    float sdet = fl_rec_sdet(a, r);
    if (!fl_sign_of(sdet, pos)) return false;             // s <= 0
    float4 b = q[1][t], c = q[2][t], e = q[3][t];
    float udet = fl_rec_udet(b, c, e, r);
    if (cull_uv && !fl_sign_of(udet, pos)) return false;  // u <= 0 < edge
    float vdet = fl_rec_vdet(b, c, e, r);
    if (cull_uv && !fl_sign_of(vdet, pos)) return false;  // v <= 0 < edge
    float inv = 1.0f / det;
    u = udet * inv;
    v = vdet * inv;
    s = sdet * inv;
    bool valid = (u >= edge) && (u <= 1.0f);
    valid = valid && (v >= edge) && (u + v <= 1.0f);
    return valid && (s > FL_BIAS) && (s <= r.max_len);
}

// The front-face-culled any-hit test of triangle t (glsl:143-158,
// ops/intersect_kernel.py any_hit_plain: det >= BIAS and the window with
// its u / v edge at BIAS), after the exact early rejects.
template <typename Q>
__device__ __forceinline__ bool fl_rec_any(const Q& q, int t, const fl_rray& r) {
    float4 a = q[0][t];
    float det = fl_rec_det(a, r);
    if (!(det >= FL_BIAS)) return false;
    float sdet = fl_rec_sdet(a, r);
    if (!(sdet > 0.0f)) return false;
    float4 b = q[1][t], c = q[2][t], e = q[3][t];
    float udet = fl_rec_udet(b, c, e, r);
    if (!(udet > 0.0f)) return false;
    float vdet = fl_rec_vdet(b, c, e, r);
    if (!(vdet > 0.0f)) return false;
    float inv = 1.0f / det;
    float u = udet * inv;
    float v = vdet * inv;
    float s = sdet * inv;
    bool valid = (u >= FL_BIAS) && (u <= 1.0f);
    valid = valid && (v >= FL_BIAS) && (u + v <= 1.0f);
    return valid && (s > FL_BIAS) && (s <= r.max_len);
}

struct fl_hit {
    float s, u, v;
    int col;  // triangle column, -1 on a miss
};

// A whole scene's records in shared memory, triangle t's four quads at
// rec[4t .. 4t + 3] (64 bytes), read as q[p][t].
struct fl_rec_table {
    const float4* rec;
    struct quad {
        const float4* p;
        __device__ __forceinline__ float4 operator[](int t) const { return p[4 * t]; }
    };
    __device__ __forceinline__ quad operator[](int p) const { return {rec + p}; }
};

// Every thread of the block builds its share of the records of triangles
// [c0, c0 + cnt) of W[4, tp, 16] into `rec` (4 * cnt quads): each value is
// one of W's entries or its exact negation (ops/intersect_kernel.py
// tri_rows: det = [0, 0, -n, 0], udet = [0, 0, -(e2 x v0), skew(e2)],
// vdet = [0, 0, -(v0 x e1), -skew(e1)], sdet = [-v0.n, n, 0, 0]), so the
// table equals tri_record's. The caller publishes it with a barrier.
__device__ __forceinline__ void fl_rec_stage(const float* __restrict__ w4, int tp, int c0,
                                             int cnt, float4* rec) {
    for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
        int t = c0 + k;
        const float* u = w4 + ((size_t)tp + t) * 16;
        const float* v = w4 + ((size_t)2 * tp + t) * 16;
        const float* s = w4 + ((size_t)3 * tp + t) * 16;
        rec[4 * k] = make_float4(s[1], s[2], s[3], -s[0]);
        rec[4 * k + 1] = make_float4(-u[4], -u[5], -u[6], -v[4]);
        rec[4 * k + 2] = make_float4(-v[5], -v[6], u[14], u[9]);
        rec[4 * k + 3] = make_float4(u[10], v[12], v[13], v[8]);
    }
}

// Closest hit of one ray over the whole table, in this thread alone (no
// barrier): ties in s go to the lowest column; on a miss s, u, v are 0
// and col is -1 (closest_hit_plain's result).
__device__ __forceinline__ fl_hit fl_table_closest(const float4* rec, int tp, const fl_rray& r,
                                                   float edge) {
    fl_rec_table q = {rec};
    bool cull_uv = edge > 0.0f;
    float best_s = FL_POW32, best_u = 0.0f, best_v = 0.0f;
    int best_col = -1;
    for (int t = 0; t < tp; ++t) {
        float s, u, v;
        if (fl_rec_closest(q, t, r, edge, cull_uv, s, u, v) && s < best_s) {
            best_s = s;
            best_u = u;
            best_v = v;
            best_col = t;
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

// Front-face-culled any hit within r.max_len over the whole table, in this
// thread alone, up to the first triangle that occludes (any_hit_plain's
// result). A ray with max_len <= 0 (or NaN) can have no hit (s > BIAS).
__device__ __forceinline__ bool fl_table_any(const float4* rec, int tp, const fl_rray& r) {
    if (!(r.max_len > 0.0f)) return false;
    fl_rec_table q = {rec};
    for (int t = 0; t < tp; ++t)
        if (fl_rec_any(q, t, r)) return true;
    return false;
}

// ---- the bounce stages (ops/pathtrace.py), shared by fused.cu and shade.cu --

#define FL_MAX_LIGHTS 256
#define FL_MAT_C 49

// carry rows of a state block (ops/fused.py), then the surface rows
#define FL_ALIVE 0
#define FL_TRI 1
#define FL_HS 2
#define FL_HU 3
#define FL_HV 4
#define FL_RAY_ORIGIN 5
#define FL_RAY_DIR 8
#define FL_LAST_HIT 11
#define FL_IMPORTANCY 14
#define FL_ORIGINAL_COLOR 17
#define FL_DONT_FILTER 20
#define FL_FINAL_COLOR 21
#define FL_RENDER_ID 24
#define FL_GLASS 28
#define FL_RME_X 29
#define FL_TPO_X 30
#define FL_FIRST_RAY_LENGTH 31
#define FL_SURF 32

// The loop-carried state of one ray (ops/pathtrace.py BounceCarry).
struct fl_carry {
    bool alive;
    int tri;
    float hs, hu, hv;
    fl_v3 ray_origin, ray_dir, last_hit, importancy, original_color;
    bool dont_filter;
    fl_v3 final_color;
    float render_id[4];
    float glass, rme_x, tpo_x, first_ray_length;
};

// bounce_pre's surface (ops/pathtrace.py BounceSurface).
struct fl_surface {
    bool m;
    fl_v3 smooth_normal;
    float geometry_offset, bary_u, bary_v;
    float tex[12];  // tex nums (3), inline albedo (3), rme (3), tpo (3)
};

// bounce_shade's request (ops/pathtrace.py ShadeRequest and ReservoirPick).
struct fl_shade_req {
    fl_v3 ray_dir, smooth_normal, random_sphere;
    float sign_dir, roughness_brdf;
    bool is_solid, write_id_w;
    fl_v3 local_color;
    int res_num;
    bool show_color, show_shadow;
    fl_v3 offset_target, light_dir;
    float max_len;
};

__device__ __forceinline__ float fl_row(const float* st, int n, int row, int i) {
    return st[(size_t)row * n + i];
}

__device__ __forceinline__ void fl_put(float* st, int n, int row, int i, float x) {
    st[(size_t)row * n + i] = x;
}

__device__ __forceinline__ fl_carry fl_read_carry(const float* st, int n, int i) {
    fl_carry c;
    c.alive = fl_row(st, n, FL_ALIVE, i) > 0.0f;
    c.tri = (int)fl_row(st, n, FL_TRI, i);
    c.hs = fl_row(st, n, FL_HS, i);
    c.hu = fl_row(st, n, FL_HU, i);
    c.hv = fl_row(st, n, FL_HV, i);
    c.ray_origin = fl_load3(st + (size_t)FL_RAY_ORIGIN * n, n, i);
    c.ray_dir = fl_load3(st + (size_t)FL_RAY_DIR * n, n, i);
    c.last_hit = fl_load3(st + (size_t)FL_LAST_HIT * n, n, i);
    c.importancy = fl_load3(st + (size_t)FL_IMPORTANCY * n, n, i);
    c.original_color = fl_load3(st + (size_t)FL_ORIGINAL_COLOR * n, n, i);
    c.dont_filter = fl_row(st, n, FL_DONT_FILTER, i) > 0.0f;
    c.final_color = fl_load3(st + (size_t)FL_FINAL_COLOR * n, n, i);
    for (int k = 0; k < 4; ++k) c.render_id[k] = fl_row(st, n, FL_RENDER_ID + k, i);
    c.glass = fl_row(st, n, FL_GLASS, i);
    c.rme_x = fl_row(st, n, FL_RME_X, i);
    c.tpo_x = fl_row(st, n, FL_TPO_X, i);
    c.first_ray_length = fl_row(st, n, FL_FIRST_RAY_LENGTH, i);
    return c;
}

__device__ __forceinline__ void fl_write_carry(float* st, int n, int i, const fl_carry& c) {
    fl_put(st, n, FL_ALIVE, i, c.alive ? 1.0f : 0.0f);
    fl_put(st, n, FL_TRI, i, (float)c.tri);
    fl_put(st, n, FL_HS, i, c.hs);
    fl_put(st, n, FL_HU, i, c.hu);
    fl_put(st, n, FL_HV, i, c.hv);
    fl_store3(st + (size_t)FL_RAY_ORIGIN * n, n, i, c.ray_origin);
    fl_store3(st + (size_t)FL_RAY_DIR * n, n, i, c.ray_dir);
    fl_store3(st + (size_t)FL_LAST_HIT * n, n, i, c.last_hit);
    fl_store3(st + (size_t)FL_IMPORTANCY * n, n, i, c.importancy);
    fl_store3(st + (size_t)FL_ORIGINAL_COLOR * n, n, i, c.original_color);
    fl_put(st, n, FL_DONT_FILTER, i, c.dont_filter ? 1.0f : 0.0f);
    fl_store3(st + (size_t)FL_FINAL_COLOR * n, n, i, c.final_color);
    for (int k = 0; k < 4; ++k) fl_put(st, n, FL_RENDER_ID + k, i, c.render_id[k]);
    fl_put(st, n, FL_GLASS, i, c.glass);
    fl_put(st, n, FL_RME_X, i, c.rme_x);
    fl_put(st, n, FL_TPO_X, i, c.tpo_x);
    fl_put(st, n, FL_FIRST_RAY_LENGTH, i, c.first_ray_length);
}

// bounce_pre (glsl:475-526): importance kill, material row fetch, hit-point
// update, normal interpolation, texture coordinates.
__device__ __forceinline__ fl_surface fl_bounce_pre(fl_carry& c, const float* __restrict__ mat,
                                                    float min_importance) {
    float importance_len = fl_norm3(fl_mul3(c.importancy, c.original_color));
    c.alive = c.alive && (importance_len >= min_importance);
    fl_surface s;
    s.m = c.alive;
    const float* row = mat + (size_t)c.tri * FL_MAT_C;
    float rot[9];
    for (int k = 0; k < 9; ++k) rot[k] = row[40 + k];
    fl_v3 new_origin = fl_add3(fl_scale3(c.ray_dir, c.hs), c.ray_origin);
    c.ray_origin = fl_where3(s.m, new_origin, c.ray_origin);
    float uvw[3] = {1.0f - c.hu - c.hv, c.hu, c.hv};
    fl_v3 wv[3];
    for (int k = 0; k < 3; ++k) wv[k] = fl_make3(row[3 * k], row[3 * k + 1], row[3 * k + 2]);
    fl_v3 geometry_normal =
        fl_normalize3(fl_cross3(fl_sub3(wv[0], wv[1]), fl_sub3(wv[0], wv[2])));
    fl_v3 smooth_normal = fl_make3(0.0f, 0.0f, 0.0f);
    float geometry_offset = 0.0f, bary_u = 0.0f, bary_v = 0.0f;
    for (int k = 0; k < 3; ++k) {
        fl_v3 vn = fl_make3(row[12 + 3 * k], row[13 + 3 * k], row[14 + 3 * k]);
        fl_v3 wn = fl_matvec3(rot, vn);
        smooth_normal = fl_add3(smooth_normal, fl_scale3(wn, uvw[k]));
        // tan(acos(x)) = sqrt(1-x^2)/x: shadow-acne offset (glsl:516-518)
        float cos_a = fabsf(fl_clamp(fl_dot3(geometry_normal, wn), -1.0f, 1.0f));
        float tan_a = fl_clamp(sqrtf(1.0f - cos_a * cos_a) / cos_a, 0.0f, 1.0f);
        float diff = fl_norm3(fl_sub3(c.ray_origin, wv[k]));
        geometry_offset = geometry_offset + diff * tan_a * uvw[k];
        bary_u = bary_u + row[21 + 2 * k] * uvw[k];
        bary_v = bary_v + row[22 + 2 * k] * uvw[k];
    }
    s.smooth_normal = fl_normalize3(smooth_normal);
    s.geometry_offset = geometry_offset;
    s.bary_u = bary_u;
    s.bary_v = bary_v;
    for (int k = 0; k < 12; ++k) s.tex[k] = row[27 + k];
    return s;
}

// to_4bit_representation (glsl:91-95)
__device__ __forceinline__ float fl_4bit(float a, float b) {
    long long aui = (long long)(a * 255.0f) & 240;
    long long bui = ((long long)(b * 255.0f) & 240) >> 4;
    return (float)(aui | bui) * FL_INV_255;
}

// bounce_shade (glsl:529-576) with reservoir_select (glsl:400-447) of one
// live ray, up to the NEE shadow ray: shading frame, RNG, Fresnel-chance
// decision, first-surface bookkeeping and render_id packing (atan2 runs
// here), the reservoir over the `n_lights` lights `sl` (rows of 6:
// position, strength, variation). Updates the carry's importancy,
// original_color, dont_filter, render_id[0..2], glass, rme_x, tpo_x and
// first_ray_length; returns the request.
__device__ __forceinline__ fl_shade_req fl_bounce_shade(
    fl_carry& c, fl_v3 smooth_normal, float geometry_offset, fl_v3 albedo, float rough,
    float metal, float emis, fl_v3 tpo, float ndc0, float ndc1, const float* sl,
    int n_lights, const float* cam, float random_seed, float cos_sample_n, int bounce,
    int counter) {
    fl_shade_req q;
    fl_v3 ray_dir = fl_normalize3(fl_sub3(c.ray_origin, c.last_hit));
    float sign_dir = fl_sign(fl_dot3(ray_dir, smooth_normal));
    smooth_normal = fl_scale3(smooth_normal, -sign_dir);

    float rv[4];
    fl_noise(counter, ndc0, ndc1, (float)bounce + cos_sample_n, random_seed, 0, 4, rv);
    fl_v3 random_sphere = fl_normalize3(
        fl_add3(smooth_normal, fl_normalize3(fl_make3(rv[0], rv[1], rv[2]))));
    float brdf = 1.0f + (fabsf(fl_dot3(smooth_normal, ray_dir)) - 1.0f) * metal;
    float roughness_brdf = rough * brdf;
    fl_v3 rough_normal = fl_normalize3(fl_mix3(smooth_normal, random_sphere, roughness_brdf));

    fl_v3 h = fl_normalize3(fl_sub3(rough_normal, ray_dir));
    float v_dot_h = fl_clamp_min(-fl_dot3(ray_dir, h), 0.0f);
    float one_m_theta5 = fl_pow5(1.0f - v_dot_h);
    float alb[3] = {albedo.x, albedo.y, albedo.z};
    float fresnel_reflect = 0.0f;
    for (int k = 0; k < 3; ++k) {
        float f0 = alb[k] * brdf;
        fresnel_reflect = fl_maximum(fresnel_reflect, f0 + (1.0f - f0) * one_m_theta5);
    }
    // Fresnel-chance solid/translucent decision (glsl:550)
    bool is_solid = tpo.x * fresnel_reflect <= fabsf(rv[3]);

    // first-surface bookkeeping vs importancy accumulation (glsl:553-573)
    bool df = c.dont_filter;  // && m
    if (df) {
        c.tpo_x = tpo.x;
        c.original_color = fl_mul3(c.original_color, albedo);
        c.rme_x = c.rme_x + rough;
    }
    float phi = atan2f(smooth_normal.z, smooth_normal.x) * FL_INV_PI * 0.5f + 0.5f;
    float theta = atan2f(smooth_normal.x, smooth_normal.y) * FL_INV_PI * 0.5f + 0.5f;
    float idu[3] = {fl_4bit(phi, theta), rough, fl_4bit(metal, emis)};
    float scale_i = 1.0f;
    for (int k = 0; k < bounce; ++k) scale_i = scale_i * 0.5f;
    for (int k = 0; k < 3; ++k)
        c.render_id[k] = c.render_id[k] + (df ? scale_i * idu[k] : 0.0f);
    bool new_dont_filter = ((rough < (float)0.01) && is_solid) || !is_solid;
    bool is_glass = is_solid && (tpo.x > (float)0.01);
    if (df && is_glass) c.glass = c.glass + 1.0f;
    new_dont_filter = new_dont_filter && !is_glass;
    if (!c.dont_filter) c.importancy = fl_mul3(c.importancy, albedo);
    c.dont_filter = (df && new_dont_filter) || (!df && c.dont_filter);

    if (bounce == 1) {
        float ratio = fl_norm3(fl_sub3(c.ray_origin, c.last_hit))
                      / fl_clamp_min(fl_norm3(fl_sub3(c.last_hit, fl_make3(cam[0], cam[1],
                                                                           cam[2]))),
                                     FL_TINY);
        c.first_ray_length = fl_minimum(ratio, c.first_ray_length);
    }

    // ---- reservoir_select (glsl:400-447) ----
    fl_v3 n_rough = fl_scale3(rough_normal, -sign_dir);
    fl_v3 n_smooth = fl_scale3(smooth_normal, -sign_dir);
    fl_v3 local_color = fl_make3(0.0f, 0.0f, 0.0f);
    float res_length = 0.0f, total_weight = 0.0f, res_weight = 0.0f;
    int res_num = 0;
    fl_v3 res_dir = fl_make3(0.0f, 0.0f, 0.0f);
    float lr[4];
    fl_noise(counter, rv[2], rv[3], FL_BIAS, random_seed, 0, 2, lr);
    fl_v3 v = fl_neg3(ray_dir);
    for (int j = 0; j < n_lights; ++j) {
        const float* row = sl + 6 * j;
        float strength = row[3];
        float variation = row[4];
        bool active = strength > 0.0f;  // skip dead lights (glsl:415)
        fl_v3 light = fl_make3(row[0] + rv[0] * variation, row[1] + rv[1] * variation,
                               row[2] + rv[2] * variation);
        fl_v3 d = fl_sub3(light, c.ray_origin);
        fl_v3 cfl = fl_forward_trace(albedo, rough, metal, d, strength, n_rough, v);
        float weight = fl_norm3(cfl);
        if (active) {
            local_color = fl_add3(local_color, cfl);
            res_length = res_length + 1.0f;
            total_weight = total_weight + weight;
        }
        bool sel = active && (fabsf(lr[1]) * total_weight <= weight);
        if (sel) {
            res_num = j;
            res_weight = weight;
            res_dir = d;
        }
        fl_noise(counter, lr[0], lr[1], FL_BIAS, random_seed, 2, 4, lr);
        if (active) {
            lr[0] = lr[2];
            lr[1] = lr[3];
        }
    }
    q.ray_dir = ray_dir;
    q.smooth_normal = smooth_normal;
    q.sign_dir = sign_dir;
    q.random_sphere = random_sphere;
    q.roughness_brdf = roughness_brdf;
    q.is_solid = is_solid;
    q.write_id_w = c.dont_filter || bounce == 0;  // && m
    q.local_color = local_color;
    q.res_num = res_num;
    q.light_dir = fl_normalize3(res_dir);
    q.show_color = (res_length == 0.0f) || (res_weight == 0.0f);
    q.show_shadow = fl_dot3(n_smooth, q.light_dir) <= FL_BIAS;
    q.offset_target = fl_add3(c.ray_origin, fl_scale3(n_smooth, geometry_offset));
    q.max_len = fl_norm3(res_dir);
    return q;
}

// bounce_apply (glsl:448-461, 577-589) of one live ray after its shadow
// cast: reservoir_finish, radiance and next_ray_dir (reflect, or
// Fresnel-chance refract, roughness-mixed).
__device__ __forceinline__ void fl_bounce_apply(fl_carry& c, const fl_shade_req& q, float emis,
                                                fl_v3 tpo, bool shadowed) {
    bool in_shadow = !q.show_color && (q.show_shadow || shadowed);
    float id_w = (float)((q.res_num % 128) * 2) * FL_INV_255;
    id_w = id_w + (in_shadow ? FL_INV_255 : 0.0f);
    fl_v3 e3 = fl_make3(emis, emis, emis);
    fl_v3 lc = (q.show_color || !in_shadow) ? fl_add3(q.local_color, e3) : e3;
    if (q.write_id_w) c.render_id[3] = id_w;
    c.final_color = fl_add3(c.final_color, fl_mul3(lc, c.importancy));
    float n_dot_i = fl_dot3(q.smooth_normal, q.ray_dir);
    fl_v3 reflected = fl_sub3(q.ray_dir, fl_scale3(q.smooth_normal, 2.0f * n_dot_i));
    float inv_eta = 1.0f / tpo.z;
    float eta = inv_eta + (tpo.z - inv_eta) * fl_clamp_min0(q.sign_dir);
    float k = 1.0f - eta * eta * (1.0f - n_dot_i * n_dot_i);
    float refr_coef = eta * n_dot_i + sqrtf(fl_clamp_min(k, 0.0f));
    fl_v3 refracted = k < 0.0f ? fl_make3(0.0f, 0.0f, 0.0f)
                               : fl_sub3(fl_scale3(q.ray_dir, eta),
                                         fl_scale3(q.smooth_normal, refr_coef));
    fl_v3 base = q.is_solid ? reflected : refracted;
    c.ray_dir = fl_normalize3(fl_mix3(base, q.random_sphere, q.roughness_brdf));
}

// ---- the atlas fetch (ops/buffers.py fetch_tex_val_table) ----------------

// One compact atlas table (ops/buffers.py AtlasTable): texels [K, 3], u8
// (each byte times f32(1/255)) or f32; tile_info [n_slots, 3] int32
// (offset, stored width, stored height); meta [5] int32 (std_w, std_h,
// tiles per row, virtual height, virtual width).
struct fl_atlas {
    const void* texels;
    int u8;
    const int* tile_info;
    int n_slots;
    const int* meta;
};

// torch.div(a, b, rounding_mode="floor") on int32
__device__ __forceinline__ int fl_floor_div(int a, int b) {
    int q = a / b;
    return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int fl_clamp_int(int x, int lo, int hi) {
    x = x < lo ? lo : x;
    return x > hi ? hi : x;
}

// NEAREST sampling with REPEAT wrap through the compact table, the inline
// value `dflt` where tex_num is -1 (pathtracer_fragment.glsl:108-117).
// torch.remainder is fl_mod (fmod, then the divisor added where the signs
// differ); float -> int32 is the truncating conversion torch takes.
__device__ __forceinline__ fl_v3 fl_fetch_tex(const fl_atlas& a, float u, float v,
                                              float tex_num, fl_v3 dflt) {
    if (tex_num == -1.0f) return dflt;
    int std_w = a.meta[0], std_h = a.meta[1], tpr = a.meta[2];
    int virt_h = a.meta[3], virt_w = a.meta[4];
    float hf = (float)virt_h;
    float wf = (float)virt_w;
    float tw = (float)tpr;
    float height_factor = wf / hf;
    float cx = (u + fl_mod(tex_num, tw)) / tw;
    float cy = (v + floorf(tex_num / tw)) * height_factor / tw;
    int px = (int)floorf(fl_mod(cx, 1.0f) * wf);
    px = fl_clamp_int(px, 0, virt_w - 1);
    int py = (int)floorf(fl_mod(cy, 1.0f) * hf);
    py = fl_clamp_int(py, 0, virt_h - 1);
    int col = fl_floor_div(px, std_w);
    int row = fl_floor_div(py, std_h);
    int slot = fl_clamp_int(row * tpr + col, 0, a.n_slots - 1);
    const int* info = a.tile_info + 3 * (size_t)slot;
    int sw = info[1], sh = info[2];
    int sx = fl_floor_div((px - col * std_w) * sw, std_w);
    int sy = fl_floor_div((py - row * std_h) * sh, std_h);
    size_t idx = 3 * (size_t)(info[0] + sy * sw + sx);
    if (a.u8) {
        const uint8_t* t = (const uint8_t*)a.texels + idx;
        return fl_make3((float)t[0] * FL_INV_255, (float)t[1] * FL_INV_255,
                        (float)t[2] * FL_INV_255);
    }
    const float* t = (const float*)a.texels + idx;
    return fl_make3(t[0], t[1], t[2]);
}
