// The per-bounce split pipeline: PRE and POST, one thread per ray.
//
// Replaces: flexlight_tpu/ops/fused.py `_sp_i0_kernel` (PRE) and
// `_sp_post_kernel` (POST), launched by render_mrt_fused_split.run_kernel.
// Plain versions: ops/fused.py sp_pre_plain / sp_post_plain, built from
// the stage functions of ops/pathtrace.py; every float operation here is
// theirs, in their order (trace.cuh), so with --fmad=false the kernels
// agree with them bit for bit.
//
// PRE:  primary closest hit (relaxed -BIAS edge) + bounce_carry_init +
//       bounce_pre(0); with `resample` it reads the primary hit and the
//       carried channels from the state instead of casting.
// POST: bounce_post(i) (shading frame, RNG, Fresnel-chance decision,
//       first-surface bookkeeping and render_id packing, the reservoir
//       over all lights, the shadow any hit, reservoir_finish, radiance,
//       next direction) and, unless i is the last bounce, the next closest
//       hit and bounce_pre(i + 1). The bounce index is an argument, so one
//       kernel serves every bounce.
//
// The state is float32 [SP_C, N], one contiguous row per channel (the
// layout of ops/fused.py), so a warp reads and writes 32 neighbouring
// floats of one row at a time. Each thread reads and writes only its own
// ray's column, so POST updates the state in place, and PRE in place too
// (it reads what it needs of its column before it writes it).
//
// What bounds them on the H100: memory. At 1920x1080 (N = 2,073,600) one
// state row is 8.3 MB; PRE writes all 55 rows (~456 MB, ~0.14 ms at
// 3.35 TB/s), POST reads ~47 rows and writes ~51 of a live ray (~0.24 ms
// when every ray is live). The rest, 9 lights x (shading + noise) and two
// 20-triangle casts per live ray, is a few kFLOP per ray, small beside it.
// The triangle rows pass through shared memory in chunks, block-wide, as
// in intersect.cu (the same traversal code, trace.cuh); the lights (<= 256
// rows of 6 floats) sit in shared memory; the material row (49 floats) of
// a ray's own triangle is read from global memory, where L1 and L2 serve
// it (at the 1024-triangle cap the table is 200 KB).
//
// Dead rays. Every carry write of bounce_post is guarded by the live mask
// m, so for a ray with m == 0 the plain version's output equals its input:
// the carry is unchanged and bounce_pre(i + 1) recomputes the surface it
// already holds (flexlight_tpu's dead-subtile rule, ops/fused.py:993-1024,
// at the granularity of one ray). Such a thread computes and writes
// nothing; it only helps stage the triangle rows, and a block whose rays
// are all dead returns at once.
#include "trace.cuh"

#define FL_FUSED_BLOCK 128
#define FL_MAX_LIGHTS 256
#define FL_MAT_C 49

// state rows (ops/fused.py)
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
#define FL_PPART 37
#define FL_TEXIN 41
#define FL_SP_C 55

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

__device__ __forceinline__ void fl_write_surface(float* st, int n, int i,
                                                 const fl_surface& s) {
    fl_put(st, n, FL_SURF, i, s.m ? 1.0f : 0.0f);
    fl_store3(st + (size_t)(FL_SURF + 1) * n, n, i, s.smooth_normal);
    fl_put(st, n, FL_SURF + 4, i, s.geometry_offset);
    fl_put(st, n, FL_TEXIN, i, s.bary_u);
    fl_put(st, n, FL_TEXIN + 1, i, s.bary_v);
    for (int k = 0; k < 12; ++k) fl_put(st, n, FL_TEXIN + 2 + k, i, s.tex[k]);
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

__global__ void fl_sp_pre_kernel(float* __restrict__ st, const float* __restrict__ dirs,
                                 const float* __restrict__ w4, int tp,
                                 const int* __restrict__ ids, const float* __restrict__ mat,
                                 const float* __restrict__ cam, int resample,
                                 float min_importance, int n) {
    __shared__ float sw[4][FL_TRI_CHUNK][16];
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    bool in = i < n;
    fl_v3 camera = fl_make3(cam[0], cam[1], cam[2]);
    fl_v3 dir = in ? fl_load3(dirs, n, i) : fl_make3(0.0f, 0.0f, 1.0f);
    fl_carry c;
    float ps, pu, pv;
    int ptri;
    if (resample) {
        if (!in) return;
        ps = fl_row(st, n, FL_PPART, i);
        pu = fl_row(st, n, FL_PPART + 1, i);
        pv = fl_row(st, n, FL_PPART + 2, i);
        ptri = (int)fl_row(st, n, FL_PPART + 3, i);
        for (int k = 0; k < 4; ++k) c.render_id[k] = fl_row(st, n, FL_RENDER_ID + k, i);
        c.glass = fl_row(st, n, FL_GLASS, i);
        c.rme_x = fl_row(st, n, FL_RME_X, i);
        c.tpo_x = fl_row(st, n, FL_TPO_X, i);
        c.first_ray_length = fl_row(st, n, FL_FIRST_RAY_LENGTH, i);
    } else {
        fl_ray r;
        fl_make_ray(camera, dir, FL_POW32, r);
        // primaries replace the reference's watertight raster pass: relaxed edge
        fl_hit h = fl_block_closest(w4, tp, sw, in, r, -FL_BIAS);
        if (!in) return;
        ps = h.s;
        pu = h.u;
        pv = h.v;
        ptri = h.col >= 0 ? ids[h.col] : -1;
        for (int k = 0; k < 4; ++k) c.render_id[k] = 0.0f;
        c.glass = 0.0f;
        c.rme_x = 0.0f;
        c.tpo_x = 0.0f;
        c.first_ray_length = 1.0f;
    }
    // bounce_carry_init
    c.alive = ptri != -1;
    c.tri = ptri < 0 ? 0 : ptri;
    c.hs = ps;
    c.hu = pu;
    c.hv = pv;
    c.ray_origin = camera;
    c.ray_dir = dir;
    c.last_hit = camera;
    c.importancy = fl_make3(1.0f, 1.0f, 1.0f);
    c.original_color = fl_make3(1.0f, 1.0f, 1.0f);
    c.dont_filter = true;
    c.final_color = fl_make3(0.0f, 0.0f, 0.0f);
    fl_surface s = fl_bounce_pre(c, mat, min_importance);
    fl_write_carry(st, n, i, c);
    fl_write_surface(st, n, i, s);
    fl_put(st, n, FL_PPART, i, ps);
    fl_put(st, n, FL_PPART + 1, i, pu);
    fl_put(st, n, FL_PPART + 2, i, pv);
    fl_put(st, n, FL_PPART + 3, i, (float)ptri);
}

__global__ void fl_sp_post_kernel(float* __restrict__ st, const float* __restrict__ tex,
                                  const float* __restrict__ ndc,
                                  const float* __restrict__ w4, int tp,
                                  const int* __restrict__ ids, const float* __restrict__ mat,
                                  const float* __restrict__ lights, int n_lights,
                                  const float* __restrict__ cam, float random_seed,
                                  float cos_sample_n, int bounce, int do_next, int counter,
                                  float min_importance, int n) {
    __shared__ float sw[4][FL_TRI_CHUNK][16];
    __shared__ float sl[FL_MAX_LIGHTS * 6];
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    bool m = i < n && fl_row(st, n, FL_SURF, i) > 0.0f;
    if (!__syncthreads_or(m)) return;
    for (int e = threadIdx.x; e < n_lights * 6; e += blockDim.x) sl[e] = lights[e];
    __syncthreads();

    // ---- bounce_shade (glsl:529-576) ----
    fl_carry c;
    fl_v3 ray_dir, smooth_normal, random_sphere, albedo, tpo;
    float sign_dir = 0.0f, roughness_brdf = 0.0f, rough = 0.0f, metal = 0.0f, emis = 0.0f;
    bool is_solid = false, write_id_w = false, show_color = false, show_shadow = false;
    int res_num = 0;
    fl_v3 local_color, light_dir, offset_target;
    float max_len = 0.0f;
    if (m) {
        c = fl_read_carry(st, n, i);
        smooth_normal = fl_load3(st + (size_t)(FL_SURF + 1) * n, n, i);
        float geometry_offset = fl_row(st, n, FL_SURF + 4, i);
        albedo = fl_load3(tex, n, i);
        rough = tex[(size_t)3 * n + i];
        metal = tex[(size_t)4 * n + i];
        emis = tex[(size_t)5 * n + i];
        tpo = fl_load3(tex + (size_t)6 * n, n, i);
        float ndc0 = ndc[i], ndc1 = ndc[(size_t)n + i];

        ray_dir = fl_normalize3(fl_sub3(c.ray_origin, c.last_hit));
        sign_dir = fl_sign(fl_dot3(ray_dir, smooth_normal));
        smooth_normal = fl_scale3(smooth_normal, -sign_dir);

        float rv[4];
        fl_noise(counter, ndc0, ndc1, (float)bounce + cos_sample_n, random_seed, 0, 4, rv);
        random_sphere = fl_normalize3(
            fl_add3(smooth_normal, fl_normalize3(fl_make3(rv[0], rv[1], rv[2]))));
        float brdf = 1.0f + (fabsf(fl_dot3(smooth_normal, ray_dir)) - 1.0f) * metal;
        roughness_brdf = rough * brdf;
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
        is_solid = tpo.x * fresnel_reflect <= fabsf(rv[3]);

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
        local_color = fl_make3(0.0f, 0.0f, 0.0f);
        float res_length = 0.0f, total_weight = 0.0f, res_weight = 0.0f;
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
        light_dir = fl_normalize3(res_dir);
        show_color = (res_length == 0.0f) || (res_weight == 0.0f);
        show_shadow = fl_dot3(n_smooth, light_dir) <= FL_BIAS;
        offset_target = fl_add3(c.ray_origin, fl_scale3(n_smooth, geometry_offset));
        max_len = fl_norm3(res_dir);
        write_id_w = c.dont_filter || bounce == 0;  // && m
    }

    // ---- NEE shadow ray ----
    fl_ray shadow_ray;
    if (m) fl_make_ray(offset_target, light_dir, max_len, shadow_ray);
    bool shadowed = fl_block_any(w4, tp, sw, m, shadow_ray);

    // ---- bounce_apply (glsl:448-461, 577-589) ----
    if (m) {
        bool in_shadow = !show_color && (show_shadow || shadowed);
        float id_w = (float)((res_num % 128) * 2) * FL_INV_255;
        id_w = id_w + (in_shadow ? FL_INV_255 : 0.0f);
        fl_v3 e3 = fl_make3(emis, emis, emis);
        fl_v3 lc = (show_color || !in_shadow) ? fl_add3(local_color, e3) : e3;
        if (write_id_w) c.render_id[3] = id_w;
        c.final_color = fl_add3(c.final_color, fl_mul3(lc, c.importancy));
        // next_ray_dir: reflect, or Fresnel-chance refract, roughness-mixed
        float n_dot_i = fl_dot3(smooth_normal, ray_dir);
        fl_v3 reflected = fl_sub3(ray_dir, fl_scale3(smooth_normal, 2.0f * n_dot_i));
        float inv_eta = 1.0f / tpo.z;
        float eta = inv_eta + (tpo.z - inv_eta) * fl_clamp_min(sign_dir, 0.0f);
        float k = 1.0f - eta * eta * (1.0f - n_dot_i * n_dot_i);
        float refr_coef = eta * n_dot_i + sqrtf(fl_clamp_min(k, 0.0f));
        fl_v3 refracted = k < 0.0f ? fl_make3(0.0f, 0.0f, 0.0f)
                                   : fl_sub3(fl_scale3(ray_dir, eta),
                                             fl_scale3(smooth_normal, refr_coef));
        fl_v3 base = is_solid ? reflected : refracted;
        c.ray_dir = fl_normalize3(fl_mix3(base, random_sphere, roughness_brdf));
    }

    if (!do_next) {
        if (m) fl_write_carry(st, n, i, c);
        return;
    }

    // ---- bounce_commit (glsl:591-597): the next closest hit ----
    fl_ray next_ray;
    if (m) fl_make_ray(c.ray_origin, c.ray_dir, FL_POW32, next_ray);
    fl_hit h = fl_block_closest(w4, tp, sw, m, next_ray, FL_BIAS);
    if (!m) return;
    int new_tri = h.col >= 0 ? ids[h.col] : -1;
    c.hs = h.s;
    c.hu = h.u;
    c.hv = h.v;
    c.alive = c.alive && (new_tri != -1);
    c.tri = new_tri < 0 ? 0 : new_tri;
    c.last_hit = c.ray_origin;

    // ---- bounce_pre(i + 1) ----
    fl_surface s = fl_bounce_pre(c, mat, min_importance);
    fl_write_carry(st, n, i, c);
    fl_write_surface(st, n, i, s);
}

FL_EXPORT int fl_sp_pre(float* state, const float* dirs, const float* w4, int tp,
                        const int* ids, const float* mat, const float* cam, int resample,
                        float min_importance, int n, void* stream) {
    if (n <= 0) return 0;
    FL_LAUNCH(fl_sp_pre_kernel, n, FL_FUSED_BLOCK, stream, state, dirs, w4, tp, ids, mat,
              cam, resample, min_importance, n);
}

FL_EXPORT int fl_sp_post(float* state, const float* tex, const float* ndc, const float* w4,
                         int tp, const int* ids, const float* mat, const float* lights,
                         int n_lights, const float* cam, float random_seed,
                         float cos_sample_n, int bounce, int do_next, int counter,
                         float min_importance, int n, void* stream) {
    if (n <= 0) return 0;
    if (n_lights < 0 || n_lights > FL_MAX_LIGHTS) return -1;
    FL_LAUNCH(fl_sp_post_kernel, n, FL_FUSED_BLOCK, stream, state, tex, ndc, w4, tp, ids,
              mat, lights, n_lights, cam, random_seed, cos_sample_n, bounce, do_next,
              counter, min_importance, n);
}
