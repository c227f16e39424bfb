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

// the rows of the split pipeline's state past the carry and the surface
// (ops/fused.py); the carry rows and FL_SURF are trace.cuh's
#define FL_PPART 37
#define FL_TEXIN 41
#define FL_SP_C 55

__device__ __forceinline__ void fl_write_surface(float* st, int n, int i,
                                                 const fl_surface& s) {
    fl_put(st, n, FL_SURF, i, s.m ? 1.0f : 0.0f);
    fl_store3(st + (size_t)(FL_SURF + 1) * n, n, i, s.smooth_normal);
    fl_put(st, n, FL_SURF + 4, i, s.geometry_offset);
    fl_put(st, n, FL_TEXIN, i, s.bary_u);
    fl_put(st, n, FL_TEXIN + 1, i, s.bary_v);
    for (int k = 0; k < 12; ++k) fl_put(st, n, FL_TEXIN + 2 + k, i, s.tex[k]);
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

    // ---- bounce_shade (glsl:529-576) + reservoir_select (glsl:400-447) ----
    fl_carry c;
    fl_shade_req q;
    fl_v3 tpo;
    float emis = 0.0f;
    if (m) {
        c = fl_read_carry(st, n, i);
        fl_v3 smooth_normal = fl_load3(st + (size_t)(FL_SURF + 1) * n, n, i);
        float geometry_offset = fl_row(st, n, FL_SURF + 4, i);
        fl_v3 albedo = fl_load3(tex, n, i);
        float rough = tex[(size_t)3 * n + i];
        float metal = tex[(size_t)4 * n + i];
        emis = tex[(size_t)5 * n + i];
        tpo = fl_load3(tex + (size_t)6 * n, n, i);
        q = fl_bounce_shade(c, smooth_normal, geometry_offset, albedo, rough, metal, emis, tpo,
                            ndc[i], ndc[(size_t)n + i], sl, n_lights, cam, random_seed,
                            cos_sample_n, bounce, counter);
    }

    // ---- NEE shadow ray ----
    fl_ray shadow_ray;
    if (m) fl_make_ray(q.offset_target, q.light_dir, q.max_len, shadow_ray);
    bool shadowed = fl_block_any(w4, tp, sw, m, shadow_ray);

    // ---- bounce_apply (glsl:448-461, 577-589) ----
    if (m) {
        bool in_shadow = !q.show_color && (q.show_shadow || shadowed);
        float id_w = (float)((q.res_num % 128) * 2) * FL_INV_255;
        id_w = id_w + (in_shadow ? FL_INV_255 : 0.0f);
        fl_v3 e3 = fl_make3(emis, emis, emis);
        fl_v3 lc = (q.show_color || !in_shadow) ? fl_add3(q.local_color, e3) : e3;
        if (q.write_id_w) c.render_id[3] = id_w;
        c.final_color = fl_add3(c.final_color, fl_mul3(lc, c.importancy));
        // next_ray_dir: reflect, or Fresnel-chance refract, roughness-mixed
        float n_dot_i = fl_dot3(q.smooth_normal, q.ray_dir);
        fl_v3 reflected = fl_sub3(q.ray_dir, fl_scale3(q.smooth_normal, 2.0f * n_dot_i));
        float inv_eta = 1.0f / tpo.z;
        float eta = inv_eta + (tpo.z - inv_eta) * fl_clamp_min(q.sign_dir, 0.0f);
        float k = 1.0f - eta * eta * (1.0f - n_dot_i * n_dot_i);
        float refr_coef = eta * n_dot_i + sqrtf(fl_clamp_min(k, 0.0f));
        fl_v3 refracted = k < 0.0f ? fl_make3(0.0f, 0.0f, 0.0f)
                                   : fl_sub3(fl_scale3(q.ray_dir, eta),
                                             fl_scale3(q.smooth_normal, refr_coef));
        fl_v3 base = q.is_solid ? reflected : refracted;
        c.ray_dir = fl_normalize3(fl_mix3(base, q.random_sphere, q.roughness_brdf));
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
