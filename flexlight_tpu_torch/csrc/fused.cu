// The per-bounce split pipeline, PRE and POST, and the whole-frame kernel
// FRAME, one thread per ray.
//
// Replaces: flexlight_tpu/ops/fused.py `_sp_i0_kernel` (PRE) and
// `_sp_post_kernel` (POST), launched by render_mrt_fused_split.run_kernel,
// and `_fused_kernel` (FRAME), launched by render_mrt_fused.
// Plain versions: ops/fused.py sp_pre_plain / sp_post_plain and
// fused_frame_plain, built from the stage functions of ops/pathtrace.py;
// every float operation here is theirs, in their order (trace.cuh), so
// with --fmad=false the kernels agree with them bit for bit.
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

// bounce_carry_init from the primary hit (s, u, v, triangle slot or -1),
// up to the channels carried across samples (render_id, glass, rme_x,
// tpo_x, first_ray_length), which the caller sets
__device__ __forceinline__ void fl_carry_init(fl_carry& c, float ps, float pu, float pv,
                                              int ptri, fl_v3 camera, fl_v3 dir) {
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
}

// bounce_commit (glsl:591-597) of a live ray given its next closest hit
__device__ __forceinline__ void fl_bounce_commit(fl_carry& c, const fl_hit& h,
                                                 const int* __restrict__ ids) {
    int new_tri = h.col >= 0 ? ids[h.col] : -1;
    c.hs = h.s;
    c.hu = h.u;
    c.hv = h.v;
    c.alive = c.alive && (new_tri != -1);
    c.tri = new_tri < 0 ? 0 : new_tri;
    c.last_hit = c.ray_origin;
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
    fl_carry_init(c, ps, pu, pv, ptri, camera, dir);
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
    if (m) fl_bounce_apply(c, q, emis, tpo, shadowed);

    if (!do_next) {
        if (m) fl_write_carry(st, n, i, c);
        return;
    }

    // ---- bounce_commit (glsl:591-597): the next closest hit ----
    fl_ray next_ray;
    if (m) fl_make_ray(c.ray_origin, c.ray_dir, FL_POW32, next_ray);
    fl_hit h = fl_block_closest(w4, tp, sw, m, next_ray, FL_BIAS);
    if (!m) return;
    fl_bounce_commit(c, h, ids);

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

// ---- FRAME: the whole direct frame of a small scene -----------------------
//
// Per ray: the primary closest hit (relaxed -BIAS edge), then for each of
// `spp` samples bounce_carry_init (the render_id, glass, rme_x, tpo_x and
// first_ray_length of the sample before carried over, as PRE's
// `resample`), bounce_pre(0) and `bounces` bounces of: the three atlas
// fetches of bounce_tex (fl_fetch_tex, in place of the torch glue
// between POST calls), POST's bounce_shade, shadow any hit, bounce_apply,
// next closest hit and bounce_pre; after each sample light_trace's
// ambient epilogue, summed over the samples in render_mrt_fused_split's
// order and scaled by f32(1 / spp). It writes the block [FR_C, N] that
// ops/fused.py assembles into the MRT: final color (3), original color
// (3), render_id (4), glass, rme_x, tpo_x, first_ray_length, primary s,
// u, v and triangle slot (-1 on a miss).
//
// What bounds it on the H100: operations. A ray reads 5 words and writes
// 18, ~0.06 ms at 1080p; each live ray and bounce tests every triangle in
// its next cast and up to every triangle in its shadow cast (~60 float
// operations a test) and shades every light (~150 a light): with wave's
// 50 triangles and 1 light, 3-6 kFLOP per live ray and bounce, so the
// bound follows the live rays (chip_smoke.py counts them). The carry, the
// sample sum and the primary hit stay in registers for the whole frame; the
// triangle rows pass through shared memory in chunks and the lights sit
// there, as in POST; the material rows and the atlas tables are read from
// global memory (at the caps 200 KB and 3 x 4096 texels, which L1 and L2
// hold).
//
// Every thread of a block reaches every cast of every bounce (the casts
// stage W block-wide): a dead ray, and a thread past the last ray, only
// helps stage and keeps its carry as it is, as in POST. A ray that is dead
// at a bounce stays dead for the rest of its sample, so the block leaves
// the sample's bounce loop together once none of its rays is live.

__global__ void fl_fused_frame_kernel(
    float* __restrict__ out, const float* __restrict__ dirs, const float* __restrict__ ndc,
    const float* __restrict__ w4, int tp, const int* __restrict__ ids,
    const float* __restrict__ mat, const float* __restrict__ lights, int n_lights,
    const float* __restrict__ ambient, fl_atlas alb, fl_atlas pbr, fl_atlas tpo_tab,
    const float* __restrict__ cam, const float* __restrict__ seed,
    const float* __restrict__ cos_samples, int spp, float inv_spp, int bounces, int counter,
    float min_importance, int n) {
    __shared__ float sw[4][FL_TRI_CHUNK][16];
    __shared__ float sl[FL_MAX_LIGHTS * 6];
    for (int e = threadIdx.x; e < n_lights * 6; e += blockDim.x) sl[e] = lights[e];
    __syncthreads();
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    bool in = i < n;
    fl_v3 camera = fl_make3(cam[0], cam[1], cam[2]);
    fl_v3 amb = fl_make3(ambient[0], ambient[1], ambient[2]);
    fl_v3 dir = in ? fl_load3(dirs, n, i) : fl_make3(0.0f, 0.0f, 1.0f);
    float ndc0 = in ? ndc[i] : 0.0f;
    float ndc1 = in ? ndc[(size_t)n + i] : 0.0f;
    float random_seed = *seed;

    // primaries replace the reference's watertight raster pass: relaxed edge
    fl_ray r;
    fl_make_ray(camera, dir, FL_POW32, r);
    fl_hit h = fl_block_closest(w4, tp, sw, in, r, -FL_BIAS);
    float ps = h.s, pu = h.u, pv = h.v;
    int ptri = h.col >= 0 ? ids[h.col] : -1;

    fl_carry c;
    for (int k = 0; k < 4; ++k) c.render_id[k] = 0.0f;
    c.glass = 0.0f;
    c.rme_x = 0.0f;
    c.tpo_x = 0.0f;
    c.first_ray_length = 1.0f;
    fl_v3 total = fl_make3(0.0f, 0.0f, 0.0f);
    for (int s = 0; s < spp; ++s) {
        float cos_sample_n = cos_samples[s];
        fl_carry_init(c, ps, pu, pv, ptri, camera, dir);
        fl_surface sf;
        sf.m = false;
        if (in) sf = fl_bounce_pre(c, mat, min_importance);
        for (int b = 0; b < bounces; ++b) {
            bool m = in && sf.m;
            if (!__syncthreads_or(m)) break;
            // ---- bounce_tex, bounce_shade + reservoir_select ----
            fl_shade_req q;
            fl_v3 tpo;
            float emis = 0.0f;
            if (m) {
                fl_v3 albedo = fl_fetch_tex(alb, sf.bary_u, sf.bary_v, sf.tex[0],
                                            fl_make3(sf.tex[3], sf.tex[4], sf.tex[5]));
                fl_v3 rme = fl_fetch_tex(pbr, sf.bary_u, sf.bary_v, sf.tex[1],
                                         fl_make3(sf.tex[6], sf.tex[7], sf.tex[8]));
                tpo = fl_fetch_tex(tpo_tab, sf.bary_u, sf.bary_v, sf.tex[2],
                                   fl_make3(sf.tex[9], sf.tex[10], sf.tex[11]));
                emis = rme.z;
                q = fl_bounce_shade(c, sf.smooth_normal, sf.geometry_offset, albedo, rme.x,
                                    rme.y, emis, tpo, ndc0, ndc1, sl, n_lights, cam,
                                    random_seed, cos_sample_n, b, counter);
            }
            // ---- NEE shadow ray, bounce_apply ----
            fl_ray shadow_ray;
            if (m) fl_make_ray(q.offset_target, q.light_dir, q.max_len, shadow_ray);
            bool shadowed = fl_block_any(w4, tp, sw, m, shadow_ray);
            if (m) fl_bounce_apply(c, q, emis, tpo, shadowed);
            if (b + 1 == bounces) break;
            // ---- bounce_commit: the next closest hit, bounce_pre(b + 1) ----
            fl_ray next_ray;
            if (m) fl_make_ray(c.ray_origin, c.ray_dir, FL_POW32, next_ray);
            fl_hit nh = fl_block_closest(w4, tp, sw, m, next_ray, FL_BIAS);
            if (m) {
                fl_bounce_commit(c, nh, ids);
                sf = fl_bounce_pre(c, mat, min_importance);
            }
        }
        // light_trace's epilogue (glsl:595-597): ambient by importancy
        fl_v3 color = fl_add3(c.final_color, fl_mul3(c.importancy, amb));
        total = s == 0 ? color : fl_add3(total, color);
    }
    if (!in) return;
    fl_store3(out, n, i, fl_scale3(total, inv_spp));
    fl_store3(out + (size_t)3 * n, n, i, c.original_color);
    for (int k = 0; k < 4; ++k) fl_put(out, n, 6 + k, i, c.render_id[k]);
    fl_put(out, n, 10, i, c.glass);
    fl_put(out, n, 11, i, c.rme_x);
    fl_put(out, n, 12, i, c.tpo_x);
    fl_put(out, n, 13, i, c.first_ray_length);
    fl_put(out, n, 14, i, ps);
    fl_put(out, n, 15, i, pu);
    fl_put(out, n, 16, i, pv);
    fl_put(out, n, 17, i, (float)ptri);
}

FL_EXPORT int fl_fused_frame(float* out, const float* dirs, const float* ndc, const float* w4,
                             int tp, const int* ids, const float* mat, const float* lights,
                             int n_lights, const float* ambient, const void* alb_texels,
                             int alb_u8, const int* alb_info, int alb_slots,
                             const int* alb_meta, const void* pbr_texels, int pbr_u8,
                             const int* pbr_info, int pbr_slots, const int* pbr_meta,
                             const void* tpo_texels, int tpo_u8, const int* tpo_info,
                             int tpo_slots, const int* tpo_meta, const float* cam,
                             const float* seed, const float* cos_samples, int spp,
                             float inv_spp, int bounces, int counter, float min_importance,
                             int n, void* stream) {
    if (n <= 0) return 0;
    if (n_lights < 0 || n_lights > FL_MAX_LIGHTS) return -1;
    fl_atlas alb = {alb_texels, alb_u8, alb_info, alb_slots, alb_meta};
    fl_atlas pbr = {pbr_texels, pbr_u8, pbr_info, pbr_slots, pbr_meta};
    fl_atlas tpo = {tpo_texels, tpo_u8, tpo_info, tpo_slots, tpo_meta};
    FL_LAUNCH(fl_fused_frame_kernel, n, FL_FUSED_BLOCK, stream, out, dirs, ndc, w4, tp, ids,
              mat, lights, n_lights, ambient, alb, pbr, tpo, cam, seed, cos_samples, spp,
              inv_spp, bounces, counter, min_importance, n);
}
