// The per-bounce split pipeline, PRE and POST (with the live-ray list that
// POST walks), and the whole-frame kernel FRAME.
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
// layout of ops/fused.py), so a warp reads and writes neighbouring floats
// of one row at a time. Each thread reads and writes only its own ray's
// column, so POST updates the state in place, and PRE in place too (it
// reads what it needs of its column before it writes it).
//
// PRE, POST and FRAME are designed for the H100 from what held them back:
// per (ray, triangle) test four 16-term dot products of W (~150
// instructions before any reject), lanes of dead rays riding along in
// every warp through every bounce, and two block-wide barriers per chunk
// of every cast.
// - The record table: each block builds the scene's 16-float triangle
//   records (trace.cuh fl_rec_stage, exact entries of W) in dynamic shared
//   memory once, 64 bytes a triangle (64 KB at the 1024-triangle cap of
//   ops/fused.py), and the lights beside them. A cast is then one thread's
//   loop over the table (fl_table_closest / fl_table_any) with no barrier:
//   the lanes of a warp read the same record (a broadcast), the record
//   test rejects most pairs after 6-14 operations, exactly (trace.cuh
//   fl_rec_closest / fl_rec_any), and a survivor takes the plain version's
//   division and window. Ties in s go to the lowest column.
// - PRE on a persistent grid: PRE is mostly a stream of state writes (55
//   rows a ray, each warp writing 32 neighbouring floats of a row), and its
//   primary cast has no u / v cull, so it casts on the record table as
//   FRAME does, built once per resident block (as many blocks as the card
//   holds at once), not once per block of rays. The blocks stride over the
//   rays in index order, so each warp's row writes stay coalesced. A
//   resampling call (the samples after the first) reads its primary hit
//   from the state: it stages no table and casts nothing, one ray a thread.
// - POST over a live list: fl_sp_live_list_kernel writes the indices of the
//   rays with m = 1 (a ballot per warp and one atomicAdd per block, so they
//   stay in ascending runs) and their count, on the device; POST's persistent
//   blocks (as many as the card holds at once) stride over the list, which
//   they read on the device, so no host sync is needed. A ray with m = 0
//   is left as it is, as the plain version leaves it (every carry write of
//   bounce_post is guarded by m; flexlight_tpu's dead-subtile rule,
//   ops/fused.py:993-1024, at the granularity of one ray). Each ray reads
//   and writes only its own column, so the list's order changes nothing.
// - FRAME with lane refill: a persistent grid; a lane whose ray has run
//   all its samples writes its outputs and takes the next ray index from a
//   global counter (one atomicAdd per warp for the lanes that need one),
//   casts its primary and starts its first sample, so no warp waits for
//   its slowest ray and a ray that misses, or dies, frees its lane at
//   once. Each ray's samples run in order on one lane and its sum is
//   scaled by f32(1 / spp), so the output is the plain frame's whatever
//   the schedule.
//
// What bounds them on the H100: PRE the state's bytes (3 rows read and 55
// written a ray, 70 rows in all when it resamples: ~0.14 / 0.17 ms at
// 1080p); POST the state's bytes (~47 rows read and ~51 written of a live
// ray: ~0.24 ms when every ray of a 1080p frame is live) beside 9 lights x
// (shading + noise) and two casts per live ray; FRAME the operations of its live ray-bounces (chip_smoke.py counts them,
// each test up to its reject). The material row (49 floats) of a ray's own
// triangle and the atlas tables are read from global memory, where L1 and
// L2 serve them.
#include "trace.cuh"

#define FL_FUSED_BLOCK 128
// blocks of FL_FUSED_BLOCK threads that __launch_bounds__ asks ptxas to fit
// on one SM (POST and FRAME), which caps the registers a thread: the
// fewest registers they reach without spills
#define FL_FUSED_MIN_BLOCKS 3
#define FL_FUSED_MAX_TRIS 1024  // ops/fused.py MAX_TRIS: a 64 KB record table
// PRE's blocks, and the blocks of FL_PRE_BLOCK threads that
// __launch_bounds__ asks ptxas to fit on one SM: 72 registers, so more
// warps for PRE's write stream, and at the cap three 64 KB tables, 768
// threads, an SM (the fastest of the shapes tried, PERF.md)
#define FL_PRE_BLOCK 256
#define FL_PRE_MIN_BLOCKS 3

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

// bytes of the record table of tp triangles
static size_t fl_table_bytes(int tp) { return (size_t)tp * 4 * sizeof(float4); }

// PRE over the rays i = thread, thread + grid threads, ...: the primary
// cast (relaxed -BIAS edge, so no u / v cull) on the record table, or with
// `resample` the primary hit and the carried channels read from the state,
// then bounce_carry_init and bounce_pre(0).
__global__ void __launch_bounds__(FL_PRE_BLOCK, FL_PRE_MIN_BLOCKS)
fl_sp_pre_kernel(float* __restrict__ st, const float* __restrict__ dirs,
                 const float* __restrict__ w4, int tp, const int* __restrict__ ids,
                 const float* __restrict__ mat, const float* __restrict__ cam, int resample,
                 float min_importance, int n) {
    FL_DYN_SHARED(float4, rec);
    if (!resample) {
        fl_rec_stage(w4, tp, 0, tp, rec);
        __syncthreads();
    }
    fl_v3 camera = fl_make3(cam[0], cam[1], cam[2]);
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
        fl_v3 dir = fl_load3(dirs, n, i);
        fl_carry c;
        float ps, pu, pv;
        int ptri;
        if (resample) {
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
            // primaries replace the reference's watertight raster pass: relaxed edge
            fl_rray r;
            fl_make_rray(camera, dir, FL_POW32, r);
            fl_hit h = fl_table_closest(rec, tp, r, -FL_BIAS);
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
}

// The live-ray list of a POST call: the indices of the rays with m = 1
// (the SURF row) and, in `count` (zeroed before the launch), how many. A
// warp's live rays take consecutive entries in ascending order (a ballot),
// and a block's warps consecutive runs, by one atomicAdd of the block (the
// grid covers whole blocks): ~2,000 atomics on one address at 1080p, not
// one per warp.
#define FL_LIST_BLOCK 1024
__global__ void __launch_bounds__(FL_LIST_BLOCK)
fl_sp_live_list_kernel(const float* __restrict__ st, int n, int* __restrict__ list,
                       int* __restrict__ count) {
    __shared__ int warp_base[FL_LIST_BLOCK / 32 + 1];
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    bool m = i < n && fl_row(st, n, FL_SURF, i) > 0.0f;
    unsigned live = __ballot_sync(0xffffffffu, m);
    int lane = threadIdx.x % FL_WARP_LANES, warp = threadIdx.x / FL_WARP_LANES;
    int warps = blockDim.x / FL_WARP_LANES;
    if (lane == 0) warp_base[warp] = __popc(live);
    __syncthreads();
    if (threadIdx.x == 0) {
        int sum = 0;
        for (int k = 0; k < warps; ++k) {
            int c = warp_base[k];
            warp_base[k] = sum;
            sum += c;
        }
        warp_base[warps] = sum ? atomicAdd(count, sum) : 0;
    }
    __syncthreads();
    if (m)
        list[warp_base[warps] + warp_base[warp] + __popc(live & ((1u << lane) - 1u))] = i;
}

// POST over the live list: each thread of the persistent grid takes the
// list's entries j = thread, thread + grid threads, ...
__global__ void __launch_bounds__(FL_FUSED_BLOCK, FL_FUSED_MIN_BLOCKS)
fl_sp_post_kernel(float* __restrict__ st, const float* __restrict__ tex,
                  const float* __restrict__ ndc, const float* __restrict__ w4, int tp,
                  const int* __restrict__ ids, const float* __restrict__ mat,
                  const float* __restrict__ lights, int n_lights, const float* __restrict__ cam,
                  float random_seed, float cos_sample_n, int bounce, int do_next, int counter,
                  float min_importance, int n, const int* __restrict__ list,
                  const int* __restrict__ count) {
    FL_DYN_SHARED(float4, rec);
    __shared__ float sl[FL_MAX_LIGHTS * 6];
    int live = *count;
    int first = blockIdx.x * blockDim.x;
    if (first >= live) return;
    fl_rec_stage(w4, tp, 0, tp, rec);
    for (int e = threadIdx.x; e < n_lights * 6; e += blockDim.x) sl[e] = lights[e];
    __syncthreads();
    for (int j = first + threadIdx.x; j < live; j += gridDim.x * blockDim.x) {
        int i = list[j];
        // ---- bounce_shade (glsl:529-576) + reservoir_select (glsl:400-447) ----
        fl_carry c = fl_read_carry(st, n, i);
        fl_v3 smooth_normal = fl_load3(st + (size_t)(FL_SURF + 1) * n, n, i);
        float geometry_offset = fl_row(st, n, FL_SURF + 4, i);
        fl_v3 albedo = fl_load3(tex, n, i);
        float rough = tex[(size_t)3 * n + i];
        float metal = tex[(size_t)4 * n + i];
        float emis = tex[(size_t)5 * n + i];
        fl_v3 tpo = fl_load3(tex + (size_t)6 * n, n, i);
        fl_shade_req q = fl_bounce_shade(c, smooth_normal, geometry_offset, albedo, rough, metal,
                                         emis, tpo, ndc[i], ndc[(size_t)n + i], sl, n_lights,
                                         cam, random_seed, cos_sample_n, bounce, counter);
        // ---- NEE shadow ray, bounce_apply (glsl:448-461, 577-589) ----
        fl_rray shadow_ray;
        fl_make_rray(q.offset_target, q.light_dir, q.max_len, shadow_ray);
        bool shadowed = fl_table_any(rec, tp, shadow_ray);
        fl_bounce_apply(c, q, emis, tpo, shadowed);
        if (!do_next) {
            fl_write_carry(st, n, i, c);
            continue;
        }
        // ---- bounce_commit (glsl:591-597): the next closest hit ----
        fl_rray next_ray;
        fl_make_rray(c.ray_origin, c.ray_dir, FL_POW32, next_ray);
        fl_bounce_commit(c, fl_table_closest(rec, tp, next_ray, FL_BIAS), ids);
        // ---- bounce_pre(i + 1) ----
        fl_surface s = fl_bounce_pre(c, mat, min_importance);
        fl_write_carry(st, n, i, c);
        fl_write_surface(st, n, i, s);
    }
}

FL_EXPORT int fl_sp_pre(float* state, const float* dirs, const float* w4, int tp,
                        const int* ids, const float* mat, const float* cam, int resample,
                        float min_importance, int n, void* stream) {
    if (n <= 0) return 0;
    if (tp < 0 || tp > FL_FUSED_MAX_TRIS) return -1;
    int blocks = (n + FL_PRE_BLOCK - 1) / FL_PRE_BLOCK;
    if (resample)  // no table: one ray a thread
        FL_LAUNCH_BLOCKS(fl_sp_pre_kernel, blocks, FL_PRE_BLOCK, stream, state, dirs, w4, tp,
                         ids, mat, cam, resample, min_importance, n);
    size_t smem = fl_table_bytes(tp);
    int grid = fl_persistent_grid(fl_sp_pre_kernel, FL_PRE_BLOCK, smem, blocks);
    FL_LAUNCH_BLOCKS_SMEM(fl_sp_pre_kernel, grid, FL_PRE_BLOCK, smem, stream, state, dirs, w4,
                          tp, ids, mat, cam, resample, min_importance, n);
}

FL_EXPORT int fl_sp_live_list(const float* state, int n, int* list, int* count, void* stream) {
    int err = FL_ZERO_ASYNC(count, sizeof(int), stream);
    if (err || n <= 0) return err;
    FL_LAUNCH(fl_sp_live_list_kernel, n, FL_LIST_BLOCK, stream, state, n, list, count);
}

// POST over the live list of `state` that fl_sp_live_list wrote into
// `list` / `count` (int32 [n] and [1]).
FL_EXPORT int fl_sp_post(float* state, const float* tex, const float* ndc, const float* w4,
                         int tp, const int* ids, const float* mat, const float* lights,
                         int n_lights, const float* cam, float random_seed,
                         float cos_sample_n, int bounce, int do_next, int counter,
                         float min_importance, int n, const int* list, const int* count,
                         void* stream) {
    if (n <= 0) return 0;
    if (n_lights < 0 || n_lights > FL_MAX_LIGHTS || tp < 0 || tp > FL_FUSED_MAX_TRIS) return -1;
    size_t smem = fl_table_bytes(tp);
    int grid = fl_persistent_grid(fl_sp_post_kernel, FL_FUSED_BLOCK, smem,
                                  (n + FL_FUSED_BLOCK - 1) / FL_FUSED_BLOCK);
    FL_LAUNCH_BLOCKS_SMEM(fl_sp_post_kernel, grid, FL_FUSED_BLOCK, smem, stream, state, tex,
                          ndc, w4, tp, ids, mat, lights, n_lights, cam, random_seed,
                          cos_sample_n, bounce, do_next, counter, min_importance, n, list,
                          count);
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
// The schedule: every lane holds one ray at a time (its carry, surface,
// sample sum and primary hit in registers). A step of the warp first lets
// each lane without a ray take the next ray index (one atomicAdd of
// `ray_counter` for the warp), cast its primary and start its first sample;
// a sample that has no bounce to run (a miss, a ray dead or past the last
// bounce) is closed at once, the next one started, and a ray whose samples
// are all done writes its outputs and frees the lane, which takes another.
// Then every lane with a ray runs one bounce. A warp leaves once its lanes
// have no ray and the counter is spent. With `lane_stats` (else null), lane
// 0 of each warp adds, per step, the warp's lanes to lane_stats[0] and its
// lanes that ran a bounce to lane_stats[1].

__global__ void __launch_bounds__(FL_FUSED_BLOCK, FL_FUSED_MIN_BLOCKS)
fl_fused_frame_kernel(
    float* __restrict__ out, const float* __restrict__ dirs, const float* __restrict__ ndc,
    const float* __restrict__ w4, int tp, const int* __restrict__ ids,
    const float* __restrict__ mat, const float* __restrict__ lights, int n_lights,
    const float* __restrict__ ambient, fl_atlas alb, fl_atlas pbr, fl_atlas tpo_tab,
    const float* __restrict__ cam, const float* __restrict__ seed,
    const float* __restrict__ cos_samples, int spp, float inv_spp, int bounces, int counter,
    float min_importance, int n, int* __restrict__ ray_counter, int* __restrict__ lane_stats) {
    FL_DYN_SHARED(float4, rec);
    __shared__ float sl[FL_MAX_LIGHTS * 6];
    fl_rec_stage(w4, tp, 0, tp, rec);
    for (int e = threadIdx.x; e < n_lights * 6; e += blockDim.x) sl[e] = lights[e];
    __syncthreads();
    const unsigned full = 0xffffffffu;
    int lane = threadIdx.x % FL_WARP_LANES;
    fl_v3 camera = fl_make3(cam[0], cam[1], cam[2]);
    fl_v3 amb = fl_make3(ambient[0], ambient[1], ambient[2]);
    float random_seed = *seed;

    int i = -1;        // this lane's ray, -1 while it has none
    bool more = true;  // the counter may still hand out rays
    int s = 0, b = 0;  // the ray's sample and bounce
    fl_v3 dir = fl_make3(0.0f, 0.0f, 1.0f), total = fl_make3(0.0f, 0.0f, 0.0f);
    float ndc0 = 0.0f, ndc1 = 0.0f, ps = 0.0f, pu = 0.0f, pv = 0.0f, cos_sample_n = 0.0f;
    int ptri = -1;
    fl_carry c;
    fl_surface sf;

    auto start_sample = [&]() {
        cos_sample_n = cos_samples[s];
        fl_carry_init(c, ps, pu, pv, ptri, camera, dir);
        sf = fl_bounce_pre(c, mat, min_importance);
        b = 0;
    };
    // close the samples that have no bounce left to run; after the last,
    // write the ray's outputs and free the lane
    auto settle = [&]() {
        while (i >= 0 && !(sf.m && b < bounces)) {
            // light_trace's epilogue (glsl:595-597): ambient by importancy
            fl_v3 color = fl_add3(c.final_color, fl_mul3(c.importancy, amb));
            total = s == 0 ? color : fl_add3(total, color);
            if (++s < spp) {
                start_sample();
                continue;
            }
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
            i = -1;
        }
    };

    while (true) {
        // ---- refill: the lanes without a ray take the next ones ----
        while (true) {
            bool need = i < 0 && more;
            unsigned want = __ballot_sync(full, need);
            if (!want) break;
            int leader = __ffs(want) - 1;
            int base = 0;
            if (lane == leader) base = atomicAdd(ray_counter, __popc(want));
            base = __shfl_sync(full, base, leader);
            if (!need) continue;
            int ray = base + __popc(want & ((1u << lane) - 1u));
            if (ray >= n) {
                more = false;
                continue;
            }
            i = ray;
            dir = fl_load3(dirs, n, i);
            ndc0 = ndc[i];
            ndc1 = ndc[(size_t)n + i];
            // primaries replace the reference's watertight raster pass: relaxed edge
            fl_rray r;
            fl_make_rray(camera, dir, FL_POW32, r);
            fl_hit h = fl_table_closest(rec, tp, r, -FL_BIAS);
            ps = h.s;
            pu = h.u;
            pv = h.v;
            ptri = h.col >= 0 ? ids[h.col] : -1;
            for (int k = 0; k < 4; ++k) c.render_id[k] = 0.0f;
            c.glass = 0.0f;
            c.rme_x = 0.0f;
            c.tpo_x = 0.0f;
            c.first_ray_length = 1.0f;
            s = 0;
            start_sample();
            settle();
        }
        bool active = i >= 0;
        unsigned busy = __ballot_sync(full, active);
        if (!busy) break;
        if (lane_stats && lane == 0) {
            atomicAdd(&lane_stats[0], FL_WARP_LANES);
            atomicAdd(&lane_stats[1], __popc(busy));
        }
        if (!active) continue;
        // ---- one bounce: bounce_tex, bounce_shade + reservoir_select ----
        fl_v3 albedo = fl_fetch_tex(alb, sf.bary_u, sf.bary_v, sf.tex[0],
                                    fl_make3(sf.tex[3], sf.tex[4], sf.tex[5]));
        fl_v3 rme = fl_fetch_tex(pbr, sf.bary_u, sf.bary_v, sf.tex[1],
                                 fl_make3(sf.tex[6], sf.tex[7], sf.tex[8]));
        fl_v3 tpo = fl_fetch_tex(tpo_tab, sf.bary_u, sf.bary_v, sf.tex[2],
                                 fl_make3(sf.tex[9], sf.tex[10], sf.tex[11]));
        float emis = rme.z;
        fl_shade_req q = fl_bounce_shade(c, sf.smooth_normal, sf.geometry_offset, albedo, rme.x,
                                         rme.y, emis, tpo, ndc0, ndc1, sl, n_lights, cam,
                                         random_seed, cos_sample_n, b, counter);
        // ---- NEE shadow ray, bounce_apply ----
        fl_rray shadow_ray;
        fl_make_rray(q.offset_target, q.light_dir, q.max_len, shadow_ray);
        bool shadowed = fl_table_any(rec, tp, shadow_ray);
        fl_bounce_apply(c, q, emis, tpo, shadowed);
        // ---- bounce_commit: the next closest hit, bounce_pre(b + 1) ----
        if (b + 1 < bounces) {
            fl_rray next_ray;
            fl_make_rray(c.ray_origin, c.ray_dir, FL_POW32, next_ray);
            fl_bounce_commit(c, fl_table_closest(rec, tp, next_ray, FL_BIAS), ids);
            sf = fl_bounce_pre(c, mat, min_importance);
        }
        ++b;
        settle();
    }
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
                             int n, int* ray_counter, int* lane_stats, void* stream) {
    if (n <= 0) return 0;
    if (n_lights < 0 || n_lights > FL_MAX_LIGHTS || tp < 0 || tp > FL_FUSED_MAX_TRIS) return -1;
    fl_atlas alb = {alb_texels, alb_u8, alb_info, alb_slots, alb_meta};
    fl_atlas pbr = {pbr_texels, pbr_u8, pbr_info, pbr_slots, pbr_meta};
    fl_atlas tpo = {tpo_texels, tpo_u8, tpo_info, tpo_slots, tpo_meta};
    int err = FL_ZERO_ASYNC(ray_counter, sizeof(int), stream);
    if (err) return err;
    size_t smem = fl_table_bytes(tp);
    int grid = fl_persistent_grid(fl_fused_frame_kernel, FL_FUSED_BLOCK, smem,
                                  (n + FL_FUSED_BLOCK - 1) / FL_FUSED_BLOCK);
    FL_LAUNCH_BLOCKS_SMEM(fl_fused_frame_kernel, grid, FL_FUSED_BLOCK, smem, stream, out, dirs,
                          ndc, w4, tp, ids, mat, lights, n_lights, ambient, alb, pbr, tpo, cam,
                          seed, cos_samples, spp, inv_spp, bounces, counter, min_importance, n,
                          ray_counter, lane_stats);
}
