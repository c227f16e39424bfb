// The per-bounce shading kernels of large scenes: shade and interp_shade,
// each a walk over a device-side list of its live rays on a persistent
// grid.
//
// Replaces: flexlight_tpu/ops/fused.py `_shade_kernel` (launched by
// make_shade_bounce_post) and `_interp_shade_kernel` (launched by
// make_fused_bounce_step), flexlight_tpu's per-bounce shading of the
// kernel and sparse schemes. Plain versions: ops/shade.py shade_plain /
// interp_shade_plain, built from the stage functions of ops/pathtrace.py;
// every float operation here is theirs, in their order (trace.cuh: the
// same fl_bounce_pre and fl_bounce_shade as POST in fused.cu), so with
// --fmad=false the kernels agree with them bit for bit.
//
// shade:        bounce_shade(i) (shading frame, RNG, Fresnel-chance
//               decision, first-surface bookkeeping and render_id packing,
//               the reservoir light selection) of a ray whose surface
//               (bounce_pre) and textures (bounce_tex) torch computed.
// interp_shade: bounce_pre(i) from the ray's own material row, the texture
//               select of three 1x1 atlases, then bounce_shade(i).
// Both stop at the NEE request: the shadow cast, bounce_apply and the next
// closest hit stay with the scheme's casts and torch (ops/shade.py).
//
// The state is float32 [ST_C, N] (ops/shade.py: the carry rows of
// ops/fused.py, then m, the smooth normal and the geometry offset), one
// contiguous row per channel; the request is float32 [REQ_C, N] (shade) or
// [REQ_STEP_C, N] (interp_shade: the request, then emis and tpo for
// bounce_apply). Each thread reads and writes only its own ray's column and
// updates the carry in place: shade writes the 14 carry rows that
// bounce_shade changes, interp_shade those and alive, ray_origin and m.
// flexlight_tpu's kernels also write seven "record" channels per bounce
// (dont_filter and the inputs of the render_id packing) and pack the ids
// outside, only because arctan2 has no Mosaic lowering; atan2f exists
// here, so the packing runs in the kernel and the port has no record
// channels.
//
// Dead rays, as in POST. shade: a ray with m == 0 is not listed and is
// not read or written (every carry write of bounce_shade is guarded by
// m); its request columns keep what they held (the caller masks them).
// interp_shade: the list pass writes m = 0 for a ray that is not alive
// and reads nothing else of it; bounce_pre's importance kill writes alive
// = m = 0 and nothing else.
//
// What bounds them on the H100: memory. A live ray reads 34 words and
// writes 39 (shade), or reads 28 words and its 49-float material row and
// writes 46 (interp_shade), and every ray's m or alive is read once: at
// 1920x1080 ~0.17-0.19 ms per bounce when every ray is live, and in
// proportion to the live rays after it. The arithmetic, ~160
// float operations per light plus the noise and the frame (~1.6 kFLOP per
// ray with 9 lights), takes a third of that at the fp32 rate.
// What the design does about it. One thread per ray over all N rays made a
// warp with one live lane pay the whole body, so the sparse later bounces
// cost nearly what bounce 0 does. So:
// - The list. shade walks POST's live list (fused.cu
//   fl_sp_live_list_kernel, launched by its own wrapper: the m row is
//   FL_SURF in both states). interp_shade's rays are the alive ones, and
//   every other ray must get m = 0, so its list pass fl_alive_list_kernel
//   reads alive once for all N rays, writes m = 0 for the rays that are
//   not alive and appends the alive ones (a ballot per warp, one atomicAdd
//   per block). The count stays on the device, where the walk reads it:
//   no host sync.
// - The grid. The walk's blocks are as many as the card holds at once
//   (fl_persistent_grid); each stages the lights (<= 256 rows of 6
//   floats) into shared memory once and strides over the list, j =
//   thread, thread + grid threads, ..., with the next entry loaded a step
//   ahead; a block whose first entry is past the count returns at once.
//   Live rays fill the lanes of every warp but the last.
// - Order. Each ray reads and writes only its own column, so the list's
//   order (its warps' runs come in any order) changes nothing.
// - The shared body is unchanged: fl_read_carry, fl_bounce_pre and
//   fl_bounce_shade (trace.cuh) are POST's and FRAME's too. A listed ray
//   is alive, which the walk sets rather than reads again.
// What the list cannot remove: a sparse bounce's listed rays lie scattered
// over the rows, so each of their reads and writes moves a whole 32-byte
// sector of a row for one ray's word, and the last bounces hold too few
// warps to fill the card; so a later bounce costs more per shaded ray
// than bounce 0 (PERF.md). The material row is read from global memory,
// where L1 and L2 serve the rays that share a triangle.
#include "trace.cuh"

// the walk's blocks, and the blocks of FL_SHADE_BLOCK threads that
// __launch_bounds__ asks ptxas to fit on one SM (shade, interp_shade),
// which caps the registers a thread: shade 96 registers without a spill,
// interp_shade 128 (it spills at 96); the fastest of the shapes tried
// (PERF.md)
#define FL_SHADE_BLOCK 128
#define FL_SHADE_MIN_BLOCKS 5
#define FL_INTERP_MIN_BLOCKS 1
#define FL_ALIVE_LIST_BLOCK 1024

// request rows (ops/shade.py)
#define FL_Q_RAY_DIR 0
#define FL_Q_SMOOTH_NORMAL 3
#define FL_Q_SIGN_DIR 6
#define FL_Q_RANDOM_SPHERE 7
#define FL_Q_ROUGHNESS_BRDF 10
#define FL_Q_IS_SOLID 11
#define FL_Q_WRITE_ID_W 12
#define FL_Q_LOCAL_COLOR 13
#define FL_Q_RES_NUM 16
#define FL_Q_SHOW_COLOR 17
#define FL_Q_SHOW_SHADOW 18
#define FL_Q_OFFSET_TARGET 19
#define FL_Q_LIGHT_DIR 22
#define FL_Q_MAX_LEN 25
#define FL_Q_EMIS 26
#define FL_Q_TPO 27

__device__ __forceinline__ void fl_stage_lights(const float* __restrict__ lights, int n_lights,
                                                float* sl) {
    for (int e = threadIdx.x; e < n_lights * 6; e += blockDim.x) sl[e] = lights[e];
}

// The carry rows bounce_shade changes.
__device__ __forceinline__ void fl_write_shaded(float* st, int n, int i, const fl_carry& c) {
    fl_store3(st + (size_t)FL_IMPORTANCY * n, n, i, c.importancy);
    fl_store3(st + (size_t)FL_ORIGINAL_COLOR * n, n, i, c.original_color);
    fl_put(st, n, FL_DONT_FILTER, i, c.dont_filter ? 1.0f : 0.0f);
    for (int k = 0; k < 3; ++k) fl_put(st, n, FL_RENDER_ID + k, i, c.render_id[k]);
    fl_put(st, n, FL_GLASS, i, c.glass);
    fl_put(st, n, FL_RME_X, i, c.rme_x);
    fl_put(st, n, FL_TPO_X, i, c.tpo_x);
    fl_put(st, n, FL_FIRST_RAY_LENGTH, i, c.first_ray_length);
}

__device__ __forceinline__ void fl_write_request(float* rq, int n, int i,
                                                 const fl_shade_req& q) {
    fl_store3(rq + (size_t)FL_Q_RAY_DIR * n, n, i, q.ray_dir);
    fl_store3(rq + (size_t)FL_Q_SMOOTH_NORMAL * n, n, i, q.smooth_normal);
    fl_put(rq, n, FL_Q_SIGN_DIR, i, q.sign_dir);
    fl_store3(rq + (size_t)FL_Q_RANDOM_SPHERE * n, n, i, q.random_sphere);
    fl_put(rq, n, FL_Q_ROUGHNESS_BRDF, i, q.roughness_brdf);
    fl_put(rq, n, FL_Q_IS_SOLID, i, q.is_solid ? 1.0f : 0.0f);
    fl_put(rq, n, FL_Q_WRITE_ID_W, i, q.write_id_w ? 1.0f : 0.0f);
    fl_store3(rq + (size_t)FL_Q_LOCAL_COLOR * n, n, i, q.local_color);
    fl_put(rq, n, FL_Q_RES_NUM, i, (float)q.res_num);
    fl_put(rq, n, FL_Q_SHOW_COLOR, i, q.show_color ? 1.0f : 0.0f);
    fl_put(rq, n, FL_Q_SHOW_SHADOW, i, q.show_shadow ? 1.0f : 0.0f);
    fl_store3(rq + (size_t)FL_Q_OFFSET_TARGET * n, n, i, q.offset_target);
    fl_store3(rq + (size_t)FL_Q_LIGHT_DIR * n, n, i, q.light_dir);
    fl_put(rq, n, FL_Q_MAX_LEN, i, q.max_len);
}

// shade over the live list of `st` that fl_sp_live_list wrote (`list`,
// `count`): each thread of the persistent grid takes the entries j =
// thread, thread + grid threads, ..., and loads its next entry's ray index
// one step ahead, so that a step's state loads need not wait for it.
__global__ void __launch_bounds__(FL_SHADE_BLOCK, FL_SHADE_MIN_BLOCKS)
fl_shade_kernel(float* __restrict__ st, float* __restrict__ rq, const float* __restrict__ tex,
                const float* __restrict__ ndc, const float* __restrict__ lights, int n_lights,
                const float* __restrict__ cam, const float* __restrict__ seed,
                const float* __restrict__ cos_sample_n, int bounce, int counter, int n,
                const int* __restrict__ list, const int* __restrict__ count) {
    __shared__ float sl[FL_MAX_LIGHTS * 6];
    int live = *count;
    int first = blockIdx.x * blockDim.x;
    if (first >= live) return;
    fl_stage_lights(lights, n_lights, sl);
    __syncthreads();
    float random_seed = *seed, cos_n = *cos_sample_n;
    int stride = gridDim.x * blockDim.x;
    int next = first + threadIdx.x < live ? list[first + threadIdx.x] : 0;
    for (int j = first + threadIdx.x; j < live; j += stride) {
        int i = next;
        if (j + stride < live) next = list[j + stride];
        fl_carry c = fl_read_carry(st, n, i);
        fl_v3 smooth_normal = fl_load3(st + (size_t)(FL_SURF + 1) * n, n, i);
        float geometry_offset = fl_row(st, n, FL_SURF + 4, i);
        fl_v3 albedo = fl_load3(tex, n, i);
        float rough = tex[(size_t)3 * n + i];
        float metal = tex[(size_t)4 * n + i];
        float emis = tex[(size_t)5 * n + i];
        fl_v3 tpo = fl_load3(tex + (size_t)6 * n, n, i);
        fl_shade_req q = fl_bounce_shade(c, smooth_normal, geometry_offset, albedo, rough,
                                         metal, emis, tpo, ndc[i], ndc[(size_t)n + i], sl,
                                         n_lights, cam, random_seed, cos_n, bounce, counter);
        fl_write_shaded(st, n, i, c);
        fl_write_request(rq, n, i, q);
    }
}

// interp_shade's list pass: the indices of the rays with alive = 1 (the
// ALIVE row) and, in `count` (zeroed before the launch), how many; m = 0
// for every other ray. A warp's alive rays take consecutive entries in
// ascending order (a ballot), a block's warps consecutive runs, by one
// atomicAdd of the block (the grid covers whole blocks): the append of
// fused.cu fl_sp_live_list_kernel, which reads m and writes no state.
__global__ void __launch_bounds__(FL_ALIVE_LIST_BLOCK)
fl_alive_list_kernel(float* __restrict__ st, int n, int* __restrict__ list,
                     int* __restrict__ count) {
    __shared__ int warp_base[FL_ALIVE_LIST_BLOCK / 32 + 1];
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    bool in = i < n;
    bool alive = in && fl_row(st, n, FL_ALIVE, i) > 0.0f;
    if (in && !alive) fl_put(st, n, FL_SURF, i, 0.0f);
    unsigned live = __ballot_sync(0xffffffffu, alive);
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
    if (alive)
        list[warp_base[warps] + warp_base[warp] + __popc(live & ((1u << lane) - 1u))] = i;
}

// interp_shade over the alive list (`list`, `count`) on the persistent
// grid, as shade. `atlas`: the one texel of each 1x1 atlas (albedo, pbr,
// tpo), 9 floats.
__global__ void __launch_bounds__(FL_SHADE_BLOCK, FL_INTERP_MIN_BLOCKS)
fl_interp_shade_kernel(float* __restrict__ st, float* __restrict__ rq,
                       const float* __restrict__ ndc, const float* __restrict__ mat,
                       const float* __restrict__ atlas, const float* __restrict__ lights,
                       int n_lights, const float* __restrict__ cam,
                       const float* __restrict__ seed, const float* __restrict__ cos_sample_n,
                       int bounce, int counter, float min_importance, int n,
                       const int* __restrict__ list, const int* __restrict__ count) {
    __shared__ float sl[FL_MAX_LIGHTS * 6];
    int live = *count;
    int first = blockIdx.x * blockDim.x;
    if (first >= live) return;
    fl_stage_lights(lights, n_lights, sl);
    __syncthreads();
    float random_seed = *seed, cos_n = *cos_sample_n;
    int stride = gridDim.x * blockDim.x;
    int next = first + threadIdx.x < live ? list[first + threadIdx.x] : 0;
    for (int j = first + threadIdx.x; j < live; j += stride) {
        int i = next;
        if (j + stride < live) next = list[j + stride];
        fl_carry c = fl_read_carry(st, n, i);
        c.alive = true;  // listed: the list pass read alive > 0
        fl_surface s = fl_bounce_pre(c, mat, min_importance);
        fl_put(st, n, FL_SURF, i, s.m ? 1.0f : 0.0f);
        if (!s.m) {
            // the importance kill: the ray origin stays where it was
            fl_put(st, n, FL_ALIVE, i, 0.0f);
            continue;
        }
        // bounce_tex on 1x1 atlases: the inline value where the texture
        // number is -1, else the atlas' one texel
        float t[9];
        for (int k = 0; k < 3; ++k) {
            bool miss = s.tex[k] == -1.0f;
            for (int ch = 0; ch < 3; ++ch)
                t[3 * k + ch] = miss ? s.tex[3 + 3 * k + ch] : atlas[3 * k + ch];
        }
        fl_v3 albedo = fl_make3(t[0], t[1], t[2]);
        fl_v3 tpo = fl_make3(t[6], t[7], t[8]);
        fl_shade_req q = fl_bounce_shade(c, s.smooth_normal, s.geometry_offset, albedo, t[3],
                                         t[4], t[5], tpo, ndc[i], ndc[(size_t)n + i], sl,
                                         n_lights, cam, random_seed, cos_n, bounce, counter);
        fl_store3(st + (size_t)FL_RAY_ORIGIN * n, n, i, c.ray_origin);
        fl_write_shaded(st, n, i, c);
        fl_write_request(rq, n, i, q);
        fl_put(rq, n, FL_Q_EMIS, i, t[5]);
        fl_store3(rq + (size_t)FL_Q_TPO * n, n, i, tpo);
    }
}

// shade over the live list of `state` that fl_sp_live_list wrote into
// `list` / `count` (int32 [n] and [1]).
FL_EXPORT int fl_shade(float* state, float* req, const float* tex, const float* ndc,
                       const float* lights, int n_lights, const float* cam, const float* seed,
                       const float* cos_sample_n, int bounce, int counter, int n,
                       const int* list, const int* count, void* stream) {
    if (n <= 0) return 0;
    if (n_lights < 0 || n_lights > FL_MAX_LIGHTS) return -1;
    int grid = fl_persistent_grid(fl_shade_kernel, FL_SHADE_BLOCK, 0,
                                  (n + FL_SHADE_BLOCK - 1) / FL_SHADE_BLOCK);
    FL_LAUNCH_BLOCKS(fl_shade_kernel, grid, FL_SHADE_BLOCK, stream, state, req, tex, ndc,
                     lights, n_lights, cam, seed, cos_sample_n, bounce, counter, n, list,
                     count);
}

FL_EXPORT int fl_alive_list(float* state, int n, int* list, int* count, void* stream) {
    int err = FL_ZERO_ASYNC(count, sizeof(int), stream);
    if (err || n <= 0) return err;
    FL_LAUNCH(fl_alive_list_kernel, n, FL_ALIVE_LIST_BLOCK, stream, state, n, list, count);
}

// interp_shade over the alive list of `state` that fl_alive_list wrote into
// `list` / `count`.
FL_EXPORT int fl_interp_shade(float* state, float* req, const float* ndc, const float* mat,
                              const float* atlas, const float* lights, int n_lights,
                              const float* cam, const float* seed, const float* cos_sample_n,
                              int bounce, int counter, float min_importance, int n,
                              const int* list, const int* count, void* stream) {
    if (n <= 0) return 0;
    if (n_lights < 0 || n_lights > FL_MAX_LIGHTS) return -1;
    int grid = fl_persistent_grid(fl_interp_shade_kernel, FL_SHADE_BLOCK, 0,
                                  (n + FL_SHADE_BLOCK - 1) / FL_SHADE_BLOCK);
    FL_LAUNCH_BLOCKS(fl_interp_shade_kernel, grid, FL_SHADE_BLOCK, stream, state, req, ndc,
                     mat, atlas, lights, n_lights, cam, seed, cos_sample_n, bounce, counter,
                     min_importance, n, list, count);
}
