// Closest hit and any hit of a ray wavefront against a dense triangle list.
//
// Replaces: flexlight_tpu/ops/intersect_kernel.py `_kernel` (launched by
// `_intersect_ft`, entry points traverse_kernel(_soa) / shadow_kernel(_soa)).
// Same function: Moeller-Trumbore in its bilinear form over the constant
// rows W[4, T, 16] (det, u*det, v*det, s*det; ops/intersect_kernel.py
// tri_rows) and the ray features f = [1, o, d, d (x) o], then the same
// accept window. Plain FP32, no bf16 limbs, no TF32. A strict `<` over
// triangles in ascending column order keeps the lowest column on ties,
// like the TPU kernel's argmin.
//
// What bounds it on the H100: instruction issue. A ray reads 28 bytes and
// writes 16 (closest) or 1 (any), and the triangles are the same for every
// ray, so the loop over (ray, triangle) pairs is the whole cost. W's rows
// have 64 terms a triangle, of which 25 are non-zero; the kernels test the
// 16-float triangle record instead (trace.cuh fl_rec_closest / fl_rec_any:
// the non-zero terms in W's k order, so the sums equal W's but for a
// zero's sign, which no accept decision reads) and reject a pair exactly
// as soon as its det or a numerator's sign rules it out, before the
// division. Each block of FL_CAST_BLOCK rays builds the records of
// FL_CAST_CHUNK triangles at a time from W in shared memory (each value
// one of W's entries or its exact negation: trace.cuh fl_rec_stage), and
// every thread then walks the chunk with its ray in registers; the
// records are read as warp-wide broadcasts. A dead ray (max_len <= 0)
// casts nothing: a block packs its live rays into its first threads, so
// that a late bounce's few live rays fill few warps and the rest idle,
// and a block with no live ray stages nothing. An any-hit ray leaves at
// its first occluder, and the any-hit block stops staging once none of
// its rays is still searching. The TPU's flag prepass, octant sort and
// ray/triangle tiles are MXU scheduling and are left out.
#include "trace.cuh"

// rays a block casts, and triangles whose records it holds at once (16 KB)
#define FL_CAST_BLOCK 256
#define FL_CAST_CHUNK 256

// The rays of the block that cast (max_len > 0, so not NaN), packed into
// its first threads (one shared atomic a warp, in no fixed order) so that
// the warps of dead rays idle through the cast; `at` is the number
// packed. Returns the ray this thread casts, -1 for none; `dead` is
// whether this thread's own ray i is a dead one (it writes a miss).
__device__ __forceinline__ int fl_pack_rays(int i, int n, const float* __restrict__ max_len,
                                            int* list, int& at, bool& dead) {
    bool live = i < n && max_len[i] > 0.0f;
    dead = i < n && !live;
    if (threadIdx.x == 0) at = 0;
    __syncthreads();
    unsigned m = __ballot_sync(0xffffffffu, live);
    int lane = threadIdx.x % FL_WARP_LANES, at0 = 0;
    if (lane == 0 && m) at0 = atomicAdd(&at, __popc(m));
    at0 = __shfl_sync(0xffffffffu, at0, 0);
    if (live) list[at0 + __popc(m & ((1u << lane) - 1u))] = i;
    __syncthreads();
    return (int)threadIdx.x < at ? list[threadIdx.x] : -1;
}

__device__ __forceinline__ void fl_load_rray(
    int i, const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ max_len, fl_rray& r) {
    fl_make_rray(fl_make3(ox[i], oy[i], oz[i]), fl_make3(dx[i], dy[i], dz[i]), max_len[i], r);
}

__global__ void __launch_bounds__(FL_CAST_BLOCK) fl_closest_hit_kernel(
    const float* __restrict__ w4, int tp, const int* __restrict__ ids,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ max_len, float edge, int n,
    float* __restrict__ s_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ tri_out) {
    __shared__ float4 rec[4 * FL_CAST_CHUNK];
    __shared__ int list[FL_CAST_BLOCK];
    __shared__ int casting;
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    bool dead;
    int j = fl_pack_rays(i, n, max_len, list, casting, dead);
    if (dead) {
        s_out[i] = 0.0f;
        u_out[i] = 0.0f;
        v_out[i] = 0.0f;
        tri_out[i] = -1;
    }
    if (casting == 0) return;  // the block's rays are all dead
    fl_rray r;
    if (j >= 0) fl_load_rray(j, ox, oy, oz, dx, dy, dz, max_len, r);
    bool cull_uv = edge > 0.0f;
    float best_s = FL_POW32, best_u = 0.0f, best_v = 0.0f;
    int best_col = -1;
    fl_rec_table q = {rec};
    for (int c0 = 0; c0 < tp; c0 += FL_CAST_CHUNK) {
        int cnt = tp - c0 < FL_CAST_CHUNK ? tp - c0 : FL_CAST_CHUNK;
        if (c0 > 0) __syncthreads();  // the last chunk's readers are done
        fl_rec_stage(w4, tp, c0, cnt, rec);
        __syncthreads();
        if (j < 0) continue;
        for (int t = 0; t < cnt; ++t) {
            float s, u, v;
            if (fl_rec_closest(q, t, r, edge, cull_uv, s, u, v) && s < best_s) {
                best_s = s;
                best_u = u;
                best_v = v;
                best_col = c0 + t;
            }
        }
    }
    if (j >= 0) {
        bool hit = best_col >= 0;
        s_out[j] = hit ? best_s : 0.0f;
        u_out[j] = hit ? best_u : 0.0f;
        v_out[j] = hit ? best_v : 0.0f;
        tri_out[j] = hit ? ids[best_col] : -1;
    }
}

__global__ void __launch_bounds__(FL_CAST_BLOCK) fl_any_hit_kernel(
    const float* __restrict__ w4, int tp,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ max_len, int n, uint8_t* __restrict__ hit_out) {
    __shared__ float4 rec[4 * FL_CAST_CHUNK];
    __shared__ int list[FL_CAST_BLOCK];
    __shared__ int casting;
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    bool dead;
    int j = fl_pack_rays(i, n, max_len, list, casting, dead);
    if (dead) hit_out[i] = 0;
    fl_rray r;
    if (j >= 0) fl_load_rray(j, ox, oy, oz, dx, dy, dz, max_len, r);
    bool hit = false;
    fl_rec_table q = {rec};
    for (int c0 = 0; c0 < tp; c0 += FL_CAST_CHUNK) {
        // also the barrier after the last chunk's readers
        if (!__syncthreads_or(j >= 0 && !hit)) break;
        int cnt = tp - c0 < FL_CAST_CHUNK ? tp - c0 : FL_CAST_CHUNK;
        fl_rec_stage(w4, tp, c0, cnt, rec);
        __syncthreads();
        if (j < 0 || hit) continue;
        for (int t = 0; t < cnt; ++t) {
            if (fl_rec_any(q, t, r)) {
                hit = true;
                break;
            }
        }
    }
    if (j >= 0) hit_out[j] = hit ? 1 : 0;
}

FL_EXPORT int fl_closest_hit(const float* w4, int tp, const int* ids,
                             const float* ox, const float* oy, const float* oz,
                             const float* dx, const float* dy, const float* dz,
                             const float* max_len, float edge, int n,
                             float* s_out, float* u_out, float* v_out,
                             int* tri_out, void* stream) {
    if (n <= 0) return 0;
    FL_LAUNCH(fl_closest_hit_kernel, n, FL_CAST_BLOCK, stream, w4, tp, ids, ox,
              oy, oz, dx, dy, dz, max_len, edge, n, s_out, u_out, v_out,
              tri_out);
}

FL_EXPORT int fl_any_hit(const float* w4, int tp, const float* ox,
                         const float* oy, const float* oz, const float* dx,
                         const float* dy, const float* dz,
                         const float* max_len, int n, uint8_t* hit_out,
                         void* stream) {
    if (n <= 0) return 0;
    FL_LAUNCH(fl_any_hit_kernel, n, FL_CAST_BLOCK, stream, w4, tp, ox, oy, oz,
              dx, dy, dz, max_len, n, hit_out);
}
