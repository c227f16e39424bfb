// The sparse worklist traversal of large scenes (scheme="sparse"): the
// cluster-flag prepass, the nearest2 wavefront sort key, and closest hit and
// any hit over each ray tile's worklist of 128-triangle tiles.
//
// Replaces, in flexlight_tpu/ops/intersect_sparse.py:
//   fl_sparse_flags   `_flags_kernel` / `_flags_body` (launched by _flags_call :251)
//   fl_sparse_key     `_key_kernel` / `_key_body` (nearest2_key_soa :578)
//   fl_sparse_closest `_kernel` / `_kernel_subtile` (_intersect_sparse :962)
//                     and the exact (s, u, v) recovery `_recover_suv` after it
//   fl_sparse_any     `_shadow_kernel` / `_shadow_subtile` (_any_hit_sparse :904)
// The plain PyTorch versions are in ops/intersect_sparse_kernel.py; every
// kernel takes their float operations in the same order.
//
// What bounds them on the H100, and the design:
// - flags: a slab test of every ray of a ray tile against every 64-triangle
//   cluster box, ~20 float operations each (operations bound). One block
//   per ray tile; its rays (origin, 1/d, max_len) go to dynamic shared
//   memory sized to the ray tile (3.5 KB at the path's 128 rays), each
//   thread takes 128-triangle tiles (two clusters) and reduces the entry
//   distance over the rays. Dead rays are skipped, so an all-dead tile
//   writes POW32 after one pass over its max_len.
// - key: the slab test of each ray against every supertile box (8
//   clusters), keeping the best two by (entry, index) in one pass; the
//   boxes pass through shared memory in chunks, one thread per ray.
// - closest / any hit: the Moeller-Trumbore test of trace.cuh (bilinear
//   form, all 16 terms in k order), 58 float operations per (ray,
//   triangle) (operations bound). One block per ray tile, one thread per
//   ray; the block walks the tile's worklist in entry order and stages each
//   128-triangle tile's W rows (32 KB) through shared memory in two halves.
//   The closest hit keeps the lexicographic minimum (s, drawable index) and
//   the block leaves the walk once no live ray's best can reach the next
//   tile's entry distance (the TPU kernel's guard band, _EXIT_REL and
//   _EXIT_ABS); the any hit leaves once every live ray is occluded. The
//   closest hit writes the exact (s, u, v) of the winner itself, so the
//   TPU's approximate key and recovery pass are not needed.
// The TPU's bf16x6 limbs, DMA double-buffering, SMEM worklist rows and
// subtiles are its own scheduling and are not carried over.
#include "trace.cuh"

#define FL_SPARSE_TRI_TILE 128
#define FL_SPARSE_CLUSTERS 2      // 64-triangle clusters per tile
#define FL_FLAGS_SHARED 7         // floats of a ray in the flags' shared memory
#define FL_KEY_BOX_CHUNK 256
#define FL_EXIT_REL ((float)(1.0 + 1e-4))
#define FL_EXIT_ABS ((float)1e-5)
#define FL_TINY_DIR ((float)1e-30)

// 1 / d with zero components as 1e-30 (intersect_sparse.py _rays8_soa)
__device__ __forceinline__ float fl_slab_inv(float d) {
    return 1.0f / (d == 0.0f ? FL_TINY_DIR : d);
}

// The slab interval of one ray against one box (lo, hi: 3 floats each):
// tmin over the axes of min(t0, t1), tmax of max(t0, t1), NaN-propagating
// as jnp.max / torch.amax are.
__device__ __forceinline__ void fl_slab(const float* o, const float* inv, const float* lo,
                                        const float* hi, float& tmin, float& tmax) {
    for (int c = 0; c < 3; ++c) {
        float t0 = (lo[c] - o[c]) * inv[c];
        float t1 = (hi[c] - o[c]) * inv[c];
        float a = fl_minimum(t0, t1);
        float b = fl_maximum(t0, t1);
        tmin = c == 0 ? a : fl_maximum(tmin, a);
        tmax = c == 0 ? b : fl_minimum(tmax, b);
    }
}

// ---- flags: min entry distance of each (ray tile, triangle tile) ----------

__global__ void fl_sparse_flags_kernel(const float* __restrict__ amin,
                                       const float* __restrict__ amax, int wt,
                                       const float* __restrict__ ox, const float* __restrict__ oy,
                                       const float* __restrict__ oz, const float* __restrict__ dx,
                                       const float* __restrict__ dy, const float* __restrict__ dz,
                                       const float* __restrict__ max_len, int ray_tile,
                                       float* __restrict__ out) {
    // the tile's rays, FL_FLAGS_SHARED floats a ray: origin, 1 / d, max_len
    FL_SHARED_FLOATS(sray);
    float* so[3] = {sray, sray + ray_tile, sray + 2 * ray_tile};
    float* sinv[3] = {sray + 3 * ray_tile, sray + 4 * ray_tile, sray + 5 * ray_tile};
    float* sml = sray + 6 * ray_tile;
    int rt = blockIdx.x;
    int live = 0;
    for (int r = threadIdx.x; r < ray_tile; r += blockDim.x) {
        size_t i = (size_t)rt * ray_tile + r;
        so[0][r] = ox[i];
        so[1][r] = oy[i];
        so[2][r] = oz[i];
        sinv[0][r] = fl_slab_inv(dx[i]);
        sinv[1][r] = fl_slab_inv(dy[i]);
        sinv[2][r] = fl_slab_inv(dz[i]);
        sml[r] = max_len[i];
        live |= max_len[i] > 0.0f;
    }
    float* row = out + (size_t)rt * wt;
    if (!__syncthreads_or(live)) {
        for (int w = threadIdx.x; w < wt; w += blockDim.x) row[w] = FL_POW32;
        return;
    }
    for (int w = threadIdx.x; w < wt; w += blockDim.x) {
        float best = FL_POW32;
        for (int k = w * FL_SPARSE_CLUSTERS; k < (w + 1) * FL_SPARSE_CLUSTERS; ++k) {
            float lo[3] = {amin[3 * k], amin[3 * k + 1], amin[3 * k + 2]};
            float hi[3] = {amax[3 * k], amax[3 * k + 1], amax[3 * k + 2]};
            for (int r = 0; r < ray_tile; ++r) {
                float ml = sml[r];
                if (!(ml > 0.0f)) continue;  // dead rays flag nothing
                float o[3] = {so[0][r], so[1][r], so[2][r]};
                float inv[3] = {sinv[0][r], sinv[1][r], sinv[2][r]};
                float tmin, tmax;
                fl_slab(o, inv, lo, hi, tmin, tmax);
                float entry = fl_maximum(tmin, FL_BIAS);
                if (tmax >= entry && tmin < ml && entry < best) best = entry;
            }
        }
        row[w] = best;
    }
}

// ---- nearest2 key: (nearest, second-nearest supertile, octant) per ray ----

__global__ void fl_sparse_key_kernel(const float* __restrict__ bmin,
                                     const float* __restrict__ bmax, int nb,
                                     const float* __restrict__ ox, const float* __restrict__ oy,
                                     const float* __restrict__ oz, const float* __restrict__ dx,
                                     const float* __restrict__ dy, const float* __restrict__ dz,
                                     const float* __restrict__ max_len, int n,
                                     int* __restrict__ key_out) {
    __shared__ float sb[6][FL_KEY_BOX_CHUNK];
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    bool in = i < n;
    float o[3] = {0.0f, 0.0f, 0.0f}, inv[3] = {1.0f, 1.0f, 1.0f}, ml = 0.0f;
    if (in) {
        o[0] = ox[i];
        o[1] = oy[i];
        o[2] = oz[i];
        inv[0] = fl_slab_inv(dx[i]);
        inv[1] = fl_slab_inv(dy[i]);
        inv[2] = fl_slab_inv(dz[i]);
        ml = max_len[i];
    }
    float e1 = FL_POW32, e2 = FL_POW32;
    int i1 = nb, i2 = nb;
    for (int b0 = 0; b0 < nb; b0 += FL_KEY_BOX_CHUNK) {
        int cnt = nb - b0 < FL_KEY_BOX_CHUNK ? nb - b0 : FL_KEY_BOX_CHUNK;
        for (int e = threadIdx.x; e < 3 * cnt; e += blockDim.x) {
            int j = e / 3, c = e - 3 * j;
            sb[c][j] = bmin[3 * (b0 + j) + c];
            sb[3 + c][j] = bmax[3 * (b0 + j) + c];
        }
        __syncthreads();
        if (in) {
            for (int j = 0; j < cnt; ++j) {
                float lo[3] = {sb[0][j], sb[1][j], sb[2][j]};
                float hi[3] = {sb[3][j], sb[4][j], sb[5][j]};
                float tmin, tmax;
                fl_slab(o, inv, lo, hi, tmin, tmax);
                float entry = fl_maximum(tmin, FL_BIAS);
                float e = (tmax >= entry && tmin < ml) ? entry : FL_POW32;
                // best two by (entry, lowest index); entries at or past
                // POW32 are no candidate (index nb)
                if (e < e1) {
                    e2 = e1;
                    i2 = i1;
                    e1 = e;
                    i1 = b0 + j;
                } else if (e < e2) {
                    e2 = e;
                    i2 = b0 + j;
                }
            }
        }
        __syncthreads();
    }
    if (in) {
        int octant = (inv[0] > 0.0f) * 4 + (inv[1] > 0.0f) * 2 + (inv[2] > 0.0f);
        key_out[i] = ml <= 0.0f ? (1 << 30) : (i1 * (nb + 1) + i2) * 8 + octant;
    }
}

// ---- closest hit and any hit over the worklists ----------------------------

__device__ __forceinline__ bool fl_sparse_ray(int i, int n, const float* ox, const float* oy,
                                              const float* oz, const float* dx,
                                              const float* dy, const float* dz,
                                              const float* max_len, fl_ray& r) {
    if (i >= n) return false;
    fl_make_ray(fl_make3(ox[i], oy[i], oz[i]), fl_make3(dx[i], dy[i], dz[i]), max_len[i], r);
    return r.max_len > 0.0f;
}

__global__ void fl_sparse_closest_kernel(
    const float* __restrict__ w4, int tp, const int* __restrict__ tlist,
    const float* __restrict__ tms, const int* __restrict__ counts, int wt,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ max_len, float edge, int ray_tile, int n,
    float* __restrict__ s_out, float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ tri_out) {
    __shared__ float sw[4][FL_TRI_CHUNK][16];
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    int rt = i / ray_tile;  // the block's ray tile (each ray alone, emulated)
    fl_ray r;
    bool live = fl_sparse_ray(i, n, ox, oy, oz, dx, dy, dz, max_len, r);
    float best_s = FL_POW32, best_u = 0.0f, best_v = 0.0f;
    int best_idx = 0x7fffffff;
    int cnt = counts[rt];
    const int* tl = tlist + (size_t)rt * wt;
    const float* tm = tms + (size_t)rt * wt;
    for (int c = 0; c < cnt; ++c) {
        int tile = tl[c];
        for (int h = 0; h < FL_SPARSE_TRI_TILE; h += FL_TRI_CHUNK) {
            int c0 = tile * FL_SPARSE_TRI_TILE + h;
            fl_stage(w4, tp, c0, FL_TRI_CHUNK, sw);
            __syncthreads();
            if (live) {
                for (int t = 0; t < FL_TRI_CHUNK; ++t) {
                    float s, u, v;
                    if (fl_mt_closest(sw, t, r, edge, s, u, v)
                        && (s < best_s || (s == best_s && c0 + t < best_idx))) {
                        best_s = s;
                        best_u = u;
                        best_v = v;
                        best_idx = c0 + t;
                    }
                }
            }
            __syncthreads();
        }
        // the worklist is in entry order: no later tile holds a hit nearer
        // than the next entry distance (intersect_sparse.py:756-764)
        if (c + 1 < cnt
            && !__syncthreads_or(live && best_s * FL_EXIT_REL + FL_EXIT_ABS >= tm[c + 1]))
            break;
    }
    if (i < n) {
        bool hit = best_s < FL_POW32;
        s_out[i] = hit ? best_s : 0.0f;
        u_out[i] = hit ? best_u : 0.0f;
        v_out[i] = hit ? best_v : 0.0f;
        tri_out[i] = hit ? best_idx : -1;
    }
}

__global__ void fl_sparse_any_kernel(
    const float* __restrict__ w4, int tp, const int* __restrict__ tlist,
    const int* __restrict__ counts, int wt,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ max_len, int ray_tile, int n, uint8_t* __restrict__ hit_out) {
    __shared__ float sw[4][FL_TRI_CHUNK][16];
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    int rt = i / ray_tile;
    fl_ray r;
    bool live = fl_sparse_ray(i, n, ox, oy, oz, dx, dy, dz, max_len, r);
    bool hit = false;
    int cnt = counts[rt];
    const int* tl = tlist + (size_t)rt * wt;
    for (int c = 0; c < cnt; ++c) {
        // leave once every live ray of the tile is occluded
        if (!__syncthreads_or(live && !hit)) break;
        for (int h = 0; h < FL_SPARSE_TRI_TILE; h += FL_TRI_CHUNK) {
            fl_stage(w4, tp, tl[c] * FL_SPARSE_TRI_TILE + h, FL_TRI_CHUNK, sw);
            __syncthreads();
            if (live && !hit) {
                for (int t = 0; t < FL_TRI_CHUNK; ++t) {
                    if (fl_mt_any(sw, t, r)) { hit = true; break; }
                }
            }
            __syncthreads();
        }
    }
    if (i < n) hit_out[i] = hit ? 1 : 0;
}

FL_EXPORT int fl_sparse_flags(const float* amin, const float* amax, int wt, const float* ox,
                              const float* oy, const float* oz, const float* dx,
                              const float* dy, const float* dz, const float* max_len,
                              int ray_tile, int rt, float* out, void* stream) {
    if (rt <= 0 || wt <= 0) return 0;
    FL_LAUNCH_BLOCKS_SHARED(fl_sparse_flags_kernel, rt, 128, FL_FLAGS_SHARED * ray_tile, stream,
                            amin, amax, wt, ox, oy, oz, dx, dy, dz, max_len, ray_tile, out);
}

FL_EXPORT int fl_sparse_key(const float* bmin, const float* bmax, int nb, const float* ox,
                            const float* oy, const float* oz, const float* dx, const float* dy,
                            const float* dz, const float* max_len, int n, int* key_out,
                            void* stream) {
    if (n <= 0) return 0;
    FL_LAUNCH(fl_sparse_key_kernel, n, 128, stream, bmin, bmax, nb, ox, oy, oz, dx, dy, dz,
              max_len, n, key_out);
}

FL_EXPORT int fl_sparse_closest(const float* w4, int tp, const int* tlist, const float* tms,
                                const int* counts, int wt, const float* ox, const float* oy,
                                const float* oz, const float* dx, const float* dy,
                                const float* dz, const float* max_len, float edge,
                                int ray_tile, int n, float* s_out, float* u_out, float* v_out,
                                int* tri_out, void* stream) {
    if (n <= 0) return 0;
    FL_LAUNCH(fl_sparse_closest_kernel, n, ray_tile, stream, w4, tp, tlist, tms, counts, wt,
              ox, oy, oz, dx, dy, dz, max_len, edge, ray_tile, n, s_out, u_out, v_out, tri_out);
}

FL_EXPORT int fl_sparse_any(const float* w4, int tp, const int* tlist, const int* counts,
                            int wt, const float* ox, const float* oy, const float* oz,
                            const float* dx, const float* dy, const float* dz,
                            const float* max_len, int ray_tile, int n, uint8_t* hit_out,
                            void* stream) {
    if (n <= 0) return 0;
    FL_LAUNCH(fl_sparse_any_kernel, n, ray_tile, stream, w4, tp, tlist, counts, wt, ox, oy, oz,
              dx, dy, dz, max_len, ray_tile, n, hit_out);
}
