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
// - closest / any hit: one block per ray tile (128 rays); the block walks
//   the tile's worklist of 128-triangle tiles in entry order. A (ray,
//   triangle) test is float work out of shared memory (operations bound;
//   built without FMA contraction, so unfused fp32 issues at half the rate
//   the bound counts). What keeps the work per test and the tests per ray
//   down, and the late bounces' few live rays busy:
//   * the record: each triangle is 16 floats (ops/intersect_sparse.py
//     tri_record: n, v0.n, e2 x v0, v0 x e1, e2, e1), the distinct
//     magnitudes of the 25 non-zero terms of its 64-float W rows. A test
//     reads 4 x 16 B from shared memory and sums only the non-zero terms
//     in W's k order, the signs as exact negations (24 multiplies, 21
//     adds): det, udet, vdet and sdet equal the 64-term sums (a zero may
//     differ in sign). A tile is 8 KB.
//   * exact early rejects before the division, each taking only pairs that
//     the accept window rejects too (no comparison lets a NaN through):
//     |det| < BIAS (any hit: det < BIAS); sdet zero or of the other sign
//     than det (s <= 0); and where the window's u / v edge is above 0
//     (bounce casts and every any hit), udet or vdet zero or of the other
//     sign (u <= 0 or v <= 0). A surviving pair takes 1 / det, u, v and s
//     in the plain version's order.
//   * FL_SUB_LANES (8) threads per ray, neighbours in a warp, each testing
//     every 8th triangle of a tile; after each slot they merge the ray's
//     lexicographic minimum (s, drawable index) with shuffles (any hit: an
//     or). A late bounce leaves a few hundred ray tiles with long walks,
//     and the walk of one ray is then 16 tests a slot, not 128.
//   * a per-warp walk: a ray is done when dead, when its best hit cannot
//     reach the next tile's entry bound (the TPU kernel's guard band,
//     _EXIT_REL and _EXIT_ABS, per ray), or when occluded (any hit); a
//     warp (4 rays) whose rays are all done skips the slot's tests
//     (__any_sync), and the block leaves once all its rays are done.
//   * a staged tile ring: FL_RING stages of 8 KB filled with 16-byte
//     cp.async (512 a tile), so tiles c + 1 and c + 2 are in flight
//     while tile c is tested, behind one barrier per slot; each stage
//     carries its tile's index and entry bound, and a tile's worklist entry
//     is read one slot before its copy starts. A stage keeps quad p of
//     triangle t at [p][t], so the lanes of a ray read neighbouring words.
//   The closest hit writes the exact (s, u, v) of the winner itself, so the
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

#define FL_REC 16                                          // floats of a triangle record
#define FL_RING 3                                          // staged tiles: 1 tested, 2 in flight
// threads per ray: they split each tile's triangles (one per ray emulated,
// where a block has one thread)
#ifdef FL_EMULATE
#define FL_SUB_LANES 1
#else
#define FL_SUB_LANES 8
#endif

// A ray of the worklist casts: origin, direction (a zero direction becomes
// +z, as fl_make_ray) and the components of vec(d (x) o) that meet the
// record's non-zero terms (k = 8, 9, 10, 12, 13, 14 of ray_features).
struct fl_rray {
    float o[3], d[3];
    float f8, f9, f10, f12, f13, f14;
    float max_len;
};

__device__ __forceinline__ bool fl_rec_ray(int i, int n, const float* ox, const float* oy,
                                           const float* oz, const float* dx, const float* dy,
                                           const float* dz, const float* max_len, fl_rray& r) {
    if (i >= n) return false;
    float o[3] = {ox[i], oy[i], oz[i]};
    float d[3] = {dx[i], dy[i], dz[i]};
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
    r.max_len = max_len[i];
    return r.max_len > 0.0f;
}

// The four products of a record (quads a = (n, v0.n), b = (e2 x v0,
// (v0 x e1).x), c = ((v0 x e1).yz, e2.xy), e = (e2.z, e1)) with a ray: the
// non-zero terms of tri_rows in k order (ops/intersect_sparse_kernel.py
// record_products takes the same operations).
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

// A staged tile: quad p of triangle t's record at [p][t], so that lanes
// reading neighbouring triangles read neighbouring 16-byte words.
typedef float4 fl_tile[4][FL_SPARSE_TRI_TILE];

// The two-sided closest-hit test of staged triangle t against ray r: the
// accept window of fl_mt_closest, after the exact early rejects.
// `cull_uv`: the window's u / v edge is above 0 (bounce casts).
__device__ __forceinline__ bool fl_rec_closest(const fl_tile& q, int t, const fl_rray& r,
                                               float edge, bool cull_uv, float& s, float& u,
                                               float& v) {
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

// The front-face-culled any-hit test of staged triangle t (the window of
// fl_mt_any, whose u / v edge is BIAS), after the exact early rejects.
__device__ __forceinline__ bool fl_rec_any(const fl_tile& q, int t, const fl_rray& r) {
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

// The lanes of this thread's warp that the block has.
__device__ __forceinline__ unsigned fl_warp_mask() {
    unsigned lanes = blockDim.x - (threadIdx.x & ~31u);
    return lanes >= 32u ? 0xffffffffu : (1u << lanes) - 1u;
}

// The block's ring of staged triangle tiles, with each stage's tile index
// and worklist entry bound.
struct fl_ring {
    fl_tile quads[FL_RING];
    int tile[FL_RING];
    float tm[FL_RING];
};

// Start the copy of worklist slot `slot` (tile `tile`, entry bound `tm`)
// into its stage: every thread of the block copies its share.
__device__ __forceinline__ void fl_ring_fill(fl_ring& ring, int slot,
                                             const float4* __restrict__ rec, int tile, float tm) {
    int st = slot % FL_RING;
    if (threadIdx.x == 0) {
        ring.tile[st] = tile;
        ring.tm[st] = tm;
    }
    const float4* src = rec + (size_t)tile * (FL_SPARSE_TRI_TILE * 4);
    for (int e = threadIdx.x; e < FL_SPARSE_TRI_TILE * 4; e += blockDim.x)
        fl_cp_async16(&ring.quads[st][e & 3][e >> 2], src + e);
}

// The worklist walk shared by both casts (`tm` null: no entry bounds).
// `done` comes in as "this thread has no live ray". Every lane of a warp
// that still has a ray to serve calls `test(q, c0, next_tm, done)` for slot
// c: q the staged tile, c0 its first triangle, next_tm the entry bound of
// slot c + 1 (POW32 past the last); it runs the lane's share of the slot's
// tests unless its ray is done, and returns whether the ray is done after
// them. Slot c's tile arrives while slots c - 2 and c - 1 are tested; one
// barrier per slot both publishes slot c's stage and frees slot c - 1's
// for the copy of slot c + 2, and the block leaves once every ray is done.
template <typename Test>
__device__ __forceinline__ void fl_walk(fl_ring& ring, const float4* __restrict__ rec,
                                        const int* __restrict__ tl, const float* __restrict__ tm,
                                        int cnt, bool done, Test test) {
    unsigned wmask = fl_warp_mask();
    for (int c = 0; c < FL_RING - 1; ++c) {
        if (c < cnt) fl_ring_fill(ring, c, rec, tl[c], tm ? tm[c] : 0.0f);
        fl_cp_async_commit();
    }
    int ahead = FL_RING - 1 < cnt ? tl[FL_RING - 1] : 0;
    float ahead_tm = FL_RING - 1 < cnt && tm ? tm[FL_RING - 1] : 0.0f;
    for (int c = 0; c < cnt; ++c) {
        fl_cp_async_wait<FL_RING - 2>();   // this thread's copies of slot c are in
        if (!__syncthreads_or(!done)) break;
        int next = c + FL_RING - 1;
        if (next < cnt) {
            fl_ring_fill(ring, next, rec, ahead, ahead_tm);
            if (next + 1 < cnt) {
                ahead = tl[next + 1];
                ahead_tm = tm ? tm[next + 1] : 0.0f;
            }
        }
        fl_cp_async_commit();
        if (__any_sync(wmask, !done)) {
            int st = c % FL_RING;
            float next_tm = c + 1 < cnt ? ring.tm[(c + 1) % FL_RING] : FL_POW32;
            done = test(ring.quads[st], ring.tile[st] * FL_SPARSE_TRI_TILE, next_tm, done);
        }
    }
    fl_cp_async_wait<0>();
}

// Thread g of the launch serves ray g / FL_SUB_LANES and, of each tile,
// the triangles t = g % FL_SUB_LANES (mod FL_SUB_LANES); a ray's lanes are
// neighbours in a warp.
__global__ void fl_sparse_closest_kernel(
    const float4* __restrict__ rec, const int* __restrict__ tlist,
    const float* __restrict__ tms, const int* __restrict__ counts, int wt,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ max_len, float edge, int ray_tile, int n,
    float* __restrict__ s_out, float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ tri_out) {
    __shared__ fl_ring ring;
    int g = blockIdx.x * blockDim.x + threadIdx.x;
    int i = g / FL_SUB_LANES, lane = g - i * FL_SUB_LANES;
    int rt = i / ray_tile;  // the block's ray tile (each ray alone, emulated)
    fl_rray r;
    bool live = fl_rec_ray(i, n, ox, oy, oz, dx, dy, dz, max_len, r);
    bool cull_uv = edge > 0.0f;
    unsigned wmask = fl_warp_mask();
    float best_s = FL_POW32, best_u = 0.0f, best_v = 0.0f;
    int best_idx = 0x7fffffff;
    fl_walk(ring, rec, tlist + (size_t)rt * wt, tms + (size_t)rt * wt, counts[rt], !live,
            [&](const fl_tile& q, int c0, float next_tm, bool done) {
                if (!done) {
#pragma unroll 4
                    for (int k = 0; k < FL_SPARSE_TRI_TILE / FL_SUB_LANES; ++k) {
                        int t = lane + k * FL_SUB_LANES;
                        float s, u, v;
                        if (fl_rec_closest(q, t, r, edge, cull_uv, s, u, v)
                            && (s < best_s || (s == best_s && c0 + t < best_idx))) {
                            best_s = s;
                            best_u = u;
                            best_v = v;
                            best_idx = c0 + t;
                        }
                    }
                }
                // the ray's lexicographic minimum over its lanes' minima
                for (int m = 1; m < FL_SUB_LANES; m <<= 1) {
                    float s2 = __shfl_xor_sync(wmask, best_s, m);
                    float u2 = __shfl_xor_sync(wmask, best_u, m);
                    float v2 = __shfl_xor_sync(wmask, best_v, m);
                    int i2 = __shfl_xor_sync(wmask, best_idx, m);
                    if (s2 < best_s || (s2 == best_s && i2 < best_idx)) {
                        best_s = s2;
                        best_u = u2;
                        best_v = v2;
                        best_idx = i2;
                    }
                }
                // the worklist is in entry order: no later tile holds a hit
                // nearer than the next entry bound (intersect_sparse.py:756-764)
                return done || !(best_s * FL_EXIT_REL + FL_EXIT_ABS >= next_tm);
            });
    if (i < n && lane == 0) {
        bool hit = best_s < FL_POW32;
        s_out[i] = hit ? best_s : 0.0f;
        u_out[i] = hit ? best_u : 0.0f;
        v_out[i] = hit ? best_v : 0.0f;
        tri_out[i] = hit ? best_idx : -1;
    }
}

__global__ void fl_sparse_any_kernel(
    const float4* __restrict__ rec, const int* __restrict__ tlist,
    const int* __restrict__ counts, int wt,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ max_len, int ray_tile, int n,
    uint8_t* __restrict__ hit_out) {
    __shared__ fl_ring ring;
    int g = blockIdx.x * blockDim.x + threadIdx.x;
    int i = g / FL_SUB_LANES, lane = g - i * FL_SUB_LANES;
    int rt = i / ray_tile;
    fl_rray r;
    bool live = fl_rec_ray(i, n, ox, oy, oz, dx, dy, dz, max_len, r);
    bool hit = false;
    unsigned wmask = fl_warp_mask();
    fl_walk(ring, rec, tlist + (size_t)rt * wt, nullptr, counts[rt], !live,
            [&](const fl_tile& q, int, float, bool done) {
#pragma unroll 4
                for (int k = 0; k < FL_SPARSE_TRI_TILE / FL_SUB_LANES; ++k) {
                    if (!done && fl_rec_any(q, lane + k * FL_SUB_LANES, r)) hit = done = true;
                    if (!__any_sync(wmask, !done)) break;
                }
                for (int m = 1; m < FL_SUB_LANES; m <<= 1)
                    hit = __shfl_xor_sync(wmask, (int)hit, m) || hit;
                return !live || hit;
            });
    if (i < n && lane == 0) hit_out[i] = hit ? 1 : 0;
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

FL_EXPORT int fl_sparse_closest(const float* rec, const int* tlist, const float* tms,
                                const int* counts, int wt, const float* ox, const float* oy,
                                const float* oz, const float* dx, const float* dy,
                                const float* dz, const float* max_len, float edge,
                                int ray_tile, int n, float* s_out, float* u_out, float* v_out,
                                int* tri_out, void* stream) {
    if (n <= 0) return 0;
    FL_LAUNCH(fl_sparse_closest_kernel, (size_t)n * FL_SUB_LANES, ray_tile * FL_SUB_LANES,
              stream, (const float4*)rec, tlist, tms, counts, wt, ox, oy, oz, dx, dy, dz,
              max_len, edge, ray_tile, n, s_out, u_out, v_out, tri_out);
}

FL_EXPORT int fl_sparse_any(const float* rec, const int* tlist, const int* counts, int wt,
                            const float* ox, const float* oy, const float* oz,
                            const float* dx, const float* dy, const float* dz,
                            const float* max_len, int ray_tile, int n, uint8_t* hit_out,
                            void* stream) {
    if (n <= 0) return 0;
    FL_LAUNCH(fl_sparse_any_kernel, (size_t)n * FL_SUB_LANES, ray_tile * FL_SUB_LANES, stream,
              (const float4*)rec, tlist, counts, wt, ox, oy, oz, dx, dy, dz, max_len, ray_tile,
              n, hit_out);
}
