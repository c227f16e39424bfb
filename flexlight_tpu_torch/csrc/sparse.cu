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
// - flags and key: the slab test of rays against boxes (fl_slab_entry: 12
//   subtracts and multiplies, 11 NaN-propagating min / max of one
//   instruction each, 2 compares, a select; operations bound). Rays stay in
//   registers, several a thread, and each box is broadcast from shared
//   memory as two 16-byte words, so one box load serves several tests.
//   * flags: one warp per ray tile of at most 128 rays (4 a lane) and 64
//     of its triangle tiles (a late cast's few live ray tiles still spread
//     over many warps), in a persistent grid whose blocks load the cluster
//     boxes once. A tile's
//     minimum over its rays is one warp reduction over the entries' bits.
//     An exact interval cull per (ray tile, cluster), from the ranges of
//     the tile's live origins and inverse directions (fl_cull), skips the
//     clusters that no ray of the tile can flag, and a tile's second
//     cluster where its least possible entry is not below the first's
//     minimum; the lanes cull 32 tiles at once and a ballot collects the
//     survivors. A primary ray tile (one origin, a thin fan of directions)
//     misses most clusters. An all-dead tile writes POW32.
//   * key: 2 rays a thread, the best two by (entry, index) updated with
//     selects; the boxes pass through shared memory in chunks. A block of
//     512 rays packs its rays that are not dead into its first threads, so
//     a warp left without one skips the boxes: the TPU kernel's dead-tile
//     skip, for the dead rays of a late cast, which are scattered.
// - closest / any hit: one block per ray tile (128 rays); the block walks
//   the tile's worklist of 128-triangle tiles in entry order. A (ray,
//   triangle) test is float work out of shared memory (operations bound;
//   built without FMA contraction, so unfused fp32 issues at half the rate
//   the bound counts). What keeps the work per test and the tests per ray
//   down, and the late bounces' few live rays busy:
//   * the record (trace.cuh, shared with fused.cu): each triangle is 16
//     floats (ops/intersect_sparse.py tri_record: n, v0.n, e2 x v0,
//     v0 x e1, e2, e1), the distinct
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
#define FL_EXIT_REL ((float)(1.0 + 1e-4))
#define FL_EXIT_ABS ((float)1e-5)
#define FL_TINY_DIR ((float)1e-30)

// 1 / d with zero components as 1e-30 (intersect_sparse.py _rays8_soa)
__device__ __forceinline__ float fl_slab_inv(float d) {
    return 1.0f / (d == 0.0f ? FL_TINY_DIR : d);
}

// NaN-propagating min / max (torch.minimum / torch.maximum) in one
// instruction each (sm_80 and later). Their NaN is the canonical one, not
// the operand's, and of two zeros they may return either sign: neither
// reaches the slab test's outputs. Any NaN among a pair's six t values
// makes tmin or tmax NaN, and then `tmax >= entry` (entry = max(tmin,
// BIAS), NaN with tmin) is false, whatever the payload; a zero's sign
// changes neither max(tmin, BIAS), nor `tmax >= entry` (entry >= BIAS),
// nor `tmin < ml`.
__device__ __forceinline__ float fl_min_nan(float a, float b) {
#ifdef FL_EMULATE
    return fl_minimum(a, b);
#else
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
#endif
}

__device__ __forceinline__ float fl_max_nan(float a, float b) {
#ifdef FL_EMULATE
    return fl_maximum(a, b);
#else
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
#endif
}

// A ray of the prepass kernels, in registers: origin, 1 / d, and max_len
// (-inf where the ray is dead or absent, so that `tmin < ml` fails).
struct fl_sray {
    float o[3], inv[3], ml;
};

// Rays at[j] with max_len ml[j] into registers (rays not `in`: no ray).
// Every load is issued before the first division: the division's slow
// path is a call, and the compiler moves no load across it.
template <int R>
__device__ __forceinline__ void fl_srays_load(fl_sray (&r)[R], const size_t (&at)[R],
                                              const bool (&in)[R], const float (&ml)[R],
                                              const float* ox, const float* oy,
                                              const float* oz, const float* dx,
                                              const float* dy, const float* dz) {
    float d[R][3];
#pragma unroll
    for (int j = 0; j < R; ++j) {
        r[j].o[0] = in[j] ? ox[at[j]] : 0.0f;
        r[j].o[1] = in[j] ? oy[at[j]] : 0.0f;
        r[j].o[2] = in[j] ? oz[at[j]] : 0.0f;
        d[j][0] = in[j] ? dx[at[j]] : 1.0f;
        d[j][1] = in[j] ? dy[at[j]] : 1.0f;
        d[j][2] = in[j] ? dz[at[j]] : 1.0f;
        r[j].ml = in[j] && ml[j] > 0.0f ? ml[j] : -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
        for (int c = 0; c < 3; ++c) r[j].inv[c] = fl_slab_inv(d[j][c]);
}

// The entry distance of ray r into box (lo, hi) where it enters the box
// within its length, else POW32: the plain version's
// where((tmax >= entry) & (tmin < ml), entry, POW32) with entry =
// max(tmin, BIAS), tmin the max over the axes of min(t0, t1) and tmax the
// min of max(t0, t1), t = (box - o) * (1 / d). 12 subtracts and
// multiplies, 11 NaN-propagating min / max, 2 compares and a select.
__device__ __forceinline__ float fl_slab_entry(const fl_sray& r, float4 lo, float4 hi) {
    float t0 = (lo.x - r.o[0]) * r.inv[0], t1 = (hi.x - r.o[0]) * r.inv[0];
    float tmin = fl_min_nan(t0, t1), tmax = fl_max_nan(t0, t1);
    t0 = (lo.y - r.o[1]) * r.inv[1];
    t1 = (hi.y - r.o[1]) * r.inv[1];
    tmin = fl_max_nan(tmin, fl_min_nan(t0, t1));
    tmax = fl_min_nan(tmax, fl_max_nan(t0, t1));
    t0 = (lo.z - r.o[2]) * r.inv[2];
    t1 = (hi.z - r.o[2]) * r.inv[2];
    tmin = fl_max_nan(tmin, fl_min_nan(t0, t1));
    tmax = fl_min_nan(tmax, fl_max_nan(t0, t1));
    float entry = fl_max_nan(tmin, FL_BIAS);
    return tmax >= entry && tmin < r.ml ? entry : FL_POW32;
}

// Box k of (lo, hi) [K, 3] as two 16-byte words, .w a pad.
__device__ __forceinline__ void fl_box_load(float4* slo, float4* shi, const float* lo,
                                            const float* hi, int k) {
    slo->x = lo[3 * k];
    slo->y = lo[3 * k + 1];
    slo->z = lo[3 * k + 2];
    slo->w = 0.0f;
    shi->x = hi[3 * k];
    shi->y = hi[3 * k + 1];
    shi->z = hi[3 * k + 2];
    shi->w = 0.0f;
}

// ---- flags: min entry distance of each (ray tile, triangle tile) ----------

#define FL_FLAGS_RAY_TILE 128                               // rays a warp holds
#define FL_FLAGS_PER_LANE (FL_FLAGS_RAY_TILE / FL_WARP_LANES) // 4 (128 emulated)
#define FL_FLAGS_WARPS 8                                    // work items a block holds
#define FL_FLAGS_PART 64                                    // triangle tiles of a work item
#define FL_FLAGS_CHUNK 1024                                 // cluster boxes in shared memory

// What every ray of a ray tile can be, over its live rays: the range of
// each origin and 1 / d component, and the largest max_len.
struct fl_span {
    float olo[3], ohi[3], ilo[3], ihi[3], ml;
};

// The interval cull of one cluster box against a ray tile's span. Every
// float of (box - o) * (1 / d) that a live ray computes lies between the
// least and the largest of the eight corner values (lo and hi, the two
// extreme origins, the two extreme inverses) computed with the same float
// operations: a correctly rounded subtract is monotone in o, a correctly
// rounded multiply in each factor, and a product that is NaN for no corner
// but a ray flags nothing. So the least corner of each axis bounds that
// axis's min(t0, t1) from below, the largest its max(t0, t1) from above,
// and the folds over the axes keep the bounds: `tmin_lo` <= every ray's
// tmin, `tmax_hi` >= every ray's tmax. A corner NaN (0 x inf: an origin on
// a face with a denormal direction component; inf - inf) makes both NaN.
// Returns the least entry any ray can have, max(tmin_lo, BIAS), and sets
// `none` where no ray can enter the box within its length: tmax_hi < that
// entry, or tmin_lo >= the largest max_len. Both are comparisons that are
// false for NaN, so a NaN bound rejects nothing.
__device__ __forceinline__ float fl_cull(const fl_span& s, float4 lo, float4 hi, bool& none) {
    float lo3[3] = {lo.x, lo.y, lo.z}, hi3[3] = {hi.x, hi.y, hi.z};
    float tmin_lo = 0.0f, tmax_hi = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        float x[4] = {lo3[c] - s.ohi[c], lo3[c] - s.olo[c], hi3[c] - s.ohi[c],
                      hi3[c] - s.olo[c]};
        float least = x[0] * s.ilo[c], most = least;
#pragma unroll
        for (int q = 1; q < 8; ++q) {
            float p = x[q >> 1] * (q & 1 ? s.ihi[c] : s.ilo[c]);
            least = fl_min_nan(least, p);
            most = fl_max_nan(most, p);
        }
        tmin_lo = c == 0 ? least : fl_max_nan(tmin_lo, least);
        tmax_hi = c == 0 ? most : fl_min_nan(tmax_hi, most);
    }
    float entry_lo = fl_max_nan(tmin_lo, FL_BIAS);
    none = tmax_hi < entry_lo || tmin_lo >= s.ml;
    return entry_lo;
}

// The least entry over the warp's rays into box (lo, hi), as the bits of a
// positive float (which order as unsigned integers): each lane over its
// rays, then one reduction over the warp.
__device__ __forceinline__ unsigned fl_flags_box(const fl_sray (&rays)[FL_FLAGS_PER_LANE],
                                                 float4 lo, float4 hi) {
    float e = FL_POW32;
#pragma unroll
    for (int j = 0; j < FL_FLAGS_PER_LANE; ++j) e = fminf(e, fl_slab_entry(rays[j], lo, hi));
    return __reduce_min_sync(0xffffffffu, __float_as_uint(e));
}

// The least / largest of a float over the warp (no NaN among them): one
// reduction over an unsigned image of the float that keeps its order.
__device__ __forceinline__ unsigned fl_ordered(float x) {
    unsigned u = __float_as_uint(x);
    return u & 0x80000000u ? ~u : u | 0x80000000u;
}

__device__ __forceinline__ float fl_unordered(unsigned u) {
    return __uint_as_float(u & 0x80000000u ? u & 0x7fffffffu : ~u);
}

__device__ __forceinline__ float fl_warp_min(float x) {
    return fl_unordered(__reduce_min_sync(0xffffffffu, fl_ordered(x)));
}

__device__ __forceinline__ float fl_warp_max(float x) {
    return fl_unordered(__reduce_max_sync(0xffffffffu, fl_ordered(x)));
}

// One warp per work item, a ray tile of at most FL_FLAGS_RAY_TILE rays
// (FL_FLAGS_PER_LANE a lane, in registers) and FL_FLAGS_PART of its
// triangle tiles: a late cast's few live ray tiles then still spread over
// many warps. A persistent grid whose blocks load the cluster boxes into
// shared memory once (in chunks of FL_FLAGS_CHUNK where there are more)
// and walk the items FL_FLAGS_WARPS at a time (blockIdx.x, blockIdx.x +
// gridDim.x, ...). Per item: the span of the tile's live rays (none: its
// flags are POW32); then, FL_WARP_LANES triangle tiles at a time, each lane
// culls the two clusters of one tile, a ballot collects the survivors, and
// the warp tests its rays against each surviving cluster (the second of a
// tile only where its least entry is below the first's minimum); lane l
// keeps the flag of tile l and the warp stores them together.
__global__ void __launch_bounds__(FL_FLAGS_WARPS * 32)
fl_sparse_flags_kernel(const float* __restrict__ amin, const float* __restrict__ amax, int nk,
                       const float* __restrict__ ox, const float* __restrict__ oy,
                       const float* __restrict__ oz, const float* __restrict__ dx,
                       const float* __restrict__ dy, const float* __restrict__ dz,
                       const float* __restrict__ max_len, int ray_tile, int rt,
                       float* __restrict__ out) {
    __shared__ float4 sbox[2][FL_FLAGS_CHUNK];
    const unsigned all = 0xffffffffu;
    int lane = threadIdx.x % FL_WARP_LANES;
    int warps = blockDim.x / FL_WARP_LANES;
    int wt = nk / FL_SPARSE_CLUSTERS;
    int parts = (wt + FL_FLAGS_PART - 1) / FL_FLAGS_PART;
    int items = rt * parts;
    bool resident = nk <= FL_FLAGS_CHUNK;
    if (resident) {
        for (int k = threadIdx.x; k < nk; k += blockDim.x)
            fl_box_load(&sbox[0][k], &sbox[1][k], amin, amax, k);
        __syncthreads();
    }
    int groups = (items + warps - 1) / warps;
    for (int g = blockIdx.x; g < groups; g += gridDim.x) {
        int item = g * warps + threadIdx.x / FL_WARP_LANES;
        bool has = item < items;
        int tile = has ? item / parts : 0;
        int pw0 = (item - tile * parts) * FL_FLAGS_PART;
        int pw1 = pw0 + FL_FLAGS_PART < wt ? pw0 + FL_FLAGS_PART : wt;
        // max_len first: an item whose tile has no live ray reads nothing else
        size_t at[FL_FLAGS_PER_LANE];
        bool in[FL_FLAGS_PER_LANE];
        float ml[FL_FLAGS_PER_LANE];
        bool live = false;
#pragma unroll
        for (int j = 0; j < FL_FLAGS_PER_LANE; ++j) {
            int r = lane + j * FL_WARP_LANES;
            at[j] = (size_t)tile * ray_tile + r;
            ml[j] = has && r < ray_tile ? max_len[at[j]] : 0.0f;
            in[j] = ml[j] > 0.0f;   // NaN: no live ray, it flags nothing
            live |= in[j];
        }
        live = __any_sync(all, live);
        fl_sray rays[FL_FLAGS_PER_LANE];
        fl_span s;
        if (live) {
            fl_srays_load(rays, at, in, ml, ox, oy, oz, dx, dy, dz);
            // fminf / fmaxf pass over a NaN component: such a ray flags nothing
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                float olo = INFINITY, ohi = -INFINITY, ilo = INFINITY, ihi = -INFINITY;
#pragma unroll
                for (int j = 0; j < FL_FLAGS_PER_LANE; ++j) {
                    if (!in[j]) continue;
                    olo = fminf(olo, rays[j].o[c]);
                    ohi = fmaxf(ohi, rays[j].o[c]);
                    ilo = fminf(ilo, rays[j].inv[c]);
                    ihi = fmaxf(ihi, rays[j].inv[c]);
                }
                s.olo[c] = fl_warp_min(olo);
                s.ohi[c] = fl_warp_max(ohi);
                s.ilo[c] = fl_warp_min(ilo);
                s.ihi[c] = fl_warp_max(ihi);
            }
            float most = -INFINITY;
#pragma unroll
            for (int j = 0; j < FL_FLAGS_PER_LANE; ++j) most = fmaxf(most, rays[j].ml);
            s.ml = fl_warp_max(most);
        }
        float* row = out + (size_t)tile * wt;
        for (int k0 = 0; k0 < nk; k0 += FL_FLAGS_CHUNK) {
            int cnt = nk - k0 < FL_FLAGS_CHUNK ? nk - k0 : FL_FLAGS_CHUNK;
            if (!resident) {
                __syncthreads();
                for (int k = threadIdx.x; k < cnt; k += blockDim.x)
                    fl_box_load(&sbox[0][k], &sbox[1][k], amin, amax, k0 + k);
                __syncthreads();
            }
            if (!has) continue;
            // this item's triangle tiles in the chunk, [wa, wb); box j of
            // the chunk is cluster k0 + j
            int c0 = k0 / FL_SPARSE_CLUSTERS, c1 = (k0 + cnt) / FL_SPARSE_CLUSTERS;
            int wa = pw0 > c0 ? pw0 : c0, wb = pw1 < c1 ? pw1 : c1;
            const float4* slo = sbox[0];
            const float4* shi = sbox[1];
            for (int w0 = wa; w0 < wb; w0 += FL_WARP_LANES) {
                int w = w0 + lane;   // this lane's triangle tile
                bool none0 = true, none1 = true;
                float entry1 = 0.0f;
                if (live && w < wb) {
                    int j = 2 * w - k0;
                    fl_cull(s, slo[j], shi[j], none0);
                    entry1 = fl_cull(s, slo[j + 1], shi[j + 1], none1);
                }
                unsigned m0 = __ballot_sync(all, !none0), m1 = __ballot_sync(all, !none1);
                float flag = FL_POW32;
                for (unsigned m = m0 | m1; m; m &= m - 1) {
                    int b = __ffs(m) - 1;
                    int k = 2 * (w0 + b) - k0;
                    unsigned best = __float_as_uint(FL_POW32);
                    if (m0 >> b & 1u) best = fl_flags_box(rays, slo[k], shi[k]);
                    float least = __shfl_sync(all, entry1, b);
                    if ((m1 >> b & 1u) && !(least >= __uint_as_float(best))) {
                        unsigned e = fl_flags_box(rays, slo[k + 1], shi[k + 1]);
                        best = e < best ? e : best;
                    }
                    if (lane == b) flag = __uint_as_float(best);
                }
                if (w < wb) row[w] = flag;
            }
        }
    }
}

// The persistent grid of the flags: as many blocks as fit on the card at
// once, and no more than the groups of FL_FLAGS_WARPS items (emulated: a
// block of one thread per item). The card's capacity is asked once, on the
// first launch; the grid size only spreads the items (every block walks
// them with a stride of gridDim.x), so any size is correct.
#ifndef FL_EMULATE
static int fl_flags_resident() {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fl_sparse_flags_kernel,
                                                  FL_FLAGS_WARPS * 32, 0);
    return (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
}
#endif

static int fl_flags_grid(int rt, int wt) {
    int items = rt * ((wt + FL_FLAGS_PART - 1) / FL_FLAGS_PART);
#ifdef FL_EMULATE
    return items;
#else
    static const int most = fl_flags_resident();
    int groups = (items + FL_FLAGS_WARPS - 1) / FL_FLAGS_WARPS;
    return groups < most ? groups : most;
#endif
}

// ---- nearest2 key: (nearest, second-nearest supertile, octant) per ray ----

#define FL_KEY_THREADS 256     // threads of a block
#define FL_KEY_RAYS 2          // rays a thread holds: a block holds 512 rays in a row
#define FL_KEY_BOX_CHUNK 256   // supertile boxes in shared memory

// A block takes FL_KEY_THREADS x FL_KEY_RAYS rays in a row: it writes the
// dead key of its dead rays at once and packs the others into a list (in
// any order: a ray's key depends on it alone), so that they fill the first
// threads, FL_KEY_RAYS each, and a warp left without a ray skips the
// boxes (it still joins the block's barriers): the TPU
// kernel's dead-tile skip, for dead rays scattered among live ones. The
// boxes pass through shared memory in chunks.
__global__ void __launch_bounds__(FL_KEY_THREADS)
fl_sparse_key_kernel(const float* __restrict__ bmin, const float* __restrict__ bmax, int nb,
                     const float* __restrict__ ox, const float* __restrict__ oy,
                     const float* __restrict__ oz, const float* __restrict__ dx,
                     const float* __restrict__ dy, const float* __restrict__ dz,
                     const float* __restrict__ max_len, int n, int* __restrict__ key_out) {
    __shared__ float4 sb[2][FL_KEY_BOX_CHUNK];
    __shared__ int slist[FL_KEY_THREADS * FL_KEY_RAYS];
    __shared__ int scount;
    size_t base = (size_t)blockIdx.x * blockDim.x * FL_KEY_RAYS;
    if (threadIdx.x == 0) scount = 0;
    __syncthreads();
    int lane = threadIdx.x % FL_WARP_LANES;
#pragma unroll
    for (int j = 0; j < FL_KEY_RAYS; ++j) {
        size_t i = base + threadIdx.x + (size_t)j * blockDim.x;
        bool in = i < (size_t)n;
        bool dead = in && max_len[i] <= 0.0f;   // a NaN max_len is no dead ray
        if (dead) key_out[i] = 1 << 30;
        // one shared atomic a warp: its rays that are not dead, in lane order
        unsigned m = __ballot_sync(0xffffffffu, in && !dead);
        int at0 = 0;
        if (lane == 0 && m) at0 = atomicAdd(&scount, __popc(m));
        at0 = __shfl_sync(0xffffffffu, at0, 0);
        if (in && !dead) slist[at0 + __popc(m & ((1u << lane) - 1u))] = (int)(i - base);
    }
    __syncthreads();
    int count = scount;
    fl_sray rays[FL_KEY_RAYS];
    size_t at[FL_KEY_RAYS];
    bool in[FL_KEY_RAYS];
    float ml[FL_KEY_RAYS], e1[FL_KEY_RAYS], e2[FL_KEY_RAYS];
    int i1[FL_KEY_RAYS], i2[FL_KEY_RAYS];
    bool work = false;
#pragma unroll
    for (int j = 0; j < FL_KEY_RAYS; ++j) {
        int q = threadIdx.x * FL_KEY_RAYS + j;   // the rays fill the first threads
        in[j] = q < count;
        at[j] = in[j] ? base + slist[q] : (size_t)n;
        ml[j] = in[j] ? max_len[at[j]] : 0.0f;
        work |= in[j];
        e1[j] = e2[j] = FL_POW32;
        i1[j] = i2[j] = nb;
    }
    fl_srays_load(rays, at, in, ml, ox, oy, oz, dx, dy, dz);
    work = __any_sync(0xffffffffu, work);
    for (int b0 = 0; b0 < nb; b0 += FL_KEY_BOX_CHUNK) {
        int cnt = nb - b0 < FL_KEY_BOX_CHUNK ? nb - b0 : FL_KEY_BOX_CHUNK;
        __syncthreads();
        for (int k = threadIdx.x; k < cnt; k += blockDim.x)
            fl_box_load(&sb[0][k], &sb[1][k], bmin, bmax, b0 + k);
        __syncthreads();
        if (!work) continue;
        for (int k = 0; k < cnt; ++k) {
            float4 lo = sb[0][k], hi = sb[1][k];
#pragma unroll
            for (int j = 0; j < FL_KEY_RAYS; ++j) {
                // best two by (entry, lowest index): the boxes come in
                // ascending index, so a tie keeps the earlier box; entries
                // at or past POW32 are no candidate (index nb)
                float e = fl_slab_entry(rays[j], lo, hi);
                bool first = e < e1[j], second = e < e2[j];
                e2[j] = first ? e1[j] : (second ? e : e2[j]);
                i2[j] = first ? i1[j] : (second ? b0 + k : i2[j]);
                e1[j] = first ? e : e1[j];
                i1[j] = first ? b0 + k : i1[j];
            }
        }
    }
#pragma unroll
    for (int j = 0; j < FL_KEY_RAYS; ++j) {
        if (at[j] >= (size_t)n) continue;
        const fl_sray& r = rays[j];
        int octant = (r.inv[0] > 0.0f) * 4 + (r.inv[1] > 0.0f) * 2 + (r.inv[2] > 0.0f);
        key_out[at[j]] = (i1[j] * (nb + 1) + i2[j]) * 8 + octant;
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

// A ray of the worklist casts (trace.cuh fl_rray) from its SoA channels;
// whether it is live (max_len > 0).
__device__ __forceinline__ bool fl_rec_ray(int i, int n, const float* ox, const float* oy,
                                           const float* oz, const float* dx, const float* dy,
                                           const float* dz, const float* max_len, fl_rray& r) {
    if (i >= n) return false;
    fl_make_rray(fl_make3(ox[i], oy[i], oz[i]), fl_make3(dx[i], dy[i], dz[i]), max_len[i], r);
    return r.max_len > 0.0f;
}

// A staged tile: quad p of triangle t's record at [p][t], so that lanes
// reading neighbouring triangles read neighbouring 16-byte words.
typedef float4 fl_tile[4][FL_SPARSE_TRI_TILE];

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
    FL_LAUNCH_BLOCKS(fl_sparse_flags_kernel, fl_flags_grid(rt, wt), FL_FLAGS_WARPS * FL_WARP_LANES,
                     stream, amin, amax, wt * FL_SPARSE_CLUSTERS, ox, oy, oz, dx, dy, dz, max_len,
                     ray_tile, rt, out);
}

FL_EXPORT int fl_sparse_key(const float* bmin, const float* bmax, int nb, const float* ox,
                            const float* oy, const float* oz, const float* dx, const float* dy,
                            const float* dz, const float* max_len, int n, int* key_out,
                            void* stream) {
    if (n <= 0) return 0;
    FL_LAUNCH(fl_sparse_key_kernel, (n + FL_KEY_RAYS - 1) / FL_KEY_RAYS, FL_KEY_THREADS, stream,
              bmin, bmax, nb, ox, oy, oz, dx, dy, dz, max_len, n, key_out);
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
