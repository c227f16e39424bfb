// FXAA (modules/fxaa.js:7-137): luma edge detection, 3x3 blur, 6-step edge
// search with per-pixel early exit, sub-pixel blend. [H, W, 4] f32 in and
// out; texels outside the image read as zero.
//
// Replaces: flexlight_tpu/post/fxaa_kernel.py `_fxaa_kernel` (entry
// `fxaa_tpu`). The TPU kernel turns the data-dependent search into a
// static prefix form over all 12 samples, because it runs whole strips in
// lock-step; a GPU thread runs the reference's sequential loop and stops
// at the first sample past the gradient, so it reads only the samples it
// uses. Expressions and their order follow post/fxaa.py, the plain twin.
//
// What bounds it on the H100: the bytes, 16 read and 16 written a pixel.
// A pixel whose neighbourhood is low-contrast (most of a frame) needs its
// 3x3 luma and leaves with its own value; an edge pixel takes up to 6
// search samples, each a 3x3 blur and a 5-luma blend, ~150 texels from a
// radius-7 window. So each block stages its tile of FL_FXAA_TX x FL_FXAA_TY
// pixels with a halo of 7 texels in shared memory once, with one 16-byte
// load a texel, and beside it the texel's luma; every pixel then reads
// shared memory only. A warp is one row of the tile: the 3x3 test runs on
// all pixels, a low-contrast pixel writes its texel with one 16-byte store,
// and an edge pixel goes on a block-local list (a ballot and one shared
// atomic a warp). The block's threads then stride over the list, so the
// edge search runs on full warps instead of on the few edge lanes of
// every warp while the rest wait.
#include "common.cuh"

#define FL_SEARCH_STEPS 6
// a tile: one warp a row; and the blocks that __launch_bounds__ asks ptxas
// to fit on one SM, 32 registers, 64 warps (the fastest of the shapes
// tried, PERF.md)
#define FL_FXAA_TX 32
#define FL_FXAA_TY 16
#define FL_FXAA_MIN_BLOCKS 4
// the reach of an edge pixel's samples: 6 search steps, then 1 for the
// blur's and the blend's neighbours
#define FL_FXAA_HALO (FL_SEARCH_STEPS + 1)
#define FL_FXAA_SW (FL_FXAA_TX + 2 * FL_FXAA_HALO)
#define FL_FXAA_SH (FL_FXAA_TY + 2 * FL_FXAA_HALO)
#define FL_FXAA_PIXELS (FL_FXAA_TX * FL_FXAA_TY)

// A block's tile in shared memory: the texels and their lumas at staged
// coordinates (y, x) = image (y0 + y, x0 + x), zero outside the image, and
// the list of the tile's edge pixels (index py * TX + px). ~29 KB.
struct fl_fxaa_tile {
    float4 col[FL_FXAA_SH][FL_FXAA_SW];
    float lum[FL_FXAA_SH][FL_FXAA_SW];
    int list[FL_FXAA_PIXELS];
    int count;
};

__device__ __forceinline__ float fl_luma(float r, float g, float a) {
    return (g * (float)(0.587 / 0.299) + r) * a;
}

// 3x3 box blur at (y, x), summed in (dy, dx) row-major order, then / 9.
__device__ __forceinline__ float4 fl_blur_at(const fl_fxaa_tile& t, int y, int x) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int dy = -1; dy <= 1; ++dy)
        for (int dx = -1; dx <= 1; ++dx) {
            float4 v = t.col[y + dy][x + dx];
            acc.x = acc.x + v.x;
            acc.y = acc.y + v.y;
            acc.z = acc.z + v.z;
            acc.w = acc.w + v.w;
        }
    return make_float4(acc.x / 9.0f, acc.y / 9.0f, acc.z / 9.0f, acc.w / 9.0f);
}

// sub-pixel blend factor (fxaa.js:58-68) at (y, x)
__device__ __forceinline__ float fl_blend_at(const fl_fxaa_tile& t, int y, int x) {
    float lc = t.lum[y][x];
    float up = t.lum[y - 1][x], lf = t.lum[y][x - 1];
    float dn = t.lum[y + 1][x], rt = t.lum[y][x + 1];
    float cmin = fminf(fminf(up, lf), fminf(dn, rt));
    float cmax = fmaxf(fmaxf(up, lf), fmaxf(dn, rt));
    float rng = fmaxf(lc, cmax) - fminf(lc, cmin);
    float luma_l = 0.25f * (((up + lf) + dn) + rt);
    float range_l = fabsf(luma_l - lc);
    float b = fmaxf(0.0f, range_l / fmaxf(rng, 1e-10f) - 0.0f) * 1.0f;
    return fminf(7.0f / 8.0f, b);
}

__device__ __forceinline__ bool fl_search_step(const fl_fxaa_tile& t, int y, int x,
                                               float luma_mcn, float gradient, float4& color) {
    float4 img = t.col[y][x];
    float4 blur = fl_blur_at(t, y, x);
    float blur_luma = fl_luma(blur.x, blur.y, blur.w);
    float bl = fl_blend_at(t, y, x);
    color.x = color.x + (img.x + (blur.x - img.x) * bl);
    color.y = color.y + (img.y + (blur.y - img.y) * bl);
    color.z = color.z + (img.z + (blur.z - img.z) * bl);
    color.w = color.w + (img.w + (blur.w - img.w) * bl);
    return fabsf(blur_luma - luma_mcn) >= gradient;
}

// The edge pixel at staged (y, x): edge direction, the search in the
// negative direction and then the positive one with the rest of the
// 6-step budget (fxaa.js:82-134).
__device__ __forceinline__ float4 fl_fxaa_edge(const fl_fxaa_tile& t, int y, int x) {
    float lm[3][3];  // lm[dy + 1][dx + 1] = luma at (y + dy, x + dx)
    for (int dy = -1; dy <= 1; ++dy)
        for (int dx = -1; dx <= 1; ++dx) lm[dy + 1][dx + 1] = t.lum[y + dy][x + dx];
    float luma = lm[1][1];
    float up = lm[0][1], lf = lm[1][0], dn = lm[2][1], rt = lm[1][2];
    float edge_vert = fabsf(0.25f * lm[0][0] - 0.5f * lm[0][1] + 0.25f * lm[0][2])
                      + fabsf(0.50f * lm[1][0] - 1.0f * lm[1][1] + 0.50f * lm[1][2])
                      + fabsf(0.25f * lm[2][0] - 0.5f * lm[2][1] + 0.25f * lm[2][2]);
    float edge_horz = fabsf(0.25f * lm[0][0] - 0.5f * lm[1][0] + 0.25f * lm[2][0])
                      + fabsf(0.50f * lm[0][1] - 1.0f * lm[1][1] + 0.50f * lm[2][1])
                      + fabsf(0.25f * lm[0][2] - 0.5f * lm[1][2] + 0.25f * lm[2][2]);
    bool horz_span = edge_horz >= edge_vert;
    float luma_mcn = fmaxf(fmaxf(fabsf(up - luma), fabsf(rt - luma)),
                           fmaxf(fabsf(dn - luma), fabsf(lf - luma)));
    float gradient = fabsf(luma_mcn - luma);
    int sy = horz_span ? 0 : 1, sx = horz_span ? 1 : 0;

    float4 color = t.col[y][x];
    float count = 1.0f;
    int taken = 0;
    for (int k = 1; k <= FL_SEARCH_STEPS; ++k) {
        ++taken;
        count = count + 1.0f;
        if (fl_search_step(t, y - sy * k, x - sx * k, luma_mcn, gradient, color)) break;
    }
    for (int k = 1; k <= FL_SEARCH_STEPS - taken; ++k) {
        count = count + 1.0f;
        if (fl_search_step(t, y + sy * k, x + sx * k, luma_mcn, gradient, color)) break;
    }
    return make_float4(color.x / count, color.y / count, color.z / count, color.w / count);
}

// One block a tile, tiles in row-major order; the image's texels are
// 16-byte aligned (the wrapper checks).
__global__ void __launch_bounds__(FL_FXAA_PIXELS, FL_FXAA_MIN_BLOCKS)
fl_fxaa_kernel(const float4* __restrict__ src, int h, int w, float4* __restrict__ dst) {
    __shared__ fl_fxaa_tile t;
    int tiles_x = (w + FL_FXAA_TX - 1) / FL_FXAA_TX;
    int ty0 = (int)(blockIdx.x / tiles_x) * FL_FXAA_TY;
    int tx0 = (int)(blockIdx.x % tiles_x) * FL_FXAA_TX;
    if (threadIdx.x == 0) t.count = 0;
    for (int e = threadIdx.x; e < FL_FXAA_SH * FL_FXAA_SW; e += blockDim.x) {
        int r = e / FL_FXAA_SW, c = e - r * FL_FXAA_SW;
        int gy = ty0 - FL_FXAA_HALO + r, gx = tx0 - FL_FXAA_HALO + c;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (gy >= 0 && gy < h && gx >= 0 && gx < w) v = src[(size_t)gy * w + gx];
        t.col[r][c] = v;
        t.lum[r][c] = fl_luma(v.x, v.y, v.w);
    }
    __syncthreads();
    // the 3x3 test (fxaa.js:36-41): low contrast keeps the texel
    int lane = threadIdx.x % FL_WARP_LANES;
    for (int base = 0; base < FL_FXAA_PIXELS; base += blockDim.x) {
        int p = base + threadIdx.x;
        int py = p / FL_FXAA_TX, px = p - py * FL_FXAA_TX;
        int gy = ty0 + py, gx = tx0 + px;
        bool edge = false;
        if (p < FL_FXAA_PIXELS && gy < h && gx < w) {
            int y = py + FL_FXAA_HALO, x = px + FL_FXAA_HALO;
            float luma = t.lum[y][x];
            float up = t.lum[y - 1][x], lf = t.lum[y][x - 1];
            float dn = t.lum[y + 1][x], rt = t.lum[y][x + 1];
            float cmin = fminf(fminf(up, lf), fminf(dn, rt));
            float cmax = fmaxf(fmaxf(up, lf), fmaxf(dn, rt));
            float range_max = fmaxf(luma, cmax);
            float rng = range_max - fminf(luma, cmin);
            if (rng < fmaxf(1.0f / 32.0f, range_max * 0.5f))
                dst[(size_t)gy * w + gx] = t.col[y][x];
            else
                edge = true;
        }
        unsigned vote = __ballot_sync(0xffffffffu, edge);
        if (vote) {
            int leader = __ffs(vote) - 1;
            int slot = 0;
            if (lane == leader) slot = atomicAdd(&t.count, __popc(vote));
            slot = __shfl_sync(0xffffffffu, slot, leader);
            if (edge) t.list[slot + __popc(vote & ((1u << lane) - 1u))] = p;
        }
    }
    __syncthreads();
    int count = t.count;
    for (int j = threadIdx.x; j < count; j += blockDim.x) {
        int p = t.list[j];
        int py = p / FL_FXAA_TX, px = p - py * FL_FXAA_TX;
        dst[(size_t)(ty0 + py) * w + tx0 + px] =
            fl_fxaa_edge(t, py + FL_FXAA_HALO, px + FL_FXAA_HALO);
    }
}

FL_EXPORT int fl_fxaa(const float* src, int h, int w, float* dst, void* stream) {
    if (h <= 0 || w <= 0) return 0;
    int tiles = ((h + FL_FXAA_TY - 1) / FL_FXAA_TY) * ((w + FL_FXAA_TX - 1) / FL_FXAA_TX);
    FL_LAUNCH_BLOCKS(fl_fxaa_kernel, tiles, FL_FXAA_PIXELS, stream, (const float4*)src, h, w,
                     (float4*)dst);
}
