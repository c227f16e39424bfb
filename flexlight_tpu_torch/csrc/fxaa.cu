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
// What bounds it on the H100: the reads. A pixel whose neighbourhood is
// low-contrast (most of a frame) reads its 3x3 luma and leaves with its
// own value; an edge pixel reads up to 12 search samples, each with a 3x3
// blur and a 5-tap blend, about 150 texels from a radius-7 window. One
// thread per pixel in row-major 256-thread blocks, so a warp's reads at a
// given step are neighbouring addresses; the window's reuse between
// pixels is served by L1/L2. A shared-memory tile with a halo of 8 is the
// next step if the pass shows up in the frame's profile.
#include "common.cuh"

#define FL_PIX_BLOCK 256
#define FL_SEARCH_STEPS 6

struct fl_image {
    const float* p;
    int h, w;
};

__device__ __forceinline__ float fl_texel(const fl_image& im, int y, int x, int c) {
    if (y < 0 || y >= im.h || x < 0 || x >= im.w) return 0.0f;
    return im.p[((size_t)y * im.w + x) * 4 + c];
}

__device__ __forceinline__ float fl_luma(float r, float g, float a) {
    return (g * (float)(0.587 / 0.299) + r) * a;
}

__device__ __forceinline__ float fl_luma_at(const fl_image& im, int y, int x) {
    return fl_luma(fl_texel(im, y, x, 0), fl_texel(im, y, x, 1), fl_texel(im, y, x, 3));
}

// 3x3 box blur at (y, x), summed in (dy, dx) row-major order, then / 9.
__device__ __forceinline__ void fl_blur_at(const fl_image& im, int y, int x,
                                           float out[4]) {
    for (int c = 0; c < 4; ++c) {
        float acc = 0.0f;
        for (int dy = -1; dy <= 1; ++dy)
            for (int dx = -1; dx <= 1; ++dx) acc = acc + fl_texel(im, y + dy, x + dx, c);
        out[c] = acc / 9.0f;
    }
}

// sub-pixel blend factor (fxaa.js:58-68) at (y, x)
__device__ __forceinline__ float fl_blend_at(const fl_image& im, int y, int x) {
    float lc = fl_luma_at(im, y, x);
    float up = fl_luma_at(im, y - 1, x), lf = fl_luma_at(im, y, x - 1);
    float dn = fl_luma_at(im, y + 1, x), rt = fl_luma_at(im, y, x + 1);
    float cmin = fminf(fminf(up, lf), fminf(dn, rt));
    float cmax = fmaxf(fmaxf(up, lf), fmaxf(dn, rt));
    float rng = fmaxf(lc, cmax) - fminf(lc, cmin);
    float luma_l = 0.25f * (((up + lf) + dn) + rt);
    float range_l = fabsf(luma_l - lc);
    float b = fmaxf(0.0f, range_l / fmaxf(rng, 1e-10f) - 0.0f) * 1.0f;
    return fminf(7.0f / 8.0f, b);
}

__device__ __forceinline__ bool fl_search_step(const fl_image& im, int y, int x,
                                               float luma_mcn, float gradient,
                                               float color[4]) {
    float img[4], blur[4];
    for (int c = 0; c < 4; ++c) img[c] = fl_texel(im, y, x, c);
    fl_blur_at(im, y, x, blur);
    float blur_luma = fl_luma(blur[0], blur[1], blur[3]);
    float bl = fl_blend_at(im, y, x);
    for (int c = 0; c < 4; ++c) color[c] = color[c] + (img[c] + (blur[c] - img[c]) * bl);
    return fabsf(blur_luma - luma_mcn) >= gradient;
}

__global__ void fl_fxaa_kernel(const float* __restrict__ src, int h, int w,
                               float* __restrict__ dst) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= h * w) return;
    int y = i / w, x = i - (i / w) * w;
    fl_image im = {src, h, w};
    float lm[3][3];  // lm[dy + 1][dx + 1] = luma at (y + dy, x + dx)
    for (int dy = -1; dy <= 1; ++dy)
        for (int dx = -1; dx <= 1; ++dx) lm[dy + 1][dx + 1] = fl_luma_at(im, y + dy, x + dx);
    float luma = lm[1][1];
    float up = lm[0][1], lf = lm[1][0], dn = lm[2][1], rt = lm[1][2];
    float cmin = fminf(fminf(up, lf), fminf(dn, rt));
    float cmax = fmaxf(fmaxf(up, lf), fmaxf(dn, rt));
    float range_max = fmaxf(luma, cmax);
    float rng = range_max - fminf(luma, cmin);
    float* out = dst + (size_t)i * 4;
    if (rng < fmaxf(1.0f / 32.0f, range_max * 0.5f)) {  // low contrast
        for (int c = 0; c < 4; ++c) out[c] = fl_texel(im, y, x, c);
        return;
    }
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

    float color[4];
    for (int c = 0; c < 4; ++c) color[c] = fl_texel(im, y, x, c);
    float count = 1.0f;
    int taken = 0;
    // negative direction, then the positive one with the rest of the
    // 6-step budget (fxaa.js:117-134)
    for (int k = 1; k <= FL_SEARCH_STEPS; ++k) {
        ++taken;
        count = count + 1.0f;
        if (fl_search_step(im, y - sy * k, x - sx * k, luma_mcn, gradient, color)) break;
    }
    for (int k = 1; k <= FL_SEARCH_STEPS - taken; ++k) {
        count = count + 1.0f;
        if (fl_search_step(im, y + sy * k, x + sx * k, luma_mcn, gradient, color)) break;
    }
    for (int c = 0; c < 4; ++c) out[c] = color[c] / count;
}

FL_EXPORT int fl_fxaa(const float* src, int h, int w, float* dst, void* stream) {
    if (h <= 0 || w <= 0) return 0;
    FL_LAUNCH(fl_fxaa_kernel, h * w, FL_PIX_BLOCK, stream, src, h, w, dst);
}
