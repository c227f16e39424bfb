// Edge-aware disc denoise passes (first / second / final) over packed
// rgba8 planes.
//
// Replaces: flexlight_tpu/post/filter_kernel.py `_disc_kernel` / `_disc_body`
// (launched by `_run_disc`, entry points first/second/final_filter_tpu_packed).
// The TPU kernel enumerates every integer offset the scaled stencil can
// reach as a compile-time constant, in scale bands over remapped tiles,
// because its vector unit has no per-lane gather. A GPU thread gathers, so
// this is the reference's per-tap loop: tap k reads the neighbour at
// ivec2(stencil[k] * scale(pixel)) (truncation toward zero, zero outside
// the image), and the sums run in tap order, starting from the same
// initial accumulator as `_first/_second/_final_init`. Scale formulas,
// gates, the byte unpacking k * f32(1/255) and the finish arithmetic are
// those of `_first/_second/_final_*` (filter_kernel.py:609-860); the
// plain twin is flexlight_tpu_torch/post/filters.py.
//
// Input: the packed stack [5, H, W] int32 (ID, OID, COLOR, IP, OCOLOR), one
// rgba8 pixel per int. Output: packed planes, or [H, W, 3] f32 for the final
// pass.
//
// What bounds it on the H100: memory latency of the data-dependent reads.
// Each pixel reads up to 37 neighbours x 5 ints (740 B) from a disc of
// radius up to 42 px, and does little arithmetic per byte. One thread per
// pixel, 256-thread row-major blocks: neighbouring threads read
// neighbouring addresses for every tap whose offset is the same across the
// warp (the common case: the scale key is smooth or tile-uniform), and the
// disc's reuse between pixels is served by L1/L2. A shared-memory tile
// does not pay here yet: a 16x16 tile with the first pass's 42-px halo
// would stage 100x100x5 ints (200 KB) to serve 256 pixels.
#include "common.cuh"

#define FL_PIX_BLOCK 256

enum { FL_ID = 0, FL_OID = 1, FL_COLOR = 2, FL_IP = 3, FL_OCOLOR = 4 };

// 37-tap disc (pathtracer_first_filter.glsl:50-58), (dy, dx); the 36-tap
// disc of the second pass is the same list without the centre (index 18).
// In constant memory: every thread of a warp reads the same tap, a
// broadcast (a table local to the function lives on the stack instead).
static __constant__ signed char fl_tap_dy[37] = {
    -3, -3, -3, -2, -2, -2, -2, -2, -1, -1, -1, -1, -1, -1, -1, 0, 0, 0, 0,
    0,  0,  0,  1,  1,  1,  1,  1,  1,  1,  2,  2,  2,  2,  2,  3, 3, 3};
static __constant__ signed char fl_tap_dx[37] = {
    -1, 0, 1, -2, -1, 0, 1, 2, -3, -2, -1, 0, 1, 2, 3, -3, -2, -1, 0,
    1,  2, 3, -3, -2, -1, 0, 1, 2,  3,  -2, -1, 0, 1, 2, -1, 0,  1};

struct fl_px {
    uint32_t id, oid, color, ip, ocolor;
};

__device__ __forceinline__ fl_px fl_load_px(const int* __restrict__ p5, int h,
                                            int w, int y, int x) {
    fl_px q = {0u, 0u, 0u, 0u, 0u};
    if (y >= 0 && y < h && x >= 0 && x < w) {
        size_t plane = (size_t)h * w;
        size_t o = (size_t)y * w + x;
        q.id = (uint32_t)p5[FL_ID * plane + o];
        q.oid = (uint32_t)p5[FL_OID * plane + o];
        q.color = (uint32_t)p5[FL_COLOR * plane + o];
        q.ip = (uint32_t)p5[FL_IP * plane + o];
        q.ocolor = (uint32_t)p5[FL_OCOLOR * plane + o];
    }
    return q;
}

__device__ __forceinline__ bool fl_xyz_eq(uint32_t a, uint32_t b) {
    return (a & 0x00FFFFFFu) == (b & 0x00FFFFFFu);
}

__device__ __forceinline__ void fl_offset(int k, float scale, int& oy, int& ox) {
    oy = (int)truncf((float)fl_tap_dy[k] * scale);
    ox = (int)truncf((float)fl_tap_dx[k] * scale);
}

// first pass: gated disc blur of (color + ip * 256), radius (1 + ow)^2 * 3.5
// (first_filter.glsl:96-124; the vote repair runs outside, as torch ops)
__global__ void fl_disc_first_kernel(const int* __restrict__ p5, int h, int w,
                                     int* __restrict__ color_out,
                                     int* __restrict__ ip3_out) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= h * w) return;
    int y = i / w, x = i - (i / w) * w;
    fl_px c = fl_load_px(p5, h, w, y, x);
    float ow = fl_byte_f(c.ocolor, 3);
    float t = 1.0f + ow;
    float scale = t * t * 3.5f;
    uint32_t c_light = (c.id >> 24) >> 1, c_shadow = (c.id >> 24) & 1u;
    float acc[3] = {0.0f, 0.0f, 0.0f};
    float cnt = 0.0f;
    for (int k = 0; k < 37; ++k) {
        int oy, ox;
        fl_offset(k, scale, oy, ox);
        fl_px b = fl_load_px(p5, h, w, y + oy, x + ox);
        uint32_t light = (b.id >> 24) >> 1, shadow = (b.id >> 24) & 1u;
        bool gate = fl_xyz_eq(b.id, c.id) && b.oid == c.oid &&
                    (c_light != light || c_shadow == shadow);
        if (gate) {
            for (int ch = 0; ch < 3; ++ch)
                acc[ch] = acc[ch] + (fl_byte_f(b.color, ch) + fl_byte_f(b.ip, ch) * 256.0f);
            cnt = cnt + 1.0f;
        }
    }
    bool no_blur = ow == 0.0f;
    float count = no_blur ? 1.0f : (cnt > 1.0f ? cnt : 1.0f);
    float inv = 1.0f / count;
    float cw = fl_byte_f(c.color, 3);
    float sgn = cw > 0.0f ? 1.0f : 0.0f;
    uint32_t col = 0u, ip3 = 0u;
    for (int ch = 0; ch < 3; ++ch) {
        float o = no_blur ? fl_byte_f(c.color, ch) : acc[ch];
        float q = o * inv;
        col |= fl_quant_byte(sgn * fl_mod(q, 1.0f)) << (8 * ch);
        ip3 |= fl_quant_byte(sgn * (floorf(q) * FL_INV_256)) << (8 * ch);
    }
    col |= fl_quant_byte(sgn * cw) << 24;
    color_out[i] = (int)col;
    ip3_out[i] = (int)ip3;
}

// second pass: glass-aware 36-tap blur, radius 1 + 2 tanh(ow + oidw * 4)
// (pathtracer_second_filter.glsl)
__global__ void fl_disc_second_kernel(const int* __restrict__ p5, int h, int w,
                                      int* __restrict__ color_out,
                                      int* __restrict__ ip_out,
                                      int* __restrict__ ocolor_out) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= h * w) return;
    int y = i / w, x = i - (i / w) * w;
    fl_px c = fl_load_px(p5, h, w, y, x);
    float c_ipw = fl_byte_f(c.ip, 3);
    float c_oidw = fl_byte_f(c.oid, 3);
    float scale = 1.0f + 2.0f * tanhf(fl_byte_f(c.ocolor, 3) + c_oidw * 4.0f);
    float acc[4], oacc[4];
    for (int ch = 0; ch < 3; ++ch)
        acc[ch] = fl_byte_f(c.color, ch) + fl_byte_f(c.ip, ch) * 256.0f;
    acc[3] = fl_byte_f(c.color, 3);
    for (int ch = 0; ch < 4; ++ch) oacc[ch] = fl_byte_f(c.ocolor, ch);
    float count = 1.0f, ocount = 1.0f, ipw = c_ipw;
    for (int k = 0; k < 37; ++k) {
        if (k == 18) continue;  // no centre tap
        int oy, ox;
        fl_offset(k, scale, oy, ox);
        fl_px b = fl_load_px(p5, h, w, y + oy, x + ox);
        float b_ipw = fl_byte_f(b.ip, 3);
        float b_oidw = fl_byte_f(b.oid, 3);
        bool oid_xyz = fl_xyz_eq(b.oid, c.oid);
        bool full_id = b.id == c.id;
        bool id_xyz = fl_xyz_eq(b.id, c.id);
        float mn = c_oidw < b_oidw ? c_oidw : b_oidw;
        float mx = b_ipw > c_ipw ? b_ipw : c_ipw;
        bool glassy = (mn > 0.1f) && (full_id || mx >= 0.1f);
        bool branch_a = oid_xyz && glassy;
        bool add_color = branch_a || (oid_xyz && !glassy && id_xyz);
        if (add_color) {
            for (int ch = 0; ch < 3; ++ch)
                acc[ch] = acc[ch] + (fl_byte_f(b.color, ch) + fl_byte_f(b.ip, ch) * 256.0f);
            acc[3] = acc[3] + fl_byte_f(b.color, 3);
            count = count + 1.0f;
        }
        if (branch_a) {
            ipw = ipw + b_ipw;
            for (int ch = 0; ch < 4; ++ch) oacc[ch] = oacc[ch] + fl_byte_f(b.ocolor, ch);
            ocount = ocount + 1.0f;
        }
    }
    float inv = 1.0f / count;
    float cw = fl_byte_f(c.color, 3);
    uint32_t col = 0u, ip = 0u, oc = 0u;
    for (int ch = 0; ch < 3; ++ch) {
        float q = acc[ch] * inv;
        col |= fl_quant_byte(cw * fl_mod(q, 1.0f)) << (8 * ch);
        ip |= fl_quant_byte(cw * (floorf(q) * FL_INV_256)) << (8 * ch);
    }
    col |= fl_quant_byte(cw * (acc[3] * inv)) << 24;
    ip |= fl_quant_byte(cw * ipw) << 24;
    for (int ch = 0; ch < 4; ++ch)
        oc |= fl_quant_byte(cw * oacc[ch] / ocount) << (8 * ch);
    color_out[i] = (int)col;
    ip_out[i] = (int)ip;
    ocolor_out[i] = (int)oc;
}

// final pass: 37-tap blur, first-hit albedo multiply, Reinhard + gamma
// (pathtracer_final_filter.glsl)
__global__ void fl_disc_final_kernel(const int* __restrict__ p5, int h, int w,
                                     int hdr, float* __restrict__ out3) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= h * w) return;
    int y = i / w, x = i - (i / w) * w;
    fl_px c = fl_load_px(p5, h, w, y, x);
    float c_ipw = fl_byte_f(c.ip, 3);
    float c_oidw = fl_byte_f(c.oid, 3);
    float scale = 0.7f + 2.0f * tanhf(fl_byte_f(c.ocolor, 3) + c_oidw * 4.0f);
    float csum[3] = {0.0f, 0.0f, 0.0f}, osum[3] = {0.0f, 0.0f, 0.0f};
    float count = 0.0f, ocount = 0.0f;
    for (int k = 0; k < 37; ++k) {
        int oy, ox;
        fl_offset(k, scale, oy, ox);
        fl_px b = fl_load_px(p5, h, w, y + oy, x + ox);
        float b_ipw = fl_byte_f(b.ip, 3);
        float b_oidw = fl_byte_f(b.oid, 3);
        float mx = b_ipw > c_ipw ? b_ipw : c_ipw;
        float mn = c_oidw < b_oidw ? c_oidw : b_oidw;
        bool blur_tr = (mx != 0.0f) && (mn > 0.0f);
        bool oid_xyz = fl_xyz_eq(b.oid, c.oid);
        bool id_xyz = fl_xyz_eq(b.id, c.id);
        if (blur_tr && oid_xyz) {
            for (int ch = 0; ch < 3; ++ch) osum[ch] = osum[ch] + fl_byte_f(b.ocolor, ch);
            ocount = ocount + 1.0f;
        }
        if ((blur_tr || id_xyz) && oid_xyz) {
            // 255, not 256 (final_filter.glsl:51)
            for (int ch = 0; ch < 3; ++ch)
                csum[ch] = csum[ch] + (fl_byte_f(b.color, ch) + fl_byte_f(b.ip, ch) * 255.0f);
            count = count + 1.0f;
        }
    }
    bool covered = fl_byte_f(c.color, 3) > 0.0f;
    float cnt = count > 1.0f ? count : 1.0f;
    float ocnt = ocount > 1.0f ? ocount : 1.0f;
    for (int ch = 0; ch < 3; ++ch) {
        float f = csum[ch] / cnt;
        float o = ocount == 0.0f ? fl_byte_f(c.ocolor, ch) : osum[ch] / ocnt;
        f = f * o;
        if (hdr) {
            float r = f / (f + 1.0f);
            float g = 4.0f * r;
            f = powf(g > 0.0f ? g : 0.0f, (float)(1.0 / 0.8)) / 4.0f * 1.3f;
        }
        f = f < 0.0f ? 0.0f : (f > 1.0f ? 1.0f : f);
        out3[(size_t)i * 3 + ch] = covered ? f : 0.0f;
    }
}

FL_EXPORT int fl_disc_first(const int* p5, int h, int w, int* color_out,
                            int* ip3_out, void* stream) {
    if (h <= 0 || w <= 0) return 0;
    FL_LAUNCH(fl_disc_first_kernel, h * w, FL_PIX_BLOCK, stream, p5, h, w,
              color_out, ip3_out);
}

FL_EXPORT int fl_disc_second(const int* p5, int h, int w, int* color_out,
                             int* ip_out, int* ocolor_out, void* stream) {
    if (h <= 0 || w <= 0) return 0;
    FL_LAUNCH(fl_disc_second_kernel, h * w, FL_PIX_BLOCK, stream, p5, h, w,
              color_out, ip_out, ocolor_out);
}

FL_EXPORT int fl_disc_final(const int* p5, int h, int w, int hdr, float* out3,
                            void* stream) {
    if (h <= 0 || w <= 0) return 0;
    FL_LAUNCH(fl_disc_final_kernel, h * w, FL_PIX_BLOCK, stream, p5, h, w, hdr,
              out3);
}
