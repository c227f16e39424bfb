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
// Input: the five packed planes ID, OID, COLOR, IP, OCOLOR, each [H, W]
// int32, one rgba8 pixel per int. Output: packed planes, or [H, W, 3] f32
// for the final pass.
//
// What bounds it on the H100: the bytes (each plane read once, each output
// written once) take ~20 us a 1080p pass; the taps take longer. A pixel
// takes up to 37 taps, each a gate on the neighbour's ID and OID and, where
// it passes, a sum of the neighbour's colour (3-4 channels unpacked from
// two bytes each). So the design takes the per-tap work down to a few
// instructions and 24 bytes of shared memory:
// - Every tap offset is +-trunc(d * scale) for d in 1..3 (a float product
//   and its truncation are odd in d), so a pixel computes three offsets,
//   not 74, in the same float operations.
// - A block stages its neighbourhood in shared memory once, each pixel as
//   its ID and OID (the gate), its IP and OCOLOR, and its colour sums
//   byte(color) + byte(ip) * 256 (255 in the final pass) with byte 3 of
//   COLOR, which every tap that passes the gate adds as they are: the
//   same values as computed per tap. A tap is then a shared-memory read at
//   an offset from the pixel with no bounds test; staged pixels outside the
//   image are zero, as the reference's texelFetch is.
// - Second and final pass: 2-D tiles of FL_DISC_TX x FL_DISC_TY pixels with
//   a halo of FL_DISC_REACH = trunc(3 * 3.0) = 9 px (the scale is at most
//   3). A pixel whose own OID byte 3 rules out the glass gates (<= 0.1 in
//   the second pass, 0 in the final) takes the taps of the plain id gate
//   alone.
// - First pass: its reach goes to trunc(3 * 14) = 42 px, but its scale
//   depends on the OCOLOR key alone, which filter_mode="fast" makes one
//   value per 32 x 128 key tile where it is not 0. A pixel whose key is 0
//   takes no taps at all (no_blur keeps its own colour, count 1). A block
//   is a FL_FIRST_TX x FL_FIRST_TY piece of one key tile; it stages, for
//   its largest key, the seven row bands that its seven row offsets reach,
//   each as wide as the tile plus its column reach. A pixel with that key
//   reads every tap there; a pixel with another key (per-pixel keys, as in
//   filter_mode="exact") reads its taps from global memory, where it finds
//   the same values.
// Every cooperative loop strides by blockDim.x, and the launches are 1-D
// over tiles, so the emulated build (a block of one thread) runs a whole
// tile in one thread.
#include "common.cuh"

#ifndef FL_EMULATE
#include <mutex>
#endif

#define FL_DISC_THREADS 256

// second / final pass: the tile and its halo
#define FL_DISC_TX 32
#define FL_DISC_TY 16
#define FL_DISC_REACH 9
#define FL_DISC_SW (FL_DISC_TX + 2 * FL_DISC_REACH)
#define FL_DISC_STAGED (FL_DISC_SW * (FL_DISC_TY + 2 * FL_DISC_REACH))

// first pass: the tile (a piece of one 32 x 128 key tile) and its bands
#define FL_FIRST_TX 128
#define FL_FIRST_TY 1
#define FL_FIRST_REACH 42
#define FL_FIRST_THREADS (FL_FIRST_TX * FL_FIRST_TY)  // a pixel a thread
// pixels a thread stages at a time, their loads in flight together
#define FL_STAGE_BATCH 8
#define FL_FIRST_STAGED (7 * FL_FIRST_TY * (FL_FIRST_TX + 2 * FL_FIRST_REACH))

struct alignas(8) fl_u2 {
    uint32_t x, y;
};

// The 37-tap disc (pathtracer_first_filter.glsl:50-58), rows dy = -3..3 of
// 3, 5, 7, 7, 7, 5, 3 taps; the 36-tap disc of the second pass is the same
// list without the centre (k = 18). Tap k's (dy, dx), constants wherever k
// is (an unrolled loop).
__device__ __forceinline__ int fl_tap_dy(int k) {
    return k < 3 ? -3 : k < 8 ? -2 : k < 15 ? -1 : k < 22 ? 0 : k < 29 ? 1 : k < 34 ? 2 : 3;
}

__device__ __forceinline__ int fl_tap_dx(int k) {
    return k < 3 ? k - 1 : k < 8 ? k - 5 : k < 29 ? (k - 8) % 7 - 3 : k < 34 ? k - 31 : k - 35;
}

// The three offsets trunc(d * scale), d = 1, 2, 3 (trunc((-d) * scale) is
// their negation: a float product and a truncation are odd, and
// trunc(0 * scale) is 0 for a finite scale).
struct fl_reach {
    int o1, o2, o3;
};

__device__ __forceinline__ fl_reach fl_reach_of(float scale) {
    fl_reach q;
    q.o1 = (int)truncf(1.0f * scale);
    q.o2 = (int)truncf(2.0f * scale);
    q.o3 = (int)truncf(3.0f * scale);
    return q;
}

// the offset of tap coordinate d in -3..3
__device__ __forceinline__ int fl_off(int d, const fl_reach& q) {
    int m = d < 0 ? -d : d;
    int o = m == 1 ? q.o1 : m == 2 ? q.o2 : m == 3 ? q.o3 : 0;
    return d < 0 ? -o : o;
}

__device__ __forceinline__ bool fl_xyz_eq(uint32_t a, uint32_t b) {
    return (a & 0x00FFFFFFu) == (b & 0x00FFFFFFu);
}

// a channel's colour sum: byte(color) + byte(ip) * hi (hi 256, or 255 in
// the final pass, final_filter.glsl:51)
__device__ __forceinline__ float fl_sum_ch(uint32_t color, uint32_t ip, int ch, float hi) {
    return fl_byte_f(color, ch) + fl_byte_f(ip, ch) * hi;
}

// A tap that passes its gate adds its colour sums and counts one; one that
// fails leaves both as they are. The sums are taken either way (the
// staged values are always there to read), so a warp runs the taps
// without branches.
__device__ __forceinline__ void fl_add_if(bool gate, float* acc, float4 v, float& count) {
    acc[0] = gate ? acc[0] + v.x : acc[0];
    acc[1] = gate ? acc[1] + v.y : acc[1];
    acc[2] = gate ? acc[2] + v.z : acc[2];
    count = gate ? count + 1.0f : count;
}

__device__ __forceinline__ bool fl_inside(int y, int x, int h, int w) {
    return y >= 0 && y < h && x >= 0 && x < w;
}

// ---- first pass -------------------------------------------------------

// the first pass's gate (first_filter.glsl:104-110)
__device__ __forceinline__ bool fl_first_gate(uint32_t bid, uint32_t boid, uint32_t cid,
                                              uint32_t coid) {
    uint32_t c_light = (cid >> 24) >> 1, c_shadow = (cid >> 24) & 1u;
    uint32_t light = (bid >> 24) >> 1, shadow = (bid >> 24) & 1u;
    return fl_xyz_eq(bid, cid) && boid == coid && (c_light != light || c_shadow == shadow);
}

// first pass: gated disc blur of (color + ip * 256), radius (1 + ow)^2 * 3.5
// (first_filter.glsl:96-124; the vote repair runs outside, as torch ops)
__global__ void __launch_bounds__(FL_FIRST_THREADS) fl_disc_first_kernel(
    const int* __restrict__ pid, const int* __restrict__ poid, const int* __restrict__ pcolor,
    const int* __restrict__ pip, const int* __restrict__ pocolor, int h, int w,
    int* __restrict__ color_out, int* __restrict__ ip3_out) {
    FL_DYN_SHARED(float4, smem);
    float4* s_val = smem;                                   // colour sums
    fl_u2* s_gate = (fl_u2*)(smem + FL_FIRST_STAGED);       // ID, OID
    __shared__ unsigned block_key;
    int tiles_x = (w + FL_FIRST_TX - 1) / FL_FIRST_TX;
    int y0 = (int)(blockIdx.x / tiles_x) * FL_FIRST_TY;
    int x0 = (int)(blockIdx.x % tiles_x) * FL_FIRST_TX;

    // the block's largest key byte (0: no pixel of it blurs)
    if (threadIdx.x == 0) block_key = 0u;
    __syncthreads();
    for (int p = threadIdx.x; p < FL_FIRST_TX * FL_FIRST_TY; p += blockDim.x) {
        int y = y0 + p / FL_FIRST_TX, x = x0 + p % FL_FIRST_TX;
        if (y < h && x < w) {
            unsigned key = (uint32_t)pocolor[(size_t)y * w + x] >> 24;
            if (key) atomicMax(&block_key, key);
        }
    }
    __syncthreads();
    unsigned key = block_key;
    float kt = 1.0f + fl_byte_f(key << 24, 3);
    fl_reach kq = fl_reach_of(kt * kt * 3.5f);
    bool staged = key != 0u && kq.o3 <= FL_FIRST_REACH;
    int bw = FL_FIRST_TX + 2 * kq.o3;   // a band's width
    // band a (row offset of dy = a - 3), row r: the tile's row r moved by
    // that offset, columns [x0 - o3, x0 + TX + o3); element (a TY + r) bw +
    // column. A thread takes a column, FL_STAGE_BATCH of its rows at a time.
    for (int c = threadIdx.x; staged && c < bw; c += blockDim.x) {
        int x = x0 - kq.o3 + c;
        for (int row0 = 0; row0 < 7 * FL_FIRST_TY; row0 += FL_STAGE_BATCH) {
            uint32_t px[FL_STAGE_BATCH][4];
#pragma unroll
            for (int j = 0; j < FL_STAGE_BATCH; ++j) {
                int row = row0 + j, a = row / FL_FIRST_TY;
                int y = y0 + row - a * FL_FIRST_TY + fl_off(a - 3, kq);
                bool in = row < 7 * FL_FIRST_TY && fl_inside(y, x, h, w);
                size_t o = in ? (size_t)y * w + x : 0;
                px[j][0] = in ? (uint32_t)pid[o] : 0u;
                px[j][1] = in ? (uint32_t)poid[o] : 0u;
                px[j][2] = in ? (uint32_t)pcolor[o] : 0u;
                px[j][3] = in ? (uint32_t)pip[o] : 0u;
            }
#pragma unroll
            for (int j = 0; j < FL_STAGE_BATCH; ++j) {
                int e = (row0 + j) * bw + c;
                if (row0 + j >= 7 * FL_FIRST_TY) break;
                s_gate[e] = fl_u2{px[j][0], px[j][1]};
                s_val[e] = make_float4(fl_sum_ch(px[j][2], px[j][3], 0, 256.0f),
                                       fl_sum_ch(px[j][2], px[j][3], 1, 256.0f),
                                       fl_sum_ch(px[j][2], px[j][3], 2, 256.0f), 0.0f);
            }
        }
    }
    __syncthreads();

    int band = FL_FIRST_TY * bw;
    for (int p = threadIdx.x; p < FL_FIRST_TX * FL_FIRST_TY; p += blockDim.x) {
        int ly = p / FL_FIRST_TX, lx = p % FL_FIRST_TX;
        int y = y0 + ly, x = x0 + lx;
        if (y >= h || x >= w) continue;
        size_t i = (size_t)y * w + x;
        uint32_t cid = (uint32_t)pid[i], coid = (uint32_t)poid[i];
        uint32_t ccolor = (uint32_t)pcolor[i], cocolor = (uint32_t)pocolor[i];
        float ow = fl_byte_f(cocolor, 3);
        float acc[3] = {0.0f, 0.0f, 0.0f};
        float cnt = 0.0f;
        if (staged && (cocolor >> 24) == key) {
            int base = ly * bw + lx + kq.o3;
#pragma unroll
            for (int k = 0; k < 37; ++k) {
                int e = base + (fl_tap_dy(k) + 3) * band + fl_off(fl_tap_dx(k), kq);
                fl_u2 g = s_gate[e];
                float4 v = s_val[e];
                fl_add_if(fl_first_gate(g.x, g.y, cid, coid), acc, v, cnt);
            }
        } else if (ow != 0.0f) {
            float t = 1.0f + ow;
            fl_reach q = fl_reach_of(t * t * 3.5f);
            for (int k = 0; k < 37; ++k) {
                int yy = y + fl_off(fl_tap_dy(k), q), xx = x + fl_off(fl_tap_dx(k), q);
                bool in = fl_inside(yy, xx, h, w);
                size_t o = in ? (size_t)yy * w + xx : 0;
                uint32_t bid = in ? (uint32_t)pid[o] : 0u, boid = in ? (uint32_t)poid[o] : 0u;
                if (fl_first_gate(bid, boid, cid, coid)) {
                    uint32_t color = in ? (uint32_t)pcolor[o] : 0u;
                    uint32_t ip = in ? (uint32_t)pip[o] : 0u;
                    for (int ch = 0; ch < 3; ++ch)
                        acc[ch] = acc[ch] + fl_sum_ch(color, ip, ch, 256.0f);
                    cnt = cnt + 1.0f;
                }
            }
        }
        bool no_blur = ow == 0.0f;
        float count = no_blur ? 1.0f : (cnt > 1.0f ? cnt : 1.0f);
        float inv = 1.0f / count;
        float cw = fl_byte_f(ccolor, 3);
        float sgn = cw > 0.0f ? 1.0f : 0.0f;
        uint32_t col = 0u, ip3 = 0u;
        for (int ch = 0; ch < 3; ++ch) {
            float o = no_blur ? fl_byte_f(ccolor, ch) : acc[ch];
            float q = o * inv;
            col |= fl_quant_byte(sgn * fl_mod(q, 1.0f)) << (8 * ch);
            ip3 |= fl_quant_byte(sgn * (floorf(q) * FL_INV_256)) << (8 * ch);
        }
        col |= fl_quant_byte(sgn * cw) << 24;
        color_out[i] = (int)col;
        ip3_out[i] = (int)ip3;
    }
}

// ---- second and final pass: a tile with its 9-px halo ------------------

// Stage the tile at (y0, x0) with its halo: ID and OID, IP and OCOLOR, and
// the colour sums with byte 3 of COLOR; zero outside the image. Each thread
// takes FL_STAGE_BATCH pixels at a time and issues all their loads first.
__device__ __forceinline__ void fl_disc_stage(
    const int* __restrict__ pid, const int* __restrict__ poid, const int* __restrict__ pcolor,
    const int* __restrict__ pip, const int* __restrict__ pocolor, int h, int w, int y0, int x0,
    float hi, float4* s_val, fl_u2* s_gate, fl_u2* s_aux) {
    for (int e0 = threadIdx.x; e0 < FL_DISC_STAGED; e0 += FL_STAGE_BATCH * blockDim.x) {
        uint32_t px[FL_STAGE_BATCH][5];
#pragma unroll
        for (int j = 0; j < FL_STAGE_BATCH; ++j) {
            int e = e0 + j * blockDim.x;
            int r = e / FL_DISC_SW;
            int y = y0 - FL_DISC_REACH + r, x = x0 - FL_DISC_REACH + (e - r * FL_DISC_SW);
            bool in = e < FL_DISC_STAGED && fl_inside(y, x, h, w);
            size_t o = in ? (size_t)y * w + x : 0;
            px[j][0] = in ? (uint32_t)pid[o] : 0u;
            px[j][1] = in ? (uint32_t)poid[o] : 0u;
            px[j][2] = in ? (uint32_t)pcolor[o] : 0u;
            px[j][3] = in ? (uint32_t)pip[o] : 0u;
            px[j][4] = in ? (uint32_t)pocolor[o] : 0u;
        }
#pragma unroll
        for (int j = 0; j < FL_STAGE_BATCH; ++j) {
            int e = e0 + j * blockDim.x;
            if (e >= FL_DISC_STAGED) break;
            uint32_t color = px[j][2], ip = px[j][3];
            s_gate[e] = fl_u2{px[j][0], px[j][1]};
            s_aux[e] = fl_u2{ip, px[j][4]};
            s_val[e] = make_float4(fl_sum_ch(color, ip, 0, hi), fl_sum_ch(color, ip, 1, hi),
                                   fl_sum_ch(color, ip, 2, hi), fl_byte_f(color, 3));
        }
    }
}

// the staged element of tap (dy, dx) from the pixel's element c
__device__ __forceinline__ int fl_tap_at(int c, int k, const fl_reach& q, const fl_reach& rows) {
    return c + fl_off(fl_tap_dy(k), rows) + fl_off(fl_tap_dx(k), q);
}

// second pass: glass-aware 36-tap blur, radius 1 + 2 tanh(ow + oidw * 4)
// (pathtracer_second_filter.glsl)
__global__ void __launch_bounds__(FL_DISC_THREADS) fl_disc_second_kernel(
    const int* __restrict__ pid, const int* __restrict__ poid, const int* __restrict__ pcolor,
    const int* __restrict__ pip, const int* __restrict__ pocolor, int h, int w,
    int* __restrict__ color_out, int* __restrict__ ip_out, int* __restrict__ ocolor_out) {
    FL_DYN_SHARED(float4, smem);
    float4* s_val = smem;
    fl_u2* s_gate = (fl_u2*)(smem + FL_DISC_STAGED);
    fl_u2* s_aux = s_gate + FL_DISC_STAGED;
    int tiles_x = (w + FL_DISC_TX - 1) / FL_DISC_TX;
    int y0 = (int)(blockIdx.x / tiles_x) * FL_DISC_TY;
    int x0 = (int)(blockIdx.x % tiles_x) * FL_DISC_TX;
    fl_disc_stage(pid, poid, pcolor, pip, pocolor, h, w, y0, x0, 256.0f, s_val, s_gate, s_aux);
    __syncthreads();
    for (int p = threadIdx.x; p < FL_DISC_TX * FL_DISC_TY; p += blockDim.x) {
        int ly = p / FL_DISC_TX, lx = p % FL_DISC_TX;
        int y = y0 + ly, x = x0 + lx;
        if (y >= h || x >= w) continue;
        int c = (ly + FL_DISC_REACH) * FL_DISC_SW + lx + FL_DISC_REACH;
        fl_u2 cg = s_gate[c], ca = s_aux[c];
        float4 cv = s_val[c];
        uint32_t cid = cg.x, coid = cg.y, cocolor = ca.y;
        float c_ipw = fl_byte_f(ca.x, 3);
        float c_oidw = fl_byte_f(coid, 3);
        float scale = 1.0f + 2.0f * tanhf(fl_byte_f(cocolor, 3) + c_oidw * 4.0f);
        fl_reach q = fl_reach_of(scale);
        fl_reach rows = {q.o1 * FL_DISC_SW, q.o2 * FL_DISC_SW, q.o3 * FL_DISC_SW};
        float acc[4] = {cv.x, cv.y, cv.z, cv.w};
        float oacc[4];
        for (int ch = 0; ch < 4; ++ch) oacc[ch] = fl_byte_f(cocolor, ch);
        float count = 1.0f, ocount = 1.0f, ipw = c_ipw;
        if (!(c_oidw > 0.1f)) {
            // min(oidw) > 0.1 fails for every tap: no tap is glassy, and a
            // tap adds its colour where its OID and ID match in xyz
#pragma unroll
            for (int k = 0; k < 37; ++k) {
                if (k == 18) continue;  // no centre tap
                int e = fl_tap_at(c, k, q, rows);
                fl_u2 g = s_gate[e];
                float4 v = s_val[e];
                bool add = fl_xyz_eq(g.y, coid) && fl_xyz_eq(g.x, cid);
                acc[3] = add ? acc[3] + v.w : acc[3];
                fl_add_if(add, acc, v, count);
            }
        } else {
#pragma unroll
            for (int k = 0; k < 37; ++k) {
                if (k == 18) continue;
                int e = fl_tap_at(c, k, q, rows);
                fl_u2 g = s_gate[e];
                bool oid_xyz = fl_xyz_eq(g.y, coid);
                if (!oid_xyz) continue;  // both sums need it
                fl_u2 a = s_aux[e];
                float b_ipw = fl_byte_f(a.x, 3);
                float b_oidw = fl_byte_f(g.y, 3);
                bool full_id = g.x == cid;
                bool id_xyz = fl_xyz_eq(g.x, cid);
                float mn = c_oidw < b_oidw ? c_oidw : b_oidw;
                float mx = b_ipw > c_ipw ? b_ipw : c_ipw;
                bool glassy = (mn > 0.1f) && (full_id || mx >= 0.1f);
                if (glassy || id_xyz) {
                    float4 v = s_val[e];
                    acc[0] = acc[0] + v.x;
                    acc[1] = acc[1] + v.y;
                    acc[2] = acc[2] + v.z;
                    acc[3] = acc[3] + v.w;
                    count = count + 1.0f;
                }
                if (glassy) {
                    ipw = ipw + b_ipw;
                    for (int ch = 0; ch < 4; ++ch) oacc[ch] = oacc[ch] + fl_byte_f(a.y, ch);
                    ocount = ocount + 1.0f;
                }
            }
        }
        float inv = 1.0f / count;
        float cw = cv.w;
        uint32_t col = 0u, ip = 0u, oc = 0u;
        for (int ch = 0; ch < 3; ++ch) {
            float qv = acc[ch] * inv;
            col |= fl_quant_byte(cw * fl_mod(qv, 1.0f)) << (8 * ch);
            ip |= fl_quant_byte(cw * (floorf(qv) * FL_INV_256)) << (8 * ch);
        }
        col |= fl_quant_byte(cw * (acc[3] * inv)) << 24;
        ip |= fl_quant_byte(cw * ipw) << 24;
        for (int ch = 0; ch < 4; ++ch)
            oc |= fl_quant_byte(cw * oacc[ch] / ocount) << (8 * ch);
        size_t i = (size_t)y * w + x;
        color_out[i] = (int)col;
        ip_out[i] = (int)ip;
        ocolor_out[i] = (int)oc;
    }
}

// final pass: 37-tap blur, first-hit albedo multiply, Reinhard + gamma
// (pathtracer_final_filter.glsl)
__global__ void __launch_bounds__(FL_DISC_THREADS) fl_disc_final_kernel(
    const int* __restrict__ pid, const int* __restrict__ poid, const int* __restrict__ pcolor,
    const int* __restrict__ pip, const int* __restrict__ pocolor, int h, int w, int hdr,
    float* __restrict__ out3) {
    FL_DYN_SHARED(float4, smem);
    float4* s_val = smem;
    fl_u2* s_gate = (fl_u2*)(smem + FL_DISC_STAGED);
    fl_u2* s_aux = s_gate + FL_DISC_STAGED;
    int tiles_x = (w + FL_DISC_TX - 1) / FL_DISC_TX;
    int y0 = (int)(blockIdx.x / tiles_x) * FL_DISC_TY;
    int x0 = (int)(blockIdx.x % tiles_x) * FL_DISC_TX;
    fl_disc_stage(pid, poid, pcolor, pip, pocolor, h, w, y0, x0, 255.0f, s_val, s_gate, s_aux);
    __syncthreads();
    for (int p = threadIdx.x; p < FL_DISC_TX * FL_DISC_TY; p += blockDim.x) {
        int ly = p / FL_DISC_TX, lx = p % FL_DISC_TX;
        int y = y0 + ly, x = x0 + lx;
        if (y >= h || x >= w) continue;
        int c = (ly + FL_DISC_REACH) * FL_DISC_SW + lx + FL_DISC_REACH;
        fl_u2 cg = s_gate[c], ca = s_aux[c];
        uint32_t cid = cg.x, coid = cg.y, cocolor = ca.y;
        float c_ipw = fl_byte_f(ca.x, 3);
        float c_oidw = fl_byte_f(coid, 3);
        float scale = 0.7f + 2.0f * tanhf(fl_byte_f(cocolor, 3) + c_oidw * 4.0f);
        fl_reach q = fl_reach_of(scale);
        fl_reach rows = {q.o1 * FL_DISC_SW, q.o2 * FL_DISC_SW, q.o3 * FL_DISC_SW};
        float csum[3] = {0.0f, 0.0f, 0.0f}, osum[3] = {0.0f, 0.0f, 0.0f};
        float count = 0.0f, ocount = 0.0f;
        if (!(c_oidw > 0.0f)) {
            // min(oidw) > 0 fails for every tap: no tap blurs the
            // transparent sum, and a tap adds its colour where its OID and
            // ID match in xyz
#pragma unroll
            for (int k = 0; k < 37; ++k) {
                int e = fl_tap_at(c, k, q, rows);
                fl_u2 g = s_gate[e];
                float4 v = s_val[e];
                fl_add_if(fl_xyz_eq(g.y, coid) && fl_xyz_eq(g.x, cid), csum, v, count);
            }
        } else {
#pragma unroll
            for (int k = 0; k < 37; ++k) {
                int e = fl_tap_at(c, k, q, rows);
                fl_u2 g = s_gate[e];
                if (!fl_xyz_eq(g.y, coid)) continue;  // both sums need it
                fl_u2 a = s_aux[e];
                float b_ipw = fl_byte_f(a.x, 3);
                float b_oidw = fl_byte_f(g.y, 3);
                float mx = b_ipw > c_ipw ? b_ipw : c_ipw;
                float mn = c_oidw < b_oidw ? c_oidw : b_oidw;
                bool blur_tr = (mx != 0.0f) && (mn > 0.0f);
                if (blur_tr) {
                    for (int ch = 0; ch < 3; ++ch) osum[ch] = osum[ch] + fl_byte_f(a.y, ch);
                    ocount = ocount + 1.0f;
                }
                if (blur_tr || fl_xyz_eq(g.x, cid)) {
                    float4 v = s_val[e];
                    csum[0] = csum[0] + v.x;
                    csum[1] = csum[1] + v.y;
                    csum[2] = csum[2] + v.z;
                    count = count + 1.0f;
                }
            }
        }
        bool covered = s_val[c].w > 0.0f;
        float cnt = count > 1.0f ? count : 1.0f;
        float ocnt = ocount > 1.0f ? ocount : 1.0f;
        size_t i = (size_t)y * w + x;
        for (int ch = 0; ch < 3; ++ch) {
            float f = csum[ch] / cnt;
            float o = ocount == 0.0f ? fl_byte_f(cocolor, ch) : osum[ch] / ocnt;
            f = f * o;
            if (hdr) {
                float r = f / (f + 1.0f);
                float g = 4.0f * r;
                f = powf(g > 0.0f ? g : 0.0f, (float)(1.0 / 0.8)) / 4.0f * 1.3f;
            }
            f = f < 0.0f ? 0.0f : (f > 1.0f ? 1.0f : f);
            out3[i * 3 + ch] = covered ? f : 0.0f;
        }
    }
}

// ---- entry points --------------------------------------------------------

#define FL_FIRST_SMEM ((size_t)FL_FIRST_STAGED * (sizeof(float4) + sizeof(fl_u2)))
#define FL_DISC_SMEM ((size_t)FL_DISC_STAGED * (sizeof(float4) + 2 * sizeof(fl_u2)))

// Allow `kernel` `smem` bytes of dynamic shared memory on the current
// device (needed above 48 KB), once per kernel and device; 0 or the CUDA
// error.
#define FL_DISC_DEVICES 64
template <typename K>
static int fl_allow_smem(K kernel, size_t smem) {
#ifdef FL_EMULATE
    (void)kernel;
    (void)smem;
    return 0;
#else
    if (smem <= 48 * 1024) return 0;
    static std::mutex lock;
    static bool allowed[FL_DISC_DEVICES];
    int dev = 0;
    int err = (int)cudaGetDevice(&dev);
    if (err) return err;
    bool kept = dev >= 0 && dev < FL_DISC_DEVICES;
    std::lock_guard<std::mutex> hold(lock);
    if (kept && allowed[dev]) return 0;
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem);
    if (!err && kept) allowed[dev] = true;
    return err;
#endif
}

static int fl_tiles(int h, int w, int ty, int tx) {
    return ((h + ty - 1) / ty) * ((w + tx - 1) / tx);
}

FL_EXPORT int fl_disc_first(const int* id, const int* oid, const int* color, const int* ip,
                            const int* ocolor, int h, int w, int* color_out, int* ip3_out,
                            void* stream) {
    if (h <= 0 || w <= 0) return 0;
    int err = fl_allow_smem(fl_disc_first_kernel, FL_FIRST_SMEM);
    if (err) return err;
    FL_LAUNCH_BLOCKS_SMEM(fl_disc_first_kernel, fl_tiles(h, w, FL_FIRST_TY, FL_FIRST_TX),
                          FL_FIRST_THREADS, FL_FIRST_SMEM, stream, id, oid, color, ip, ocolor,
                          h, w, color_out, ip3_out);
}

FL_EXPORT int fl_disc_second(const int* id, const int* oid, const int* color, const int* ip,
                             const int* ocolor, int h, int w, int* color_out, int* ip_out,
                             int* ocolor_out, void* stream) {
    if (h <= 0 || w <= 0) return 0;
    int err = fl_allow_smem(fl_disc_second_kernel, FL_DISC_SMEM);
    if (err) return err;
    FL_LAUNCH_BLOCKS_SMEM(fl_disc_second_kernel, fl_tiles(h, w, FL_DISC_TY, FL_DISC_TX),
                          FL_DISC_THREADS, FL_DISC_SMEM, stream, id, oid, color, ip, ocolor,
                          h, w, color_out, ip_out, ocolor_out);
}

FL_EXPORT int fl_disc_final(const int* id, const int* oid, const int* color, const int* ip,
                            const int* ocolor, int h, int w, int hdr, float* out3,
                            void* stream) {
    if (h <= 0 || w <= 0) return 0;
    int err = fl_allow_smem(fl_disc_final_kernel, FL_DISC_SMEM);
    if (err) return err;
    FL_LAUNCH_BLOCKS_SMEM(fl_disc_final_kernel, fl_tiles(h, w, FL_DISC_TY, FL_DISC_TX),
                          FL_DISC_THREADS, FL_DISC_SMEM, stream, id, oid, color, ip, ocolor,
                          h, w, hdr, out3);
}
