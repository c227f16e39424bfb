// The rasterizer's shading of one hit layer (models/rasterizer.py _shade,
// rasterizer_fragment.glsl main) in three kernels, around the shadow casts
// of the scheme, which stay as they are:
//   surface  one launch a layer: the hit's world position, the origin of
//            every shadow ray of the layer, as SoA [3, N];
//   rays     one launch a light and layer: the shadow ray of light j, its
//            unit direction and its length, [4, N];
//   shade    one launch a layer: the surface again, the three textures,
//            Cook-Torrance of every light gated by its shadow flag, the
//            translucency fade, Reinhard + gamma, the clamp and alpha.
//
// Replaces: no TPU kernel. flexlight_tpu jits the whole rasterizer frame
// (flexlight_tpu/models/rasterizer.py raster_frame), so XLA fuses this
// shading into a few fusions; the port ran it op by op, ~1,600 torch
// launches a layer at 1080p. These kernels stand in for XLA's fusion.
// Plain versions: ops/raster_kernel.py raster_surface_plain,
// raster_rays_plain and raster_shade_plain, the eager `_shade` split at
// its two seams (the shadow casts); every float operation here is theirs,
// in their order, so with --fmad=false they agree bit for bit. The shade
// kernel computes the surface again from the hit with the surface kernel's
// operations, so that nothing but the shadow origin goes to device memory.
//
// What bounds them on the H100: the bytes of the per-pixel streams. The
// surface reads the hit's u, v and slot (12 bytes) and writes the origin
// (12); a light's rays read the origin (12) and write 16; the shade reads
// the hit (12) and one flag byte a light and writes rgb and alpha (16).
// The triangle rows, transforms, lights and texels they gather are the
// scene's, a few KB for theater, and stay in the caches. The shade's
// arithmetic (~150 float operations a light, the square roots and IEEE
// divisions among them) is about a third of its bytes' time at the fp32
// rate. One thread a pixel, launched 1-D: every access to a stream is
// coalesced, and the gathers are broadcasts within a triangle's pixels.
#include "trace.cuh"

#define FL_RASTER_BLOCK 256
#define FL_GEOM_C 12
#define FL_ATTR_C 28

// sum_v rows[v * stride + c] * w[v] over the three vertices, as
// models/rasterizer.py _bary sums them
__device__ __forceinline__ float fl_bary(const float* r, int stride, int c, const float* w) {
    return r[c] * w[0] + r[stride + c] * w[1] + r[2 * stride + c] * w[2];
}

// ops/brdf.py normalize: the rows divided by their clamped length
__device__ __forceinline__ fl_v3 fl_normalize_rows(fl_v3 a) {
    float n = fl_clamp_min(sqrtf(a.x * a.x + a.y * a.y + a.z * a.z), FL_TINY);
    return fl_make3(a.x / n, a.y / n, a.z / n);
}

// The surface of pixel i's hit: its triangle (a miss, slot -1, reads
// triangle 0), the barycentric weights (1 - u - v, u, v), the local
// position over the untransformed vertices and the forward rotation of the
// triangle's transform ([M, 2, 3, 3], the first of the pair).
struct fl_raster_hit {
    int tri;
    float w[3];
    fl_v3 local;
    const float* rot;
    int t;
};

__device__ __forceinline__ fl_raster_hit fl_raster_surface_of(
    int i, const float* __restrict__ geometry, const float* __restrict__ rotations,
    const float* __restrict__ hu, const float* __restrict__ hv, const int* __restrict__ slot) {
    fl_raster_hit h;
    float u = hu[i], v = hv[i];
    h.tri = slot[i] < 0 ? 0 : slot[i];
    h.w[0] = 1.0f - u - v;
    h.w[1] = u;
    h.w[2] = v;
    const float* g = geometry + (size_t)FL_GEOM_C * h.tri;
    h.local = fl_make3(fl_bary(g, 3, 0, h.w), fl_bary(g, 3, 1, h.w), fl_bary(g, 3, 2, h.w));
    h.t = (int)g[9];
    h.rot = rotations + 18 * (size_t)h.t;
    return h;
}

__global__ void __launch_bounds__(FL_RASTER_BLOCK) fl_raster_surface_kernel(
    const float* __restrict__ geometry, const float* __restrict__ rotations,
    const float* __restrict__ shifts, const float* __restrict__ hu,
    const float* __restrict__ hv, const int* __restrict__ slot, int n,
    float* __restrict__ origin) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fl_raster_hit h = fl_raster_surface_of(i, geometry, rotations, hu, hv, slot);
    const float* shift = shifts + 6 * (size_t)h.t;
    fl_v3 world = fl_add3(fl_matvec3(h.rot, h.local), fl_make3(shift[0], shift[1], shift[2]));
    fl_store3(origin, n, i, world);
}

__global__ void __launch_bounds__(FL_RASTER_BLOCK) fl_raster_rays_kernel(
    const float* __restrict__ origin, const float* __restrict__ light, int n,
    float* __restrict__ rays) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fl_v3 d = fl_sub3(fl_make3(light[0], light[1], light[2]), fl_load3(origin, n, i));
    float dist = fl_norm3(d);
    float len = fl_clamp_min(dist, FL_TINY);
    fl_store3(rays, n, i, fl_make3(d.x / len, d.y / len, d.z / len));
    rays[3 * (size_t)n + i] = dist;
}

__global__ void __launch_bounds__(FL_RASTER_BLOCK) fl_raster_shade_kernel(
    const float* __restrict__ geometry, const float* __restrict__ attributes,
    const float* __restrict__ rotations, fl_atlas alb, fl_atlas pbr, fl_atlas tpo_tab,
    const float* __restrict__ lights, int n_lights, const float* __restrict__ ambient,
    const float* __restrict__ cam, const float* __restrict__ hu,
    const float* __restrict__ hv, const int* __restrict__ slot,
    const uint8_t* __restrict__ shadowed, int hdr, int n, float* __restrict__ rgb,
    float* __restrict__ alpha) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fl_raster_hit h = fl_raster_surface_of(i, geometry, rotations, hu, hv, slot);
    const float* a = attributes + (size_t)FL_ATTR_C * h.tri;
    fl_v3 normal = fl_normalize_rows(fl_matvec3(
        h.rot, fl_make3(fl_bary(a, 3, 0, h.w), fl_bary(a, 3, 1, h.w), fl_bary(a, 3, 2, h.w))));
    float tu = fl_bary(a + 9, 2, 0, h.w), tv = fl_bary(a + 9, 2, 1, h.w);
    fl_v3 albedo = fl_fetch_tex(alb, tu, tv, a[15], fl_make3(a[18], a[19], a[20]));
    fl_v3 rme = fl_fetch_tex(pbr, tu, tv, a[16], fl_make3(a[21], a[22], a[23]));
    fl_v3 tpo = fl_fetch_tex(tpo_tab, tu, tv, a[17], fl_make3(a[24], a[25], a[26]));

    fl_v3 final = fl_make3(rme.z + ambient[0], rme.z + ambient[1], rme.z + ambient[2]);
    fl_v3 v = fl_normalize_rows(fl_sub3(fl_make3(cam[0], cam[1], cam[2]), h.local));
    for (int j = 0; j < n_lights; ++j) {
        const float* l = lights + 6 * j;
        float strength = l[3];
        fl_v3 c = fl_forward_trace(albedo, rme.x, rme.y,
                                   fl_sub3(fl_make3(l[0], l[1], l[2]), h.local), strength,
                                   normal, v);
        bool show = fl_norm3(c) == 0.0f;
        bool lit = !shadowed[(size_t)j * n + i];
        if (strength > 0.0f && (show || lit)) final = fl_add3(final, c);
    }

    final = fl_mul3(final, albedo);
    float peak = fl_maximum(fl_maximum(final.x, final.y), final.z);
    float t_factor = 1.0f + peak - tpo.x;
    t_factor = t_factor > 1.0f ? 1.0f : t_factor;  // torch.clamp_max: NaN stays
    fl_v3 a2 = fl_mul3(albedo, albedo);
    final = fl_add3(a2, fl_scale3(fl_sub3(final, a2), t_factor));
    float out[3] = {final.x, final.y, final.z};
    for (int k = 0; k < 3; ++k) {
        float f = out[k];
        if (hdr) {  // post/common.py reinhard_gamma
            float r = f / (f + 1.0f);
            f = powf(fl_clamp_min(4.0f * r, 0.0f), (float)(1.0 / 0.8)) / 4.0f * 1.3f;
        }
        rgb[3 * (size_t)i + k] = fl_clamp(f, 0.0f, 1.0f);
    }
    alpha[i] = 1.0f - 0.5f * tpo.x;
}

FL_EXPORT int fl_raster_surface(const float* geometry, const float* rotations,
                                const float* shifts, const float* hu, const float* hv,
                                const int* slot, int n, float* origin, void* stream) {
    if (n <= 0) return 0;
    FL_LAUNCH(fl_raster_surface_kernel, n, FL_RASTER_BLOCK, stream, geometry, rotations,
              shifts, hu, hv, slot, n, origin);
}

FL_EXPORT int fl_raster_rays(const float* origin, const float* light, int n, float* rays,
                             void* stream) {
    if (n <= 0) return 0;
    FL_LAUNCH(fl_raster_rays_kernel, n, FL_RASTER_BLOCK, stream, origin, light, n, rays);
}

FL_EXPORT int fl_raster_shade(const float* geometry, const float* attributes,
                              const float* rotations, const void* alb_texels, int alb_u8,
                              const int* alb_info, int alb_slots, const int* alb_meta,
                              const void* pbr_texels, int pbr_u8, const int* pbr_info,
                              int pbr_slots, const int* pbr_meta, const void* tpo_texels,
                              int tpo_u8, const int* tpo_info, int tpo_slots,
                              const int* tpo_meta, const float* lights, int n_lights,
                              const float* ambient, const float* cam, const float* hu,
                              const float* hv, const int* slot, const uint8_t* shadowed,
                              int hdr, int n, float* rgb, float* alpha, void* stream) {
    if (n <= 0) return 0;
    fl_atlas alb = {alb_texels, alb_u8, alb_info, alb_slots, alb_meta};
    fl_atlas pbr = {pbr_texels, pbr_u8, pbr_info, pbr_slots, pbr_meta};
    fl_atlas tpo = {tpo_texels, tpo_u8, tpo_info, tpo_slots, tpo_meta};
    FL_LAUNCH(fl_raster_shade_kernel, n, FL_RASTER_BLOCK, stream, geometry, attributes,
              rotations, alb, pbr, tpo, lights, n_lights, ambient, cam, hu, hv, slot,
              shadowed, hdr, n, rgb, alpha);
}
