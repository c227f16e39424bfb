// Shared definitions of the flexlight_tpu_torch kernels.
//
// Every kernel here is launched 1-D over its items (rays or pixels) with
// FL_LAUNCH, or over its blocks (ray tiles) with FL_LAUNCH_BLOCKS, and
// reads blockDim.x wherever it cooperates inside a block.
// That lets the same sources compile for the host (-DFL_EMULATE, see
// _native.build_library): each thread then runs in turn as a block of one,
// __syncthreads() is a no-op, a warp is one lane (FL_WARP_LANES), a warp
// vote or ballot is its own predicate, a warp shuffle or reduction returns
// the thread's own value, an asynchronous copy to shared
// memory is a plain copy and waiting for one is a no-op, and the C entry
// points take host pointers.
// The CPU tests use that build to hold the kernels' arithmetic against
// their plain PyTorch versions.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

#ifdef FL_EMULATE

#include <vector>

struct fl_dim3 { unsigned x, y, z; };
static thread_local fl_dim3 threadIdx, blockIdx, blockDim, gridDim;
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__
#define __constant__
#define __restrict__ __restrict
static inline void __syncthreads() {}
static inline int __syncthreads_and(int p) { return p; }
static inline int __syncthreads_or(int p) { return p; }
static inline int __any_sync(unsigned, int p) { return p; }
static inline unsigned __ballot_sync(unsigned, int p) { return p ? 1u : 0u; }
static inline unsigned __reduce_min_sync(unsigned, unsigned v) { return v; }
static inline unsigned __reduce_max_sync(unsigned, unsigned v) { return v; }
static inline int atomicAdd(int* p, int v) {
    int old = *p;
    *p += v;
    return old;
}
static inline unsigned atomicMax(unsigned* p, unsigned v) {
    unsigned old = *p;
    if (v > old) *p = v;
    return old;
}
template <typename T> static inline T __shfl_xor_sync(unsigned, T v, int) { return v; }
template <typename T> static inline T __shfl_sync(unsigned, T v, int) { return v; }
static inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
static inline int __popc(unsigned x) { return __builtin_popcount(x); }
static inline unsigned __float_as_uint(float x) {
    unsigned u;
    memcpy(&u, &x, sizeof u);
    return u;
}
static inline float __uint_as_float(unsigned u) {
    float x;
    memcpy(&x, &u, sizeof x);
    return x;
}
#define __launch_bounds__(...)
// the lanes of a warp: a block of one thread is a warp of one lane
#define FL_WARP_LANES 1
struct alignas(16) float4 { float x, y, z, w; };
static inline float4 make_float4(float x, float y, float z, float w) { return float4{x, y, z, w}; }
static inline void fl_cp_async16(float4* dst, const float4* src) { *dst = *src; }
static inline void fl_cp_async_commit() {}
template <int N> static inline void fl_cp_async_wait() {}
#define FL_LAUNCH(kernel, n_items, block, stream, ...)                  \
    do {                                                                 \
        (void)(stream);                                                  \
        gridDim = fl_dim3{(unsigned)(n_items), 1, 1};                    \
        blockDim = fl_dim3{1, 1, 1};                                     \
        threadIdx = fl_dim3{0, 0, 0};                                    \
        for (unsigned b_ = 0; b_ < (unsigned)(n_items); ++b_) {          \
            blockIdx = fl_dim3{b_, 0, 0};                                \
            kernel(__VA_ARGS__);                                         \
        }                                                                \
        return 0;                                                        \
    } while (0)

// One block per unit of work (a ray tile): n_blocks blocks of `block`
// threads on the card, n_blocks blocks of one thread emulated.
#define FL_LAUNCH_BLOCKS(kernel, n_blocks, block, stream, ...)           \
    do {                                                                 \
        (void)(block);                                                   \
        FL_LAUNCH(kernel, n_blocks, 1, stream, __VA_ARGS__);             \
    } while (0)

// The block's dynamic shared memory, `smem` bytes of the launch
// (FL_LAUNCH_BLOCKS_SMEM): one host buffer.
static thread_local std::vector<float4> fl_dyn_smem;
#define FL_DYN_SHARED(type, name) type* name = (type*)fl_dyn_smem.data()
#define FL_LAUNCH_BLOCKS_SMEM(kernel, n_blocks, block, smem, stream, ...) \
    do {                                                                 \
        fl_dyn_smem.assign(((size_t)(smem) + 15) / 16, float4{});        \
        FL_LAUNCH_BLOCKS(kernel, n_blocks, block, stream, __VA_ARGS__);  \
    } while (0)
#define FL_ZERO_ASYNC(ptr, bytes, stream) ((void)(stream), memset((ptr), 0, (bytes)), 0)

#else

#include <cuda_runtime.h>
#define FL_WARP_LANES 32
#define FL_LAUNCH(kernel, n_items, block, stream, ...)                  \
    do {                                                                 \
        unsigned grid_ = (unsigned)(((n_items) + (block) - 1) / (block)); \
        kernel<<<grid_, (block), 0, (cudaStream_t)(stream)>>>(__VA_ARGS__); \
        return (int)cudaGetLastError();                                  \
    } while (0)

#define FL_LAUNCH_BLOCKS(kernel, n_blocks, block, stream, ...)           \
    do {                                                                 \
        kernel<<<(unsigned)(n_blocks), (block), 0, (cudaStream_t)(stream)>>>(__VA_ARGS__); \
        return (int)cudaGetLastError();                                  \
    } while (0)

// FL_LAUNCH_BLOCKS with `smem` bytes of dynamic shared memory, which the
// kernel names with FL_DYN_SHARED (above 48 KB the kernel must first be
// allowed it: cudaFuncSetAttribute).
#define FL_DYN_SHARED(type, name) extern __shared__ type name[]
#define FL_LAUNCH_BLOCKS_SMEM(kernel, n_blocks, block, smem, stream, ...) \
    do {                                                                 \
        kernel<<<(unsigned)(n_blocks), (block), (smem), (cudaStream_t)(stream)>>>(__VA_ARGS__); \
        return (int)cudaGetLastError();                                  \
    } while (0)
// zero `bytes` at device pointer `ptr` on the stream; 0 or the CUDA error
#define FL_ZERO_ASYNC(ptr, bytes, stream) \
    ((int)cudaMemsetAsync((ptr), 0, (bytes), (cudaStream_t)(stream)))

// 16 bytes from device memory to shared memory without the registers
// (cp.async, Ampere and later: both addresses 16-byte aligned); a thread's
// copies since its last commit form one group, and
// fl_cp_async_wait<N>() returns once at most N of its groups are still in
// flight. Other threads see the data after a barrier that follows the wait.
__device__ __forceinline__ void fl_cp_async16(float4* dst, const float4* src) {
    unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void fl_cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void fl_cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

#endif

#define FL_EXPORT extern "C"

// 2^-16, the reference's intersection epsilon (ops/intersect.py BIAS)
#define FL_BIAS 0.0000152587890625f
#define FL_POW32 4294967296.0f
// f32(1/255), the exact reconstruction factor of an rgba8 byte
#define FL_INV_255 ((float)(1.0 / 255.0))
#define FL_INV_256 ((float)(1.0 / 256.0))

// One rgba8 byte of a packed pixel as its quantized float k * f32(1/255).
__device__ __forceinline__ float fl_byte_f(uint32_t p, int i) {
    return (float)((p >> (8 * i)) & 0xFFu) * FL_INV_255;
}

// The rgba8 store: round(clip(v, 0, 1) * 255) as a byte (round half to even).
__device__ __forceinline__ uint32_t fl_quant_byte(float v) {
    v = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
    return (uint32_t)rintf(v * 255.0f);
}

// x mod y with the sign of y (jnp.mod / torch.remainder on floats).
__device__ __forceinline__ float fl_mod(float x, float y) {
    float m = fmodf(x, y);
    if (m != 0.0f && ((m < 0.0f) != (y < 0.0f))) m += y;
    return m;
}

// The persistent grid of a kernel whose blocks stride over their work: as
// many blocks of `block` threads, with `smem` bytes of dynamic shared
// memory each, as the card holds at once, and no more than `most` (one
// block of one thread emulated). Above 48 KB the kernel is first allowed
// its dynamic shared memory, on the current device. The answer is kept per
// kernel type and device (for the last table size asked there: the kernels
// that ask have signatures of their own); the grid size only spreads the
// work, so any size is correct.
#define FL_GRID_DEVICES 64
template <typename K>
static int fl_persistent_grid(K kernel, int block, size_t smem, int most) {
#ifdef FL_EMULATE
    (void)kernel;
    (void)block;
    (void)smem;
    (void)most;
    return 1;
#else
    static std::mutex lock;
    static size_t asked[FL_GRID_DEVICES];  // smem + 1 of the last answer, 0 for none
    static int resident[FL_GRID_DEVICES];
    int dev = 0;
    cudaGetDevice(&dev);
    std::lock_guard<std::mutex> hold(lock);
    bool kept = dev >= 0 && dev < FL_GRID_DEVICES;
    if (!kept || asked[dev] != smem + 1) {
        int sms = 0, per_sm = 0;
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (smem > 48 * 1024)
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block, smem);
        int r = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
        if (!kept) return r < most ? r : most;
        resident[dev] = r;
        asked[dev] = smem + 1;
    }
    return resident[dev] < most ? resident[dev] : most;
#endif
}
