// Stand-in for <cuda_runtime.h>: compiles the kernels as plain C++ and runs
// every block with ONE thread (blockDim = 1), so __syncthreads() is a no-op
// and the kernels' index arithmetic can be checked where there is no card.
// A kernel whose threads exchange registers (a barrier between generations,
// a lane shuffle) launches through KERNEL_LAUNCH_THREADED: there each block's
// threads run as host threads of their own, __syncthreads() a barrier over
// them and __shfl_sync an exchange through a slot a thread.
#pragma once
#define CUDA_EMULATION 1
#include <algorithm>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <cstddef>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)
#define __grid_constant__

struct dim3 {
    unsigned x, y, z;
    dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
static thread_local dim3 blockIdx, threadIdx(0, 0, 0);
static dim3 blockDim(1, 1, 1), gridDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorPeerAccessAlreadyEnabled = 704 };
enum cudaMemcpyKind { cudaMemcpyDeviceToDevice = 3 };
inline cudaError_t cudaMemcpyAsync(void* dst, const void* src, size_t bytes, cudaMemcpyKind,
                                   cudaStream_t) {
    std::memmove(dst, src, bytes);
    return cudaSuccess;
}
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaDeviceEnablePeerAccess(int, unsigned) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) { return e ? "invalid value" : "ok"; }
template <typename K> cudaError_t cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }
struct cudaFuncAttributes {
    int numRegs;
    size_t sharedSizeBytes, localSizeBytes;
};
template <typename K> cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, K) {
    *a = cudaFuncAttributes{0, 0, 0};
    return cudaSuccess;
}
template <typename K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, K, int, size_t) {
    *blocks = 1;
    return cudaSuccess;
}

struct alignas(16) float4 {
    float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) { return float4{x, y, z, w}; }
struct alignas(16) uint4 {
    unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
    return uint4{x, y, z, w};
}
struct alignas(8) float2 {
    float x, y;
};
inline float2 make_float2(float x, float y) { return float2{x, y}; }
// The barrier of a threaded block (null: one thread a block, nothing to wait for).
struct EmuBarrier {
    explicit EmuBarrier(unsigned n) : count(n) {}
    void wait() {
        std::unique_lock<std::mutex> lock(m);
        const unsigned gen = generation;
        if (++waiting == count) {
            waiting = 0;
            ++generation;
            cv.notify_all();
        } else {
            cv.wait(lock, [&] { return gen != generation; });
        }
    }
    std::mutex m;
    std::condition_variable cv;
    unsigned count, waiting = 0, generation = 0;
};
static thread_local EmuBarrier* emu_barrier = nullptr;
static thread_local uint32_t* emu_lanes = nullptr;  // a slot a thread of the block
inline void __syncthreads() {
    if (emu_barrier) emu_barrier->wait();
}
// Lane src (modulo width) of the caller's width-lane segment of its warp;
// every thread of the block calls it together, as the kernels do.
inline uint32_t __shfl_sync(unsigned, uint32_t v, int src, int width = 32) {
    if (!emu_lanes) return v;
    const unsigned t = threadIdx.x, lane = t % 32;
    emu_lanes[t] = v;
    __syncthreads();
    const uint32_t got = emu_lanes[t - lane % width + static_cast<unsigned>(src) % width];
    __syncthreads();
    return got;
}
// The predicate of each lane of the caller's warp, lane j at bit j; every
// thread of the block calls it together, as the kernels do.
inline unsigned __ballot_sync(unsigned, int pred) {
    if (!emu_lanes) return pred ? 1u : 0u;
    const unsigned t = threadIdx.x, base = t - t % 32;
    emu_lanes[t] = pred ? 1u : 0u;
    __syncthreads();
    unsigned v = 0;
    for (unsigned j = 0; j < 32 && base + j < blockDim.x; ++j) v |= emu_lanes[base + j] << j;
    __syncthreads();
    return v;
}
inline float __shfl_down_sync(unsigned, float, int) { return 0.f; }  // no other lane
inline double __shfl_down_sync(unsigned, double, int) { return 0.0; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(int v) { return __builtin_ffs(v); }
// Blocks run one after another: an atomic is a plain update, a fence nothing.
inline unsigned atomicAdd(unsigned* p, unsigned v) {
    const unsigned old = *p;
    *p = old + v;
    return old;
}
inline void __threadfence() {}
inline float __ldcg(const float* p) { return *p; }
inline cudaError_t cudaMemsetAsync(void* p, int value, size_t bytes, cudaStream_t) {
    std::memset(p, value, bytes);
    return cudaSuccess;
}
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
    return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) >> 32);
}
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, unsigned s) {
    s &= 31;
    return s ? (hi << s) | (lo >> (32 - s)) : hi;
}
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, unsigned s) {
    s &= 31;
    return s ? (lo >> s) | (hi << (32 - s)) : lo;
}
// The Tensor Memory Accelerator's 1-D bulk copy (csrc/ca_step.cu's helpers):
// a copy that has landed by the time the one thread waits.
inline void bulk_barrier_init(uint64_t*) {}
inline void bulk_barrier_expect(uint64_t*, uint32_t) {}
inline void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t*) {
    std::memcpy(dst, src, bytes);
}
inline void bulk_barrier_wait(uint64_t*, uint32_t) {}
using std::min;
using std::max;

alignas(16) float smem[64 * 1024];  // 256 KB of "shared memory"

#define KERNEL_LAUNCH(kernel, grid, block, smem_bytes, stream, ...)          \
    do {                                                                     \
        const dim3 g_ = dim3(grid);                                          \
        gridDim = g_;                                                        \
        if (static_cast<size_t>(smem_bytes) > sizeof(::smem)) return 1;        \
        for (unsigned bz = 0; bz < g_.z; ++bz)                               \
            for (unsigned by = 0; by < g_.y; ++by)                           \
                for (unsigned bx = 0; bx < g_.x; ++bx) {                     \
                    blockIdx = dim3(bx, by, bz);                             \
                    std::memset(::smem, 0xff, smem_bytes); /* NaN poison */    \
                    kernel(__VA_ARGS__);                                     \
                }                                                            \
    } while (0)

// Each block's threads as host threads (1-D blocks), one block after another.
#define KERNEL_LAUNCH_THREADED(kernel, grid, block, smem_bytes, stream, ...) \
    do {                                                                     \
        const dim3 g_ = dim3(grid), b_ = dim3(block);                        \
        if (static_cast<size_t>(smem_bytes) > sizeof(::smem) || b_.y != 1 || b_.z != 1) \
            return 1;                                                        \
        gridDim = g_;                                                        \
        blockDim = b_;                                                       \
        EmuBarrier bar_(b_.x);                                               \
        std::vector<uint32_t> lanes_(b_.x);                                  \
        for (unsigned bz = 0; bz < g_.z; ++bz)                               \
            for (unsigned by = 0; by < g_.y; ++by)                           \
                for (unsigned bx = 0; bx < g_.x; ++bx) {                     \
                    std::memset(::smem, 0xff, smem_bytes); /* NaN poison */    \
                    std::vector<std::thread> threads_;                       \
                    for (unsigned t_ = 0; t_ < b_.x; ++t_)                   \
                        threads_.emplace_back([&, t_] {                      \
                            blockIdx = dim3(bx, by, bz);                     \
                            threadIdx = dim3(t_, 0, 0);                      \
                            emu_barrier = &bar_;                             \
                            emu_lanes = lanes_.data();                       \
                            kernel(__VA_ARGS__);                             \
                        });                                                  \
                    for (auto& th : threads_) th.join();                     \
                }                                                            \
        blockDim = dim3(1, 1, 1);                                            \
    } while (0)
