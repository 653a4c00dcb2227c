// Shared by every kernel source of carle_tpu_torch.
//
// Each source compiles into its own shared library with a plain C interface
// (ops/cuda_build.py): every launcher selects the tensors' device, launches
// on the caller's stream and returns cudaGetLastError() as an int, which the
// Python wrapper turns into an exception through cuda_error_string().
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Opt a kernel in to more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

// Cells as the kernels read them: a plane of uint8_t cells (one a byte), of
// float values, or of uint32_t words that pack 32 cells along a row (bit j of
// word k is cell 32k + j: ops/bitpack.py's layout, rows a multiple of 32
// cells).  Indices and offsets count cells, whatever the type; a packed word
// is expanded in registers, so no cell plane passes through device memory.
__device__ __forceinline__ float cell_value(const uint8_t* p, size_t i) {
    return static_cast<float>(p[i]);
}
__device__ __forceinline__ float cell_value(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float cell_value(const uint32_t* p, size_t i) {
    return static_cast<float>((p[i >> 5] >> (i & 31)) & 1u);
}
template <typename T>
__device__ __forceinline__ const T* cells_at(const T* p, size_t i) {
    return p + i;
}
__device__ __forceinline__ const uint32_t* cells_at(const uint32_t* p, size_t i) {
    return p + (i >> 5);
}

// Rows [r0, r0 + rows) of a [H, W] plane of cells into xs[rows][W + 2] as
// bytes, with a zero column each side and zero rows outside the plane.
__device__ __forceinline__ void stage_cells(uint8_t* xs, const uint8_t* __restrict__ plane,
                                            int r0, int rows, int H, int W) {
    const int tid = threadIdx.x, nt = blockDim.x;
    const int IW = W + 2;
    for (int i = tid; i < rows * IW; i += nt) {
        const int lr = i / IW, lc = i - lr * IW;
        const int r = r0 + lr, c = lc - 1;
        xs[i] = (r >= 0 && r < H && c >= 0 && c < W)
                    ? plane[static_cast<size_t>(r) * W + c]
                    : 0;
    }
}

// The same from packed words: a thread expands one word into 32 bytes.
__device__ __forceinline__ void stage_cells(uint8_t* xs, const uint32_t* __restrict__ plane,
                                            int r0, int rows, int H, int W) {
    const int tid = threadIdx.x, nt = blockDim.x;
    const int IW = W + 2, NW = W >> 5;
    for (int i = tid; i < rows * NW; i += nt) {
        const int lr = i / NW, k = i - lr * NW;
        const int r = r0 + lr;
        const uint32_t word = (r >= 0 && r < H) ? plane[static_cast<size_t>(r) * NW + k] : 0u;
        uint8_t* dst = xs + lr * IW + 1 + 32 * k;
#pragma unroll
        for (int j = 0; j < 32; ++j) dst[j] = static_cast<uint8_t>((word >> j) & 1u);
    }
    for (int lr = tid; lr < rows; lr += nt) {
        xs[lr * IW] = 0;
        xs[lr * IW + W + 1] = 0;
    }
}

// What a cell pointer argument holds: float values, uint8 cells or packed
// uint32 words (the launchers' `*_kind` arguments).
constexpr int KIND_F32 = 0, KIND_U8 = 1, KIND_U32 = 2;

// Both cell arguments uint8 or packed, and packed rows whole words.
__host__ __device__ inline bool cell_kinds_ok(int a, int b, int W) {
    const bool packed = a == KIND_U32 || b == KIND_U32;
    return (a == KIND_U8 || a == KIND_U32) && (b == KIND_U8 || b == KIND_U32) &&
           !(packed && W % 32);
}

// A kernel launch.  A macro so that a host build can replace it: compiled as
// plain C++ with a stand-in <cuda_runtime.h> that runs each block with one
// thread, the kernels' index arithmetic can be checked where there is no
// card (tests/cuda_emulation/).
#ifndef KERNEL_LAUNCH
#define KERNEL_LAUNCH(kernel, grid, block, smem, stream, ...) \
    kernel<<<(grid), (block), (smem), (stream)>>>(__VA_ARGS__)
#endif
