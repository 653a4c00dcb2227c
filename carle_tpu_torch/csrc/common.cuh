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

// Rows [r0, r0 + rows) and columns [c0, c0 + cols) of a [H, W] plane of
// cells into xs[rows][cols] as bytes, zero outside the plane.  The whole
// width with a zero column each side is c0 = -1, cols = W + 2.
__device__ __forceinline__ void stage_cells(uint8_t* xs, const uint8_t* __restrict__ plane,
                                            int r0, int rows, int c0, int cols, int H, int W) {
    const int tid = threadIdx.x, nt = blockDim.x;
    for (int i = tid; i < rows * cols; i += nt) {
        const int lr = i / cols, lc = i - lr * cols;
        const int r = r0 + lr, c = c0 + lc;
        xs[i] = (r >= 0 && r < H && c >= 0 && c < W)
                    ? plane[static_cast<size_t>(r) * W + c]
                    : 0;
    }
}

// The same from packed words.  The whole width: a thread expands one word
// into 32 bytes.  A column window (a tile of the row, its edges anywhere in
// a word): a thread expands the window's part of one word, the words on
// either side of the plane reading as zero.
__device__ __forceinline__ void stage_cells(uint8_t* xs, const uint32_t* __restrict__ plane,
                                            int r0, int rows, int c0, int cols, int H, int W) {
    const int tid = threadIdx.x, nt = blockDim.x;
    const int NW = W >> 5;
    if (c0 != -1 || cols != W + 2) {
        const int k0 = c0 >> 5, kw = ((c0 + cols - 1) >> 5) - k0 + 1;  // words touched
        for (int i = tid; i < rows * kw; i += nt) {
            const int lr = i / kw, k = k0 + (i - lr * kw);
            const int r = r0 + lr;
            const uint32_t word = (r >= 0 && r < H && k >= 0 && k < NW)
                                      ? plane[static_cast<size_t>(r) * NW + k] : 0u;
            const int j0 = max(c0 - 32 * k, 0), j1 = min(c0 + cols - 32 * k, 32);
            for (int j = j0; j < j1; ++j)
                xs[lr * cols + 32 * k + j - c0] = static_cast<uint8_t>((word >> j) & 1u);
        }
        return;
    }
    const int IW = W + 2;
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

// The whole width: xs[rows][W + 2], a zero column each side.
template <typename T>
__device__ __forceinline__ void stage_cells(uint8_t* xs, const T* __restrict__ plane, int r0,
                                            int rows, int H, int W) {
    stage_cells(xs, plane, r0, rows, -1, W + 2, H, W);
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

// The most blocks a grid's y dimension takes: a launcher with more
// instances than this launches the same grid again for the rest, each block
// adding the first instance of its launch (N0) to blockIdx.y.
constexpr int MAX_GRID_Y = 65535;
static inline int grid_rows(int N, int n0) { return N - n0 < MAX_GRID_Y ? N - n0 : MAX_GRID_Y; }

// The clamped window [max(c0 - h, 0), min(c0 + t + h, n)) as (start, width).
__host__ __device__ inline void clamped_window(int c0, int t, int h, int n, int& start,
                                               int& width) {
    start = c0 - h > 0 ? c0 - h : 0;
    width = (c0 + t + h < n ? c0 + t + h : n) - start;
}

// The widest clamped window over the tiles c0 = 0, t, 2t, ... of [0, n).
__host__ __device__ inline int widest_window(int n, int t, int h) {
    int best = 0;
    for (int c0 = 0; c0 < n; c0 += t) {
        int start, width;
        clamped_window(c0, t < n - c0 ? t : n - c0, h, n, start, width);
        best = width > best ? width : best;
    }
    return best;
}

// A kernel launch.  A macro so that a host build can replace it: compiled as
// plain C++ with a stand-in <cuda_runtime.h> that runs each block with one
// thread, the kernels' index arithmetic can be checked where there is no
// card (tests/cuda_emulation/).
#ifndef KERNEL_LAUNCH
#define KERNEL_LAUNCH(kernel, grid, block, smem, stream, ...) \
    kernel<<<(grid), (block), (smem), (stream)>>>(__VA_ARGS__)
#endif
