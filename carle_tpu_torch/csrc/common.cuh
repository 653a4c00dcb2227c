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

// A kernel launch.  A macro so that a host build can replace it: compiled as
// plain C++ with a stand-in <cuda_runtime.h> that runs each block with one
// thread, the kernels' index arithmetic can be checked where there is no
// card (tests/cuda_emulation/).
#ifndef KERNEL_LAUNCH
#define KERNEL_LAUNCH(kernel, grid, block, smem, stream, ...) \
    kernel<<<(grid), (block), (smem), (stream)>>>(__VA_ARGS__)
#endif
