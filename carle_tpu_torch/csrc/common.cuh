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
