// One decoder stage of the wrapper autoencoder at the package's two stage
// widths, specialised at compile time: CIN = 2 or 1 input channels, COUT =
// 1 output (carle_tpu_torch/mcl/ae.py's deconv1, 2 -> 1 relu, and deconv2,
// 1 -> 1 sigmoid, which Prediction and Surprise share through
// init_ae_params).  Shared by the forward (tail2_fwd.cu) and the backward
// (tail2_bwd.cu):
//
//   y = act(drop(conv_transpose(x, wt, k4 s2 p1) + b))    x [CIN, h, w] -> y [2h, 2w]
//
// by parity.cuh's stencils, each pre-activation bit for bit the generic
// kernel's (tail.cu).  A block owns a band of RI input rows and a tile of TJ
// input columns of one instance (its outputs: 2 RI rows, 2 TJ columns) and
// stages the input window its outputs read in shared memory, one row and
// column a side, zero outside the input; its shared memory depends on the
// plan (ops/cuda_stages.py::_tail2_plan), never on the universe's width.
// Loops walk (row, column) without a division an element (grid_walk).
//
// Dropout keep bits (philox.cuh's layout, the generic kernel's and the
// twin's): a training forward saves them as keep [N, h, w] bytes, bit 2a + b
// the output (2i + a, 2j + b), and the backward reads them, so a training
// step draws each bit once.
//
// Windows are staged by asynchronous copies (cp.async): a thread issues all
// of its copies without waiting for any, so a block's staging costs one
// memory latency, not one a copy (a loop of loads and stores waits for each
// load before its store).
#pragma once

#include "parity.cuh"

constexpr int TAIL2_RELU = 0, TAIL2_SIGMOID = 1;   // tail.cu's act codes
constexpr int TAIL2_THREADS = 256;
// Resident blocks a multiprocessor each kernel is compiled for (its register
// cap): at least two blocks of 256 threads at every plan.  The backward at
// two channels holds 24 inputs and 32 weight-gradient sums a thread, which
// spill below 128 registers.
constexpr int TAIL2_FWD_BLOCKS = 4;
constexpr int tail2_bwd_blocks(int CIN) { return CIN == 1 ? 3 : 2; }

// The stage's weights in the block's shared memory: channel c's taps by
// output parity (u, v), tail2_wp[c * 4 + u * 2 + v] (parity.cuh's order),
// and the bias.
__shared__ float4 tail2_wp[8];
__shared__ float tail2_bias;

// -- asynchronous copies into shared memory: a thread issues them and goes on;
// copies_wait() and a __syncthreads() make them visible.  A copy with inside
// false reads nothing (src must still be a valid address) and writes zeros.
// The emulated build (tests/cuda_emulation) copies at once.
#ifndef CUDA_EMULATION
__device__ __forceinline__ void copy_async4(float* dst, const float* src, bool inside) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src),
                 "r"(inside ? 4 : 0) : "memory");
}

// 16 bytes, both addresses 16-byte aligned.
__device__ __forceinline__ void copy_async16(float* dst, const float* src, bool inside) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src),
                 "r"(inside ? 16 : 0) : "memory");
}

__device__ __forceinline__ void copies_wait() { asm volatile("cp.async.wait_all;" ::: "memory"); }
#else
inline void copy_async4(float* dst, const float* src, bool inside) { *dst = inside ? *src : 0.f; }
inline void copy_async16(float* dst, const float* src, bool inside) {
    for (int k = 0; k < 4; ++k) dst[k] = inside ? src[k] : 0.f;
}
inline void copies_wait() {}
#endif

// wt [CIN, 1, 4, 4], b [1], float32, contiguous.
struct Tail2Weights {
    const float *wt, *b;
};

// The input [h, w] of each instance and a block's share: RI input rows and
// TJ input columns (even; TJ >= w is one tile of the width).
struct Tail2Shape {
    int h, w, RI, TJ;
};

// Block (band * tiles + tile, n - N0): input rows [i0, i0 + ri) and columns
// [j0, j0 + tj) of instance n, cut at the input's extent.
struct Tail2Block {
    int n, i0, j0, ri, tj;
    __device__ Tail2Block(const Tail2Shape& s, int N0) : n(N0 + static_cast<int>(blockIdx.y)) {
        const int T = min(s.TJ, s.w);
        const int tiles = (s.w + T - 1) / T;
        const int band = static_cast<int>(blockIdx.x) / tiles;
        const int tile = static_cast<int>(blockIdx.x) - band * tiles;
        i0 = band * s.RI;
        j0 = tile * T;
        ri = min(s.RI, s.h - i0);
        tj = min(T, s.w - j0);
    }
};

// Fills the block's copy of the weights; every thread calls it, and a
// __syncthreads() follows before the first read.
template <int CIN>
__device__ __forceinline__ void tail2_load_weights(const Tail2Weights& wp) {
    for (int i = threadIdx.x; i < 4 * CIN + 1; i += blockDim.x) {
        if (i < 4 * CIN)
            tail2_wp[i] = parity_taps(wp.wt + (i >> 2) * 16, (i >> 1) & 1, i & 1);
        else
            tail2_bias = wp.b[0];
    }
}

// Issues the copies of the input window xs (CIN planes of xs.rows x
// xs.cols) from instance n's input x_n [CIN, h, w], zero outside it.
template <int CIN>
__device__ __forceinline__ void tail2_stage_input(const Win& xs, const float* __restrict__ x_n,
                                                  int h, int w) {
    const int plane = xs.rows * xs.cols;
    grid_walk(xs.rows, xs.cols, [&](int lr, int lc) {
        const int r = xs.r0 + lr, col = xs.c0 + lc;
        const bool inside = r >= 0 && r < h && col >= 0 && col < w;
        const size_t at = inside ? static_cast<size_t>(r) * w + col : 0;
#pragma unroll
        for (int c = 0; c < CIN; ++c)
            copy_async4(xs.p + c * plane + lr * xs.cols + lc,
                        x_n + static_cast<size_t>(c) * h * w + at, inside);
    });
}

template <int ACT>
__device__ __forceinline__ float tail2_act(float r) {
    return ACT == TAIL2_RELU ? fmaxf(r, 0.f) : 1.f / (1.f + expf(-r));
}

// Shared memory of the forward: the input window, (RI + 2) x (TJ + 2) a
// channel (T = min(TJ, w)).
__host__ __device__ inline size_t tail2_fwd_smem(int CIN, int w, int RI, int TJ) {
    const size_t T = TJ < w ? TJ : w;
    return 4 * static_cast<size_t>(CIN) * (RI + 2) * (T + 2);
}

// Shared memory of the backward: g and then the cotangent of the
// pre-activation in its place on (2 RI + 4) x (2 T + 8) outputs, the input
// window (RI + 4) x (T + 6) a channel, the warps' partial sums (16 CIN + 1
// values a warp) and the saved keep bytes, (RI + 2) x (T + 4).
__host__ __device__ inline size_t tail2_bwd_smem(int CIN, int w, int RI, int TJ) {
    const size_t T = TJ < w ? TJ : w;
    return 4 * ((2 * RI + 4) * (2 * T + 8) + static_cast<size_t>(CIN) * (RI + 4) * (T + 6) +
                (TAIL2_THREADS / 32) * (16 * CIN + 1)) +
           (RI + 2) * (T + 4);
}
