// The head's tiles at the package's three stage widths, shared by the
// kernels specialised for them: the forward (head2_fwd.cu) and the backward
// (head2_bwd.cu).  A launch of persistent blocks walks tiles of RB pooled
// rows and TW pooled columns of the universes (tile blockIdx.x, then every
// gridDim.x-th); on cells a tile's input rows are staged as bits
// (bit_table.cuh), on floats as a float tile.
#pragma once

#include "bit_table.cuh"

constexpr int HEAD2_THREADS = 256;

// The universe [H, W] of each instance and a tile: RB pooled rows, TW pooled
// columns (TW >= W / P: the whole width).
struct Head2Shape {
    int N, H, W, RB, TW;
};

// w [O, C, 3, 3], b [O], float32, contiguous.
struct Head2Weights {
    const float *w, *b;
};

// Words a staged bit row needs for TW windows of P cells (bit_table.cuh's
// window_indices reads one word past its last).
__host__ __device__ inline int head2_words(int P, int TW) { return (P * TW + 2 + 62) / 32 + 1; }

// The tiles of a launch.
__device__ __forceinline__ int head2_tiles(const Head2Shape& s, int P) {
    return s.N * ((s.H / P + s.RB - 1) / s.RB) * ((s.W / P + s.TW - 1) / s.TW);
}

// Tile t of the launch: instance n, pooled rows [o0, o0 + R), pooled columns
// [oc0, oc0 + TC).
struct Head2Tile {
    int n, o0, R, oc0, TC;
    __device__ Head2Tile(const Head2Shape& s, int P, int t) {
        const int Ho = s.H / P, Wo = s.W / P;
        const int tiles = (Wo + s.TW - 1) / s.TW, bands = (Ho + s.RB - 1) / s.RB;
        n = t / (bands * tiles);
        const int rest = t - n * bands * tiles;
        const int band = rest / tiles, tile = rest - band * tiles;
        o0 = band * s.RB;
        R = min(s.RB, Ho - o0);
        oc0 = tile * s.TW;
        TC = min(s.TW, Wo - oc0);
    }
};

// Rows [X0, X0 + XR) and columns [XC0, XC0 + XW) of the C float planes x_n
// [C, H, W] into xs[c][XR][XW] by asynchronous copies (net_stages.cuh), zero
// outside the planes; copies_wait() and a __syncthreads() make them visible.
template <int C>
__device__ __forceinline__ void head2_stage_floats(float* xs, const float* __restrict__ x_n,
                                                   int X0, int XR, int XC0, int XW, int H,
                                                   int W) {
    grid_walk(XR, XW, [&](int lr, int lc) {
        const int r = X0 + lr, col = XC0 + lc;
        const bool inside = r >= 0 && r < H && col >= 0 && col < W;
        const size_t at = inside ? static_cast<size_t>(r) * W + col : 0;
#pragma unroll
        for (int c = 0; c < C; ++c)
            copy_async4(xs + (c * XR + lr) * XW + lc, x_n + static_cast<size_t>(c) * H * W + at,
                        inside);
    });
}
