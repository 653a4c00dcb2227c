// The two-stage encoder specialised at compile time for the package's four
// encoder widths (C1, C2, P1, P2):
//
//   (4, 1, 4, 2)  the RND predictor (carle_tpu_torch/mcl/rnd.py)
//   (2, 1, 4, 2)  the frozen RND target
//   (4, 2, 2, 2)  AE2D's encoder (mcl/ae.py; Prediction and Surprise), on the
//                 routes that do not run the whole autoencoder as one kernel
//   (8, 1, 2, 2)  the toggle policy's conv front-end (policy.py, fused_head)
//
// Shared by enc3_fwd.cu (the forward, optionally saving its dropout keep
// bits) and enc3_bwd.cu (the gradients).  They replace the generic kernels
// (encoder_fwd.cu, encoder_bwd.cu) wherever these widths run; other widths
// take the generic ones.  The net is the generic kernels' (encoder_fwd.cu):
//
//   x1  = maxpool_P1(relu(drop(conv3x3(x, w1) + b1))) x mask   [C1, H/P1, W/P1]
//   out = maxpool_2(relu(drop(conv3x3(x1, w2) + b2)))          [C2, H/2P1, W/2P1]
//
// What bounded the generic kernels is instruction issue, not arithmetic:
// runtime widths under MAXC register arrays, a shared load for every
// multiply-add's weight, stage 1 recomputed as 9 C1 multiply-adds a cell by
// the forward and by both backward kernels, cells staged a byte each (which
// forced narrow tiles at width 8192), Philox draws in every pass, an integer
// division an element, and a planner that gave the target one-row blocks of
// 213 KB.  What this design does about each (the AE2D kernels' design,
// ae2d.cuh, carried over):
//
// - Widths are constants, so the stage loops unroll exactly.  Each block
//   copies the four weight tensors (passed as pointers by value) into shared
//   memory; nothing is shared between launches.
// - Stage 1 by table over bit-staged cells (bit_table.cuh): a pixel is one
//   shared load of C1 floats, bit for bit the generic kernel's
//   pre-activation, so the outputs and the pool ties are the generic
//   kernel's.  The rows are staged as whole words of bits, so a tile's input
//   is 8 times smaller than as bytes.
// - A training forward writes every keep bit it draws (Enc3Saved), and the
//   backward reads them: a step draws each bit once.
// - The backward is one band kernel: it recomputes stage 1 by table on its
//   rows and a halo, routes the output cotangent through pool 2 on its own
//   windows and one to either side (so the stage-2 cotangent never crosses
//   device memory), sums its part of dW2 and db2, forms the stage-1
//   cotangent of its own positions and routes it through pool 1 (ties share
//   g / count): a tap is a cell, 0 or 1, so dW1 adds the routed cotangent
//   times the count of tied pixels with the tap set (bit_table.cuh's spread
//   table; 5-bit counts at pool 4, where a blank window ties all 16).  Its
//   partial sums are added in a fixed order by a second launch.
// - Loops walk (row, column) without a division an element (grid_walk).
//
// Tensor cores are not the lever: the layers' depths (K <= 36) and widths
// (N <= 4) would fill an mma tile mostly with zeros, and TF32 would lose the
// twins' 1e-4 agreement, so the kernels stay on float32 FMA.
//
// A block owns R2 output rows and TW output columns of one instance (bands
// of row-tiled universes and the slots of a sharded one are instances; the
// stage-1 row mask [N, H/P1], null for all ones, zeroes their rows outside
// the universe).  ops/cuda_head.py::_enc3_plan picks R2 and TW.
#pragma once

#include "bit_table.cuh"

constexpr int ENC3_THREADS = 256;

// w1 [C1, 1, 3, 3], b1 [C1], w2 [C2, C1, 3, 3], b2 [C2], float32, contiguous.
struct Enc3Weights {
    const float *w1, *b1, *w2, *b2;
};

// The universe [H, W] and a block's share: R2 output rows, TW output columns.
struct Enc3Shape {
    int H, W, R2, TW;
};

// What a training forward saves for its backward (null without dropout):
// keep1 [N, H/P1, W/P1], one word of P1 P1 C1 bits a stage-1 position (bit
// C1 p + c: channel c of pixel p = P1 py + px of its pool window); keep2
// [N, H/2P1, W/2P1] bytes (bit C2 p + o: channel o of stage-2 pixel p).  Each
// bit is philox.cuh's for its element, as the generic kernels draw it.
struct Enc3Saved {
    void* keep1;
    uint8_t* keep2;
};

// Whether (C1, C2, p1, p2) is one of the widths above.
__host__ __device__ inline bool enc3_widths(int C1, int C2, int p1, int p2) {
    return p2 == 2 && ((C1 == 4 && C2 == 1 && p1 == 4) || (C1 == 2 && C2 == 1 && p1 == 4) ||
                       (C1 == 4 && C2 == 2 && p1 == 2) || (C1 == 8 && C2 == 1 && p1 == 2));
}

// An unsigned word of BITS bits (keep1's).
template <int BITS> struct UWord;
template <> struct UWord<16> { using type = uint16_t; };
template <> struct UWord<32> { using type = uint32_t; };
template <> struct UWord<64> { using type = unsigned long long; };

// Words a staged bit row needs for XW stage-1 columns at pool P1: their
// P1 XW + 2 input cells touch at most (P1 XW + 2 + 62) / 32 words, and a
// window's last row_bits reads the word after.
__host__ __device__ inline int enc3_words(int P1, int XW) {
    return (P1 * XW + 2 + 62) / 32 + 1;
}

// Shared memory of the forward for blocks of R2 x TW outputs: the table,
// the stage-1 band (2 R2 + 2 rows, 2 TW + 2 columns) and the bit rows.
__host__ __device__ inline size_t enc3_fwd_smem(int C1, int P1, int R2, int TW) {
    const size_t XR = 2 * R2 + 2, XW = 2 * TW + 2;
    return 4 * (512 * static_cast<size_t>(C1) + C1 * XR * XW) +
           4 * (P1 * XR + 2) * static_cast<size_t>(enc3_words(P1, static_cast<int>(XW)));
}

// Shared memory of the backward: the table, the spread table, the stage-1
// band (2 R2 + 6 rows, 2 TW + 6 columns), the stage-2 cotangent (2 R2 + 4,
// 2 TW + 4), block_sums' scratch for 9 values and the bit rows.
__host__ __device__ inline size_t enc3_bwd_smem(int C1, int C2, int P1, int R2, int TW) {
    const size_t XR = 2 * R2 + 6, XW = 2 * TW + 6, GR = 2 * R2 + 4, GW = 2 * TW + 4;
    return 4 * (512 * static_cast<size_t>(C1) + C1 * XR * XW + C2 * GR * GW + 32 * 9) +
           512 * static_cast<size_t>(P1 == 4 ? 8 : 4) +
           4 * (P1 * XR + 2) * static_cast<size_t>(enc3_words(P1, static_cast<int>(XW)));
}

// Block (band * tiles + tile, n - N0): output rows [o0, o0 + R) and columns
// [oc0, oc0 + TC) of instance n.
struct Enc3Block {
    int H1, W1, Ho, Wo, n, o0, R, oc0, TC;
    __device__ Enc3Block(const Enc3Shape& s, int P1, int N0)
        : H1(s.H / P1), W1(s.W / P1), Ho(s.H / P1 / 2), Wo(s.W / P1 / 2),
          n(N0 + static_cast<int>(blockIdx.y)) {
        const int tiles = (Wo + s.TW - 1) / s.TW;
        const int band = static_cast<int>(blockIdx.x) / tiles;
        const int tile = static_cast<int>(blockIdx.x) - band * tiles;
        o0 = band * s.R2;
        R = min(s.R2, Ho - o0);
        oc0 = tile * s.TW;
        TC = min(s.TW, Wo - oc0);
    }
};

// The block's copy of the weights; every thread calls it, and a
// __syncthreads() follows before the first read.
template <int C1, int C2>
__device__ __forceinline__ void enc3_load_weights(const Enc3Weights& wp, float* w1s, float* b1s,
                                                  float* w2s, float* b2s) {
    copy_floats(w1s, wp.w1, C1 * 9);
    copy_floats(b1s, wp.b1, C1);
    copy_floats(w2s, wp.w2, C2 * C1 * 9);
    copy_floats(b2s, wp.b2, C2);
}

// Stage 1 into x1s [C1][XR][XW] (stage-1 rows from X0, columns from XC0):
// maxpool_P1(relu(drop(table))) times the row mask (maskn: the instance's
// [H1], null for ones), zero outside [H1, W1].  bits holds input rows from
// I0, words from K0.  KEEP_DRAW draws the bits (and SAVE writes those of the
// block's own positions to keep1n, the instance's [H1][W1]); KEEP_READ reads
// them from keep1n.
template <int C1, int P1, int KEEP, bool SAVE>
__device__ __forceinline__ void enc3_stage1(const typename ChanVec<C1>::type* tab,
                                            const uint32_t* bits, int NS, int I0, int K0,
                                            float* x1s, int X0, int XR, int XC0, int XW,
                                            const Enc3Block& b, const float* maskn,
                                            const DropCfg& cfg,
                                            typename UWord<P1 * P1 * C1>::type* keep1n) {
    using Keep1 = typename UWord<P1 * P1 * C1>::type;
    const int own_r0 = 2 * b.o0, own_r1 = 2 * (b.o0 + b.R);
    const int own_c0 = 2 * b.oc0, own_c1 = 2 * (b.oc0 + b.TC);
    grid_walk(XR, XW, [&](int lr, int lc) {
        const int r = X0 + lr, c = XC0 + lc;
        float* out = x1s + lr * XW + lc;
        if (r < 0 || r >= b.H1 || c < 0 || c >= b.W1) {
#pragma unroll
            for (int k = 0; k < C1; ++k) out[k * XR * XW] = 0.f;
            return;
        }
        unsigned idx[P1 * P1];
        window_indices<P1>(bits, NS, I0, K0, r, c, idx);
        const size_t at = static_cast<size_t>(r) * b.W1 + c;
        Keep1 keeps = KEEP == KEEP_READ ? keep1n[at] : static_cast<Keep1>(0);
        float m[C1];
#pragma unroll
        for (int k = 0; k < C1; ++k) m[k] = NEG_INF;
#pragma unroll
        for (int p = 0; p < P1 * P1; ++p) {
            float z[C1];
            channels(tab[idx[p]], z);
            if (KEEP != KEEP_NONE) {
                unsigned keep;
                if (KEEP == KEEP_DRAW) {
                    keep = drop_keep_bits(cfg, STAGE_ENC1, b.n, C1, P1 * r + p / P1,
                                          P1 * c + p % P1) & ((1u << C1) - 1u);
                    keeps |= static_cast<Keep1>(static_cast<Keep1>(keep) << (C1 * p));
                } else {
                    keep = static_cast<unsigned>(keeps >> (C1 * p));
                }
#pragma unroll
                for (int k = 0; k < C1; ++k) z[k] = drop_apply(z[k], keep, k, cfg.scale);
            }
#pragma unroll
            for (int k = 0; k < C1; ++k) m[k] = fmaxf(m[k], z[k]);
        }
        const float valid = maskn != nullptr ? maskn[r] : 1.f;
#pragma unroll
        for (int k = 0; k < C1; ++k) {
            const float a = fmaxf(m[k], 0.f);
            out[k * XR * XW] = maskn != nullptr ? a * valid : a;
        }
        if (SAVE && KEEP == KEEP_DRAW && r >= own_r0 && r < own_r1 && c >= own_c0 &&
            c < own_c1)
            keep1n[at] = keeps;
    });
}
