// The backward of one decoder stage at the package's two stage widths
// (tail2.cuh), templated on where the cotangent of its activation comes from
// (COT), and shared by the tail's backward (tail2_bwd.cu: g, GradRows) and
// the loss tail's (loss_tail2_bwd.cu: 2 gbar[n] (y - obs), ObsRows).
//
// A block owns RI input rows and TJ input columns (ops/cuda_stages.py::
// _tail2_plan) and a thread the 2 x 4 outputs of an input pair (i, j),
// (i, j + 1), as the forward does:
//
//   1. the block stages, by asynchronous copies, the cotangent's source on
//      the 2 x 4 blocks of its pairs and of one pair and row of pairs a side
//      (g, or float obs, in gz by 16-byte pieces; obs as cells in the
//      policy's tile), the input window those read, and the saved keep bytes;
//   2. a thread recomputes its block's pre-activations and activations by
//      the parity stencils, forms the activation's cotangent (COT::value),
//      gates it by the activation's derivative and the keep bits into the
//      cotangent gz of the pre-activation (in gz's place: the pairs a side
//      are recomputed, never added twice) in the generic kernel's order of
//      operations (tail.cu) and, for its own pairs, adds each output's part
//      of dW and db in registers;
//   3. the warps sum them by halving exchanges (a warp's 16 CIN dW values in
//      16 CIN - 1 shuffles), then the warps in a fixed order, into one
//      partial row a block;
//   4. gx of the own pairs from the 4 x 6 cotangent window they read (three
//      16-byte loads a row): the generic kernel's sum (taps in ky, kx order),
//      so gx is its bits;
//
// and column_sums_kernel adds the partial rows in a fixed order (the same
// bits every run, no atomics).
#pragma once

#include "tail2.cuh"

// Where the policy's tile starts in the backward's shared memory: past
// tail2_bwd_smem, 16-byte aligned.
__host__ __device__ inline size_t tail2_bwd_tile_at(int CIN, int w, int RI, int TJ) {
    return (tail2_bwd_smem(CIN, w, RI, TJ) + 15) / 16 * 16;
}

// Rows [gz.r0, gz.r0 + gz.rows) and columns [gz.c0, gz.c0 + gz.cols) of a
// float plane p_n [H2, W2] into gz by 16-byte copies (columns a multiple of
// 4), zero outside the plane.
__device__ __forceinline__ void tail2_stage_rows16(const Win& gz, const float* __restrict__ p_n,
                                                   int H2, int W2) {
    grid_walk(gz.rows, gz.cols / 4, [&](int lr, int k) {
        const int y = gz.r0 + lr, xo = gz.c0 + 4 * k;
        const bool in = y >= 0 && y < H2 && xo >= 0 && xo < W2;
        copy_async16(gz.p + lr * gz.cols + 4 * k, p_n + (in ? static_cast<size_t>(y) * W2 + xo : 0),
                     in);
    });
}

// The tail's cotangent: g [N, 1, 2h, 2w], staged in gz's place.
struct GradRows {
    const float* __restrict__ g;
    __device__ void stage(const Win& gz, uint8_t*, const Tail2Shape& sh, int n) const {
        tail2_stage_rows16(gz, g + static_cast<size_t>(n) * 4 * sh.h * sh.w, 2 * sh.h, 2 * sh.w);
    }
    __device__ float scale(int) const { return 0.f; }
    // g at output (y, x .. x + 3)
    __device__ void quad(const Win& gz, const uint8_t*, const Tail2Shape&, int y, int x,
                         float (&v)[4]) const {
        const float4 g4 = *reinterpret_cast<const float4*>(gz.at(y, x));
        v[0] = g4.x;
        v[1] = g4.y;
        v[2] = g4.z;
        v[3] = g4.w;
    }
    __device__ float value(float g, float, float) const { return g; }
};

template <int CIN, int ACT, int KEEP, typename COT>
__global__ void __launch_bounds__(TAIL2_THREADS, tail2_bwd_blocks(CIN))
tail2_bwd_kernel(const float* __restrict__ x, Tail2Weights wp, COT cot,
                 const uint8_t* __restrict__ keep, float* __restrict__ gx,
                 float* __restrict__ partials, Tail2Shape sh, int N0, int stage, DropCfg cfg) {
    constexpr bool DROP = KEEP != KEEP_NONE;
    constexpr int KW = 16 * CIN, K = KW + 1;   // dW, then db
    const Tail2Block bk(sh, N0);
    const int h = sh.h, w = sh.w, H2 = 2 * h, W2 = 2 * w, n = bk.n;
    const int i0 = bk.i0, j0 = bk.j0, ri = bk.ri, tj = bk.tj;

    // gz: the pre-activation's cotangent (staged there first: g, or float
    // obs) on the 2 x 4 output blocks of the pairs (i, j), i in [i0 - 1, i0 +
    // ri], j in {j0 - 2, j0, .., j0 + tj}: rows 2 i0 - 2 .., columns 2 j0 - 4 ..
    extern __shared__ float smem[];
    const Win gz{smem, 2 * i0 - 2, 2 * j0 - 4, 2 * ri + 4, 2 * tj + 8};
    // the input those blocks read: rows i0 - 2 .. i0 + ri + 1, columns j0 - 3 ..
    const Win xs{gz.p + gz.rows * gz.cols, i0 - 2, j0 - 3, ri + 4, tj + 6};
    float* red = xs.p + CIN * xs.rows * xs.cols;   // (TAIL2_THREADS / 32) x K
    // the keep bytes of the pairs' inputs: rows i0 - 1 .., columns j0 - 2 ..
    uint8_t* ks = reinterpret_cast<uint8_t*>(red + (TAIL2_THREADS / 32) * K);
    const int KR = ri + 2, KC = tj + 4;
    // the policy's own tile (obs as cells), past the backward's shared memory
    uint8_t* tile = reinterpret_cast<uint8_t*>(smem) + tail2_bwd_tile_at(CIN, w, sh.RI, sh.TJ);

    cot.stage(gz, tile, sh, n);
    tail2_stage_input<CIN>(xs, x + static_cast<size_t>(n) * CIN * h * w, h, w);
    tail2_load_weights<CIN>(wp);
    if (KEEP == KEEP_READ) {   // byte pairs, four loads a thread in flight before their stores
        const uint16_t* keep_n = reinterpret_cast<const uint16_t*>(keep + static_cast<size_t>(n) * h * w);
        uint16_t* ks2 = reinterpret_cast<uint16_t*>(ks);
        const int cols = KC / 2, total = KR * cols, nt = blockDim.x;
        for (int e0 = threadIdx.x; e0 < total; e0 += 4 * nt) {
            uint16_t v[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int e = e0 + k * nt, lr = e / cols, lc = e - lr * cols;
                const int r = i0 - 1 + lr, c = j0 - 2 + 2 * lc;
                v[k] = (e < total && r >= 0 && r < h && c >= 0 && c < w)
                    ? keep_n[(static_cast<size_t>(r) * w + c) / 2] : 0;
            }
#pragma unroll
            for (int k = 0; k < 4; ++k)
                if (e0 + k * nt < total) ks2[e0 + k * nt] = v[k];
        }
    }
    copies_wait();
    __syncthreads();

    const int plane = xs.rows * xs.cols;
    const float gs = cot.scale(n);
    float dw[KW], db = 0.f;
#pragma unroll
    for (int k = 0; k < KW; ++k) dw[k] = 0.f;
    grid_walk(ri + 2, tj / 2 + 2, [&](int li, int lp) {
        const int i = i0 - 1 + li, j = j0 - 2 + 2 * lp;
        const bool own = li >= 1 && li <= ri && lp >= 1 && lp <= tj / 2;
        // X[c][r][q]: input (i - 1 + r, j - 1 + q)
        float X[CIN][3][4];
        const float* p = xs.at(i - 1, j - 1);
#pragma unroll
        for (int c = 0; c < CIN; ++c)
#pragma unroll
            for (int r = 0; r < 3; ++r) {
                const float2 lo = *reinterpret_cast<const float2*>(p + c * plane + r * xs.cols);
                const float2 hi = *reinterpret_cast<const float2*>(p + c * plane + r * xs.cols + 2);
                X[c][r][0] = lo.x;
                X[c][r][1] = lo.y;
                X[c][r][2] = hi.x;
                X[c][r][3] = hi.y;
            }
        unsigned bits = 0;   // byte t: input (i, j + t), bit 2a + b
        if (KEEP == KEEP_READ)
            bits = *reinterpret_cast<const uint16_t*>(ks + li * KC + 2 * lp);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
            const int y = 2 * i + a;
            float4* gp = reinterpret_cast<float4*>(gz.at(y, 2 * j));
            float gv[4];   // g, or obs
            cot.quad(gz, tile, sh, y, 2 * j, gv);
            float gc[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                // output (2i + a, 2j + q): parity (1 - a, 1 - b), its window
                // ending at input (i + a, j + t + b)
                const int t = q >> 1, b = q & 1, e = t + b, xo = 2 * j + q;
                float r = tail2_bias;
#pragma unroll
                for (int c = 0; c < CIN; ++c)
                    r = parity_preact(tail2_wp[c * 4 + (1 - a) * 2 + (1 - b)], r,
                                      X[c][a + 1][e + 1], X[c][a + 1][e], X[c][a][e + 1],
                                      X[c][a][e]);
                unsigned k = 1;
                if (KEEP == KEEP_READ)
                    k = (bits >> (8 * t + 2 * a + b)) & 1u;
                else if (KEEP == KEEP_DRAW)
                    k = drop_keep_group(cfg, stage, n, 0, y, xo) & 1u;
                if (DROP) r = k ? r * cfg.scale : 0.f;
                const float yv = tail2_act<ACT>(r);
                const float gy = cot.value(gv[q], yv, gs);   // the activation's cotangent
                float c_ = ACT == TAIL2_RELU ? (r > 0.f ? gy : 0.f) : gy * yv * (1.f - yv);
                if (DROP) c_ = k ? c_ * cfg.scale : 0.f;
                // zero outside the output
                gc[q] = y >= 0 && y < H2 && xo >= 0 && xo < W2 ? c_ : 0.f;
                if (own) {
#pragma unroll
                    for (int c = 0; c < CIN; ++c)
                        parity_wgrad(dw + 16 * c, 1 - a, 1 - b, gc[q], X[c][a + 1][e + 1],
                                     X[c][a + 1][e], X[c][a][e + 1], X[c][a][e]);
                    db += gc[q];
                }
            }
            *gp = make_float4(gc[0], gc[1], gc[2], gc[3]);
        }
    });

    // the block's partial row: warps, then the warps in turn
    float* row = partials + (static_cast<size_t>(n) * gridDim.x + blockIdx.x) * K;
#ifdef CUDA_EMULATION
    for (int k = 0; k < KW; ++k) red[k] = dw[k];   // one lane a block
    red[KW] = db;
#else
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float total = warp_sums<KW>(dw, lane);
    if (lane % (32 / KW) == 0) red[warp * K + lane / (32 / KW)] = total;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) db += __shfl_xor_sync(0xffffffffu, db, o);
    if (lane == 0) red[warp * K + KW] = db;
#endif
    __syncthreads();   // also between gz's writes and its reads below
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
        float sum = 0.f;
        for (int v = 0; v < (blockDim.x + 31) / 32; ++v) sum += red[v * K + k];
        row[k] = sum;
    }

    // gx of the own pairs: gz rows 2i - 1 .. 2i + 2, columns 2j - 1 .. 2j + 4
    float* gx_n = gx + static_cast<size_t>(n) * CIN * h * w;
    grid_walk(ri, tj / 2, [&](int li, int lp) {
        const int i = i0 + li, j = j0 + 2 * lp;
        float G[4][6];
#pragma unroll
        for (int ky = 0; ky < 4; ++ky) {
            const float4* q = reinterpret_cast<const float4*>(gz.at(2 * i - 1 + ky, 2 * j - 4));
            const float4 l4 = q[0], m4 = q[1], r4 = q[2];
            G[ky][0] = l4.w;
            G[ky][1] = m4.x;
            G[ky][2] = m4.y;
            G[ky][3] = m4.z;
            G[ky][4] = m4.w;
            G[ky][5] = r4.x;
        }
#pragma unroll
        for (int c = 0; c < CIN; ++c) {
            float s0 = 0.f, s1 = 0.f;
#pragma unroll
            for (int ky = 0; ky < 4; ++ky)
#pragma unroll
                for (int kx = 0; kx < 4; ++kx) {
                    const float wk = parity_tap(tail2_wp + 4 * c, ky, kx);
                    s0 += wk * G[ky][kx];
                    s1 += wk * G[ky][kx + 2];
                }
            *reinterpret_cast<float2*>(gx_n + (static_cast<size_t>(c) * h + i) * w + j) =
                make_float2(s0, s1);
        }
    });
}
