// The wrapper autoencoder's decoder at the package's one decoder width,
// specialised at compile time: C2 = 2 embedding channels, CMID = 1 middle
// channel, COUT = 1 output (carle_tpu_torch/mcl/ae.py, and Prediction and
// Surprise through init_ae_params).  Shared by the whole-autoencoder kernels
// at AE2D's widths (ae2d_fwd.cu, ae2d_bwd.cu) and the decoder-loss kernels
// at this width (dec2_fwd.cu, dec2_bwd.cu):
//
//   mid = relu(drop(conv_transpose(emb, wt1, k4 s2 p1) + bt1))   [H/2, W/2]
//   y   = sigmoid(drop(conv_transpose(mid, wt2, k4 s2 p1) + bt2)) [H, W]
//
// Transpose convolutions by output parity: output (y, x) uses taps ky in
// {(y + 1) mod 2, (y + 1) mod 2 + 2} and kx likewise, so a thread computes a
// 2 x 2 block of a stage's outputs from a 2 x 2 (or 3 x 3) window of its
// input, the four parity classes as fixed stencils, each sum in the generic
// kernels' order (net_stages.cuh::deconv_preact: bias, then channel, ky, kx
// ascending).  So every middle activation and output pre-activation is the
// generic kernel's bit for bit.  The weights sit in the block's shared memory
// grouped by output parity as float4s: one broadcast load serves a stencil.
//
// Every buffer is a window of its layer: `rows` rows from global row r0 and
// `cols` columns from global column c0, zero outside the layer's extent (a
// column tile's window is cut nowhere: the zero columns past the universe's
// edges are the padding the generic kernel skips, which adds exact zeros).
// Loops walk (row, column) without a division an element (grid_walk).
//
// Dropout keep bits (philox.cuh's layout, the generic kernels' and the
// twins'): a training forward saves them as keepd [N, H/2, W/2] bytes, bit
// 2a + b the output (2i + a, 2j + b), bit 4 the middle position (i, j), and
// the backward reads them, so a training step draws each bit once.
//
// Tensor cores are not the lever: sums of at most 8 terms over at most 2
// channels would leave an mma tile mostly empty, and TF32 would lose the
// twins' 1e-4 agreement, so the kernels stay on float32 FMA.
#pragma once

#include "bit_table.cuh"

// The decoder's weights in the block's shared memory: the taps by output
// parity (u, v) in the order a sum takes them, {(u, v), (u, v + 2), (u + 2,
// v), (u + 2, v + 2)}: dec2_wt1p[c * 4 + u * 2 + v] of wt1[c, 0],
// dec2_wt2p[u * 2 + v] of wt2; dec2_bias = (bt1, bt2).
__shared__ float4 dec2_wt1p[8], dec2_wt2p[4];
__shared__ float dec2_bias[2];

__device__ __forceinline__ float4 parity_taps(const float* w, int u, int v) {
    return make_float4(w[u * 4 + v], w[u * 4 + v + 2], w[(u + 2) * 4 + v], w[(u + 2) * 4 + v + 2]);
}

// Tap (ky, kx) of a transpose convolution's parity table (q: dec2_wt1p + 4 c
// or dec2_wt2p): parity (ky & 1, kx & 1), place (ky >> 1) * 2 + (kx >> 1).
__device__ __forceinline__ float parity_tap(const float4* q, int ky, int kx) {
    const float4 t = q[(ky & 1) * 2 + (kx & 1)];
    const int k = (ky >> 1) * 2 + (kx >> 1);
    return k == 0 ? t.x : k == 1 ? t.y : k == 2 ? t.z : t.w;
}

// Fills the block's copy from wt1 [2, 1, 4, 4], bt1 [1], wt2 [1, 1, 4, 4],
// bt2 [1] in device memory; every thread calls it, and a __syncthreads()
// follows before the first read.
__device__ __forceinline__ void dec2_load_weights(const float* __restrict__ wt1,
                                                  const float* __restrict__ bt1,
                                                  const float* __restrict__ wt2,
                                                  const float* __restrict__ bt2) {
    for (int i = threadIdx.x; i < 14; i += blockDim.x) {
        if (i < 8)
            dec2_wt1p[i] = parity_taps(wt1 + (i >> 2) * 16, (i >> 1) & 1, i & 1);
        else if (i < 12)
            dec2_wt2p[i - 8] = parity_taps(wt2, ((i - 8) >> 1) & 1, (i - 8) & 1);
        else
            dec2_bias[i - 12] = i == 12 ? bt1[0] : bt2[0];
    }
}

// A window of a layer in a block's shared memory: `rows` x `cols` floats a
// channel plane, local (0, 0) at global (r0, c0).
struct Win {
    float* p;
    int r0, c0, rows, cols;
    __device__ float* at(int r, int c) const { return p + (r - r0) * cols + (c - c0); }
};

// The embedding window es (2 channel planes) from instance n's embedding
// emb_n [2, He, We] in device memory, zero outside it.
__device__ __forceinline__ void dec2_stage_emb(const Win& es, const float* __restrict__ emb_n,
                                               int He, int We) {
    grid_walk(2 * es.rows, es.cols, [&](int lr2, int lc) {
        const int c = lr2 >= es.rows ? 1 : 0, lr = lr2 - c * es.rows;
        const int e = es.r0 + lr, f = es.c0 + lc;
        es.p[lr2 * es.cols + lc] = (e >= 0 && e < He && f >= 0 && f < We)
            ? emb_n[(static_cast<size_t>(c) * He + e) * We + f] : 0.f;
    });
}

// The middle stage into ms: relu(drop(conv_transpose(emb, wt1) + bt1)), zero
// outside [H1, W1].  A thread computes the middle positions (2a - 1 + u,
// 2b - 1 + v) of pair (a, b), a in [a0, a0 + na), b in [b0, b0 + nb), which
// read embedding rows a - 1, a and columns b - 1, b of es.  SKIP: a pair
// whose rows miss [m_lo, m_hi) reads as zeros and draws nothing (no output
// the caller computes reads it).  KEEP_DRAW draws the bits, and SAVE writes
// those of the owned positions (rows [own_r0, own_r0 + own_rows), columns
// [own_c0, own_c0 + own_cols)) into kms (own_rows x own_cols bytes, zero
// where skipped); KEEP_READ reads bit 4 of keepd_n (instance n's [H1, W1]).
template <int KEEP, bool SAVE, bool SKIP>
__device__ __forceinline__ void dec2_middle(const Win& es, const Win& ms, int a0, int na, int b0,
                                            int nb, int H1, int W1, int m_lo, int m_hi, int n,
                                            const DropCfg& cfg,
                                            const uint8_t* __restrict__ keepd_n, uint8_t* kms,
                                            int own_r0, int own_rows, int own_c0, int own_cols) {
    const int EP = es.rows * es.cols;
    grid_walk(na, nb, [&](int la, int lb) {
        const int a = a0 + la, b = b0 + lb;
        float* out = ms.at(2 * a - 1, 2 * b - 1);
        if (SKIP && (2 * a < m_lo || 2 * a - 1 >= m_hi)) {
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
                for (int v = 0; v < 2; ++v) {
                    out[u * ms.cols + v] = 0.f;
                    const int m = 2 * a - 1 + u - own_r0, xm = 2 * b - 1 + v - own_c0;
                    if (SAVE && m >= 0 && m < own_rows && xm >= 0 && xm < own_cols)
                        kms[m * own_cols + xm] = 0;
                }
            return;
        }
        const float* e0 = es.at(a - 1, b - 1);
        float E[2][2][2];   // [channel][row a - 1, a][column b - 1, b]
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) E[c][i][j] = e0[c * EP + i * es.cols + j];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int v = 0; v < 2; ++v) {
                const int m = 2 * a - 1 + u, xm = 2 * b - 1 + v;
                float acc = dec2_bias[0];
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const float4 w = dec2_wt1p[c * 4 + u * 2 + v];
                    acc += w.x * E[c][1][1];
                    acc += w.y * E[c][1][0];
                    acc += w.z * E[c][0][1];
                    acc += w.w * E[c][0][0];
                }
                float val = 0.f;
                if (m >= 0 && m < H1 && xm >= 0 && xm < W1) {
                    if (KEEP != KEEP_NONE) {
                        unsigned keep;
                        if (KEEP == KEEP_DRAW) {
                            keep = drop_keep_group(cfg, STAGE_DEC1, n, 0, m, xm) & 1u;
                            const int om = m - own_r0, ox = xm - own_c0;
                            if (SAVE && om >= 0 && om < own_rows && ox >= 0 && ox < own_cols)
                                kms[om * own_cols + ox] = static_cast<uint8_t>(keep);
                        } else {
                            keep = (keepd_n[static_cast<size_t>(m) * W1 + xm] >> 4) & 1u;
                        }
                        acc = keep ? acc * cfg.scale : 0.f;
                    }
                    val = fmaxf(acc, 0.f);
                }
                out[u * ms.cols + v] = val;
            }
    });
}

// The last stage's pre-activation at an output of parity (ky0, kx0) from the
// middle values at (iy0, ix0) and the three before it in row and column:
// m11 = (iy0, ix0), m10 = (iy0, ix0 - 1), m01 = (iy0 - 1, ix0), m00 =
// (iy0 - 1, ix0 - 1); deconv_preact's order.
__device__ __forceinline__ float dec2_preact(int ky0, int kx0, float m11, float m10, float m01,
                                             float m00) {
    const float4 w = dec2_wt2p[ky0 * 2 + kx0];
    float acc = dec2_bias[1];
    acc += w.x * m11;
    acc += w.y * m10;
    acc += w.z * m01;
    acc += w.w * m00;
    return acc;
}

// The forward's last stage and its squared error: a thread the outputs
// (2i + a, 2j + b) of middle position (i, j), i in [i0, i0 + ni), j in
// [j0, j0 + nj), which read middle rows i - 1 .. i + 1 and columns j - 1 ..
// j + 1.  obs_n: instance n's [H, W] cells, packed words or floats; em_n (null:
// all ones) its [H] row weights (d * em * d: a weight of one gives d * d's
// bits).  SKIP: positions with i outside [i_lo, i_hi) are not computed (their
// rows weigh zero).  SAVE (drawing): writes keepd_n [H/2, W/2] of every
// position, the middle bit from kms (ni x nj, the positions' own middle
// bits).  Returns the thread's partial sum, added in ACC (each term a float).
template <typename ACC, bool DROP, bool SAVE, bool SKIP, typename OBS>
__device__ __forceinline__ ACC dec2_error(const Win& ms, int i0, int ni, int j0, int nj,
                                            int i_lo, int i_hi, int H, int W,
                                            const OBS* __restrict__ obs_n,
                                            const float* __restrict__ em_n, int n,
                                            const DropCfg& cfg, uint8_t* __restrict__ keepd_n,
                                            const uint8_t* kms) {
    const int H1 = H / 2, W1 = W / 2;
    ACC part = 0;
    grid_walk(ni, nj, [&](int li, int lj) {
        const int i = i0 + li, j = j0 + lj;
        if (i >= H1) return;
        if (SKIP && (i < i_lo || i >= i_hi)) {
            if (SAVE && DROP)
                keepd_n[static_cast<size_t>(i) * W1 + j] =
                    static_cast<uint8_t>(static_cast<unsigned>(kms[li * nj + lj]) << 4);
            return;
        }
        const float* m0 = ms.at(i - 1, j - 1);
        float M[3][3];
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
            for (int c = 0; c < 3; ++c) M[r][c] = m0[r * ms.cols + c];
        unsigned keep4 = 0;
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int b = 0; b < 2; ++b) {
                const int y = 2 * i + a, x = 2 * j + b;
                // parity: taps (1 - a, 1 - b) and + 2, at middle (i + a, j + b)
                // and the row and column before
                float r = dec2_preact(1 - a, 1 - b, M[1 + a][1 + b], M[1 + a][b], M[a][1 + b],
                                      M[a][b]);
                if (DROP) {
                    const unsigned keep = drop_keep_group(cfg, STAGE_DEC2, n, 0, y, x) & 1u;
                    keep4 |= keep << (2 * a + b);
                    r = keep ? r * cfg.scale : 0.f;
                }
                const float yv = 1.f / (1.f + expf(-r));
                const float dv = cell_value(obs_n, static_cast<size_t>(y) * W + x) - yv;
                if (em_n != nullptr)
                    part += (dv * em_n[y]) * dv;   // a float term either way
                else
                    part += dv * dv;
            }
        if (SAVE && DROP)
            keepd_n[static_cast<size_t>(i) * W1 + j] =
                static_cast<uint8_t>(keep4 | (static_cast<unsigned>(kms[li * nj + lj]) << 4));
    });
    return part;
}

// -- the backward's pieces ---------------------------------------------------------

// The cotangent of the last pre-activation into gys: a thread the outputs
// (2i - 1 + u, 2j - 1 + v), i in [i0, i0 + ni), j in [j0, j0 + nj), which read
// middle rows i - 1, i and columns j - 1, j (parity (u, v): taps u, u + 2 and
// v, v + 2); zero outside [H, W].  g = 2 gbar em (y - obs) y (1 - y) through
// the saved keep bits (keepd_n, instance n's [H/2, W/2]); em_n null: all
// ones.  SKIP: a pair of rows that misses [w_lo, w_hi) (rows that weigh zero)
// is zero without a computation.
template <bool DROP, bool SKIP, typename OBS>
__device__ __forceinline__ void dec2_out_cotangent(const Win& ms, const Win& gys, int i0, int ni,
                                                   int j0, int nj, int w_lo, int w_hi, int H,
                                                   int W, const OBS* __restrict__ obs_n,
                                                   float gb2, const float* __restrict__ em_n,
                                                   const uint8_t* __restrict__ keepd_n,
                                                   const DropCfg& cfg) {
    const int W1 = W / 2;
    grid_walk(ni, nj, [&](int li, int lj) {
        const int i = i0 + li, j = j0 + lj;
        float* g = gys.at(2 * i - 1, 2 * j - 1);
        if (SKIP && (2 * i < w_lo || 2 * i - 1 >= w_hi)) {
            g[0] = g[1] = g[gys.cols] = g[gys.cols + 1] = 0.f;
            return;
        }
        const float* m0 = ms.at(i - 1, j - 1);
        const float m00 = m0[0], m01 = m0[1], m10 = m0[ms.cols], m11 = m0[ms.cols + 1];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int v = 0; v < 2; ++v) {
                const int y = 2 * i - 1 + u, x = 2 * j - 1 + v;
                float gc = 0.f;
                if (y >= 0 && y < H && x >= 0 && x < W) {
                    float r = dec2_preact(u, v, m11, m10, m01, m00);
                    unsigned keep = 1;
                    if (DROP) {
                        keep = (keepd_n[static_cast<size_t>(y >> 1) * W1 + (x >> 1)] >>
                                (2 * (y & 1) + (x & 1))) & 1u;
                        r = keep ? r * cfg.scale : 0.f;
                    }
                    const float yv = 1.f / (1.f + expf(-r));
                    const float t = cell_value(obs_n, static_cast<size_t>(y) * W + x);
                    const float gbe = em_n != nullptr ? gb2 * em_n[y] : gb2;
                    gc = gbe * (yv - t) * yv * (1.f - yv);
                    if (DROP) gc = keep ? gc * cfg.scale : 0.f;
                }
                g[u * gys.cols + v] = gc;
            }
    });
}

// This block's part of dWt2 [1, 1, 4, 4] into out_w[0..16) and of dbt2 into
// out_b, by middle position (the whole autoencoder's order): the middle
// positions [mr0, mr0 + nr) x [mc0, mc0 + nc) times the cotangents of the
// owned output rows [oy0, oy1) they reach, the whole width's columns [ox0,
// ox1) (halo columns lie outside the universe, with a zero cotangent).  red:
// 32 x 16 floats.
__device__ __forceinline__ void dec2_wt2_grad(const Win& ms, const Win& gys, int mr0, int nr,
                                              int mc0, int nc, int oy0, int oy1, int ox0,
                                              int ox1, float* red, float* out_w, float* out_b) {
    float v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = 0.f;
    grid_walk(nr, nc, [&](int lr, int lc) {
        const int iy = mr0 + lr, ix = mc0 + lc;
        const float mv = *ms.at(iy, ix);
        const int ybase = 2 * iy - 1, xbase = 2 * ix - 1;
#pragma unroll
        for (int ky = 0; ky < 4; ++ky) {
            const int yr = ybase + ky;
            if (yr < oy0 || yr >= oy1) continue;
            const float* gp = gys.at(yr, xbase);
#pragma unroll
            for (int kx = 0; kx < 4; ++kx) v[ky * 4 + kx] += mv * gp[kx];
        }
    });
    block_sums<16>(v, red, out_w);
    float bsum[1] = {0.f};
    grid_walk(oy1 - oy0, ox1 - ox0, [&](int lr, int lc) { bsum[0] += *gys.at(oy0 + lr, ox0 + lc); });
    block_sums<1>(bsum, red, out_b);
}

// The middle cotangent into gms (its window's positions), through relu and
// dropout (a positive activation was kept): sum over ky, kx of wt2[ky, kx]
// gys(2 gm - 1 + ky, 2 mx - 1 + kx), the generic kernel's order.  gcm_n
// (not null): instance n's [H1, W1] in device memory also receives each row
// inside the layer.
template <bool DROP>
__device__ __forceinline__ void dec2_mid_cotangent(const Win& ms, const Win& gys, const Win& gms,
                                                   int H1, int W1, float* __restrict__ gcm_n,
                                                   const DropCfg& cfg) {
    grid_walk(gms.rows, gms.cols, [&](int lr, int lc) {
        const int gm = gms.r0 + lr, mx = gms.c0 + lc;
        float g = 0.f;
        if (gm < H1 && *ms.at(gm, mx) > 0.f) {
            float s = 0.f;
#pragma unroll
            for (int ky = 0; ky < 4; ++ky) {
                const float* gp = gys.at(2 * gm - 1 + ky, 2 * mx - 1);
#pragma unroll
                for (int kx = 0; kx < 4; ++kx) s += parity_tap(dec2_wt2p, ky, kx) * gp[kx];
            }
            g = DROP ? s * cfg.scale : s;
        }
        gms.p[lr * gms.cols + lc] = g;
        if (gcm_n != nullptr && gm < H1) gcm_n[static_cast<size_t>(gm) * W1 + mx] = g;
    });
}

// This block's part of dWt1 [2, 1, 4, 4] into out_w[0..32) and of dbt1 into
// out_b, by embedding position (the whole autoencoder's order): the embedding
// positions [er0, er0 + nr) x [ec0, ec0 + nc) of es
// times the middle cotangents (gms) of the owned middle positions [my0, my1)
// x [mx0, mx1) they reach.  red: 32 x 16 floats.
__device__ __forceinline__ void dec2_wt1_grad(const Win& es, const Win& gms, int er0, int nr,
                                              int ec0, int nc, int my0, int my1, int mx0,
                                              int mx1, float* red, float* out_w, float* out_b) {
    const int EP = es.rows * es.cols;
    for (int c = 0; c < 2; ++c) {
        float v[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) v[k] = 0.f;
        grid_walk(nr, nc, [&](int lr, int lc) {
            const int e = er0 + lr, f = ec0 + lc;
            const float ev = es.at(e, f)[c * EP];
            const int mbase = 2 * e - 1, xbase = 2 * f - 1;
#pragma unroll
            for (int ky = 0; ky < 4; ++ky) {
                const int mr = mbase + ky;
                if (mr < my0 || mr >= my1) continue;
#pragma unroll
                for (int kx = 0; kx < 4; ++kx) {
                    const int mc = xbase + kx;
                    if (mc >= mx0 && mc < mx1) v[ky * 4 + kx] += ev * *gms.at(mr, mc);
                }
            }
        });
        block_sums<16>(v, red, out_w + c * 16);
    }
    float bsum[1] = {0.f};
    grid_walk(my1 - my0, mx1 - mx0, [&](int lr, int lc) { bsum[0] += *gms.at(my0 + lr, mx0 + lc); });
    block_sums<1>(bsum, red, out_b);
}

// dWt2 and dbt2 from the output cotangents gys as the last stage's quads see
// them: a thread the outputs (2i - 1 + u, 2j - 1 + v), i in [i0, i0 + ni), j in
// [j0, j0 + nj), each owned output (rows [oy0, oy1), columns [ox0, ox1)) adding
// its cotangent times the four middle values its pre-activation read (parity
// (u, v): taps u, u + 2 and v, v + 2).  out_w[0..16) and out_b receive the
// block's sums; red: 32 x 16 floats.
__device__ __forceinline__ void dec2_wt2_grad_quads(const Win& ms, const Win& gys, int i0,
                                                    int ni, int j0, int nj, int oy0, int oy1,
                                                    int ox0, int ox1, float* red, float* out_w,
                                                    float* out_b) {
    float v[16], db[1] = {0.f};
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = 0.f;
    grid_walk(ni, nj, [&](int li, int lj) {
        const int i = i0 + li, j = j0 + lj;
        const float* m0 = ms.at(i - 1, j - 1);
        const float m00 = m0[0], m01 = m0[1], m10 = m0[ms.cols], m11 = m0[ms.cols + 1];
        const float* g = gys.at(2 * i - 1, 2 * j - 1);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int w = 0; w < 2; ++w) {
                const int y = 2 * i - 1 + u, x = 2 * j - 1 + w;
                if (y < oy0 || y >= oy1 || x < ox0 || x >= ox1) continue;
                const float gc = g[u * gys.cols + w];
                v[u * 4 + w] += gc * m11;
                v[u * 4 + w + 2] += gc * m10;
                v[(u + 2) * 4 + w] += gc * m01;
                v[(u + 2) * 4 + w + 2] += gc * m00;
                db[0] += gc;
            }
    });
    block_sums<16>(v, red, out_w);
    block_sums<1>(db, red, out_b);
}

// dWt1 and dbt1 from the middle cotangents gms as the middle stage's pairs see
// them: a thread the middle positions (2a - 1 + u, 2b - 1 + v), a in [a0, a0 +
// na), b in [b0, b0 + nb), each owned one (rows [my0, my1), columns [mx0,
// mx1)) adding its cotangent times the eight embedding values its
// pre-activation read.  out_w[0..32) and out_b receive the block's sums; red:
// 32 x 16 floats.
__device__ __forceinline__ void dec2_wt1_grad_pairs(const Win& es, const Win& gms, int a0,
                                                    int na, int b0, int nb, int my0, int my1,
                                                    int mx0, int mx1, float* red, float* out_w,
                                                    float* out_b) {
    const int EP = es.rows * es.cols;
    float v[2][16], db[1] = {0.f};
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int k = 0; k < 16; ++k) v[c][k] = 0.f;
    grid_walk(na, nb, [&](int la, int lb) {
        const int a = a0 + la, b = b0 + lb;
        const float* e0 = es.at(a - 1, b - 1);
        float E[2][2][2];   // [channel][row a - 1, a][column b - 1, b]
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) E[c][i][j] = e0[c * EP + i * es.cols + j];
        const float* g = gms.at(2 * a - 1, 2 * b - 1);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int w = 0; w < 2; ++w) {
                const int m = 2 * a - 1 + u, xm = 2 * b - 1 + w;
                if (m < my0 || m >= my1 || xm < mx0 || xm >= mx1) continue;
                const float gm = g[u * gms.cols + w];
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    v[c][u * 4 + w] += gm * E[c][1][1];
                    v[c][u * 4 + w + 2] += gm * E[c][1][0];
                    v[c][(u + 2) * 4 + w] += gm * E[c][0][1];
                    v[c][(u + 2) * 4 + w + 2] += gm * E[c][0][0];
                }
                db[0] += gm;
            }
    });
    block_sums<16>(v[0], red, out_w);
    block_sums<16>(v[1], red, out_w + 16);
    block_sums<1>(db, red, out_b);
}

// -- the decoder-loss kernels' blocks (dec2_fwd.cu, dec2_bwd.cu) ---------------------

constexpr int DEC2_THREADS = 256;
// Resident blocks a multiprocessor each kernel is compiled for (its register
// cap): the forward four, the backward three.
constexpr int DEC2_FWD_BLOCKS = 4, DEC2_BWD_BLOCKS = 3;
constexpr int DEC2_PARTS = 50;   // a block's partial gradients: dWt1 32, dbt1, dWt2 16, dbt2
constexpr int DEC2_ALL = 1 << 29;   // a row bound past every row

// wt1 [2, 1, 4, 4], bt1 [1], wt2 [1, 1, 4, 4], bt2 [1], float32, contiguous.
struct Dec2Weights {
    const float *wt1, *bt1, *wt2, *bt2;
};

// The output [H, W] of each instance and a block's share: RY output rows and
// TX output columns (multiples of 4; TX >= W is one tile of the width).
struct Dec2Shape {
    int H, W, RY, TX;
};

// Block (band * tiles + tile, n - N0): output rows [Y0, Y0 + RY) and columns
// [X0, X0 + TX) of instance n, cut at the output's extent.
struct Dec2Block {
    int n, Y0, X0, RY, TX;
    __device__ Dec2Block(const Dec2Shape& s, int N0) : n(N0 + static_cast<int>(blockIdx.y)) {
        const int T = min(s.TX, s.W);
        const int tiles = (s.W + T - 1) / T;
        const int band = static_cast<int>(blockIdx.x) / tiles;
        const int tile = static_cast<int>(blockIdx.x) - band * tiles;
        Y0 = band * s.RY;
        X0 = tile * T;
        RY = min(s.RY, s.H - Y0);
        TX = min(T, s.W - X0);
    }
};

// [lo, hi): the first and one past the last row in [r0, r1) whose weight
// em_n[row] is not zero (lo = hi = r0 when none is).
__device__ __forceinline__ void weighted_rows(const float* __restrict__ em_n, int r0, int r1,
                                              int& lo, int& hi) {
    lo = r0;
    hi = r0;
    for (int r = r0; r < r1; ++r)
        if (em_n[r] != 0.f) {
            if (hi == r0) lo = r;
            hi = r + 1;
        }
}

// Shared memory of the forward for blocks of RY x TX outputs (T = min(TX,
// W)): the embedding window (2 x (RY/4 + 2) x (T/4 + 2)), the middle window
// ((RY/2 + 2) x (T/2 + 2)) and, saving the keep bits, the own middle
// positions' bits ((RY/2) x (T/2) bytes).
__host__ __device__ inline size_t dec2_fwd_smem(int W, int RY, int TX, bool save_keep) {
    const size_t T = TX < W ? TX : W;
    return 4 * (2 * (RY / 4 + 2) * (T / 4 + 2) + (RY / 2 + 2) * (T / 2 + 2)) +
           (save_keep ? (RY / 2) * (T / 2) : 0);
}

// Shared memory of the backward: the embedding window (two rows and columns
// a side), the middle window (three), the output cotangent (RY + 6) x (T + 6),
// the middle cotangent (RY/2 + 2) x (T/2 + 2) and block_sums' scratch for 16
// values.
__host__ __device__ inline size_t dec2_bwd_smem(int W, int RY, int TX) {
    const size_t T = TX < W ? TX : W;
    return 4 * (2 * (RY / 4 + 4) * (T / 4 + 4) + (RY / 2 + 6) * (T / 2 + 6) +
                (RY + 6) * (T + 6) + (RY / 2 + 2) * (T / 2 + 2) + 32 * 16);
}
