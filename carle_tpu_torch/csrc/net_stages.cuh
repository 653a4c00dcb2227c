// The wrapper nets' layers as device functions over bands of rows held in
// shared memory, shared by the forward kernels (encoder_fwd.cu,
// ae_loss_fwd.cu, head_fwd.cu, tail.cu, decoder_loss_fwd.cu) and the backward
// kernels, which recompute the forward (encoder_bwd.cuh, decoder_bwd.cuh,
// head_bwd.cu, tail.cu).
//
// A band buffer holds `rows` rows starting at a global row `r0`; rows and
// columns outside the layer's extent hold the zero padding the next layer
// reads.  Sums run bias first, then the taps in (channel, dy, dx) order, as
// the TPU kernels' _conv_block and _deconv_block.  With DROP the
// pre-activation passes through dropout (philox.cuh) before relu or sigmoid;
// without it no random number is drawn and the code is the inference path.
#pragma once

#include "common.cuh"
#include "philox.cuh"

constexpr int MAXC = 8;  // channel bound for the register arrays
#define NEG_INF __int_as_float(static_cast<int>(0xff800000u))

// Dropout stages (the counter's stage field).
constexpr int STAGE_ENC1 = 0, STAGE_ENC2 = 1, STAGE_DEC1 = 2, STAGE_DEC2 = 3;

__device__ __forceinline__ void copy_floats(float* dst, const float* __restrict__ src,
                                            int count) {
    const int tid = threadIdx.x, nt = blockDim.x;
    for (int i = tid; i < count; i += nt) dst[i] = src[i];
}

// Rows [r0, r0 + rows) of C planes [H, W] (floats, cells or packed words)
// into dst[c][rows][W + 2 PAD] as floats, with PAD zero columns each side and
// zero rows outside the planes.
template <typename T, int PAD>
__device__ __forceinline__ void stage_planes(float* dst, const T* __restrict__ planes, int C,
                                             int r0, int rows, int H, int W) {
    const int tid = threadIdx.x, nt = blockDim.x;
    const int SW = W + 2 * PAD, per = rows * SW;
    for (int i = tid; i < C * per; i += nt) {
        const int c = i / per, rem = i - c * per;
        const int lr = rem / SW, lc = rem - lr * SW;
        const int r = r0 + lr, col = lc - PAD;
        dst[i] = (r >= 0 && r < H && col >= 0 && col < W)
                     ? cell_value(planes, (static_cast<size_t>(c) * H + r) * W + col)
                     : 0.f;
    }
}

// Rows [r0, r0 + rows) and columns [c0, c0 + cols) of C float planes [H, W]
// into dst[c][rows][cols], zero outside the planes.
__device__ __forceinline__ void stage_float_window(float* dst, const float* __restrict__ planes,
                                                   int C, int r0, int rows, int c0, int cols,
                                                   int H, int W) {
    const int tid = threadIdx.x, nt = blockDim.x;
    const int per = rows * cols;
    for (int i = tid; i < C * per; i += nt) {
        const int c = i / per, rem = i - c * per;
        const int lr = rem / cols, lc = rem - lr * cols;
        const int r = r0 + lr, col = c0 + lc;
        dst[i] = (r >= 0 && r < H && col >= 0 && col < W)
                     ? planes[(static_cast<size_t>(c) * H + r) * W + col]
                     : 0.f;
    }
}

// The 3x3 neighbourhood of staged cell (local row sr, local column sc).
__device__ __forceinline__ void cell_taps(const uint8_t* xs, int IW, int sr, int sc,
                                          float t[9]) {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) t[dy * 3 + dx] = xs[(sr + dy - 1) * IW + sc + dx - 1];
}

// Encoder stage 1: x1s[c][lr][lc] = maxpool_P(relu(drop(conv3x3(cells) + b1)))
// times the row's validity for XR pooled rows from X0 and XW pooled columns
// from XC0, zero outside the [H1, W1] extent.  xs holds input rows from I0
// and columns from IC0, IW a row (stage_cells).  mask (nullptr: all ones) is
// the instance's stage-1 row validity [H1]: a band of a larger universe
// zeroes the rows outside that universe, which stage 2 must read as its zero
// padding and not as relu(b1) of zero cells.  The whole width is XC0 = -1,
// XW = W1 + 2, IC0 = -1, IW = W + 2.
template <int P, bool DROP>
__device__ __forceinline__ void encoder_stage1_band(
    const uint8_t* xs, int I0, int IC0, int IW, int W, const float* w1s, const float* b1s,
    int C1, float* x1s, int X0, int XR, int XC0, int XW, int H1,
    const float* __restrict__ mask, int n, const DropCfg& cfg) {
    const int tid = threadIdx.x, nt = blockDim.x;
    const int W1 = W / P;
    for (int i = tid; i < XR * XW; i += nt) {
        const int lr = i / XW, lc = i - lr * XW;
        const int gr = X0 + lr, gc = XC0 + lc;
        const bool inside = gr >= 0 && gr < H1 && gc >= 0 && gc < W1;
        float m[MAXC];
#pragma unroll
        for (int c = 0; c < MAXC; ++c) m[c] = NEG_INF;
        if (inside) {
            for (int py = 0; py < P; ++py)
                for (int px = 0; px < P; ++px) {
                    // input pixel (gr*P+py, gc*P+px) and its 3x3 taps in xs
                    float t[9];
                    cell_taps(xs, IW, gr * P + py - I0, gc * P + px - IC0, t);
                    unsigned keep = 0;
                    if (DROP) keep = drop_keep_bits(cfg, STAGE_ENC1, n, C1, gr * P + py, gc * P + px);
#pragma unroll
                    for (int c = 0; c < MAXC; ++c) {
                        if (c < C1) {
                            float z = b1s[c];
#pragma unroll
                            for (int k = 0; k < 9; ++k) z += w1s[c * 9 + k] * t[k];
                            if (DROP) z = drop_apply(z, keep, c, cfg.scale);
                            m[c] = fmaxf(m[c], z);
                        }
                    }
                }
        }
        const float valid = (mask != nullptr && inside) ? mask[gr] : 1.f;
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
            if (c < C1) {
                const float a = inside ? fmaxf(m[c], 0.f) : 0.f;
                x1s[(c * XR + lr) * XW + lc] = mask != nullptr ? a * valid : a;
            }
    }
}

// Stage-2 pre-activations conv3x3(x1, w2) + b2 of every output channel at
// stage-1 position (row sr, column sc, both local to x1s; sc counts the zero
// column).
__device__ __forceinline__ void encoder_stage2_preact(const float* x1s, int XR, int XW,
                                                      int sr, int sc, const float* w2s,
                                                      const float* b2s, int C1, int C2,
                                                      float acc[MAXC]) {
#pragma unroll
    for (int o = 0; o < MAXC; ++o) acc[o] = o < C2 ? b2s[o] : 0.f;
    for (int c = 0; c < C1; ++c) {
        const float* p = x1s + (c * XR + sr) * XW + sc;
        float t[9];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) t[dy * 3 + dx] = p[(dy - 1) * XW + dx - 1];
#pragma unroll
        for (int o = 0; o < MAXC; ++o) {
            if (o < C2) {
                const float* w = w2s + (o * C1 + c) * 9;
#pragma unroll
                for (int k = 0; k < 9; ++k) acc[o] += w[k] * t[k];
            }
        }
    }
}

// Encoder stage 2: out[o * out_cs + lr * out_rs + lc] =
// maxpool_P(relu(drop(conv3x3(x1) + b2))) for ER pooled rows from E0 and EW
// pooled columns from EC0; x1s holds stage-1 columns from XC0.  Rows outside
// [0, He) are zeroed (ZERO_OUTSIDE) or left alone.  The whole width is
// EC0 = 0, EW = We, XC0 = -1.
template <int P, bool DROP, bool ZERO_OUTSIDE>
__device__ __forceinline__ void encoder_stage2_band(
    const float* x1s, int X0, int XR, int XC0, int XW, const float* w2s, const float* b2s,
    int C1, int C2, float* out, size_t out_cs, int out_rs, int E0, int ER, int He,
    int EC0, int EW, int n, const DropCfg& cfg) {
    const int tid = threadIdx.x, nt = blockDim.x;
    for (int i = tid; i < ER * EW; i += nt) {
        const int lr = i / EW, lc = i - lr * EW;
        const int gr = E0 + lr, ec = EC0 + lc;
        const bool inside = gr >= 0 && gr < He;
        if (!inside && !ZERO_OUTSIDE) continue;
        float m[MAXC];
#pragma unroll
        for (int o = 0; o < MAXC; ++o) m[o] = NEG_INF;
        if (inside) {
            for (int py = 0; py < P; ++py)
                for (int px = 0; px < P; ++px) {
                    float acc[MAXC];
                    encoder_stage2_preact(x1s, XR, XW, gr * P + py - X0, ec * P + px - XC0,
                                          w2s, b2s, C1, C2, acc);
                    unsigned keep = 0;
                    if (DROP) keep = drop_keep_bits(cfg, STAGE_ENC2, n, C2, gr * P + py, ec * P + px);
#pragma unroll
                    for (int o = 0; o < MAXC; ++o) {
                        if (DROP) acc[o] = drop_apply(acc[o], keep, o, cfg.scale);
                        m[o] = fmaxf(m[o], acc[o]);
                    }
                }
        }
#pragma unroll
        for (int o = 0; o < MAXC; ++o)
            if (o < C2) out[o * out_cs + lr * out_rs + lc] = inside ? fmaxf(m[o], 0.f) : 0.f;
    }
}

// Transpose convolutions in torch's layout (weights [Cin, Cout, 4, 4], kernel
// 4, stride 2, padding 1): out[o, y, x] = b[o] + sum_c,ky,kx w[c, o, ky, kx]
// in[c, iy, ix] with y = 2 iy - 1 + ky, so each output reads 2 x 2 inputs a
// channel.  `in` holds IR rows from global row I0 and IWD columns from
// global column IC0: the columns of the layer's extent that the caller needs
// (all of them: IC0 = 0, IWD the layer's width), so a column outside it is
// outside the extent and adds nothing.
__device__ __forceinline__ void deconv_preact(const float* in, int I0, int IR, int IC0,
                                              int IWD, const float* wts, const float* bts,
                                              int CIN, int COUTS, int gy, int gx,
                                              float acc[MAXC]) {
#pragma unroll
    for (int o = 0; o < MAXC; ++o) acc[o] = o < COUTS ? bts[o] : 0.f;
    for (int c = 0; c < CIN; ++c)
        for (int ky = 0; ky < 4; ++ky) {
            const int ty = gy + 1 - ky;
            if (ty & 1) continue;
            const int iy = (ty >> 1) - I0;  // local input row
            for (int kx = 0; kx < 4; ++kx) {
                const int tx = gx + 1 - kx;
                if (tx & 1) continue;
                const int ix = (tx >> 1) - IC0;  // local input column
                if (ix < 0 || ix >= IWD) continue;
                const float v = in[(c * IR + iy) * IWD + ix];
#pragma unroll
                for (int o = 0; o < MAXC; ++o)
                    if (o < COUTS) acc[o] += wts[((c * COUTS + o) * 4 + ky) * 4 + kx] * v;
            }
        }
}

// Decoder stage 1: ms[m][lr][lc] = relu(drop(conv_transpose(emb, wt1) + bt1))
// for MR rows from M0 and MW columns from MC0 (inside [0, W1)), zero outside
// [0, H1).  es holds ER embedding rows from E0 (zero outside the embedding's
// extent) and EW columns from EC0 (all of the extent the rows need).
template <bool DROP>
__device__ __forceinline__ void decoder_stage1_band(
    const float* es, int E0, int ER, int EC0, int EW, const float* wt1s, const float* bt1s,
    int C2, int CMID, float* ms, int M0, int MR, int MC0, int MW, int H1, int n,
    const DropCfg& cfg) {
    const int tid = threadIdx.x, nt = blockDim.x;
    for (int i = tid; i < MR * MW; i += nt) {
        const int lr = i / MW, lc = i - lr * MW;
        const int gm = M0 + lr, xm = MC0 + lc;
        const bool inside = gm >= 0 && gm < H1;
        float acc[MAXC];
#pragma unroll
        for (int o = 0; o < MAXC; ++o) acc[o] = 0.f;
        if (inside) {
            deconv_preact(es, E0, ER, EC0, EW, wt1s, bt1s, C2, CMID, gm, xm, acc);
            if (DROP) {
                const unsigned keep = drop_keep_bits(cfg, STAGE_DEC1, n, CMID, gm, xm);
#pragma unroll
                for (int o = 0; o < MAXC; ++o) acc[o] = drop_apply(acc[o], keep, o, cfg.scale);
            }
        }
#pragma unroll
        for (int o = 0; o < MAXC; ++o)
            if (o < CMID) ms[(o * MR + lr) * MW + lc] = inside ? fmaxf(acc[o], 0.f) : 0.f;
    }
}

// Sums of COUNT values a thread over the block, in a fixed order: warp trees,
// then the warps in turn; out[j] receives value j's total.  red needs
// 32 * COUNT floats.  Every thread of the block must call it.
template <int COUNT>
__device__ __forceinline__ void block_sums(const float (&v)[COUNT], float* red,
                                           float* out) {
    const int tid = threadIdx.x, warps = (blockDim.x + 31) / 32;
#pragma unroll
    for (int j = 0; j < COUNT; ++j) {
        float s = v[j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
        if ((tid & 31) == 0) red[(tid >> 5) * COUNT + j] = s;
    }
    __syncthreads();
    for (int j = tid; j < COUNT; j += blockDim.x) {
        float total = 0.f;
        for (int w = 0; w < warps; ++w) total += red[w * COUNT + j];
        out[j] = total;
    }
    __syncthreads();
}

// out[k] = sum over rows of partials[row * K + k], one block a column: each
// thread adds its rows in order, then a tree over the threads; the same
// order every run, so the gradients do not change from run to run.
__global__ void column_sums_kernel(const float* __restrict__ partials, int rows, int K,
                                   float* __restrict__ out) {
    __shared__ float red[128];
    const int k = blockIdx.x, tid = threadIdx.x;
    float s = 0.f;
    for (int r = tid; r < rows; r += blockDim.x) s += partials[static_cast<size_t>(r) * K + k];
    red[tid] = s;
    __syncthreads();
    for (int half = blockDim.x / 2; half > 0; half >>= 1) {
        if (tid < half) red[tid] += red[tid + half];
        __syncthreads();
    }
    if (tid == 0) out[k] = red[0];
}

// out[n] = sum over a row of partials [N, K], in order: the per-instance
// error from its bands' partial sums.
__global__ void row_sums_kernel(const float* __restrict__ partials, int K,
                                float* __restrict__ out, int N) {
    for (int n = blockIdx.x * blockDim.x + threadIdx.x; n < N; n += gridDim.x * blockDim.x) {
        float s = 0.f;
        for (int b = 0; b < K; ++b) s += partials[static_cast<size_t>(n) * K + b];
        out[n] = s;
    }
}

// The input cotangent of a transpose convolution (k4, s2, p1):
// gin[n, c, iy, ix] = sum_m,ky,kx wt[c, m, ky, kx] gout[n, m, 2 iy - 1 + ky,
// 2 ix - 1 + kx], gout [N, CM, HO, WO], gin [N, CI, HO / 2, WO / 2]; one
// thread an element.
__global__ void deconv_input_grad_kernel(const float* __restrict__ gout,
                                         const float* __restrict__ wt,
                                         float* __restrict__ gin, int N, int HO, int WO,
                                         int CI, int CM) {
    const int Hi = HO / 2, Wi = WO / 2;
    const size_t total = static_cast<size_t>(N) * CI * Hi * Wi;
    for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
         i += static_cast<size_t>(gridDim.x) * blockDim.x) {
        const int ix = static_cast<int>(i % Wi);
        const int iy = static_cast<int>((i / Wi) % Hi);
        const int c = static_cast<int>((i / (static_cast<size_t>(Wi) * Hi)) % CI);
        const int n = static_cast<int>(i / (static_cast<size_t>(Wi) * Hi * CI));
        float s = 0.f;
        for (int m = 0; m < CM; ++m) {
            const float* gp = gout + (static_cast<size_t>(n) * CM + m) * HO * WO;
            const float* wp = wt + (c * CM + m) * 16;
            for (int ky = 0; ky < 4; ++ky) {
                const int yr = 2 * iy - 1 + ky;
                if (yr < 0 || yr >= HO) continue;
                for (int kx = 0; kx < 4; ++kx) {
                    const int xc = 2 * ix - 1 + kx;
                    if (xc >= 0 && xc < WO) s += wp[ky * 4 + kx] * gp[static_cast<size_t>(yr) * WO + xc];
                }
            }
        }
        gin[i] = s;
    }
}

// Dropout settings from a probability and a 64-bit seed, as
// ops/cuda_head.py::drop_settings computes them for the plain twin.
static DropCfg make_drop_cfg(double drop_p, unsigned long long seed) {
    DropCfg cfg;
    cfg.key0 = static_cast<uint32_t>(seed & 0xffffffffull);
    cfg.key1 = static_cast<uint32_t>(seed >> 32);
    const double keep = (1.0 - drop_p) * 4294967296.0;
    cfg.keep_below = keep >= 4294967295.0 ? 0xffffffffu : static_cast<uint32_t>(keep);
    cfg.scale = static_cast<float>(1.0 / (1.0 - drop_p));
    return cfg;
}
