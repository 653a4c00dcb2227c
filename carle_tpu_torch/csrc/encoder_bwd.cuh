// The encoder's backward: two kernels and the sums of their partials, shared
// by encoder_bwd.cu (cotangent g given) and ae_loss_bwd.cu (g is the
// embedding cotangent its decoder backward produced).
//
// Counterpart of carle_tpu/ops/pallas_head.py::_enc_bwd_kernel.  The TPU
// kernel holds a whole tile in VMEM and adds into one SMEM accumulator across
// grid steps that run in order; here blocks run in parallel, so
//
//   1. encoder_bwd_stage2_kernel: a block owns a band of R2 output rows of one
//      universe.  It recomputes stage 1 (with halo) and stage 2 as the
//      forward does, routes g through pool 2 (ties share equally: g / count
//      to every element equal to the window maximum), the relu gate and the
//      dropout mask, writes that cotangent of the stage-2 pre-activation
//      (gc2, stage-1 resolution) to device memory, and sums its part of dW2
//      and db2;
//   2. encoder_bwd_stage1_kernel: a block owns a band of RB stage-1 rows.  It
//      reads gc2 with one halo row, forms the stage-1 cotangent (transpose
//      3x3 convolution with w2), recomputes each stage-1 pool window from the
//      cells, routes through pool 1, relu and dropout, and sums its part of
//      dW1 and db1.  No dx: the input is cells;
//   3. column_sums_kernel adds the blocks' partial sums in a fixed order.
//
// Every position is owned by exactly one block in each kernel, so halo rows
// are recomputed but never added twice.  gc2 crosses device memory between
// the two launches ([N, C2, H/p1, W/p1] floats); fusing the two into one
// band kernel with nested halos is left for later.  Bound: operations (the
// recompute plus the dW and dx convolutions), as the forward.
#pragma once

#include "net_stages.cuh"

constexpr int RED_FLOATS = 32 * 9;  // block_sums scratch for 9 values a thread

// ---------------------------------------------------------------------------
// stage 2 backward
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t enc_bwd2_smem(int W, int C1, int C2, int P1, int P2,
                                                int R2) {
    const int W1 = W / P1, XR = R2 * P2 + 2, IR = XR * P1 + 2;
    const size_t floats = static_cast<size_t>(C1) * 9 + C1 + C2 * C1 * 9 + C2 +
                          static_cast<size_t>(C1) * XR * (W1 + 2) +
                          static_cast<size_t>(C2) * R2 * P2 * W1 + RED_FLOATS;
    return 4 * floats + static_cast<size_t>(IR) * (W + 2);
}

template <typename T, int P1, int P2, bool DROP>
__global__ void encoder_bwd_stage2_kernel(
    const T* __restrict__ x, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ g, float* __restrict__ gc2,
    float* __restrict__ partials, int H, int W, int C1, int C2, int R2, DropCfg cfg) {
    const int H1 = H / P1, W1 = W / P1;
    const int Ho = H1 / P2, Wo = W1 / P2;
    const int n = blockIdx.y;
    const int o0 = blockIdx.x * R2;
    const int xr0 = o0 * P2 - 1, XR = R2 * P2 + 2;
    const int ir0 = xr0 * P1 - 1, IR = XR * P1 + 2;
    const int XW = W1 + 2, GR = R2 * P2;
    const int tid = threadIdx.x, nt = blockDim.x;

    extern __shared__ float smem[];
    float* w1s = smem;
    float* b1s = w1s + C1 * 9;
    float* w2s = b1s + C1;
    float* b2s = w2s + C2 * C1 * 9;
    float* x1s = b2s + C2;                  // C1 x XR x XW
    float* gcs = x1s + C1 * XR * XW;        // C2 x GR x W1: cotangent of z2
    float* red = gcs + C2 * GR * W1;        // RED_FLOATS
    uint8_t* xs = reinterpret_cast<uint8_t*>(red + RED_FLOATS);

    copy_floats(w1s, w1, C1 * 9);
    copy_floats(b1s, b1, C1);
    copy_floats(w2s, w2, C2 * C1 * 9);
    copy_floats(b2s, b2, C2);
    stage_cells(xs, cells_at(x, static_cast<size_t>(n) * H * W), ir0, IR, H, W);
    __syncthreads();
    encoder_stage1_band<P1, DROP>(xs, ir0, W, w1s, b1s, C1, x1s, xr0, XR, H1, n, cfg);
    __syncthreads();

    // route g through pool 2, relu and dropout: one thread a pool window
    const float* gn = g + static_cast<size_t>(n) * C2 * Ho * Wo;
    float* gc2n = gc2 + static_cast<size_t>(n) * C2 * H1 * W1;
    for (int i = tid; i < R2 * Wo; i += nt) {
        const int lr = i / Wo, oc = i - lr * Wo;
        const int orow = o0 + lr;
        if (orow >= Ho) {  // ragged last band: nothing to add from these rows
            for (int o = 0; o < C2; ++o)
                for (int py = 0; py < P2; ++py)
                    for (int px = 0; px < P2; ++px)
                        gcs[(o * GR + lr * P2 + py) * W1 + oc * P2 + px] = 0.f;
            continue;
        }
        // pass 1: window maximum of the activation and how many reach it
        float m[MAXC], cnt[MAXC];
#pragma unroll
        for (int o = 0; o < MAXC; ++o) { m[o] = -1.f; cnt[o] = 0.f; }
        for (int py = 0; py < P2; ++py)
            for (int px = 0; px < P2; ++px) {
                const int y1 = orow * P2 + py, x1 = oc * P2 + px;
                float acc[MAXC];
                encoder_stage2_preact(x1s, XR, XW, y1 - xr0, x1 + 1, w2s, b2s, C1, C2, acc);
                unsigned keep = 0;
                if (DROP) keep = drop_keep_bits(cfg, STAGE_ENC2, n, C2, y1, x1);
#pragma unroll
                for (int o = 0; o < MAXC; ++o) {
                    const float d = DROP ? drop_apply(acc[o], keep, o, cfg.scale) : acc[o];
                    const float a = fmaxf(d, 0.f);
                    if (a > m[o]) { m[o] = a; cnt[o] = 1.f; }
                    else if (a == m[o]) cnt[o] += 1.f;
                }
            }
        float gq[MAXC];
#pragma unroll
        for (int o = 0; o < MAXC; ++o)
            gq[o] = o < C2 ? gn[(static_cast<size_t>(o) * Ho + orow) * Wo + oc] / cnt[o] : 0.f;
        // pass 2: the same pre-activations again, now routed
        for (int py = 0; py < P2; ++py)
            for (int px = 0; px < P2; ++px) {
                const int y1 = orow * P2 + py, x1 = oc * P2 + px;
                float acc[MAXC];
                encoder_stage2_preact(x1s, XR, XW, y1 - xr0, x1 + 1, w2s, b2s, C1, C2, acc);
                unsigned keep = 0;
                if (DROP) keep = drop_keep_bits(cfg, STAGE_ENC2, n, C2, y1, x1);
#pragma unroll
                for (int o = 0; o < MAXC; ++o) {
                    if (o < C2) {
                        const float d = DROP ? drop_apply(acc[o], keep, o, cfg.scale) : acc[o];
                        // d > 0 implies kept, and then the activation is d itself
                        float gc = (d > 0.f && d == m[o]) ? gq[o] : 0.f;
                        if (DROP) gc *= cfg.scale;
                        gcs[(o * GR + lr * P2 + py) * W1 + x1] = gc;
                        gc2n[(static_cast<size_t>(o) * H1 + y1) * W1 + x1] = gc;
                    }
                }
            }
    }
    __syncthreads();

    // this band's part of dW2 [C2, C1, 3, 3] and db2 [C2]
    float* row = partials + (static_cast<size_t>(n) * gridDim.x + blockIdx.x) *
                                (C2 * C1 * 9 + C2);
    for (int o = 0; o < C2; ++o) {
        for (int c = 0; c < C1; ++c) {
            float v[9];
#pragma unroll
            for (int k = 0; k < 9; ++k) v[k] = 0.f;
            for (int i = tid; i < GR * W1; i += nt) {
                const int y = i / W1, xx = i - y * W1;
                const float gc = gcs[(o * GR + y) * W1 + xx];
                const float* p = x1s + (c * XR + y) * XW + xx;  // tap (0, 0) of (y, xx)
#pragma unroll
                for (int dy = 0; dy < 3; ++dy)
#pragma unroll
                    for (int dx = 0; dx < 3; ++dx) v[dy * 3 + dx] += p[dy * XW + dx] * gc;
            }
            block_sums<9>(v, red, row + (o * C1 + c) * 9);
        }
        float bsum[1] = {0.f};
        for (int i = tid; i < GR * W1; i += nt) bsum[0] += gcs[o * GR * W1 + i];
        block_sums<1>(bsum, red, row + C2 * C1 * 9 + o);
    }
}

// ---------------------------------------------------------------------------
// stage 1 backward
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t enc_bwd1_smem(int W, int C1, int C2, int P1, int RB) {
    const int W1 = W / P1;
    const size_t floats = static_cast<size_t>(C1) * 9 + C1 + C2 * C1 * 9 +
                          static_cast<size_t>(C2) * (RB + 2) * (W1 + 2) + RED_FLOATS;
    return 4 * floats + static_cast<size_t>(RB * P1 + 2) * (W + 2);
}

template <typename T, int P1, bool DROP>
__global__ void encoder_bwd_stage1_kernel(
    const T* __restrict__ x, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ gc2, float* __restrict__ partials, int H, int W, int C1,
    int C2, int RB, DropCfg cfg) {
    const int H1 = H / P1, W1 = W / P1;
    const int n = blockIdx.y;
    const int r0 = blockIdx.x * RB;         // first stage-1 row of the band
    const int ir0 = r0 * P1 - 1, IR = RB * P1 + 2, IW = W + 2;
    const int GR = RB + 2, GW = W1 + 2;
    const int tid = threadIdx.x, nt = blockDim.x;

    extern __shared__ float smem[];
    float* w1s = smem;
    float* b1s = w1s + C1 * 9;
    float* w2s = b1s + C1;
    float* g2s = w2s + C2 * C1 * 9;         // C2 x GR x GW, rows from r0 - 1
    float* red = g2s + C2 * GR * GW;
    uint8_t* xs = reinterpret_cast<uint8_t*>(red + RED_FLOATS);

    copy_floats(w1s, w1, C1 * 9);
    copy_floats(b1s, b1, C1);
    copy_floats(w2s, w2, C2 * C1 * 9);
    stage_cells(xs, cells_at(x, static_cast<size_t>(n) * H * W), ir0, IR, H, W);
    const float* gn = gc2 + static_cast<size_t>(n) * C2 * H1 * W1;
    for (int i = tid; i < C2 * GR * GW; i += nt) {
        const int o = i / (GR * GW), rem = i - o * GR * GW;
        const int lr = rem / GW, lc = rem - lr * GW;
        const int gr = r0 - 1 + lr, gc = lc - 1;
        g2s[i] = (gr >= 0 && gr < H1 && gc >= 0 && gc < W1)
                     ? gn[(static_cast<size_t>(o) * H1 + gr) * W1 + gc]
                     : 0.f;
    }
    __syncthreads();

    float* row = partials + (static_cast<size_t>(n) * gridDim.x + blockIdx.x) * (C1 * 9 + C1);
    for (int c0 = 0; c0 < C1; c0 += 4) {    // four channels share one Philox draw
        float accw[4][9], accb[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            accb[k] = 0.f;
#pragma unroll
            for (int j = 0; j < 9; ++j) accw[k][j] = 0.f;
        }
        for (int i = tid; i < RB * W1; i += nt) {
            const int lr = i / W1, xc = i - lr * W1;
            const int gr = r0 + lr;
            if (gr >= H1) continue;
            // cotangent of the pooled stage-1 activation: transpose conv with w2
            float gx[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) gx[k] = 0.f;
            for (int o = 0; o < C2; ++o) {
                const float* p = g2s + (o * GR + lr + 1) * GW + xc + 1;
#pragma unroll
                for (int dy = 0; dy < 3; ++dy)
#pragma unroll
                    for (int dx = 0; dx < 3; ++dx) {
                        const float gv = p[(1 - dy) * GW + (1 - dx)];
#pragma unroll
                        for (int k = 0; k < 4; ++k)
                            if (c0 + k < C1) gx[k] += gv * w2s[(o * C1 + c0 + k) * 9 + dy * 3 + dx];
                    }
            }
            // one pass over the pool window: the running maximum, how many
            // reach it, and the sum of their taps
            float m[4], cnt[4], S[4][9];
#pragma unroll
            for (int k = 0; k < 4; ++k) { m[k] = -1.f; cnt[k] = 0.f; }
            for (int py = 0; py < P1; ++py)
                for (int px = 0; px < P1; ++px) {
                    const int y = gr * P1 + py, xx = xc * P1 + px;
                    float t[9];
                    cell_taps(xs, IW, y - ir0, xx + 1, t);
                    unsigned keep = 0;
                    if (DROP) keep = drop_keep_group(cfg, STAGE_ENC1, n, c0 / 4, y, xx);
#pragma unroll
                    for (int k = 0; k < 4; ++k) {
                        if (c0 + k < C1) {
                            float z = b1s[c0 + k];
#pragma unroll
                            for (int j = 0; j < 9; ++j) z += w1s[(c0 + k) * 9 + j] * t[j];
                            if (DROP) z = drop_apply(z, keep, k, cfg.scale);
                            const float a = fmaxf(z, 0.f);
                            if (a > m[k]) {
                                m[k] = a; cnt[k] = 1.f;
#pragma unroll
                                for (int j = 0; j < 9; ++j) S[k][j] = t[j];
                            } else if (a == m[k]) {
                                cnt[k] += 1.f;
#pragma unroll
                                for (int j = 0; j < 9; ++j) S[k][j] += t[j];
                            }
                        }
                    }
                }
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                if (c0 + k < C1 && m[k] > 0.f) {  // relu gate: a zero maximum passes nothing
                    float coef = gx[k] / cnt[k];
                    if (DROP) coef *= cfg.scale;
                    accb[k] += coef * cnt[k];
#pragma unroll
                    for (int j = 0; j < 9; ++j) accw[k][j] += coef * S[k][j];
                }
            }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            if (c0 + k < C1) {
                block_sums<9>(accw[k], red, row + (c0 + k) * 9);
                float bsum[1] = {accb[k]};
                block_sums<1>(bsum, red, row + C1 * 9 + c0 + k);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct EncBwdArgs {
    const void *x, *w1, *b1, *w2, *b2, *g;
    void *gc2, *part2, *part1, *grads;  // grads: dW1, db1, dW2, db2, flat
    int N, H, W, C1, C2, R2, RB;
    size_t smem2, smem1;
    int x_kind;                         // KIND_U8 cells or KIND_U32 packed words
};

template <typename T, int P1, int P2, bool DROP>
static int encoder_bwd_run_as(const EncBwdArgs& a, const DropCfg& cfg, cudaStream_t s) {
    if (a.smem2 != enc_bwd2_smem(a.W, a.C1, a.C2, P1, P2, a.R2) ||
        a.smem1 != enc_bwd1_smem(a.W, a.C1, a.C2, P1, a.RB))
        return static_cast<int>(cudaErrorInvalidValue);
    const int H1 = a.H / P1, Ho = H1 / P2;
    const int K1 = a.C1 * 9 + a.C1, K2 = a.C2 * a.C1 * 9 + a.C2;
    const int bands2 = (Ho + a.R2 - 1) / a.R2, bands1 = (H1 + a.RB - 1) / a.RB;
    const auto k2 = encoder_bwd_stage2_kernel<T, P1, P2, DROP>;
    const auto k1 = encoder_bwd_stage1_kernel<T, P1, DROP>;
    cudaError_t e = allow_smem(k2, a.smem2);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = allow_smem(k1, a.smem1);
    if (e != cudaSuccess) return static_cast<int>(e);
    KERNEL_LAUNCH(k2, dim3(bands2, a.N), 256, a.smem2, s,
                  static_cast<const T*>(a.x), static_cast<const float*>(a.w1),
                  static_cast<const float*>(a.b1), static_cast<const float*>(a.w2),
                  static_cast<const float*>(a.b2), static_cast<const float*>(a.g),
                  static_cast<float*>(a.gc2), static_cast<float*>(a.part2), a.H, a.W, a.C1,
                  a.C2, a.R2, cfg);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    KERNEL_LAUNCH(k1, dim3(bands1, a.N), 256, a.smem1, s,
                  static_cast<const T*>(a.x), static_cast<const float*>(a.w1),
                  static_cast<const float*>(a.b1), static_cast<const float*>(a.w2),
                  static_cast<const float*>(a.gc2), static_cast<float*>(a.part1), a.H, a.W,
                  a.C1, a.C2, a.RB, cfg);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    float* grads = static_cast<float*>(a.grads);
    KERNEL_LAUNCH(column_sums_kernel, K1, 128, 0, s, static_cast<const float*>(a.part1),
                  bands1 * a.N, K1, grads);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    KERNEL_LAUNCH(column_sums_kernel, K2, 128, 0, s, static_cast<const float*>(a.part2),
                  bands2 * a.N, K2, grads + K1);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int P1, int P2>
static int encoder_bwd_run_drop(const EncBwdArgs& a, double drop_p, const DropCfg& cfg,
                                cudaStream_t s) {
    if (drop_p > 0.0) return encoder_bwd_run_as<T, P1, P2, true>(a, cfg, s);
    return encoder_bwd_run_as<T, P1, P2, false>(a, cfg, s);
}

template <int P1, int P2>
static int encoder_bwd_run_pools(const EncBwdArgs& a, double drop_p, const DropCfg& cfg,
                                 cudaStream_t s) {
    if (a.x_kind == KIND_U32) return encoder_bwd_run_drop<uint32_t, P1, P2>(a, drop_p, cfg, s);
    return encoder_bwd_run_drop<uint8_t, P1, P2>(a, drop_p, cfg, s);
}

static int encoder_bwd_run(const EncBwdArgs& a, int p1, int p2, double drop_p,
                           const DropCfg& cfg, cudaStream_t s) {
    if (a.C1 > MAXC || a.C2 > MAXC || (a.x_kind != KIND_U8 && a.x_kind != KIND_U32) ||
        (a.x_kind == KIND_U32 && a.W % 32))
        return static_cast<int>(cudaErrorInvalidValue);
    if (p1 == 2 && p2 == 2) return encoder_bwd_run_pools<2, 2>(a, drop_p, cfg, s);
    if (p1 == 4 && p2 == 2) return encoder_bwd_run_pools<4, 2>(a, drop_p, cfg, s);
    if (p1 == 2 && p2 == 4) return encoder_bwd_run_pools<2, 4>(a, drop_p, cfg, s);
    if (p1 == 4 && p2 == 4) return encoder_bwd_run_pools<4, 4>(a, drop_p, cfg, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
