// enc3_bwd: the gradients of the encoder at the package's four encoder
// widths, specialised at compile time (enc3.cuh has the widths and
// the design).
//
// Replaces carle_tpu/ops/pallas_head.py::make_fused_encoder's backward kernel
// _enc_bwd_kernel (with its stage-1 row mask) at those widths; encoder_bwd.cu
// stays the generic instantiation (and encoder_bwd.cuh the encoder half of
// the generic whole-autoencoder backward).  From the cells x, the four
// parameters, the cotangent g of the pooled output and, with dropout, the
// keep bits the training forward saved (enc3_fwd.cu with SAVE), it gives dW1
// [C1, 1, 3, 3], db1, dW2 [C2, C1, 3, 3] and db2.  No random number is drawn
// here; ops/cuda_head.py runs the saving forward first when a caller asks for
// the gradients alone.
//
// Bound on an H100: operations: stage 2 recomputed (9 C1 C2 multiply-adds a
// stage-1 pixel), dW2 and the stage-1 cotangent (9 C1 C2 each a stage-1
// position), and dW1 from counts of set taps (9 C1 a stage-1 position); stage
// 1 is a table lookup.  The generic backward recomputed stage 1 in both of
// its band kernels, each with its own halo and its own Philox draws, and
// passed the stage-2 cotangent through device memory; here
//
//   1. enc3_bwd_kernel: a block owns R2 output rows and TW output columns.
//      It recomputes stage 1 by table on stage-1 rows 2 o0 - 3 .. 2 (o0 + R2)
//      + 2 (columns likewise), routes g through pool 2 (ties share g / count
//      to every element equal to the window's maximum), relu and dropout on
//      its own windows and one to either side, sums its part of dW2 and db2
//      over its own stage-1 positions, forms their stage-1 cotangent
//      (transpose 3x3 with w2, times the row mask) and routes it through pool
//      1, relu and dropout into its part of dW1 and db1;
//   2. column_sums_kernel adds the blocks' partial rows in a fixed order.
//
// Every pre-activation is summed in the generic order, so the activations,
// the pool ties and the routed cotangents are the generic kernels'; only the
// weight-gradient sums run in another order.
#include "enc3.cuh"

// Registers capped for two blocks a multiprocessor at the RND predictor's
// and the policy's widths (128) and three at the others' (80).  On an H100
// (probes): left to the compiler with a bound of one block, it took 236 and
// 158 registers (one block) and ran 1.3-1.4x slower; AE2D's widths at 80
// registers (from 128) ran 13% faster from the saved bits at 64 x 256²; the
// predictor's at 80 spilled 112 bytes, faster on the 8192² bands and slower
// at 256².
template <int C1, int C2, int P1, bool DROP, typename SRC>
__global__ void __launch_bounds__(ENC3_THREADS, (C1 == 4 && C2 == 1) || C1 == 8 ? 2 : 3)
enc3_bwd_kernel(const SRC* __restrict__ x, Enc3Weights wp, const float* __restrict__ mask,
                const float* __restrict__ g, Enc3Saved sv, float* __restrict__ partials,
                Enc3Shape sh, int N0, DropCfg cfg) {
    constexpr int KEEP = DROP ? KEEP_READ : KEEP_NONE;
    constexpr int K = C1 * 9 + C1 + C2 * C1 * 9 + C2;   // a partial row: dW1, db1, dW2, db2
    using Vec = typename ChanVec<C1>::type;
    using Keep1 = typename UWord<P1 * P1 * C1>::type;
    using SpreadT = typename Spread<P1>::type;
    __shared__ float w1s[C1 * 9], b1s[C1], w2s[C2 * C1 * 9], b2s[C2];
    const Enc3Block b(sh, P1, N0);
    // stage-1 rows 2 o0 - 3 .. 2 (o0 + R) + 2; the stage-2 cotangent on rows
    // 2 o0 - 2 .. 2 (o0 + R) + 1 (the windows of outputs o0 - 1 .. o0 + R);
    // columns likewise
    const int X0 = 2 * b.o0 - 3, XR = 2 * b.R + 6, XC0 = 2 * b.oc0 - 3, XW = 2 * b.TC + 6;
    const int GR = 2 * b.R + 4, GW = 2 * b.TC + 4;
    const int I0 = P1 * X0 - 1, IR = P1 * XR + 2;
    const int K0 = (P1 * XC0 - 1) >> 5, NS = enc3_words(P1, XW);
    const int Ho = b.Ho, Wo = b.Wo;

    extern __shared__ float smem[];
    Vec* tab = reinterpret_cast<Vec*>(smem);                          // 512
    SpreadT* spread = reinterpret_cast<SpreadT*>(smem + 512 * C1);    // 512
    float* x1s = reinterpret_cast<float*>(spread + 512);              // C1 x XR x XW
    float* g2s = x1s + C1 * XR * XW;                                  // C2 x GR x GW
    float* red = g2s + C2 * GR * GW;                                  // 32 x 9
    uint32_t* bits = reinterpret_cast<uint32_t*>(red + 32 * 9);       // IR x NS

    enc3_load_weights<C1, C2>(wp, w1s, b1s, w2s, b2s);
    __syncthreads();
    build_table<C1>(tab, w1s, b1s);
    build_spread<P1>(spread);
    stage_bits(bits, cells_at(x, static_cast<size_t>(b.n) * sh.H * sh.W), I0, IR, K0, NS, sh.H,
               sh.W);
    __syncthreads();
    Keep1* keep1n = DROP ? static_cast<Keep1*>(sv.keep1) + static_cast<size_t>(b.n) * b.H1 * b.W1
                         : nullptr;
    const float* maskn = mask != nullptr ? mask + static_cast<size_t>(b.n) * b.H1 : nullptr;
    enc3_stage1<C1, P1, KEEP, false>(tab, bits, NS, I0, K0, x1s, X0, XR, XC0, XW, b, maskn, cfg,
                                     keep1n);
    __syncthreads();

    // route g through pool 2, relu and dropout (encoder_bwd.cuh's kernel 1):
    // one thread a window of output (e, f), whose pixels sit at local row
    // 2 (e - o0 + 1) of g2s and whose taps start there in x1s
    const float* gn = g + static_cast<size_t>(b.n) * C2 * Ho * Wo;
    grid_walk(b.R + 2, b.TC + 2, [&](int le, int lf) {
        const int e = b.o0 - 1 + le, f = b.oc0 - 1 + lf;
        float* out = g2s + 2 * le * GW + 2 * lf;
        if (e < 0 || e >= Ho || f < 0 || f >= Wo) {
#pragma unroll
            for (int o = 0; o < C2; ++o) {
                float* q = out + o * GR * GW;
                q[0] = q[1] = q[GW] = q[GW + 1] = 0.f;
            }
            return;
        }
        float acc[4][C2];
        stage2_window<C1, C2>(x1s, XR, XW, 2 * le, 2 * lf, w2s, b2s, acc);
        const unsigned keep8 =
            DROP ? sv.keep2[(static_cast<size_t>(b.n) * Ho + e) * Wo + f] : 0u;
        float m[C2], cnt[C2];
#pragma unroll
        for (int o = 0; o < C2; ++o) { m[o] = -1.f; cnt[o] = 0.f; }
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int o = 0; o < C2; ++o) {
                if (DROP) acc[p][o] = drop_apply(acc[p][o], keep8 >> (C2 * p), o, cfg.scale);
                const float a = fmaxf(acc[p][o], 0.f);
                if (a > m[o]) { m[o] = a; cnt[o] = 1.f; }
                else if (a == m[o]) cnt[o] += 1.f;
            }
#pragma unroll
        for (int o = 0; o < C2; ++o) {
            const float gq = gn[(static_cast<size_t>(o) * Ho + e) * Wo + f] / cnt[o];
#pragma unroll
            for (int p = 0; p < 4; ++p) {
                // d > 0 implies kept, and then the activation is d itself
                const float dv = acc[p][o];
                float gc = (dv > 0.f && dv == m[o]) ? gq : 0.f;
                if (DROP) gc *= cfg.scale;
                out[o * GR * GW + (p >> 1) * GW + (p & 1)] = gc;
            }
        }
    });
    __syncthreads();

    // own stage-1 positions (2 o0 + ly, 2 oc0 + lx): g2s (ly + 2, lx + 2); tap
    // (0, 0) of their 3x3 neighbourhood in x1s also at (ly + 2, lx + 2)
    float* row = partials + (static_cast<size_t>(b.n) * gridDim.x + blockIdx.x) * K;
    const int OR = 2 * b.R, OW = 2 * b.TC;

    // this block's part of dW2 [C2, C1, 3, 3] and db2
#pragma unroll 1
    for (int c = 0; c < C1; ++c) {
        float v[C2][9];
#pragma unroll
        for (int o = 0; o < C2; ++o)
#pragma unroll
            for (int k = 0; k < 9; ++k) v[o][k] = 0.f;
        grid_walk(OR, OW, [&](int ly, int lx) {
            float gv[C2];
#pragma unroll
            for (int o = 0; o < C2; ++o) gv[o] = g2s[(o * GR + ly + 2) * GW + lx + 2];
            const float* p = x1s + (c * XR + ly + 2) * XW + lx + 2;
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
#pragma unroll
                for (int dx = 0; dx < 3; ++dx) {
                    const float t = p[dy * XW + dx];
#pragma unroll
                    for (int o = 0; o < C2; ++o) v[o][dy * 3 + dx] += t * gv[o];
                }
        });
#pragma unroll
        for (int o = 0; o < C2; ++o) block_sums<9>(v[o], red, row + C1 * 10 + (o * C1 + c) * 9);
    }
#pragma unroll
    for (int o = 0; o < C2; ++o) {
        float bsum[1] = {0.f};
        grid_walk(OR, OW, [&](int ly, int lx) { bsum[0] += g2s[(o * GR + ly + 2) * GW + lx + 2]; });
        block_sums<1>(bsum, red, row + C1 * 10 + C2 * C1 * 9 + o);
    }

    // the stage-1 cotangent of the own positions (transpose 3x3 with w2),
    // routed through pool 1, relu and dropout: dW1 and db1.  The policy's
    // eight channels take two passes of four (its accumulators at once would
    // spill); the other widths keep one pass of all their channels (written
    // as the passes' loop, the predictor's backward with dropout spilled 8
    // bytes on an H100).
    if constexpr (C1 <= 4) {
        float accw[C1][9], accb[C1];
#pragma unroll
        for (int k = 0; k < C1; ++k) {
            accb[k] = 0.f;
#pragma unroll
            for (int j = 0; j < 9; ++j) accw[k][j] = 0.f;
        }
        grid_walk(OR, OW, [&](int ly, int lx) {
            const int r = 2 * b.o0 + ly, c = 2 * b.oc0 + lx;
            float gx[C1];
#pragma unroll
            for (int k = 0; k < C1; ++k) gx[k] = 0.f;
#pragma unroll
            for (int o = 0; o < C2; ++o) {
                const float* p = g2s + (o * GR + ly + 2) * GW + lx + 2;   // (r, c)
#pragma unroll
                for (int dy = 0; dy < 3; ++dy)
#pragma unroll
                    for (int dx = 0; dx < 3; ++dx) {
                        const float gv = p[(1 - dy) * GW + (1 - dx)];
#pragma unroll
                        for (int k = 0; k < C1; ++k)
                            gx[k] += gv * w2s[(o * C1 + k) * 9 + dy * 3 + dx];
                    }
            }
            if (maskn != nullptr) {   // no gradient through a zeroed row
                const float valid = maskn[r];
#pragma unroll
                for (int k = 0; k < C1; ++k) gx[k] *= valid;
            }
            unsigned idx[P1 * P1];
            window_indices<P1>(bits, NS, I0, K0, r, c, idx);
            const Keep1 keeps =
                DROP ? keep1n[static_cast<size_t>(r) * b.W1 + c] : static_cast<Keep1>(0);
            // the window's maximum, how many reach it, and the taps of those
            // that do, added as counts (bit_table.cuh::build_spread)
            float m[C1], cnt[C1];
            SpreadT taps[C1];
#pragma unroll
            for (int k = 0; k < C1; ++k) { m[k] = -1.f; cnt[k] = 0.f; taps[k] = 0; }
#pragma unroll
            for (int p = 0; p < P1 * P1; ++p) {
                float z[C1];
                channels(tab[idx[p]], z);
                const SpreadT sp = spread[idx[p]];
                const unsigned keep = DROP ? static_cast<unsigned>(keeps >> (C1 * p)) : 0u;
#pragma unroll
                for (int k = 0; k < C1; ++k) {
                    if (DROP) z[k] = drop_apply(z[k], keep, k, cfg.scale);
                    const float a = fmaxf(z[k], 0.f);
                    if (a > m[k]) { m[k] = a; cnt[k] = 1.f; taps[k] = sp; }
                    else if (a == m[k]) { cnt[k] += 1.f; taps[k] += sp; }
                }
            }
#pragma unroll
            for (int k = 0; k < C1; ++k) {
                if (m[k] > 0.f) {   // relu gate: a zero maximum passes nothing
                    float coef = gx[k] / cnt[k];
                    if (DROP) coef *= cfg.scale;
                    accb[k] += coef * cnt[k];
#pragma unroll
                    for (int j = 0; j < 9; ++j) accw[k][j] += coef * tap_count<P1>(taps[k], j);
                }
            }
        });
#pragma unroll
        for (int k = 0; k < C1; ++k) {
            block_sums<9>(accw[k], red, row + k * 9);
            float bsum[1] = {accb[k]};
            block_sums<1>(bsum, red, row + C1 * 9 + k);
        }
    } else {
        constexpr int CG = 4;
#pragma unroll 1
        for (int G0 = 0; G0 < C1; G0 += CG) {
            float accw[CG][9], accb[CG];
#pragma unroll
            for (int k = 0; k < CG; ++k) {
                accb[k] = 0.f;
#pragma unroll
                for (int j = 0; j < 9; ++j) accw[k][j] = 0.f;
            }
            grid_walk(OR, OW, [&](int ly, int lx) {
                const int r = 2 * b.o0 + ly, c = 2 * b.oc0 + lx;
                float gx[CG];
#pragma unroll
                for (int k = 0; k < CG; ++k) gx[k] = 0.f;
#pragma unroll
                for (int o = 0; o < C2; ++o) {
                    const float* p = g2s + (o * GR + ly + 2) * GW + lx + 2;   // (r, c)
#pragma unroll
                    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
                        for (int dx = 0; dx < 3; ++dx) {
                            const float gv = p[(1 - dy) * GW + (1 - dx)];
#pragma unroll
                            for (int k = 0; k < CG; ++k)
                                gx[k] += gv * w2s[(o * C1 + G0 + k) * 9 + dy * 3 + dx];
                        }
                }
                if (maskn != nullptr) {   // no gradient through a zeroed row
                    const float valid = maskn[r];
#pragma unroll
                    for (int k = 0; k < CG; ++k) gx[k] *= valid;
                }
                unsigned idx[P1 * P1];
                window_indices<P1>(bits, NS, I0, K0, r, c, idx);
                const Keep1 keeps =
                    DROP ? keep1n[static_cast<size_t>(r) * b.W1 + c] : static_cast<Keep1>(0);
                // the window's maximum, how many reach it, and the taps of those
                // that do, added as counts (bit_table.cuh::build_spread)
                float m[CG], cnt[CG];
                SpreadT taps[CG];
#pragma unroll
                for (int k = 0; k < CG; ++k) { m[k] = -1.f; cnt[k] = 0.f; taps[k] = 0; }
#pragma unroll
                for (int p = 0; p < P1 * P1; ++p) {
                    float z[CG];
                    channel_quad(tab[idx[p]], G0, z);
                    const SpreadT sp = spread[idx[p]];
                    const unsigned keep = DROP ? static_cast<unsigned>(keeps >> (C1 * p + G0)) : 0u;
#pragma unroll
                    for (int k = 0; k < CG; ++k) {
                        if (DROP) z[k] = drop_apply(z[k], keep, k, cfg.scale);
                        const float a = fmaxf(z[k], 0.f);
                        if (a > m[k]) { m[k] = a; cnt[k] = 1.f; taps[k] = sp; }
                        else if (a == m[k]) { cnt[k] += 1.f; taps[k] += sp; }
                    }
                }
#pragma unroll
                for (int k = 0; k < CG; ++k) {
                    if (m[k] > 0.f) {   // relu gate: a zero maximum passes nothing
                        float coef = gx[k] / cnt[k];
                        if (DROP) coef *= cfg.scale;
                        accb[k] += coef * cnt[k];
#pragma unroll
                        for (int j = 0; j < 9; ++j) accw[k][j] += coef * tap_count<P1>(taps[k], j);
                    }
                }
            });
#pragma unroll
            for (int k = 0; k < CG; ++k) {
                block_sums<9>(accw[k], red, row + (G0 + k) * 9);
                float bsum[1] = {accb[k]};
                block_sums<1>(bsum, red, row + C1 * 9 + G0 + k);
            }
        }
    }
}

template <int C1, int C2, int P1, bool DROP, typename SRC>
static cudaError_t launch_as(const void* x, const Enc3Weights& wp, const void* mask,
                             const void* g, const Enc3Saved& sv, void* partials, void* grads,
                             int N, const Enc3Shape& sh, size_t smem, const DropCfg& cfg,
                             cudaStream_t s) {
    constexpr int K = C1 * 9 + C1 + C2 * C1 * 9 + C2;
    const auto kernel = enc3_bwd_kernel<C1, C2, P1, DROP, SRC>;
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    const int Ho = sh.H / (2 * P1), Wo = sh.W / (2 * P1);
    const int blocks = ((Ho + sh.R2 - 1) / sh.R2) * ((Wo + sh.TW - 1) / sh.TW);
    for (int n0 = 0; n0 < N; n0 += MAX_GRID_Y) {
        KERNEL_LAUNCH(kernel, dim3(blocks, grid_rows(N, n0)), ENC3_THREADS, smem, s,
                      static_cast<const SRC*>(x), wp, static_cast<const float*>(mask),
                      static_cast<const float*>(g), sv, static_cast<float*>(partials), sh, n0,
                      cfg);
        e = cudaGetLastError();
        if (e != cudaSuccess) return e;
    }
    KERNEL_LAUNCH(column_sums_kernel, K, 128, 0, s, static_cast<const float*>(partials),
                  blocks * N, K, static_cast<float*>(grads));
    return cudaGetLastError();
}

template <int C1, int C2, int P1>
static cudaError_t launch_kind(int kind, bool drop, const void* x, const Enc3Weights& wp,
                               const void* mask, const void* g, const Enc3Saved& sv,
                               void* partials, void* grads, int N, const Enc3Shape& sh,
                               size_t smem, const DropCfg& cfg, cudaStream_t s) {
    if (kind == KIND_U32)
        return drop ? launch_as<C1, C2, P1, true, uint32_t>(x, wp, mask, g, sv, partials, grads, N, sh, smem, cfg, s)
                    : launch_as<C1, C2, P1, false, uint32_t>(x, wp, mask, g, sv, partials, grads, N, sh, smem, cfg, s);
    return drop ? launch_as<C1, C2, P1, true, uint8_t>(x, wp, mask, g, sv, partials, grads, N, sh, smem, cfg, s)
                : launch_as<C1, C2, P1, false, uint8_t>(x, wp, mask, g, sv, partials, grads, N, sh, smem, cfg, s);
}

// x, w1 .. b2, mask as enc3_fwd_launch's; g float32 [N, C2, H/2p1, W/2p1];
// keep1, keep2: what the saving forward wrote for the same inputs, weights,
// dropout and seed (null without dropout); partials: scratch of N x blocks x
// (C1 10 + C2 (9 C1 + 1)) floats, blocks = ceil(H/2p1 / R2) ceil(W/2p1 / TW);
// grads receives dW1, db1, dW2, db2 one after the other.  smem must equal
// enc3_bwd_smem (ops/cuda_head.py computes the same).
extern "C" int enc3_bwd_launch(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* b2, const void* mask, const void* g,
                               const void* keep1, const void* keep2, void* partials,
                               void* grads, int N, int H, int W, int C1, int C2, int p1, int p2,
                               int R2, int TW, long long smem, int x_kind, double drop_p,
                               int device, void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const bool drop = drop_p > 0.0;
    if (!enc3_widths(C1, C2, p1, p2) || H % (2 * p1) || W % (2 * p1) || R2 < 1 || TW < 1 ||
        drop_p < 0.0 || drop_p >= 1.0 || (x_kind != KIND_U8 && x_kind != KIND_U32) ||
        (x_kind == KIND_U32 && W % 32) || (drop && (keep1 == nullptr || keep2 == nullptr)) ||
        static_cast<size_t>(smem) != enc3_bwd_smem(C1, C2, p1, R2, TW))
        return static_cast<int>(cudaErrorInvalidValue);
    const Enc3Weights wp{static_cast<const float*>(w1), static_cast<const float*>(b1),
                         static_cast<const float*>(w2), static_cast<const float*>(b2)};
    const Enc3Saved sv{const_cast<void*>(keep1),
                       const_cast<uint8_t*>(static_cast<const uint8_t*>(keep2))};
    const Enc3Shape sh{H, W, R2, TW};
    const DropCfg cfg = make_drop_cfg(drop_p, 0);
    const size_t bytes = static_cast<size_t>(smem);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (C1 == 4 && p1 == 4)
        e = launch_kind<4, 1, 4>(x_kind, drop, x, wp, mask, g, sv, partials, grads, N, sh, bytes, cfg, s);
    else if (C1 == 2)
        e = launch_kind<2, 1, 4>(x_kind, drop, x, wp, mask, g, sv, partials, grads, N, sh, bytes, cfg, s);
    else if (C1 == 8)
        e = launch_kind<8, 1, 2>(x_kind, drop, x, wp, mask, g, sv, partials, grads, N, sh, bytes, cfg, s);
    else
        e = launch_kind<4, 2, 2>(x_kind, drop, x, wp, mask, g, sv, partials, grads, N, sh, bytes, cfg, s);
    return static_cast<int>(e);
}

// Registers, static shared memory, spilled bytes and resident blocks a
// multiprocessor of the band kernel at widths (C1, C2, p1, 2) on uint8 cells.
extern "C" int enc3_bwd_occupancy(int C1, int C2, int p1, int drop, long long smem, int device,
                                  int* out) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!enc3_widths(C1, C2, p1, 2)) return static_cast<int>(cudaErrorInvalidValue);
    const size_t bytes = static_cast<size_t>(smem);
    if (C1 == 4 && p1 == 4)
        return drop ? kernel_occupancy(enc3_bwd_kernel<4, 1, 4, true, uint8_t>, ENC3_THREADS, bytes, out)
                    : kernel_occupancy(enc3_bwd_kernel<4, 1, 4, false, uint8_t>, ENC3_THREADS, bytes, out);
    if (C1 == 2)
        return drop ? kernel_occupancy(enc3_bwd_kernel<2, 1, 4, true, uint8_t>, ENC3_THREADS, bytes, out)
                    : kernel_occupancy(enc3_bwd_kernel<2, 1, 4, false, uint8_t>, ENC3_THREADS, bytes, out);
    if (C1 == 8)
        return drop ? kernel_occupancy(enc3_bwd_kernel<8, 1, 2, true, uint8_t>, ENC3_THREADS, bytes, out)
                    : kernel_occupancy(enc3_bwd_kernel<8, 1, 2, false, uint8_t>, ENC3_THREADS, bytes, out);
    return drop ? kernel_occupancy(enc3_bwd_kernel<4, 2, 2, true, uint8_t>, ENC3_THREADS, bytes, out)
                : kernel_occupancy(enc3_bwd_kernel<4, 2, 2, false, uint8_t>, ENC3_THREADS, bytes, out);
}
