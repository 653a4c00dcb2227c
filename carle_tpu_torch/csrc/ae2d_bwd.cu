// ae2d_bwd: the gradients of the whole wrapper autoencoder's error at AE2D's
// widths (C1 = 4, C2 = 2, CMID = 1, COUT = 1), specialised at compile time.
//
// Replaces carle_tpu/ops/pallas_head.py::make_fused_ae_loss's backward kernel
// _ae_bwd_kernel (all-ones row mask) for every caller in the package;
// ae_loss_bwd.cu stays the generic instantiation.  From the cells src and
// obs, the packed weights, the cotangent gbar [N] of the per-instance error
// and what the training forward saved (ae2d_fwd.cu with SAVE: the embedding
// and, with dropout, every element's keep bits) it gives dW1, db1, dW2, db2,
// dWt1, dbt1, dWt2, dbt2.  No random number is drawn here: the forward drew
// each bit once, and ops/cuda_head.py runs that forward first when a caller
// asks for the gradients alone.
//
// Bound on an H100: operations, as the forward: the recompute, the weight
// gradients of all four layers and the cotangents of three.  The generic
// backward recomputed the forward three times with its dropout draws, each
// with its own halo, in seven launches; here each stage is recomputed once
// (stage 1 by table, ae2d.cuh), in three launches:
//
//   1. ae2d_bwd_decoder_kernel: a block owns a band of RY output rows.  From
//      the saved embedding it recomputes the middle band, then the output
//      cotangent on its rows and one to either side (sigmoid', the error, the
//      saved keep bits), its part of dWt2, dbt2, the middle cotangent on its
//      own middle rows (relu and dropout), written to gcm [N, 1, H/2, W/2],
//      and its part of dWt1, dbt1;
//   2. ae2d_bwd_encoder_kernel: a block owns a band of RY/4 embedding rows.
//      It recomputes stage 1 by table and stage 2 as the forward does, forms
//      the embedding cotangent of its rows and one to either side from gcm
//      (the transpose convolution's input cotangent), routes it through pool
//      2 (ties share g / count), relu and dropout into the stage-2 cotangent
//      (rows to either side for the next step, which needs no device
//      memory), its part of dW2, db2, the stage-1 cotangent of its own
//      stage-1 positions (transpose 3x3 with w2), and through pool 1, relu
//      and dropout its part of dW1, db1: a tap is a cell, 0 or 1, so dW1 adds
//      the routed cotangent where the tap is set (coef x the count of tied
//      pixels with the tap set, as the generic kernel's sums of taps);
//   3. ae2d_grad_sums_kernel adds the blocks' partial rows, one block a
//      gradient entry, in a fixed order.
//
// The middle cotangent crosses device memory because the embedding
// cotangent needs a halo of it that the decoder band would have to widen by
// two output rows each side to compute itself.  Every pre-activation is
// summed in the generic order, so the activations, the pool ties and the
// routed cotangents are the generic kernel's; only the weight-gradient sums
// run in other orders (other band heights).
#include "ae2d.cuh"

constexpr int DEC_PARTS = 50;    // dWt1 32, dbt1, dWt2 16, dbt2
constexpr int ENC_PARTS = 114;   // dW1 36, db1 4, dW2 72, db2 2

template <bool DROP, typename OBS>
__global__ void __launch_bounds__(AE2D_THREADS, AE2D_DEC_BLOCKS)
ae2d_bwd_decoder_kernel(const OBS* __restrict__ obs, Ae2dWeights wp,
                        const float* __restrict__ gbar, float* __restrict__ gcm,
                        float* __restrict__ partials, Ae2dSaved sv, Ae2dShape sh,
                        DropCfg cfg) {
    constexpr int KEEP = DROP ? KEEP_READ : KEEP_NONE;
    const Ae2dDims d(sh);
    const int n = blockIdx.y;
    const int Y0 = blockIdx.x * sh.RY, RY = sh.RY;
    const int H = sh.H, W = sh.W, H1 = d.H1, W1 = d.W1, We = d.We;
    const int ER = d.ER(), EW = d.EW(), XW = d.XW(), MR = d.MR(), M0 = Y0 / 2 - 1;
    const int GYW = W + 2, MY0 = Y0 / 2, GMR = RY / 2;

    extern __shared__ float smem[];
    float* es = smem;                        // 2 x ER x EW, rows from Y0/4 - 1, cols from -1
    float* ms = es + 2 * ER * EW;            // MR x XW, rows from M0, cols from -1
    float* gys = ms + MR * XW;               // (RY + 2) x GYW, rows from Y0 - 1, cols from -1
    float* gms = gys + (RY + 2) * GYW;       // GMR x W1, the own middle rows
    float* red = gms + GMR * W1;             // 32 x 16

    // the weights, and the embedding band, zero outside the universe
    load_weights(wp);
    const int E0 = Y0 / 4 - 1;
    const Win esw{es, E0, -1, ER, EW}, msw{ms, M0, -1, MR, XW};
    dec2_stage_emb(esw, sv.emb + static_cast<size_t>(n) * 2 * d.He * We, d.He, We);
    __syncthreads();
    const uint8_t* keepd_n = DROP ? sv.keepd + static_cast<size_t>(n) * H1 * W1 : nullptr;
    dec2_middle<KEEP, false, false>(esw, msw, Y0 / 4, RY / 4 + 1, 0, We + 1, H1, W1, 0, 0, n, cfg,
                                    keepd_n, nullptr, 0, 0, 0, 0);
    __syncthreads();

    // (a) the cotangent of the last pre-activation on rows Y0 - 1 .. Y0 + RY
    const Win gyw{gys, Y0 - 1, -1, RY + 2, GYW};
    dec2_out_cotangent<DROP, false>(msw, gyw, Y0 / 2, RY / 2 + 1, 0, W1 + 1, 0, 0, H, W,
                                    cells_at(obs, static_cast<size_t>(n) * H * W),
                                    2.f * gbar[n], nullptr, keepd_n, cfg);
    __syncthreads();

    float* row = partials + (static_cast<size_t>(n) * gridDim.x + blockIdx.x) * DEC_PARTS;
    const int y_end = min(Y0 + RY, H);       // owned output rows [Y0, y_end)
    // (b) this band's part of dWt2 and dbt2
    dec2_wt2_grad(msw, gyw, M0, MR, 0, W1, Y0, y_end, 0, W, red, row + 33, row + 49);
    // (c) the middle cotangent on the own middle rows, through relu and
    // dropout, also into gcm
    const Win gmw{gms, MY0, 0, GMR, W1};
    dec2_mid_cotangent<DROP>(msw, gyw, gmw, H1, W1, gcm + static_cast<size_t>(n) * H1 * W1, cfg);
    __syncthreads();
    // (d) this band's part of dWt1 and dbt1
    dec2_wt1_grad(esw, gmw, E0, ER, 0, We, MY0, min(MY0 + GMR, H1), 0, W1, red, row, row + 32);
}

template <bool DROP, typename SRC>
__global__ void __launch_bounds__(AE2D_THREADS, AE2D_ENC_BLOCKS)
ae2d_bwd_encoder_kernel(const SRC* __restrict__ src, Ae2dWeights wp,
                        const float* __restrict__ gcm, float* __restrict__ partials,
                        Ae2dSaved sv, Ae2dShape sh, DropCfg cfg) {
    constexpr int KEEP = DROP ? KEEP_READ : KEEP_NONE;
    const Ae2dDims d(sh);
    const int n = blockIdx.y;
    const int Y0 = blockIdx.x * sh.RY, RY = sh.RY;
    const int H1 = d.H1, W1 = d.W1, He = d.He, We = d.We;
    const int XR = d.XR(), XW = d.XW(), X0 = Y0 / 2 - 3, I0 = Y0 - 7, NS = d.NS();
    const int GER = d.ER(), GE0 = Y0 / 4 - 1;       // embedding cotangent rows
    const int G2R = RY / 2 + 4, G20 = Y0 / 2 - 2;   // stage-2 cotangent rows
    const int tid = threadIdx.x, nt = blockDim.x;

    extern __shared__ float smem[];
    float4* tab = reinterpret_cast<float4*>(smem);  // 512
    float* x1s = smem + 4 * 512;                      // 4 x XR x XW
    float* ges = x1s + 4 * XR * XW;                   // 2 x GER x We
    float* g2s = ges + 2 * GER * We;                  // 2 x G2R x XW, cols from -1
    float* red = g2s + 2 * G2R * XW;                  // 32 x 9
    uint32_t* spread = reinterpret_cast<uint32_t*>(red + 32 * 9);   // 512
    uint32_t* bits = spread + 512;                    // IR x NS

    load_weights(wp);
    __syncthreads();
    build_table<4>(tab, ae2d_w + AE_W1, ae2d_w + AE_B1);
    build_spread<2>(spread);
    stage_bits(bits, cells_at(src, static_cast<size_t>(n) * sh.H * sh.W), I0, d.IR(), -1, d.NS(),
               sh.H, sh.W);
    // the embedding cotangent from gcm (net_stages.cuh::deconv_input_grad_kernel's sum)
    const float* gcn = gcm + static_cast<size_t>(n) * H1 * W1;
    grid_walk(GER, We, [&](int lr, int f) {
        const int e = GE0 + lr;
        float s[2] = {0.f, 0.f};
        if (e >= 0 && e < He) {
#pragma unroll
            for (int ky = 0; ky < 4; ++ky) {
                const int yr = 2 * e - 1 + ky;
                if (yr < 0 || yr >= H1) continue;
#pragma unroll
                for (int kx = 0; kx < 4; ++kx) {
                    const int xc = 2 * f - 1 + kx;
                    if (xc < 0 || xc >= W1) continue;
                    const float g = gcn[static_cast<size_t>(yr) * W1 + xc];
                    s[0] += parity_tap(dec2_wt1p, ky, kx) * g;
                    s[1] += parity_tap(dec2_wt1p + 4, ky, kx) * g;
                }
            }
        }
        ges[lr * We + f] = s[0];
        ges[(GER + lr) * We + f] = s[1];
    });
    for (int i = tid; i < 2 * G2R; i += nt) {   // the stage-2 cotangent's zero columns
        g2s[i * XW] = 0.f;
        g2s[i * XW + XW - 1] = 0.f;
    }
    __syncthreads();
    ae2d_stage1<KEEP, false>(tab, bits, x1s, d, Y0, n, cfg, sv.keep1);
    __syncthreads();

    // route the embedding cotangent through pool 2, relu and dropout
    // (encoder_bwd.cuh's kernel 1): one thread a pool window
    grid_walk(GER, We, [&](int lr, int f) {
        const int e = GE0 + lr;
        float* out = g2s + (2 * lr) * XW + 2 * f + 1;   // rows 2e, 2e + 1; column 2f
        if (e < 0 || e >= He) {
#pragma unroll
            for (int o = 0; o < 2; ++o) {
                out[o * G2R * XW] = out[o * G2R * XW + 1] = 0.f;
                out[o * G2R * XW + XW] = out[o * G2R * XW + XW + 1] = 0.f;
            }
            return;
        }
        float acc[4][2];
        ae2d_stage2_window(x1s, XR, XW, X0, e, f, acc);
        const unsigned keep8 = DROP ? sv.keep2[(static_cast<size_t>(n) * He + e) * We + f] : 0u;
        float m[2] = {-1.f, -1.f}, cnt[2] = {0.f, 0.f};
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int o = 0; o < 2; ++o) {
                if (DROP) acc[p][o] = drop_apply(acc[p][o], keep8 >> (2 * p), o, cfg.scale);
                const float a = fmaxf(acc[p][o], 0.f);
                if (a > m[o]) { m[o] = a; cnt[o] = 1.f; }
                else if (a == m[o]) cnt[o] += 1.f;
            }
#pragma unroll
        for (int o = 0; o < 2; ++o) {
            const float gq = ges[(o * GER + lr) * We + f] / cnt[o];
#pragma unroll
            for (int p = 0; p < 4; ++p) {
                const float dv = acc[p][o];
                float gc = (dv > 0.f && dv == m[o]) ? gq : 0.f;
                if (DROP) gc *= cfg.scale;
                out[o * G2R * XW + (p >> 1) * XW + (p & 1)] = gc;
            }
        }
    });
    __syncthreads();

    float* row = partials + (static_cast<size_t>(n) * gridDim.x + blockIdx.x) * ENC_PARTS;
    const int r_own = Y0 / 2, r_end = min(Y0 / 2 + RY / 2, H1);   // own stage-1 rows

    // this band's part of dW2 [2, 4, 3, 3] and db2 from its own stage-2 rows
    for (int c = 0; c < 4; ++c) {
        float v0[9], v1[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) v0[k] = v1[k] = 0.f;
        grid_walk(r_end - r_own, W1, [&](int lr, int xx) {
            const float g0 = g2s[(lr + 2) * XW + xx + 1];
            const float g1 = g2s[(G2R + lr + 2) * XW + xx + 1];
            const float* p = x1s + (c * XR + r_own - 1 - X0 + lr) * XW + xx;   // tap (0, 0)
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
#pragma unroll
                for (int dx = 0; dx < 3; ++dx) {
                    const float t = p[dy * XW + dx];
                    v0[dy * 3 + dx] += t * g0;
                    v1[dy * 3 + dx] += t * g1;
                }
        });
        block_sums<9>(v0, red, row + 40 + c * 9);
        block_sums<9>(v1, red, row + 40 + (4 + c) * 9);
    }
    for (int o = 0; o < 2; ++o) {
        float bsum[1] = {0.f};
        grid_walk(r_end - r_own, W1, [&](int lr, int xx) {
            bsum[0] += g2s[(o * G2R + lr + 2) * XW + xx + 1];
        });
        block_sums<1>(bsum, red, row + 112 + o);
    }

    // the stage-1 cotangent of the own stage-1 positions (transpose 3x3 with
    // w2), routed through pool 1, relu and dropout: dW1 and db1
    float accw[4][9], accb[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        accb[k] = 0.f;
#pragma unroll
        for (int j = 0; j < 9; ++j) accw[k][j] = 0.f;
    }
    grid_walk(r_end - r_own, W1, [&](int lr, int c) {
        const int r = r_own + lr;
        float gx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int o = 0; o < 2; ++o) {
            const float* p = g2s + (o * G2R + r - G20) * XW + c + 1;   // (r, c)
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
#pragma unroll
                for (int dx = 0; dx < 3; ++dx) {
                    const float gv = p[(1 - dy) * XW + (1 - dx)];
                    const float4 w = ae2d_w2t[o * 9 + dy * 3 + dx];
                    gx[0] += gv * w.x;
                    gx[1] += gv * w.y;
                    gx[2] += gv * w.z;
                    gx[3] += gv * w.w;
                }
        }
        unsigned idx[4];
        window_indices<2>(bits, NS, I0, -1, r, c, idx);
        const unsigned keep16 =
            DROP ? sv.keep1[(static_cast<size_t>(n) * H1 + r) * W1 + c] : 0xffffu;
        // the window's maximum, how many reach it, and the taps of those that
        // do, added as counts (bit_table.cuh::build_spread)
        float m[4] = {-1.f, -1.f, -1.f, -1.f}, cnt[4] = {0.f, 0.f, 0.f, 0.f};
        uint32_t taps[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int p = 0; p < 4; ++p) {
            float z[4];
            channels(tab[idx[p]], z);
            const uint32_t sp = spread[idx[p]];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                if (DROP) z[k] = drop_apply(z[k], keep16 >> (4 * p), k, cfg.scale);
                const float a = fmaxf(z[k], 0.f);
                if (a > m[k]) { m[k] = a; cnt[k] = 1.f; taps[k] = sp; }
                else if (a == m[k]) { cnt[k] += 1.f; taps[k] += sp; }
            }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            if (m[k] > 0.f) {   // relu gate: a zero maximum passes nothing
                float coef = gx[k] / cnt[k];
                if (DROP) coef *= cfg.scale;
                accb[k] += coef * cnt[k];
#pragma unroll
                for (int j = 0; j < 9; ++j) accw[k][j] += coef * tap_count<2>(taps[k], j);
            }
        }
    });
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        block_sums<9>(accw[k], red, row + k * 9);
        float bsum[1] = {accb[k]};
        block_sums<1>(bsum, red, row + 36 + k);
    }
}

// grads[k] = the sum of column k of the blocks' partial rows: the encoder
// kernel's ENC_PARTS columns, then the decoder kernel's DEC_PARTS, one block
// each (column_sums_kernel's order: each thread its rows in turn, then a tree).
__global__ void ae2d_grad_sums_kernel(const float* __restrict__ enc, int enc_rows,
                                      const float* __restrict__ dec, int dec_rows,
                                      float* __restrict__ grads) {
    __shared__ float red[128];
    const int k = blockIdx.x, tid = threadIdx.x;
    const bool is_enc = k < ENC_PARTS;
    const float* part = is_enc ? enc : dec;
    const int K = is_enc ? ENC_PARTS : DEC_PARTS, col = is_enc ? k : k - ENC_PARTS;
    const int rows = is_enc ? enc_rows : dec_rows;
    float s = 0.f;
    for (int r = tid; r < rows; r += blockDim.x) s += part[static_cast<size_t>(r) * K + col];
    red[tid] = s;
    __syncthreads();
    for (int half = blockDim.x / 2; half > 0; half >>= 1) {
        if (tid < half) red[tid] += red[tid + half];
        __syncthreads();
    }
    if (tid == 0) grads[k] = red[0];
}

template <bool DROP, typename SRC, typename OBS>
static cudaError_t launch_as(const void* src, const void* obs, const Ae2dWeights& wp,
                             const void* gbar, void* gcm,
                             void* part_dec, void* part_enc, void* grads, const Ae2dSaved& sv,
                             int N, const Ae2dShape& dec_sh, size_t dec_bytes,
                             const Ae2dShape& enc_sh, size_t enc_bytes, const DropCfg& cfg,
                             cudaStream_t s) {
    const auto kdec = ae2d_bwd_decoder_kernel<DROP, OBS>;
    const auto kenc = ae2d_bwd_encoder_kernel<DROP, SRC>;
    cudaError_t e = allow_smem(kdec, dec_bytes);
    if (e == cudaSuccess) e = allow_smem(kenc, enc_bytes);
    if (e != cudaSuccess) return e;
    const int dec_bands = (dec_sh.H + dec_sh.RY - 1) / dec_sh.RY;
    const int enc_bands = (enc_sh.H + enc_sh.RY - 1) / enc_sh.RY;
    KERNEL_LAUNCH(kdec, dim3(dec_bands, N), AE2D_THREADS, dec_bytes, s,
                  static_cast<const OBS*>(obs), wp, static_cast<const float*>(gbar),
                  static_cast<float*>(gcm), static_cast<float*>(part_dec), sv, dec_sh, cfg);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    KERNEL_LAUNCH(kenc, dim3(enc_bands, N), AE2D_THREADS, enc_bytes, s,
                  static_cast<const SRC*>(src), wp, static_cast<const float*>(gcm),
                  static_cast<float*>(part_enc), sv, enc_sh, cfg);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    KERNEL_LAUNCH(ae2d_grad_sums_kernel, ENC_PARTS + DEC_PARTS, 128, 0, s,
                  static_cast<const float*>(part_enc), enc_bands * N,
                  static_cast<const float*>(part_dec), dec_bands * N,
                  static_cast<float*>(grads));
    return cudaGetLastError();
}

template <bool DROP>
static cudaError_t launch_kinds(int src_kind, int obs_kind, const void* src, const void* obs,
                                const Ae2dWeights& wp, const void* gbar, void* gcm, void* part_dec, void* part_enc,
                                void* grads, const Ae2dSaved& sv, int N,
                                const Ae2dShape& dec_sh, size_t dec_bytes,
                                const Ae2dShape& enc_sh, size_t enc_bytes, const DropCfg& cfg,
                                cudaStream_t s) {
    if (src_kind == KIND_U32)
        return obs_kind == KIND_U32
            ? launch_as<DROP, uint32_t, uint32_t>(src, obs, wp, gbar, gcm, part_dec, part_enc, grads, sv, N, dec_sh, dec_bytes, enc_sh, enc_bytes, cfg, s)
            : launch_as<DROP, uint32_t, uint8_t>(src, obs, wp, gbar, gcm, part_dec, part_enc, grads, sv, N, dec_sh, dec_bytes, enc_sh, enc_bytes, cfg, s);
    return obs_kind == KIND_U32
        ? launch_as<DROP, uint8_t, uint32_t>(src, obs, wp, gbar, gcm, part_dec, part_enc, grads, sv, N, dec_sh, dec_bytes, enc_sh, enc_bytes, cfg, s)
        : launch_as<DROP, uint8_t, uint8_t>(src, obs, wp, gbar, gcm, part_dec, part_enc, grads, sv, N, dec_sh, dec_bytes, enc_sh, enc_bytes, cfg, s);
}

// w1 .. bt2: the eight float32 weight tensors, contiguous; emb, keep1, keep2, keepd: what
// ae2d_fwd_launch saved for the same inputs, weights, dropout and seed (the
// keep bits null without dropout); gcm: scratch N x H/2 x W/2; part_dec: N x
// ceil(H / RY_dec) x DEC_PARTS; part_enc: N x ceil(H / RY_enc) x ENC_PARTS;
// grads receives dW1, db1, dW2, db2, dWt1, dbt1, dWt2, dbt2 one after the
// other.  The shared memory must equal ae2d_bwd_dec_smem and
// ae2d_bwd_enc_smem (ops/cuda_head.py computes the same).
extern "C" int ae2d_bwd_launch(const void* src, const void* obs, const void* w1,
                               const void* b1, const void* w2, const void* b2, const void* wt1,
                               const void* bt1, const void* wt2, const void* bt2, const void* emb, const void* keep1, const void* keep2,
                               const void* keepd, const void* gbar, void* gcm, void* part_dec,
                               void* part_enc, void* grads, int N, int H, int W, int RY_dec,
                               int RY_enc, long long smem_dec, long long smem_enc, int src_kind,
                               int obs_kind, double drop_p, int device, void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const Ae2dShape dec_sh{H, W, RY_dec}, enc_sh{H, W, RY_enc};
    const bool drop = drop_p > 0.0;
    if (RY_dec % 4 || RY_dec < 4 || RY_enc % 4 || RY_enc < 4 || H % 4 || W % 4 ||
        drop_p < 0.0 || drop_p >= 1.0 || emb == nullptr ||
        !cell_kinds_ok(src_kind, obs_kind, W) ||
        static_cast<size_t>(smem_dec) != ae2d_bwd_dec_smem(dec_sh) ||
        static_cast<size_t>(smem_enc) != ae2d_bwd_enc_smem(enc_sh) ||
        (drop && (keep1 == nullptr || keep2 == nullptr || keepd == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Ae2dWeights wp{{static_cast<const float*>(w1), static_cast<const float*>(b1),
                          static_cast<const float*>(w2), static_cast<const float*>(b2),
                          static_cast<const float*>(wt1), static_cast<const float*>(bt1),
                          static_cast<const float*>(wt2), static_cast<const float*>(bt2)}};
    const Ae2dSaved sv{const_cast<float*>(static_cast<const float*>(emb)),
                       const_cast<uint16_t*>(static_cast<const uint16_t*>(keep1)),
                       const_cast<uint8_t*>(static_cast<const uint8_t*>(keep2)),
                       const_cast<uint8_t*>(static_cast<const uint8_t*>(keepd))};
    const DropCfg cfg = make_drop_cfg(drop_p, 0);
    e = drop ? launch_kinds<true>(src_kind, obs_kind, src, obs, wp, gbar, gcm, part_dec, part_enc, grads, sv, N, dec_sh, static_cast<size_t>(smem_dec), enc_sh, static_cast<size_t>(smem_enc), cfg, s)
             : launch_kinds<false>(src_kind, obs_kind, src, obs, wp, gbar, gcm, part_dec, part_enc, grads, sv, N, dec_sh, static_cast<size_t>(smem_dec), enc_sh, static_cast<size_t>(smem_enc), cfg, s);
    return static_cast<int>(e);
}

// Registers, static shared memory, spilled bytes and resident blocks a
// multiprocessor (common.cuh::kernel_occupancy) of the decoder (out[0..3])
// and encoder (out[4..7]) band kernels on uint8 cells.
extern "C" int ae2d_bwd_occupancy(int drop, long long smem_dec, long long smem_enc, int device,
                                  int* out) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t bd = static_cast<size_t>(smem_dec), be = static_cast<size_t>(smem_enc);
    int rc = drop ? kernel_occupancy(ae2d_bwd_decoder_kernel<true, uint8_t>, AE2D_THREADS, bd, out)
                  : kernel_occupancy(ae2d_bwd_decoder_kernel<false, uint8_t>, AE2D_THREADS, bd, out);
    if (rc != 0) return rc;
    return drop ? kernel_occupancy(ae2d_bwd_encoder_kernel<true, uint8_t>, AE2D_THREADS, be, out + 4)
                : kernel_occupancy(ae2d_bwd_encoder_kernel<false, uint8_t>, AE2D_THREADS, be, out + 4);
}
