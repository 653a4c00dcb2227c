// ae_loss_bwd: the gradients of the whole wrapper autoencoder's error.
//
// Replaces carle_tpu/ops/pallas_head.py::make_fused_ae_loss's backward kernel
// _ae_bwd_kernel (all-ones row mask): from the cells src and obs, the eight
// parameters, the dropout seed and the cotangent gbar [N] of the
// per-instance error it gives dW1, db1, dW2, db2, dWt1, dbt1, dWt2, dbt2,
// recomputing the forward with its dropout mask.
//
// The TPU kernel holds a tile's whole net in VMEM.  Here the backward is
// staged, each stage a kernel of this file whose blocks own their positions
// exclusively, with the cotangents that cross stages in device memory:
//
//   1. ae_bwd_decoder_kernel: a block owns a band of RY output rows.  It
//      recomputes the forward up to the middle activation (ae_bands.cuh),
//      then y = sigmoid(drop(r)) on its rows and one row to either side,
//      g = gbar 2 (y - obs), through sigmoid' y (1 - y) and the dropout mask;
//      sums its part of dWt2 and dbt2; forms the middle cotangent on its
//      RY/2 middle rows, through relu and dropout, writes it (gmid,
//      [N, CMID, H/2, W/2]) and sums its part of dWt1 and dbt1;
//   2. ae_bwd_embed_kernel: the embedding cotangent (gemb, [N, C2, H/4, W/4])
//      from gmid and wt1, one thread an element;
//   3. the encoder's backward (encoder_bwd.cuh) with gemb as its cotangent;
//   4. column_sums_kernel adds the blocks' partial sums in a fixed order.
//
// Fusing the stages into one band kernel (nested halos out to 15 input rows
// either side) is left for later.  Bound: operations, as the forward.
#include "ae_bands.cuh"
#include "encoder_bwd.cuh"

constexpr int RED16_FLOATS = 32 * 16;

__host__ __device__ inline size_t ae_bwd_decoder_smem(const AEShape& sh) {
    const size_t floats = ae_band_floats(sh) +
                          static_cast<size_t>(sh.COUT) * (sh.RY + 2) * (sh.W + 2) +
                          static_cast<size_t>(sh.CMID) * (sh.RY / 2) * (sh.W / 2) +
                          RED16_FLOATS;
    return 4 * floats + static_cast<size_t>(sh.RY + 14) * (sh.W + 2);
}

template <bool DROP>
__global__ void ae_bwd_decoder_kernel(
    const uint8_t* __restrict__ src, const uint8_t* __restrict__ obs,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ wt1, const float* __restrict__ bt1,
    const float* __restrict__ wt2, const float* __restrict__ bt2,
    const float* __restrict__ gbar, float* __restrict__ gmid,
    float* __restrict__ partials, AEShape sh, DropCfg cfg) {
    const int H = sh.H, W = sh.W, C2 = sh.C2, CMID = sh.CMID, COUT = sh.COUT, RY = sh.RY;
    const int H1 = H / 2, W1 = W / 2, We = W / 4;
    const int n = blockIdx.y;
    const int Y0 = blockIdx.x * RY;
    const int GYR = RY + 2, GYW = W + 2;    // y cotangent rows from Y0 - 1, cols from -1
    const int GMR = RY / 2, MY0 = Y0 / 2;   // middle cotangent rows from MY0
    const int tid = threadIdx.x, nt = blockDim.x;

    extern __shared__ float smem[];
    AEBand b = ae_band_layout(smem, sh, Y0);
    float* gys = b.end;                      // COUT x GYR x GYW
    float* gms = gys + COUT * GYR * GYW;     // CMID x GMR x W1
    float* red = gms + CMID * GMR * W1;      // RED16_FLOATS
    uint8_t* xs = reinterpret_cast<uint8_t*>(red + RED16_FLOATS);
    ae_band_forward<DROP>(b, xs, src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, sh, n, cfg);

    // (a) cotangent of the last pre-activation on rows Y0 - 1 .. Y0 + RY
    const uint8_t* on = obs + static_cast<size_t>(n) * COUT * H * W;
    const float gb2 = 2.f * gbar[n];
    for (int i = tid; i < GYR * GYW; i += nt) {
        const int lr = i / GYW, lc = i - lr * GYW;
        const int gy = Y0 - 1 + lr, xo = lc - 1;
        const bool inside = gy >= 0 && gy < H && xo >= 0 && xo < W;
        float acc[MAXC];
        unsigned keep = 0;
        if (inside) {
            deconv_preact(b.ms, b.M0, b.MR, W1, b.wt2s, b.bt2s, CMID, COUT, gy, xo, acc);
            if (DROP) keep = drop_keep_bits(cfg, STAGE_DEC2, n, COUT, gy, xo);
        }
#pragma unroll
        for (int o = 0; o < MAXC; ++o) {
            if (o < COUT) {
                float gc = 0.f;
                if (inside) {
                    const float r = DROP ? drop_apply(acc[o], keep, o, cfg.scale) : acc[o];
                    const float y = 1.f / (1.f + expf(-r));
                    const float t = static_cast<float>(on[(static_cast<size_t>(o) * H + gy) * W + xo]);
                    gc = gb2 * (y - t) * y * (1.f - y);
                    if (DROP) gc = ((keep >> o) & 1u) ? gc * cfg.scale : 0.f;
                }
                gys[(o * GYR + lr) * GYW + lc] = gc;
            }
        }
    }
    __syncthreads();

    const int K_wt1 = C2 * CMID * 16, K_wt2 = CMID * COUT * 16;
    float* row = partials + (static_cast<size_t>(n) * gridDim.x + blockIdx.x) *
                                (K_wt1 + CMID + K_wt2 + COUT);
    float* row_wt2 = row + K_wt1 + CMID;
    const int y_end = min(Y0 + RY, H);       // owned output rows [Y0, y_end)

    // (b) this band's part of dWt2 [CMID, COUT, 4, 4] and dbt2 [COUT]
    for (int m = 0; m < CMID; ++m)
        for (int o = 0; o < COUT; ++o) {
            float v[16];
#pragma unroll
            for (int k = 0; k < 16; ++k) v[k] = 0.f;
            for (int i = tid; i < b.MR * W1; i += nt) {
                const int lr = i / W1, mx = i - lr * W1;
                const float mv = b.ms[(m * b.MR + lr) * W1 + mx];
                const int ybase = 2 * (b.M0 + lr) - 1, xbase = 2 * mx - 1;
#pragma unroll
                for (int ky = 0; ky < 4; ++ky) {
                    const int yr = ybase + ky;
                    if (yr < Y0 || yr >= y_end) continue;
                    const float* gp = gys + (o * GYR + yr - (Y0 - 1)) * GYW + xbase + 1;
#pragma unroll
                    for (int kx = 0; kx < 4; ++kx) v[ky * 4 + kx] += mv * gp[kx];
                }
            }
            block_sums<16>(v, red, row_wt2 + (m * COUT + o) * 16);
        }
    for (int o = 0; o < COUT; ++o) {
        float bsum[1] = {0.f};
        for (int i = tid; i < (y_end - Y0) * W; i += nt) {
            const int lr = i / W, xo = i - lr * W;
            bsum[0] += gys[(o * GYR + lr + 1) * GYW + xo + 1];
        }
        block_sums<1>(bsum, red, row_wt2 + K_wt2 + o);
    }

    // (c) cotangent of the middle pre-activation on the band's own middle rows
    float* gmn = gmid + static_cast<size_t>(n) * CMID * H1 * W1;
    for (int i = tid; i < GMR * W1; i += nt) {
        const int lr = i / W1, mx = i - lr * W1;
        const int gm = MY0 + lr;
        for (int m = 0; m < CMID; ++m) {
            float gcm = 0.f;
            if (gm < H1 && b.ms[(m * b.MR + gm - b.M0) * W1 + mx] > 0.f) {
                // relu gate; a positive activation was kept by the dropout
                float s = 0.f;
                for (int o = 0; o < COUT; ++o) {
                    const float* wp = b.wt2s + (m * COUT + o) * 16;
#pragma unroll
                    for (int ky = 0; ky < 4; ++ky) {
                        const float* gp = gys + (o * GYR + 2 * gm - 1 + ky - (Y0 - 1)) * GYW + 2 * mx;
#pragma unroll
                        for (int kx = 0; kx < 4; ++kx) s += wp[ky * 4 + kx] * gp[kx];
                    }
                }
                gcm = DROP ? s * cfg.scale : s;
            }
            gms[(m * GMR + lr) * W1 + mx] = gcm;
            if (gm < H1) gmn[(static_cast<size_t>(m) * H1 + gm) * W1 + mx] = gcm;
        }
    }
    __syncthreads();

    // (d) this band's part of dWt1 [C2, CMID, 4, 4] and dbt1 [CMID]
    const int m_end = min(MY0 + GMR, H1);    // owned middle rows [MY0, m_end)
    for (int c = 0; c < C2; ++c)
        for (int m = 0; m < CMID; ++m) {
            float v[16];
#pragma unroll
            for (int k = 0; k < 16; ++k) v[k] = 0.f;
            for (int i = tid; i < b.ER * We; i += nt) {
                const int lr = i / We, ex = i - lr * We;
                const float ev = b.es[(c * b.ER + lr) * We + ex];
                const int mbase = 2 * (b.E0 + lr) - 1, xbase = 2 * ex - 1;
#pragma unroll
                for (int ky = 0; ky < 4; ++ky) {
                    const int mr = mbase + ky;
                    if (mr < MY0 || mr >= m_end) continue;
#pragma unroll
                    for (int kx = 0; kx < 4; ++kx) {
                        const int mc = xbase + kx;
                        if (mc >= 0 && mc < W1)
                            v[ky * 4 + kx] += ev * gms[(m * GMR + mr - MY0) * W1 + mc];
                    }
                }
            }
            block_sums<16>(v, red, row + (c * CMID + m) * 16);
        }
    for (int m = 0; m < CMID; ++m) {
        float bsum[1] = {0.f};
        for (int i = tid; i < GMR * W1; i += nt) bsum[0] += gms[m * GMR * W1 + i];
        block_sums<1>(bsum, red, row + K_wt1 + m);
    }
}

// gemb[n, c, ey, ex] = sum_m,ky,kx wt1[c, m, ky, kx] gmid[n, m, 2 ey - 1 + ky,
// 2 ex - 1 + kx]: the transpose convolution's input cotangent.
__global__ void ae_bwd_embed_kernel(const float* __restrict__ gmid,
                                    const float* __restrict__ wt1, float* __restrict__ gemb,
                                    int N, int H1, int W1, int C2, int CMID) {
    const int He = H1 / 2, We = W1 / 2;
    const size_t total = static_cast<size_t>(N) * C2 * He * We;
    for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
         i += static_cast<size_t>(gridDim.x) * blockDim.x) {
        const int ex = static_cast<int>(i % We);
        const int ey = static_cast<int>((i / We) % He);
        const int c = static_cast<int>((i / (static_cast<size_t>(We) * He)) % C2);
        const int n = static_cast<int>(i / (static_cast<size_t>(We) * He * C2));
        float s = 0.f;
        for (int m = 0; m < CMID; ++m) {
            const float* gp = gmid + (static_cast<size_t>(n) * CMID + m) * H1 * W1;
            const float* wp = wt1 + (c * CMID + m) * 16;
            for (int ky = 0; ky < 4; ++ky) {
                const int mr = 2 * ey - 1 + ky;
                if (mr < 0 || mr >= H1) continue;
                for (int kx = 0; kx < 4; ++kx) {
                    const int mc = 2 * ex - 1 + kx;
                    if (mc >= 0 && mc < W1) s += wp[ky * 4 + kx] * gp[static_cast<size_t>(mr) * W1 + mc];
                }
            }
        }
        gemb[i] = s;
    }
}

template <bool DROP>
static int decoder_bwd_as(const void* src, const void* obs, const void* w1, const void* b1,
                          const void* w2, const void* b2, const void* wt1, const void* bt1,
                          const void* wt2, const void* bt2, const void* gbar, void* gmid,
                          void* part3, int N, const AEShape& sh, size_t bytes,
                          const DropCfg& cfg, cudaStream_t s) {
    const auto kernel = ae_bwd_decoder_kernel<DROP>;
    cudaError_t e = allow_smem(kernel, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int bands = (sh.H + sh.RY - 1) / sh.RY;
    KERNEL_LAUNCH(kernel, dim3(bands, N), 256, bytes, s,
                  static_cast<const uint8_t*>(src), static_cast<const uint8_t*>(obs),
                  static_cast<const float*>(w1), static_cast<const float*>(b1),
                  static_cast<const float*>(w2), static_cast<const float*>(b2),
                  static_cast<const float*>(wt1), static_cast<const float*>(bt1),
                  static_cast<const float*>(wt2), static_cast<const float*>(bt2),
                  static_cast<const float*>(gbar), static_cast<float*>(gmid),
                  static_cast<float*>(part3), sh, cfg);
    return static_cast<int>(cudaGetLastError());
}

// Scratch: gmid N x CMID x H/2 x W/2, gemb N x C2 x H/4 x W/4, gc2 N x C2 x
// H/2 x W/2, part3 N x ceil(H / RY) x (C2 CMID 16 + CMID + CMID COUT 16 +
// COUT), part2 and part1 as encoder_bwd_launch; grads receives dW1, db1,
// dW2, db2, dWt1, dbt1, dWt2, dbt2 one after the other.  smem3 must equal
// ae_bwd_decoder_smem (ops/cuda_head.py computes the same).
extern "C" int ae_loss_bwd_launch(
    const void* src, const void* obs, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* wt1, const void* bt1, const void* wt2, const void* bt2,
    const void* gbar, void* gmid, void* gemb, void* gc2, void* part3, void* part2,
    void* part1, void* grads, int N, int H, int W, int C1, int C2, int CMID, int COUT,
    int RY, int R2, int RB, long long smem3, long long smem2, long long smem1,
    double drop_p, unsigned long long seed, int device, void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const AEShape sh{H, W, C1, C2, CMID, COUT, RY};
    if (C1 > MAXC || C2 > MAXC || CMID > MAXC || COUT > MAXC || RY % 4 || drop_p < 0.0 ||
        drop_p >= 1.0 || static_cast<size_t>(smem3) != ae_bwd_decoder_smem(sh))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const DropCfg cfg = make_drop_cfg(drop_p, seed);
    const size_t bytes = static_cast<size_t>(smem3);
    int rc = drop_p > 0.0
        ? decoder_bwd_as<true>(src, obs, w1, b1, w2, b2, wt1, bt1, wt2, bt2, gbar, gmid, part3, N, sh, bytes, cfg, s)
        : decoder_bwd_as<false>(src, obs, w1, b1, w2, b2, wt1, bt1, wt2, bt2, gbar, gmid, part3, N, sh, bytes, cfg, s);
    if (rc != 0) return rc;
    const size_t total = static_cast<size_t>(N) * C2 * (H / 4) * (W / 4);
    const int blocks = static_cast<int>((total + 255) / 256);
    KERNEL_LAUNCH(ae_bwd_embed_kernel, blocks, 256, 0, s, static_cast<const float*>(gmid),
                  static_cast<const float*>(wt1), static_cast<float*>(gemb), N, H / 2, W / 2,
                  C2, CMID);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const EncBwdArgs a{src, w1, b1, w2, b2, gemb, gc2, part2, part1, grads, N, H, W, C1, C2,
                       R2, RB, static_cast<size_t>(smem2), static_cast<size_t>(smem1)};
    rc = encoder_bwd_run(a, 2, 2, drop_p, cfg, s);
    if (rc != 0) return rc;
    const int K12 = C1 * 9 + C1 + C2 * C1 * 9 + C2;
    const int K3 = C2 * CMID * 16 + CMID + CMID * COUT * 16 + COUT;
    KERNEL_LAUNCH(column_sums_kernel, K3, 128, 0, s, static_cast<const float*>(part3),
                  ((H + RY - 1) / RY) * N, K3, static_cast<float*>(grads) + K12);
    return static_cast<int>(cudaGetLastError());
}
