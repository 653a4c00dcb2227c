// The decoder's backward for one band of output rows, shared by
// ae_loss_bwd.cu (whole autoencoder) and decoder_loss_bwd.cu (decoder alone,
// embedding from device memory).
//
// From the band's forward (ae_bands.cuh: es, ms and the decoder's weights in
// shared memory) a block that owns output rows [Y0, Y0 + RY):
//
//   (a) recomputes y = sigmoid(drop(r)) on its rows and one row to either
//       side, g = gbar 2 (y - obs), through sigmoid' y (1 - y) and the dropout
//       mask;
//   (b) sums its part of dWt2 and dbt2;
//   (c) forms the middle cotangent on its RY/2 middle rows, through relu and
//       dropout, and writes it to gmid [N, CMID, H/2, W/2];
//   (d) sums its part of dWt1 and dbt1.
//
// The embedding's cotangent needs a one-row halo of gmid, so it is a launch
// of its own over gmid in device memory (net_stages.cuh:
// deconv_input_grad_kernel).  partials: one row a block of C2 CMID 16 + CMID +
// CMID COUT 16 + COUT floats (dWt1, dbt1, dWt2, dbt2).
#pragma once

#include "ae_bands.cuh"

constexpr int RED16_FLOATS = 32 * 16;

// Floats the backward adds to the band buffers: the output cotangent with its
// halo, the middle cotangent and the block_sums scratch.
__host__ __device__ inline size_t decoder_bwd_floats(const AEShape& sh) {
    return static_cast<size_t>(sh.COUT) * (sh.RY + 2) * (sh.W + 2) +
           static_cast<size_t>(sh.CMID) * (sh.RY / 2) * (sh.W / 2) + RED16_FLOATS;
}

// scratch: decoder_bwd_floats(sh) floats after the band buffers.  on: instance
// n's obs [COUT, H, W], cells, packed words or floats.  Every thread of the block calls it.
template <bool DROP, typename OBS>
__device__ __forceinline__ void decoder_backward_band(
    const AEBand& b, float* scratch, const OBS* __restrict__ on, float gbar_n,
    float* __restrict__ gmid, float* __restrict__ partials, const AEShape& sh, int Y0,
    int n, const DropCfg& cfg) {
    const int H = sh.H, W = sh.W, C2 = sh.C2, CMID = sh.CMID, COUT = sh.COUT, RY = sh.RY;
    const int H1 = H / 2, W1 = W / 2, We = W / 4;
    const int GYR = RY + 2, GYW = W + 2;    // y cotangent rows from Y0 - 1, cols from -1
    const int GMR = RY / 2, MY0 = Y0 / 2;   // middle cotangent rows from MY0
    const int tid = threadIdx.x, nt = blockDim.x;
    float* gys = scratch;                    // COUT x GYR x GYW
    float* gms = gys + COUT * GYR * GYW;     // CMID x GMR x W1
    float* red = gms + CMID * GMR * W1;      // RED16_FLOATS

    // (a) cotangent of the last pre-activation on rows Y0 - 1 .. Y0 + RY
    const float gb2 = 2.f * gbar_n;
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
                    const float t = cell_value(on, (static_cast<size_t>(o) * H + gy) * W + xo);
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
