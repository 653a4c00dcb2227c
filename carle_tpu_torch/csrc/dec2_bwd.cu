// dec2_bwd: the gradients of dec2_fwd's error at the decoder's width (C2 = 2,
// CMID = 1, COUT = 1), specialised at compile time.
//
// Replaces carle_tpu/ops/pallas_head.py::make_fused_decoder_loss's backward
// kernel _decoder_loss_bwd_kernel (and make_fused_decoder_loss_banded's, with
// the row weights em) for every caller in the package; decoder_loss_bwd.cu
// stays the generic instantiation.  From the embedding x, the decoder's
// weights, obs, the cotangent gbar [N] of the per-instance error and the keep
// bits the training forward saved (dec2_fwd.cu; null without dropout) it
// gives dWt1, dbt1, dWt2, dbt2 and gx, the embedding's cotangent.  No random
// number is drawn here: ops/cuda_stages.py runs the saving forward first when
// a caller asks for the gradients alone.
//
// Bound on an H100: operations (the recompute, two weight gradients and two
// input cotangents: 30 float32 multiply-adds and a sigmoid an output).  The
// generic backward recomputed the forward with its Philox draws, walked 16
// taps for each transpose-convolution output, and took three launches: its
// band kernel wrote the middle cotangent gmid to device memory (84 MB on
// Prediction's bands of 8192²), a second kernel read it back for gx, a third
// added the partial sums.  Here one band kernel forms gx itself: a block
// that owns output rows [Y0, Y0 + RY) needs gmid on middle rows [Y0/2 - 1,
// Y0/2 + RY/2 + 1) for the gx of its own embedding rows, so it recomputes
// the output cotangent on rows [Y0 - 3, Y0 + RY + 3) (and columns likewise)
// from the saved bits, and gmid never leaves shared memory; a second launch
// adds the blocks' partial gradients in a fixed order (the same bits every
// run).  Rows whose weight is zero have an exact zero cotangent and are not
// computed, nor the middle positions that only they read.
//
//   1. the band: the embedding window (two rows and columns a side), the
//      middle window (three) with the saved bits, the output cotangent on the
//      rows and columns above, the block's part of dWt2 and dbt2 over its own
//      outputs (a thread a quad of them, with the four middle values they
//      read), the middle cotangent through relu and dropout (gms), the
//      block's part of dWt1 and dbt1 over its own middle positions (a thread
//      a 2 x 2 block, with the eight embedding values it read), and gx of
//      its own embedding positions (the generic kernel's sum: wt1's taps in
//      ky, kx order);
//   2. column_sums_kernel adds the blocks' partial rows.
//
// Every activation, cotangent and gx keeps the generic kernel's sums, so gx
// is the generic kernel's; only the weight-gradient sums run in other orders.
#include "dec2.cuh"

template <bool DROP, typename OBS>
__global__ void __launch_bounds__(DEC2_THREADS, DEC2_BWD_BLOCKS)
dec2_bwd_kernel(const float* __restrict__ x, const OBS* __restrict__ obs, Dec2Weights wp,
                const float* __restrict__ gbar, const float* __restrict__ em,
                const uint8_t* __restrict__ keepd, float* __restrict__ gx,
                float* __restrict__ partials, Dec2Shape sh, int N0, DropCfg cfg) {
    constexpr int KEEP = DROP ? KEEP_READ : KEEP_NONE;
    const Dec2Block b(sh, N0);
    const int H = sh.H, W = sh.W, H1 = H / 2, W1 = W / 2, He = H / 4, We = W / 4;
    const int Y0 = b.Y0, X0 = b.X0, RY = b.RY, TX = b.TX, n = b.n;

    extern __shared__ float smem[];
    const Win es{smem, Y0 / 4 - 2, X0 / 4 - 2, RY / 4 + 4, TX / 4 + 4};
    const Win ms{es.p + 2 * es.rows * es.cols, Y0 / 2 - 3, X0 / 2 - 3, RY / 2 + 6, TX / 2 + 6};
    const Win gys{ms.p + ms.rows * ms.cols, Y0 - 3, X0 - 3, RY + 6, TX + 6};
    const Win gms{gys.p + gys.rows * gys.cols, Y0 / 2 - 1, X0 / 2 - 1, RY / 2 + 2, TX / 2 + 2};
    float* red = gms.p + gms.rows * gms.cols;   // 32 x 16

    dec2_load_weights(wp.wt1, wp.bt1, wp.wt2, wp.bt2);
    const float* x_n = x + static_cast<size_t>(n) * 2 * He * We;
    dec2_stage_emb(es, x_n, He, We);
    // the output rows with a weight among those the block's cotangent covers,
    // and the middle rows they read
    const float* em_n = em != nullptr ? em + static_cast<size_t>(n) * H : nullptr;
    int w_lo = -DEC2_ALL, w_hi = DEC2_ALL, m_lo = -DEC2_ALL, m_hi = DEC2_ALL;
    if (em_n != nullptr) {
        int lo, hi;
        weighted_rows(em_n, max(Y0 - 3, 0), min(Y0 + RY + 3, H), lo, hi);
        w_lo = lo < hi ? lo : DEC2_ALL;
        w_hi = lo < hi ? hi : -DEC2_ALL;
        m_lo = lo < hi ? (lo - 1) >> 1 : DEC2_ALL;
        m_hi = lo < hi ? ((hi - 2) >> 1) + 2 : -DEC2_ALL;
    }
    const uint8_t* keepd_n = DROP ? keepd + static_cast<size_t>(n) * H1 * W1 : nullptr;
    __syncthreads();
    dec2_middle<KEEP, false, true>(es, ms, Y0 / 4 - 1, RY / 4 + 3, X0 / 4 - 1, TX / 4 + 3, H1, W1,
                                   m_lo, m_hi, n, cfg, keepd_n, nullptr, 0, 0, 0, 0);
    __syncthreads();
    dec2_out_cotangent<DROP, true>(ms, gys, Y0 / 2 - 1, RY / 2 + 3, X0 / 2 - 1, TX / 2 + 3, w_lo,
                                   w_hi, H, W, cells_at(obs, static_cast<size_t>(n) * H * W),
                                   2.f * gbar[n], em_n, keepd_n, cfg);
    __syncthreads();

    float* row = partials + (static_cast<size_t>(n) * gridDim.x + blockIdx.x) * DEC2_PARTS;
    dec2_wt2_grad_quads(ms, gys, Y0 / 2, RY / 2 + 1, X0 / 2, TX / 2 + 1, Y0, Y0 + RY, X0, X0 + TX,
                        red, row + 33, row + 49);
    dec2_mid_cotangent<DROP>(ms, gys, gms, H1, W1, nullptr, cfg);
    __syncthreads();
    dec2_wt1_grad_pairs(es, gms, Y0 / 4, RY / 4 + 1, X0 / 4, TX / 4 + 1, Y0 / 2, Y0 / 2 + RY / 2,
                        X0 / 2, X0 / 2 + TX / 2, red, row, row + 32);

    // gx of the own embedding positions: gms's rows 2e - 1 .. 2e + 2
    float* gx_n = gx + static_cast<size_t>(n) * 2 * He * We;
    grid_walk(RY / 4, TX / 4, [&](int lr, int lc) {
        const int e = Y0 / 4 + lr, f = X0 / 4 + lc;
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int ky = 0; ky < 4; ++ky) {
            const float* gp = gms.at(2 * e - 1 + ky, 2 * f - 1);
#pragma unroll
            for (int kx = 0; kx < 4; ++kx) {
                s0 += parity_tap(dec2_wt1p, ky, kx) * gp[kx];
                s1 += parity_tap(dec2_wt1p + 4, ky, kx) * gp[kx];
            }
        }
        gx_n[static_cast<size_t>(e) * We + f] = s0;
        gx_n[(static_cast<size_t>(He) + e) * We + f] = s1;
    });
}

template <bool DROP, typename OBS>
static cudaError_t launch_as(const void* x, const void* obs, const Dec2Weights& wp,
                             const void* gbar, const void* em, const void* keepd, void* gx,
                             void* partials, int N, const Dec2Shape& sh, size_t bytes,
                             const DropCfg& cfg, cudaStream_t s) {
    const auto kernel = dec2_bwd_kernel<DROP, OBS>;
    cudaError_t e = allow_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    const int T = min(sh.TX, sh.W);
    const int blocks = ((sh.H + sh.RY - 1) / sh.RY) * ((sh.W + T - 1) / T);
    for (int n0 = 0; n0 < N; n0 += MAX_GRID_Y) {
        KERNEL_LAUNCH(kernel, dim3(blocks, grid_rows(N, n0)), DEC2_THREADS, bytes, s,
                      static_cast<const float*>(x), static_cast<const OBS*>(obs), wp,
                      static_cast<const float*>(gbar), static_cast<const float*>(em),
                      static_cast<const uint8_t*>(keepd), static_cast<float*>(gx),
                      static_cast<float*>(partials), sh, n0, cfg);
        e = cudaGetLastError();
        if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
}

template <bool DROP>
static cudaError_t launch_obs(int obs_kind, const void* x, const void* obs,
                              const Dec2Weights& wp, const void* gbar, const void* em,
                              const void* keepd, void* gx, void* partials, int N,
                              const Dec2Shape& sh, size_t bytes, const DropCfg& cfg,
                              cudaStream_t s) {
    if (obs_kind == KIND_U8)
        return launch_as<DROP, uint8_t>(x, obs, wp, gbar, em, keepd, gx, partials, N, sh, bytes, cfg, s);
    if (obs_kind == KIND_U32)
        return launch_as<DROP, uint32_t>(x, obs, wp, gbar, em, keepd, gx, partials, N, sh, bytes, cfg, s);
    return launch_as<DROP, float>(x, obs, wp, gbar, em, keepd, gx, partials, N, sh, bytes, cfg, s);
}

// x, obs, wt1 .. bt2, em, RY, TX as dec2_fwd_launch; gbar [N]; keepd: what
// dec2_fwd_launch saved for the same inputs, weights, dropout and seed (null
// without dropout).  partials: scratch of N x ceil(H / RY) x ceil(W / TX) x
// DEC2_PARTS floats; grads receives dWt1, dbt1, dWt2, dbt2 one after the
// other (50 floats); gx [N, 2, H/4, W/4].  smem must equal dec2_bwd_smem.
extern "C" int dec2_bwd_launch(const void* x, const void* obs, const void* wt1, const void* bt1,
                               const void* wt2, const void* bt2, const void* gbar, const void* em,
                               const void* keepd, void* partials, void* grads, void* gx, int N,
                               int H, int W, int RY, int TX, long long smem, int obs_kind,
                               double drop_p, int device, void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const bool drop = drop_p > 0.0;
    if (RY % 4 || RY < 4 || TX % 4 || TX < 4 || H % 4 || W % 4 || drop_p < 0.0 ||
        drop_p >= 1.0 || (drop && keepd == nullptr) || obs_kind < KIND_F32 ||
        obs_kind > KIND_U32 || (obs_kind == KIND_U32 && W % 32) ||
        static_cast<size_t>(smem) != dec2_bwd_smem(W, RY, TX))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Dec2Weights wp{static_cast<const float*>(wt1), static_cast<const float*>(bt1),
                         static_cast<const float*>(wt2), static_cast<const float*>(bt2)};
    const Dec2Shape sh{H, W, RY, TX};
    const DropCfg cfg = make_drop_cfg(drop_p, 0);
    const size_t bytes = static_cast<size_t>(smem);
    e = drop ? launch_obs<true>(obs_kind, x, obs, wp, gbar, em, keepd, gx, partials, N, sh, bytes, cfg, s)
             : launch_obs<false>(obs_kind, x, obs, wp, gbar, em, keepd, gx, partials, N, sh, bytes, cfg, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int T = TX < W ? TX : W;
    const int blocks = ((H + RY - 1) / RY) * ((W + T - 1) / T);
    KERNEL_LAUNCH(column_sums_kernel, DEC2_PARTS, 128, 0, s, static_cast<const float*>(partials),
                  blocks * N, DEC2_PARTS, static_cast<float*>(grads));
    return static_cast<int>(cudaGetLastError());
}

// Registers, static shared memory, spilled bytes and resident blocks a
// multiprocessor of the band kernel (common.cuh::kernel_occupancy) on uint8
// obs, without (drop 0) or with dropout.
extern "C" int dec2_bwd_occupancy(int drop, long long smem, int device, int* out) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t bytes = static_cast<size_t>(smem);
    return drop ? kernel_occupancy(dec2_bwd_kernel<true, uint8_t>, DEC2_THREADS, bytes, out)
                : kernel_occupancy(dec2_bwd_kernel<false, uint8_t>, DEC2_THREADS, bytes, out);
}
