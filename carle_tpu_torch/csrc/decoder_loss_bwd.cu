// decoder_loss_bwd: the gradients of decoder_loss_fwd's error.
//
// Replaces carle_tpu/ops/pallas_head.py::make_fused_decoder_loss's backward
// kernel _decoder_loss_bwd_kernel: from the embedding x, the decoder's four
// parameters, obs, the dropout seed and the cotangent gbar [N] of the
// per-instance error it gives dWt1, dbt1, dWt2, dbt2 and gx, the embedding's
// cotangent, recomputing the forward with its dropout mask; with error row
// weights em [N, H] the backward of make_fused_decoder_loss_banded (each
// output row's cotangent times its weight; em gets no gradient).
//
// Staged as ae_loss_bwd, each stage a launch whose blocks own their positions
// exclusively, so nothing is added twice and no float is added atomically
// (the same bits every run):
//
//   1. decoder_loss_bwd_kernel: a block owns a band of RY output rows; the
//      band's forward from the embedding in device memory (ae_bands.cuh),
//      then the decoder's backward of the band (decoder_bwd.cuh): its part of
//      the four parameter gradients and the middle cotangent gmid
//      [N, CMID, H/2, W/2] in device memory;
//   2. deconv_input_grad_kernel: gx [N, C2, H/4, W/4] from gmid and wt1 (the
//      one-row halo of gmid read from device memory), one thread an element;
//   3. column_sums_kernel adds the blocks' partial sums in a fixed order.
//
// A universe too wide for one band of the whole width in shared memory is
// also cut into tiles of TX output columns (decoder_loss_fwd.cu); a block
// then owns its tile's output and middle columns and reads the halo's from
// its staged windows.  Instances beyond the grid's 65,535 rows go in
// further launches of stage 1 before stages 2 and 3 run once.
//
// Bound: operations (the recompute, two dW and two input cotangents).
#include "decoder_bwd.cuh"

__host__ __device__ inline size_t decoder_loss_bwd_smem(const AEShape& sh, int TX) {
    return 4 * (decoder_band_floats(sh, TX) + decoder_bwd_floats(sh, TX));
}

// Block (band * tiles + tile, n - N0) as decoder_loss_fwd_kernel; GENERAL:
// column tiles or row weights (a block then owns only its tile's columns).
template <bool DROP, bool GENERAL, typename OBS>
__global__ void decoder_loss_bwd_kernel(
    const float* __restrict__ x, const OBS* __restrict__ obs,
    const float* __restrict__ wt1, const float* __restrict__ bt1,
    const float* __restrict__ wt2, const float* __restrict__ bt2,
    const float* __restrict__ gbar, const float* __restrict__ em, float* __restrict__ gmid,
    float* __restrict__ partials, AEShape sh, int TX, int N0, DropCfg cfg) {
    const int n = N0 + blockIdx.y;
    const int tiles = GENERAL ? (sh.W + TX - 1) / TX : 1;
    const int band = GENERAL ? blockIdx.x / tiles : blockIdx.x;
    const int tile = GENERAL ? blockIdx.x - band * tiles : 0;
    const int Y0 = band * sh.RY, X0 = tile * TX;
    const int TXb = GENERAL ? min(TX, sh.W - X0) : sh.W;
    const size_t plane = static_cast<size_t>(sh.H) * sh.W;

    extern __shared__ float smem[];
    AEBand b = decoder_band_layout<GENERAL>(smem, sh, Y0, X0, TXb);
    decoder_band_forward<DROP>(b, x + static_cast<size_t>(n) * sh.C2 * (plane / 16), wt1, bt1,
                               wt2, bt2, sh, n, cfg);
    decoder_backward_tile<DROP, GENERAL>(
        b, b.end, cells_at(obs, static_cast<size_t>(n) * sh.COUT * plane), gbar[n],
        GENERAL && em != nullptr ? em + static_cast<size_t>(n) * sh.H : nullptr, gmid,
        partials, static_cast<size_t>(n) * gridDim.x + blockIdx.x, sh, Y0, X0, TXb, n, cfg);
}

template <bool DROP, bool GENERAL, typename OBS>
static int launch_as(const void* x, const void* obs, const void* wt1, const void* bt1,
                     const void* wt2, const void* bt2, const void* gbar, const void* em,
                     void* gmid, void* partials, int N, const AEShape& sh, int TX, size_t bytes,
                     const DropCfg& cfg, cudaStream_t s) {
    const auto kernel = decoder_loss_bwd_kernel<DROP, GENERAL, OBS>;
    cudaError_t e = allow_smem(kernel, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int blocks = ((sh.H + sh.RY - 1) / sh.RY) * ((sh.W + TX - 1) / TX);
    for (int n0 = 0; n0 < N; n0 += MAX_GRID_Y) {
        KERNEL_LAUNCH(kernel, dim3(blocks, grid_rows(N, n0)), 256, bytes, s,
                      static_cast<const float*>(x), static_cast<const OBS*>(obs),
                      static_cast<const float*>(wt1), static_cast<const float*>(bt1),
                      static_cast<const float*>(wt2), static_cast<const float*>(bt2),
                      static_cast<const float*>(gbar), static_cast<const float*>(em),
                      static_cast<float*>(gmid), static_cast<float*>(partials), sh, TX, n0,
                      cfg);
        e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    return 0;
}

template <bool DROP, bool GENERAL>
static int launch_obs(int obs_kind, const void* x, const void* obs, const void* wt1,
                      const void* bt1, const void* wt2, const void* bt2, const void* gbar,
                      const void* em, void* gmid, void* partials, int N, const AEShape& sh,
                      int TX, size_t bytes, const DropCfg& cfg, cudaStream_t s) {
    if (obs_kind == KIND_U8)
        return launch_as<DROP, GENERAL, uint8_t>(x, obs, wt1, bt1, wt2, bt2, gbar, em, gmid, partials, N, sh, TX, bytes, cfg, s);
    if (obs_kind == KIND_U32)
        return launch_as<DROP, GENERAL, uint32_t>(x, obs, wt1, bt1, wt2, bt2, gbar, em, gmid, partials, N, sh, TX, bytes, cfg, s);
    return launch_as<DROP, GENERAL, float>(x, obs, wt1, bt1, wt2, bt2, gbar, em, gmid, partials, N, sh, TX, bytes, cfg, s);
}

template <bool DROP>
static int launch_cols(int obs_kind, const void* x, const void* obs, const void* wt1,
                       const void* bt1, const void* wt2, const void* bt2, const void* gbar,
                       const void* em, void* gmid, void* partials, int N, const AEShape& sh,
                       int TX, size_t bytes, const DropCfg& cfg, cudaStream_t s) {
    if (em != nullptr || TX < sh.W)
        return launch_obs<DROP, true>(obs_kind, x, obs, wt1, bt1, wt2, bt2, gbar, em, gmid, partials, N, sh, TX, bytes, cfg, s);
    return launch_obs<DROP, false>(obs_kind, x, obs, wt1, bt1, wt2, bt2, gbar, em, gmid, partials, N, sh, TX, bytes, cfg, s);
}

// obs_kind: KIND_F32, KIND_U8 cells or KIND_U32 packed words; em: float32
// [N, H] row weights or null; TX as decoder_loss_fwd_launch.
// Scratch: gmid N x CMID x H/2 x W/2, partials N x bands x tiles x K with
// K = C2 CMID 16 + CMID + CMID COUT 16 + COUT; grads receives dWt1, dbt1, dWt2,
// dbt2 one after the other, gx the embedding's cotangent.  smem must equal
// decoder_loss_bwd_smem (ops/cuda_stages.py computes the same).
extern "C" int decoder_loss_bwd_launch(
    const void* x, const void* obs, const void* wt1, const void* bt1, const void* wt2,
    const void* bt2, const void* gbar, const void* em, void* gmid, void* partials,
    void* grads, void* gx, int N, int H, int W, int C2, int CMID, int COUT, int RY, int TX,
    long long smem, int obs_kind, double drop_p, unsigned long long seed, int device,
    void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const AEShape sh{H, W, 0, C2, CMID, COUT, RY};
    const size_t bytes = static_cast<size_t>(smem);
    if (C2 > MAXC || CMID > MAXC || COUT > MAXC || RY % 4 || H % 4 || W % 4 || TX < 4 ||
        TX % 4 || drop_p < 0.0 || drop_p >= 1.0 || bytes != decoder_loss_bwd_smem(sh, TX) ||
        obs_kind < KIND_F32 || obs_kind > KIND_U32 || (obs_kind == KIND_U32 && W % 32))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const DropCfg cfg = make_drop_cfg(drop_p, seed);
    int rc;
    if (drop_p > 0.0)
        rc = launch_cols<true>(obs_kind, x, obs, wt1, bt1, wt2, bt2, gbar, em, gmid, partials, N, sh, TX, bytes, cfg, s);
    else
        rc = launch_cols<false>(obs_kind, x, obs, wt1, bt1, wt2, bt2, gbar, em, gmid, partials, N, sh, TX, bytes, cfg, s);
    if (rc != 0) return rc;
    const size_t total = static_cast<size_t>(N) * C2 * (H / 4) * (W / 4);
    KERNEL_LAUNCH(deconv_input_grad_kernel, static_cast<int>((total + 255) / 256), 256, 0, s,
                  static_cast<const float*>(gmid), static_cast<const float*>(wt1),
                  static_cast<float*>(gx), N, H / 2, W / 2, C2, CMID);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const int K = C2 * CMID * 16 + CMID + CMID * COUT * 16 + COUT;
    const int blocks = ((H + RY - 1) / RY) * ((W + TX - 1) / TX);
    KERNEL_LAUNCH(column_sums_kernel, K, 128, 0, s, static_cast<const float*>(partials),
                  blocks * N, K, static_cast<float*>(grads));
    return static_cast<int>(cudaGetLastError());
}
