// decoder_loss_bwd: the gradients of decoder_loss_fwd's error.
//
// Replaces carle_tpu/ops/pallas_head.py::make_fused_decoder_loss's backward
// kernel _decoder_loss_bwd_kernel: from the embedding x, the decoder's four
// parameters, obs, the dropout seed and the cotangent gbar [N] of the
// per-instance error it gives dWt1, dbt1, dWt2, dbt2 and gx, the embedding's
// cotangent, recomputing the forward with its dropout mask.
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
// Bound: operations (the recompute, two dW and two input cotangents).
#include "decoder_bwd.cuh"

__host__ __device__ inline size_t decoder_loss_bwd_smem(const AEShape& sh) {
    return 4 * (ae_band_floats(sh) + decoder_bwd_floats(sh));
}

template <bool DROP, typename OBS>
__global__ void decoder_loss_bwd_kernel(
    const float* __restrict__ x, const OBS* __restrict__ obs,
    const float* __restrict__ wt1, const float* __restrict__ bt1,
    const float* __restrict__ wt2, const float* __restrict__ bt2,
    const float* __restrict__ gbar, float* __restrict__ gmid,
    float* __restrict__ partials, AEShape sh, DropCfg cfg) {
    const int n = blockIdx.y;
    const int Y0 = blockIdx.x * sh.RY;
    const size_t plane = static_cast<size_t>(sh.H) * sh.W;

    extern __shared__ float smem[];
    AEBand b = ae_band_layout(smem, sh, Y0);
    decoder_band_forward<DROP>(b, x + static_cast<size_t>(n) * sh.C2 * (plane / 16), wt1, bt1,
                               wt2, bt2, sh, n, cfg);
    decoder_backward_band<DROP>(b, b.end, cells_at(obs, static_cast<size_t>(n) * sh.COUT * plane), gbar[n],
                                gmid, partials, sh, Y0, n, cfg);
}

template <bool DROP, typename OBS>
static int launch_as(const void* x, const void* obs, const void* wt1, const void* bt1,
                     const void* wt2, const void* bt2, const void* gbar, void* gmid,
                     void* partials, int N, const AEShape& sh, size_t bytes,
                     const DropCfg& cfg, cudaStream_t s) {
    const auto kernel = decoder_loss_bwd_kernel<DROP, OBS>;
    cudaError_t e = allow_smem(kernel, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int bands = (sh.H + sh.RY - 1) / sh.RY;
    KERNEL_LAUNCH(kernel, dim3(bands, N), 256, bytes, s, static_cast<const float*>(x),
                  static_cast<const OBS*>(obs), static_cast<const float*>(wt1),
                  static_cast<const float*>(bt1), static_cast<const float*>(wt2),
                  static_cast<const float*>(bt2), static_cast<const float*>(gbar),
                  static_cast<float*>(gmid), static_cast<float*>(partials), sh, cfg);
    return static_cast<int>(cudaGetLastError());
}

template <bool DROP>
static int launch_obs(int obs_kind, const void* x, const void* obs, const void* wt1,
                      const void* bt1, const void* wt2, const void* bt2, const void* gbar,
                      void* gmid, void* partials, int N, const AEShape& sh, size_t bytes,
                      const DropCfg& cfg, cudaStream_t s) {
    if (obs_kind == KIND_U8)
        return launch_as<DROP, uint8_t>(x, obs, wt1, bt1, wt2, bt2, gbar, gmid, partials, N, sh, bytes, cfg, s);
    if (obs_kind == KIND_U32)
        return launch_as<DROP, uint32_t>(x, obs, wt1, bt1, wt2, bt2, gbar, gmid, partials, N, sh, bytes, cfg, s);
    return launch_as<DROP, float>(x, obs, wt1, bt1, wt2, bt2, gbar, gmid, partials, N, sh, bytes, cfg, s);
}

// obs_kind: KIND_F32, KIND_U8 cells or KIND_U32 packed words.
// Scratch: gmid N x CMID x H/2 x W/2, partials N x ceil(H / RY) x K with
// K = C2 CMID 16 + CMID + CMID COUT 16 + COUT; grads receives dWt1, dbt1, dWt2,
// dbt2 one after the other, gx the embedding's cotangent.  smem must equal
// decoder_loss_bwd_smem with C1 = 0 (ops/cuda_stages.py computes the same).
extern "C" int decoder_loss_bwd_launch(
    const void* x, const void* obs, const void* wt1, const void* bt1, const void* wt2,
    const void* bt2, const void* gbar, void* gmid, void* partials, void* grads, void* gx,
    int N, int H, int W, int C2, int CMID, int COUT, int RY, long long smem, int obs_kind,
    double drop_p, unsigned long long seed, int device, void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const AEShape sh{H, W, 0, C2, CMID, COUT, RY};
    const size_t bytes = static_cast<size_t>(smem);
    if (C2 > MAXC || CMID > MAXC || COUT > MAXC || RY % 4 || H % 4 || W % 4 || drop_p < 0.0 ||
        drop_p >= 1.0 || bytes != decoder_loss_bwd_smem(sh) || obs_kind < KIND_F32 ||
        obs_kind > KIND_U32 || (obs_kind == KIND_U32 && W % 32))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const DropCfg cfg = make_drop_cfg(drop_p, seed);
    int rc;
    if (drop_p > 0.0)
        rc = launch_obs<true>(obs_kind, x, obs, wt1, bt1, wt2, bt2, gbar, gmid, partials, N, sh, bytes, cfg, s);
    else
        rc = launch_obs<false>(obs_kind, x, obs, wt1, bt1, wt2, bt2, gbar, gmid, partials, N, sh, bytes, cfg, s);
    if (rc != 0) return rc;
    const size_t total = static_cast<size_t>(N) * C2 * (H / 4) * (W / 4);
    KERNEL_LAUNCH(deconv_input_grad_kernel, static_cast<int>((total + 255) / 256), 256, 0, s,
                  static_cast<const float*>(gmid), static_cast<const float*>(wt1),
                  static_cast<float*>(gx), N, H / 2, W / 2, C2, CMID);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const int K = C2 * CMID * 16 + CMID + CMID * COUT * 16 + COUT;
    KERNEL_LAUNCH(column_sums_kernel, K, 128, 0, s, static_cast<const float*>(partials),
                  ((H + RY - 1) / RY) * N, K, static_cast<float*>(grads));
    return static_cast<int>(cudaGetLastError());
}
