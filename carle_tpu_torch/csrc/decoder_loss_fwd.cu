// decoder_loss_fwd: both decoder stages of the wrapper autoencoder and the
// error in one kernel, from an embedding in device memory.
//
// Replaces carle_tpu/ops/pallas_head.py::make_fused_decoder_loss's forward
// kernel _decoder_loss_fwd_kernel.
//
//   mid = relu(drop(conv_transpose(x, wt1, k4 s2 p1) + bt1))     [CMID, H/2, W/2]
//   y   = sigmoid(drop(conv_transpose(mid, wt2, k4 s2 p1) + bt2))[COUT, H,   W]
//   err[n] = sum over (COUT, H, W) of (obs - y)^2
//
// x is the encoder's output [N, C2, H/4, W/4] (float32), obs the cells (uint8)
// or a float32 frame.  Dropout draws the bits the whole-autoencoder kernel
// draws for the same elements (stages STAGE_DEC1 and STAGE_DEC2), so with one
// seed encoder_fwd followed by this kernel gives ae_loss_fwd's result.
//
// Bound on an H100: bytes for cells (one byte of obs a cell against 8 CMID
// COUT + 2 C2 CMID flops), operations for wider decoders.  Design: ae_loss_fwd
// without its encoder bands.  A block owns a band of RY output rows, stages the
// RY/4 + 2 embedding rows the band needs (zero outside the embedding), computes
// the middle band (RY/2 + 2 rows) into shared memory, then the reconstruction
// and its squared error; a second launch adds a universe's partials in a
// fixed order.
#include "ae_bands.cuh"

template <bool DROP, typename OBS>
__global__ void decoder_loss_fwd_kernel(
    const float* __restrict__ x, const OBS* __restrict__ obs,
    const float* __restrict__ wt1, const float* __restrict__ bt1,
    const float* __restrict__ wt2, const float* __restrict__ bt2,
    float* __restrict__ partials, AEShape sh, DropCfg cfg) {
    const int n = blockIdx.y;
    const int Y0 = blockIdx.x * sh.RY;
    const size_t plane = static_cast<size_t>(sh.H) * sh.W;

    extern __shared__ float smem[];
    AEBand b = ae_band_layout(smem, sh, Y0);
    float* red = b.end;  // 32
    decoder_band_forward<DROP>(b, x + static_cast<size_t>(n) * sh.C2 * (plane / 16), wt1, bt1,
                               wt2, bt2, sh, n, cfg);
    decoder_stage2_error<DROP>(b, red, obs, sh, Y0, n, cfg, partials);
}

template <bool DROP, typename OBS>
static int launch_as(const void* x, const void* obs, const void* wt1, const void* bt1,
                     const void* wt2, const void* bt2, void* partials, int N,
                     const AEShape& sh, size_t bytes, const DropCfg& cfg, cudaStream_t s) {
    const auto kernel = decoder_loss_fwd_kernel<DROP, OBS>;
    cudaError_t e = allow_smem(kernel, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int bands = (sh.H + sh.RY - 1) / sh.RY;
    KERNEL_LAUNCH(kernel, dim3(bands, N), 256, bytes, s, static_cast<const float*>(x),
                  static_cast<const OBS*>(obs), static_cast<const float*>(wt1),
                  static_cast<const float*>(bt1), static_cast<const float*>(wt2),
                  static_cast<const float*>(bt2), static_cast<float*>(partials), sh, cfg);
    return static_cast<int>(cudaGetLastError());
}

template <bool DROP>
static int launch_obs(int obs_kind, const void* x, const void* obs, const void* wt1,
                      const void* bt1, const void* wt2, const void* bt2, void* partials, int N,
                      const AEShape& sh, size_t bytes, const DropCfg& cfg, cudaStream_t s) {
    if (obs_kind == KIND_U8)
        return launch_as<DROP, uint8_t>(x, obs, wt1, bt1, wt2, bt2, partials, N, sh, bytes, cfg, s);
    if (obs_kind == KIND_U32)
        return launch_as<DROP, uint32_t>(x, obs, wt1, bt1, wt2, bt2, partials, N, sh, bytes, cfg, s);
    return launch_as<DROP, float>(x, obs, wt1, bt1, wt2, bt2, partials, N, sh, bytes, cfg, s);
}

// obs_kind: KIND_F32, KIND_U8 cells or KIND_U32 packed words.
// smem must be 4 (ae_band_floats with C1 = 0, + 32) bytes
// (ops/cuda_stages.py::_decoder_smem); partials is scratch of N x bands
// floats, bands = ceil(H / RY).  H and W are the output's.
extern "C" int decoder_loss_fwd_launch(const void* x, const void* obs, const void* wt1,
                                       const void* bt1, const void* wt2, const void* bt2,
                                       void* partials, void* err, int N, int H, int W, int C2,
                                       int CMID, int COUT, int RY, long long smem,
                                       int obs_kind, double drop_p, unsigned long long seed,
                                       int device, void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const AEShape sh{H, W, 0, C2, CMID, COUT, RY};
    const size_t bytes = static_cast<size_t>(smem);
    if (C2 > MAXC || CMID > MAXC || COUT > MAXC || RY % 4 || H % 4 || W % 4 || drop_p < 0.0 ||
        drop_p >= 1.0 || bytes != 4 * (ae_band_floats(sh) + 32) || obs_kind < KIND_F32 ||
        obs_kind > KIND_U32 || (obs_kind == KIND_U32 && W % 32))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const DropCfg cfg = make_drop_cfg(drop_p, seed);
    int rc;
    if (drop_p > 0.0)
        rc = launch_obs<true>(obs_kind, x, obs, wt1, bt1, wt2, bt2, partials, N, sh, bytes, cfg, s);
    else
        rc = launch_obs<false>(obs_kind, x, obs, wt1, bt1, wt2, bt2, partials, N, sh, bytes, cfg, s);
    if (rc != 0) return rc;
    const int bands = (H + RY - 1) / RY;
    KERNEL_LAUNCH(row_sums_kernel, (N + 127) / 128, 128, 0, s,
                  static_cast<const float*>(partials), bands, static_cast<float*>(err), N);
    return static_cast<int>(cudaGetLastError());
}
