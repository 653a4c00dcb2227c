// decoder_loss_fwd: both decoder stages of the wrapper autoencoder and the
// error in one kernel, from an embedding in device memory.
//
// Replaces carle_tpu/ops/pallas_head.py::make_fused_decoder_loss's forward
// kernel _decoder_loss_fwd_kernel and, with per-instance error row weights
// em [N, H] (each output row's squared error times its weight), that of
// make_fused_decoder_loss_banded (the same kernel with its em input).
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
// fixed order.  A universe too wide for one band of the whole width in
// shared memory is also cut into tiles of TX output columns, each block
// staging its tile's embedding and middle columns with a one-column halo
// (ae_bands.cuh); with one tile the launch is the untiled one.  Instances
// beyond the grid's 65,535 rows go in further launches of the same grid.
#include "ae_bands.cuh"

// Block (band * tiles + tile, n - N0): output rows [band RY, +RY) and
// columns [tile TX, +TX) of instance n.  GENERAL: column tiles or row
// weights; without it the offsets are the whole width's constants.
template <bool DROP, typename OBS, bool GENERAL>
__global__ void decoder_loss_fwd_kernel(
    const float* __restrict__ x, const OBS* __restrict__ obs,
    const float* __restrict__ wt1, const float* __restrict__ bt1,
    const float* __restrict__ wt2, const float* __restrict__ bt2,
    const float* __restrict__ em, float* __restrict__ partials, AEShape sh, int TX, int N0,
    DropCfg cfg) {
    const int n = N0 + blockIdx.y;
    const int tiles = GENERAL ? (sh.W + TX - 1) / TX : 1;
    const int band = GENERAL ? blockIdx.x / tiles : blockIdx.x;
    const int tile = GENERAL ? blockIdx.x - band * tiles : 0;
    const int Y0 = band * sh.RY, X0 = tile * TX;
    const int TXb = GENERAL ? min(TX, sh.W - X0) : sh.W;
    const size_t plane = static_cast<size_t>(sh.H) * sh.W;

    extern __shared__ float smem[];
    AEBand b = decoder_band_layout<GENERAL>(smem, sh, Y0, X0, TXb);
    float* red = b.end;  // 32
    decoder_band_forward<DROP>(b, x + static_cast<size_t>(n) * sh.C2 * (plane / 16), wt1, bt1,
                               wt2, bt2, sh, n, cfg);
    decoder_stage2_error_tile<DROP>(
        b, red, obs, sh, Y0, X0, TXb,
        GENERAL && em != nullptr ? em + static_cast<size_t>(n) * sh.H : nullptr, n,
        static_cast<size_t>(n) * gridDim.x + blockIdx.x, cfg, partials);
}

template <bool DROP, typename OBS, bool GENERAL>
static int launch_as(const void* x, const void* obs, const void* wt1, const void* bt1,
                     const void* wt2, const void* bt2, const void* em, void* partials, int N,
                     const AEShape& sh, int TX, size_t bytes, const DropCfg& cfg,
                     cudaStream_t s) {
    const auto kernel = decoder_loss_fwd_kernel<DROP, OBS, GENERAL>;
    cudaError_t e = allow_smem(kernel, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int blocks = ((sh.H + sh.RY - 1) / sh.RY) * ((sh.W + TX - 1) / TX);
    for (int n0 = 0; n0 < N; n0 += MAX_GRID_Y) {
        KERNEL_LAUNCH(kernel, dim3(blocks, grid_rows(N, n0)), 256, bytes, s,
                      static_cast<const float*>(x), static_cast<const OBS*>(obs),
                      static_cast<const float*>(wt1), static_cast<const float*>(bt1),
                      static_cast<const float*>(wt2), static_cast<const float*>(bt2),
                      static_cast<const float*>(em), static_cast<float*>(partials), sh, TX,
                      n0, cfg);
        e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    return 0;
}

template <bool DROP, bool GENERAL>
static int launch_obs(int obs_kind, const void* x, const void* obs, const void* wt1,
                      const void* bt1, const void* wt2, const void* bt2, const void* em,
                      void* partials, int N, const AEShape& sh, int TX, size_t bytes,
                      const DropCfg& cfg, cudaStream_t s) {
    if (obs_kind == KIND_U8)
        return launch_as<DROP, uint8_t, GENERAL>(x, obs, wt1, bt1, wt2, bt2, em, partials, N, sh, TX, bytes, cfg, s);
    if (obs_kind == KIND_U32)
        return launch_as<DROP, uint32_t, GENERAL>(x, obs, wt1, bt1, wt2, bt2, em, partials, N, sh, TX, bytes, cfg, s);
    return launch_as<DROP, float, GENERAL>(x, obs, wt1, bt1, wt2, bt2, em, partials, N, sh, TX, bytes, cfg, s);
}

template <bool DROP>
static int launch_general(int obs_kind, const void* x, const void* obs, const void* wt1,
                          const void* bt1, const void* wt2, const void* bt2, const void* em,
                          void* partials, int N, const AEShape& sh, int TX, size_t bytes,
                          const DropCfg& cfg, cudaStream_t s) {
    if (em != nullptr || TX < sh.W)
        return launch_obs<DROP, true>(obs_kind, x, obs, wt1, bt1, wt2, bt2, em, partials, N, sh, TX, bytes, cfg, s);
    return launch_obs<DROP, false>(obs_kind, x, obs, wt1, bt1, wt2, bt2, em, partials, N, sh, TX, bytes, cfg, s);
}

// obs_kind: KIND_F32, KIND_U8 cells or KIND_U32 packed words; em: float32
// [N, H] row weights or null.  TX: output columns a tile (a multiple of 4;
// W or more for one tile).  smem must be 4 (decoder_band_floats + 32) bytes
// (ops/cuda_stages.py::_decoder_fwd_smem); partials is scratch of N x bands
// x tiles floats, bands = ceil(H / RY).  H and W are the output's.
extern "C" int decoder_loss_fwd_launch(const void* x, const void* obs, const void* wt1,
                                       const void* bt1, const void* wt2, const void* bt2,
                                       const void* em, void* partials, void* err, int N,
                                       int H, int W, int C2, int CMID, int COUT, int RY,
                                       int TX, long long smem, int obs_kind, double drop_p,
                                       unsigned long long seed, int device, void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const AEShape sh{H, W, 0, C2, CMID, COUT, RY};
    const size_t bytes = static_cast<size_t>(smem);
    if (C2 > MAXC || CMID > MAXC || COUT > MAXC || RY % 4 || H % 4 || W % 4 || TX < 4 ||
        TX % 4 || drop_p < 0.0 || drop_p >= 1.0 ||
        bytes != 4 * (decoder_band_floats(sh, TX) + 32) || obs_kind < KIND_F32 ||
        obs_kind > KIND_U32 || (obs_kind == KIND_U32 && W % 32))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const DropCfg cfg = make_drop_cfg(drop_p, seed);
    int rc;
    if (drop_p > 0.0)
        rc = launch_general<true>(obs_kind, x, obs, wt1, bt1, wt2, bt2, em, partials, N, sh, TX, bytes, cfg, s);
    else
        rc = launch_general<false>(obs_kind, x, obs, wt1, bt1, wt2, bt2, em, partials, N, sh, TX, bytes, cfg, s);
    if (rc != 0) return rc;
    const int blocks = ((H + RY - 1) / RY) * ((W + TX - 1) / TX);
    KERNEL_LAUNCH(row_sums_kernel, (N + 127) / 128, 128, 0, s,
                  static_cast<const float*>(partials), blocks, static_cast<float*>(err), N);
    return static_cast<int>(cudaGetLastError());
}
