// encoder_fwd: both conv stages of a wrapper-net encoder in one kernel.
//
// Replaces carle_tpu/ops/pallas_head.py::make_fused_encoder's forward kernel
// _enc_fwd_kernel, with its per-instance stage-1 row-validity mask [N, H/p1]
// (null: all ones) multiplying the pooled stage-1 rows stage 2 reads.
//
//   x1  = maxpool_p1(relu(drop(conv3x3(x, w1) + b1)))    [C1, H/p1, W/p1]
//   out = maxpool_p2(relu(drop(conv3x3(x1, w2) + b2)))   [C2, H/(p1 p2), W/(p1 p2)]
//
// with zero padding 1 for both convolutions; x is the universe (one input
// channel) as uint8 cells or as packed uint32 words [H, W/32], expanded to
// bytes in shared memory as it is staged (common.cuh).  relu and max commute, so each pooled value is
// relu(max over the window of the pre-activation).  Dropout (training only,
// drop_p > 0) is in-kernel Philox indexed by the element (philox.cuh); with
// drop_p == 0 the kernel is instantiated without it and draws nothing.
//
// Bound on an H100: operations.  Stage 1 does 9 C1 multiply-adds a cell on
// float32 (no tensor cores: the channels are 1 to 4 wide) against one byte
// read a cell, so the card's 67 TFLOP/s float32 rate is the limit, above
// the bytes.  Design: a block owns a band of R2 output rows of one universe.
// It stages the input rows that band needs (with a zero halo) in shared
// memory as bytes, computes the pooled stage-1 activation of the band plus
// one zero-padded halo row above and below into shared memory, then stage 2
// from there; only the pooled output is written, so the stage-1 activation
// never reaches device memory.  The halo rows are computed twice, by the
// two blocks that share them.  A universe too wide for one band of the whole
// width in shared memory is also cut into tiles of TWo output columns: a
// block stages its tile's input columns and computes its stage-1 columns
// with a one-column halo each side, zero only at the universe's edges; one
// tile is the untiled launch.  Instances beyond the grid's 65,535 rows go in
// further launches of the same grid.
#include "net_stages.cuh"

// Shared memory of a block of R2 output rows and TWo output columns, the
// widest tile's: floats for the weights and the stage-1 band, then the
// staged input bytes (ops/cuda_head.py::_encoder_smem computes the same).
__host__ __device__ inline size_t encoder_fwd_smem(int W, int C1, int C2, int P1, int P2,
                                                   int R2, int TWo) {
    const int W1 = W / P1, Wo = W1 / P2, T = TWo < Wo ? TWo : Wo;
    const int XR = R2 * P2 + 2, IR = XR * P1 + 2;
    const size_t floats = static_cast<size_t>(C1) * 9 + C1 + C2 * C1 * 9 + C2 +
                          static_cast<size_t>(C1) * XR * (T * P2 + 2);
    return 4 * floats + static_cast<size_t>(IR) * (widest_window(W1, T * P2, 1) * P1 + 2);
}

// Block (band * tiles + tile, n - N0): output rows [band R2, +R2) and
// columns [tile TWo, +TWo) of instance n.  GENERAL: column tiles or a row
// mask; without it the offsets are the whole width's constants, the code
// the untiled kernel's.
template <typename T, int P1, int P2, bool DROP, bool GENERAL>
__global__ void encoder_fwd_kernel(const T* __restrict__ x,
                                   const float* __restrict__ w1,
                                   const float* __restrict__ b1,
                                   const float* __restrict__ w2,
                                   const float* __restrict__ b2,
                                   const float* __restrict__ mask,
                                   float* __restrict__ out, int H, int W, int C1,
                                   int C2, int R2, int TWo, int N0, DropCfg cfg) {
    const int H1 = H / P1, W1 = W / P1;
    const int Ho = H1 / P2, Wo = W1 / P2;
    const int n = N0 + blockIdx.y;
    const int tiles = GENERAL ? (Wo + TWo - 1) / TWo : 1;
    const int band = GENERAL ? blockIdx.x / tiles : blockIdx.x;
    const int tile = GENERAL ? blockIdx.x - band * tiles : 0;
    const int o0 = band * R2;              // first output row of the band
    const int xr0 = o0 * P2 - 1;           // first stage-1 row held
    const int XR = R2 * P2 + 2;            // stage-1 rows held
    const int ir0 = xr0 * P1 - 1;          // first input row held
    const int IR = XR * P1 + 2;            // input rows held
    const int oc0 = tile * TWo;            // first output column of the tile
    const int TW = GENERAL ? min(TWo, Wo - oc0) : Wo;  // its output columns
    const int xc0 = oc0 * P2 - 1;          // first stage-1 column held
    const int XW = GENERAL ? TW * P2 + 2 : W1 + 2;     // stage-1 columns held
    int ic0 = -1, IW = W + 2;              // the input columns those inside need
    if (GENERAL) {
        clamped_window(oc0 * P2, TW * P2, 1, W1, ic0, IW);
        ic0 = ic0 * P1 - 1;
        IW = IW * P1 + 2;
    }

    extern __shared__ float smem[];
    float* w1s = smem;                     // C1 * 9
    float* b1s = w1s + C1 * 9;             // C1
    float* w2s = b1s + C1;                 // C2 * C1 * 9
    float* b2s = w2s + C2 * C1 * 9;        // C2
    float* x1s = b2s + C2;                 // C1 x XR x XW
    uint8_t* xs = reinterpret_cast<uint8_t*>(x1s + C1 * XR * XW);  // IR x IW

    copy_floats(w1s, w1, C1 * 9);
    copy_floats(b1s, b1, C1);
    copy_floats(w2s, w2, C2 * C1 * 9);
    copy_floats(b2s, b2, C2);
    stage_cells(xs, cells_at(x, static_cast<size_t>(n) * H * W), ir0, IR, ic0, IW, H, W);
    __syncthreads();

    // stage 1: pooled activation of XR rows, zero outside the universe
    encoder_stage1_band<P1, DROP>(
        xs, ir0, ic0, IW, W, w1s, b1s, C1, x1s, xr0, XR, xc0, XW, H1,
        GENERAL && mask != nullptr ? mask + static_cast<size_t>(n) * H1 : nullptr, n, cfg);
    __syncthreads();

    // stage 2: pooled output rows [o0, o0 + R2), columns [oc0, oc0 + TW)
    float* on = out + static_cast<size_t>(n) * C2 * Ho * Wo + static_cast<size_t>(o0) * Wo + oc0;
    encoder_stage2_band<P2, DROP, false>(x1s, xr0, XR, xc0, XW, w2s, b2s, C1, C2, on,
                                         static_cast<size_t>(Ho) * Wo, Wo, o0, R2, Ho, oc0, TW,
                                         n, cfg);
}

template <typename T, int P1, int P2, bool DROP, bool GENERAL>
static int launch_as(const void* x, const void* w1, const void* b1, const void* w2,
                     const void* b2, const void* mask, void* out, int N, int H, int W, int C1,
                     int C2, int R2, int TWo, size_t smem, const DropCfg& cfg, cudaStream_t s) {
    const auto kernel = encoder_fwd_kernel<T, P1, P2, DROP, GENERAL>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int Ho = H / (P1 * P2), Wo = W / (P1 * P2);
    const int blocks = ((Ho + R2 - 1) / R2) * ((Wo + TWo - 1) / TWo);
    for (int n0 = 0; n0 < N; n0 += MAX_GRID_Y) {
        KERNEL_LAUNCH(kernel, dim3(blocks, grid_rows(N, n0)), 256, smem, s,
                      static_cast<const T*>(x), static_cast<const float*>(w1),
                      static_cast<const float*>(b1), static_cast<const float*>(w2),
                      static_cast<const float*>(b2), static_cast<const float*>(mask),
                      static_cast<float*>(out), H, W, C1, C2, R2, TWo, n0, cfg);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}

template <typename T, int P1, int P2, bool DROP>
static int launch_general(const void* x, const void* w1, const void* b1, const void* w2,
                          const void* b2, const void* mask, void* out, int N, int H, int W,
                          int C1, int C2, int R2, int TWo, size_t smem, const DropCfg& cfg,
                          cudaStream_t s) {
    if (mask != nullptr || TWo < W / (P1 * P2))
        return launch_as<T, P1, P2, DROP, true>(x, w1, b1, w2, b2, mask, out, N, H, W, C1, C2, R2, TWo, smem, cfg, s);
    return launch_as<T, P1, P2, DROP, false>(x, w1, b1, w2, b2, mask, out, N, H, W, C1, C2, R2, TWo, smem, cfg, s);
}

template <typename T, int P1, int P2>
static int launch_type(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, const void* mask, void* out, int N, int H, int W, int C1,
                       int C2, int R2, int TWo, size_t smem, double drop_p, const DropCfg& cfg,
                       cudaStream_t s) {
    if (drop_p > 0.0)
        return launch_general<T, P1, P2, true>(x, w1, b1, w2, b2, mask, out, N, H, W, C1, C2, R2, TWo, smem, cfg, s);
    return launch_general<T, P1, P2, false>(x, w1, b1, w2, b2, mask, out, N, H, W, C1, C2, R2, TWo, smem, cfg, s);
}

template <int P1, int P2>
static int launch(const void* x, const void* w1, const void* b1, const void* w2,
                  const void* b2, const void* mask, void* out, int N, int H, int W, int C1,
                  int C2, int R2, int TWo, long long smem, int x_kind, double drop_p,
                  unsigned long long seed, cudaStream_t s) {
    if (TWo < 1 || static_cast<size_t>(smem) != encoder_fwd_smem(W, C1, C2, P1, P2, R2, TWo))
        return static_cast<int>(cudaErrorInvalidValue);
    const DropCfg cfg = make_drop_cfg(drop_p, seed);
    const size_t bytes = static_cast<size_t>(smem);
    if (x_kind == KIND_U32)
        return launch_type<uint32_t, P1, P2>(x, w1, b1, w2, b2, mask, out, N, H, W, C1, C2, R2, TWo, bytes, drop_p, cfg, s);
    return launch_type<uint8_t, P1, P2>(x, w1, b1, w2, b2, mask, out, N, H, W, C1, C2, R2, TWo, bytes, drop_p, cfg, s);
}

// smem must equal encoder_fwd_smem.  x_kind is KIND_U8 (cells [N, 1, H, W])
// or KIND_U32 (packed words [N, 1, H, W/32]); mask is float32 [N, H/p1] or
// null; TWo: output columns a tile (W/(p1 p2) or more for one tile).
extern "C" int encoder_fwd_launch(const void* x, const void* w1, const void* b1,
                                  const void* w2, const void* b2, const void* mask, void* out,
                                  int N, int H, int W, int C1, int C2, int p1,
                                  int p2, int R2, int TWo, long long smem, int x_kind,
                                  double drop_p, unsigned long long seed, int device,
                                  void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (C1 > MAXC || C2 > MAXC || drop_p < 0.0 || drop_p >= 1.0 ||
        (x_kind != KIND_U8 && x_kind != KIND_U32) || (x_kind == KIND_U32 && W % 32))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (p1 == 2 && p2 == 2) return launch<2, 2>(x, w1, b1, w2, b2, mask, out, N, H, W, C1, C2, R2, TWo, smem, x_kind, drop_p, seed, s);
    if (p1 == 4 && p2 == 2) return launch<4, 2>(x, w1, b1, w2, b2, mask, out, N, H, W, C1, C2, R2, TWo, smem, x_kind, drop_p, seed, s);
    if (p1 == 2 && p2 == 4) return launch<2, 4>(x, w1, b1, w2, b2, mask, out, N, H, W, C1, C2, R2, TWo, smem, x_kind, drop_p, seed, s);
    if (p1 == 4 && p2 == 4) return launch<4, 4>(x, w1, b1, w2, b2, mask, out, N, H, W, C1, C2, R2, TWo, smem, x_kind, drop_p, seed, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
