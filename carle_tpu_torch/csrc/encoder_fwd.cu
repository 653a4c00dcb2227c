// encoder_fwd: both conv stages of a wrapper-net encoder in one kernel.
//
// Replaces carle_tpu/ops/pallas_head.py::make_fused_encoder's forward kernel
// _enc_fwd_kernel (all-ones row mask).
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
// two blocks that share them.
#include "net_stages.cuh"

template <typename T, int P1, int P2, bool DROP>
__global__ void encoder_fwd_kernel(const T* __restrict__ x,
                                   const float* __restrict__ w1,
                                   const float* __restrict__ b1,
                                   const float* __restrict__ w2,
                                   const float* __restrict__ b2,
                                   float* __restrict__ out, int H, int W, int C1,
                                   int C2, int R2, DropCfg cfg) {
    const int H1 = H / P1, W1 = W / P1;
    const int Ho = H1 / P2, Wo = W1 / P2;
    const int n = blockIdx.y;
    const int o0 = blockIdx.x * R2;        // first output row of the band
    const int xr0 = o0 * P2 - 1;           // first stage-1 row held
    const int XR = R2 * P2 + 2;            // stage-1 rows held
    const int ir0 = xr0 * P1 - 1;          // first input row held
    const int IR = XR * P1 + 2;            // input rows held
    const int XW = W1 + 2;                 // width with a zero column each side

    extern __shared__ float smem[];
    float* w1s = smem;                     // C1 * 9
    float* b1s = w1s + C1 * 9;             // C1
    float* w2s = b1s + C1;                 // C2 * C1 * 9
    float* b2s = w2s + C2 * C1 * 9;        // C2
    float* x1s = b2s + C2;                 // C1 x XR x XW
    uint8_t* xs = reinterpret_cast<uint8_t*>(x1s + C1 * XR * XW);  // IR x (W + 2)

    copy_floats(w1s, w1, C1 * 9);
    copy_floats(b1s, b1, C1);
    copy_floats(w2s, w2, C2 * C1 * 9);
    copy_floats(b2s, b2, C2);
    stage_cells(xs, cells_at(x, static_cast<size_t>(n) * H * W), ir0, IR, H, W);
    __syncthreads();

    // stage 1: pooled activation of XR rows, zero outside the universe
    encoder_stage1_band<P1, DROP>(xs, ir0, W, w1s, b1s, C1, x1s, xr0, XR, H1, n, cfg);
    __syncthreads();

    // stage 2: pooled output rows [o0, o0 + R2), written to device memory
    float* on = out + static_cast<size_t>(n) * C2 * Ho * Wo + static_cast<size_t>(o0) * Wo;
    encoder_stage2_band<P2, DROP, false>(x1s, xr0, XR, XW, w2s, b2s, C1, C2, on,
                                         static_cast<size_t>(Ho) * Wo, Wo, o0, R2, Ho, Wo,
                                         n, cfg);
}

template <typename T, int P1, int P2, bool DROP>
static int launch_as(const void* x, const void* w1, const void* b1, const void* w2,
                     const void* b2, void* out, int N, int H, int W, int C1, int C2,
                     int R2, size_t smem, const DropCfg& cfg, cudaStream_t s) {
    const auto kernel = encoder_fwd_kernel<T, P1, P2, DROP>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int Ho = H / (P1 * P2);
    const dim3 blocks((Ho + R2 - 1) / R2, N);
    KERNEL_LAUNCH(kernel, blocks, 256, smem, s,
                  static_cast<const T*>(x), static_cast<const float*>(w1),
                  static_cast<const float*>(b1), static_cast<const float*>(w2),
                  static_cast<const float*>(b2), static_cast<float*>(out), H, W, C1, C2,
                  R2, cfg);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int P1, int P2>
static int launch_type(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* out, int N, int H, int W, int C1, int C2,
                       int R2, size_t smem, double drop_p, const DropCfg& cfg,
                       cudaStream_t s) {
    if (drop_p > 0.0)
        return launch_as<T, P1, P2, true>(x, w1, b1, w2, b2, out, N, H, W, C1, C2, R2, smem, cfg, s);
    return launch_as<T, P1, P2, false>(x, w1, b1, w2, b2, out, N, H, W, C1, C2, R2, smem, cfg, s);
}

template <int P1, int P2>
static int launch(const void* x, const void* w1, const void* b1, const void* w2,
                  const void* b2, void* out, int N, int H, int W, int C1, int C2,
                  int R2, size_t smem, int x_kind, double drop_p, unsigned long long seed,
                  cudaStream_t s) {
    const DropCfg cfg = make_drop_cfg(drop_p, seed);
    if (x_kind == KIND_U32)
        return launch_type<uint32_t, P1, P2>(x, w1, b1, w2, b2, out, N, H, W, C1, C2, R2, smem, drop_p, cfg, s);
    return launch_type<uint8_t, P1, P2>(x, w1, b1, w2, b2, out, N, H, W, C1, C2, R2, smem, drop_p, cfg, s);
}

// smem must equal the layout above: floats for the weights and the stage-1
// band, then the staged input bytes (ops/cuda_head.py::_encoder_smem).  x_kind
// is KIND_U8 (cells [N, 1, H, W]) or KIND_U32 (packed words [N, 1, H, W/32]).
extern "C" int encoder_fwd_launch(const void* x, const void* w1, const void* b1,
                                  const void* w2, const void* b2, void* out,
                                  int N, int H, int W, int C1, int C2, int p1,
                                  int p2, int R2, long long smem, int x_kind, double drop_p,
                                  unsigned long long seed, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (C1 > MAXC || C2 > MAXC || drop_p < 0.0 || drop_p >= 1.0 ||
        (x_kind != KIND_U8 && x_kind != KIND_U32) || (x_kind == KIND_U32 && W % 32))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t bytes = static_cast<size_t>(smem);
    if (p1 == 2 && p2 == 2) return launch<2, 2>(x, w1, b1, w2, b2, out, N, H, W, C1, C2, R2, bytes, x_kind, drop_p, seed, s);
    if (p1 == 4 && p2 == 2) return launch<4, 2>(x, w1, b1, w2, b2, out, N, H, W, C1, C2, R2, bytes, x_kind, drop_p, seed, s);
    if (p1 == 2 && p2 == 4) return launch<2, 4>(x, w1, b1, w2, b2, out, N, H, W, C1, C2, R2, bytes, x_kind, drop_p, seed, s);
    if (p1 == 4 && p2 == 4) return launch<4, 4>(x, w1, b1, w2, b2, out, N, H, W, C1, C2, R2, bytes, x_kind, drop_p, seed, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
