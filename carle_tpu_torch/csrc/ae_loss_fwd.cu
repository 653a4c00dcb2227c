// ae_loss_fwd: the whole wrapper autoencoder and its error in one kernel.
//
// Replaces carle_tpu/ops/pallas_head.py::make_fused_ae_loss's forward kernel
// _ae_fwd_kernel (all-ones row mask).
//
//   x1  = maxpool2(relu(drop(conv3x3(src, w1) + b1)))            [C1,   H/2, W/2]
//   emb = maxpool2(relu(drop(conv3x3(x1, w2) + b2)))             [C2,   H/4, W/4]
//   mid = relu(drop(conv_transpose(emb, wt1, k4 s2 p1) + bt1))   [CMID, H/2, W/2]
//   y   = sigmoid(drop(conv_transpose(mid, wt2, k4 s2 p1) + bt2))[COUT, H,   W]
//   err[n] = sum over (COUT, H, W) of (obs - y)^2
//
// Dropout (training only, drop_p > 0) is in-kernel Philox indexed by the
// element (philox.cuh); a dropped cell of the last stage gives sigmoid(0) =
// 0.5.  With drop_p == 0 the kernel is instantiated without it.
//
// Bound on an H100: operations.  Per cell of the universe the net does about
// 9 C1 + (9 C1 C2 + 4 C2 CMID) / 4 + 4 CMID COUT multiply-adds on float32
// (48 at the AE2D widths) against 2 bytes read (src and obs), far above the
// card's 20 flops a byte balance point for float32.  Design: a block owns a
// band of RY output rows of one universe and works back through the net: it
// stages the input rows the band needs in shared memory, computes the
// stage-1 band (RY/2 + 6 rows), the embedding band (RY/4 + 2 rows) and the
// decoder's middle band (RY/2 + 2 rows) into shared memory, each with the
// zero padding of the layer outside the universe, and then the
// reconstruction and its squared error.  No activation reaches device
// memory: each block writes one partial sum, and a second launch adds a
// universe's partials in a fixed order, so the result does not change from
// run to run.
#include "ae_bands.cuh"

template <bool DROP>
__global__ void ae_loss_fwd_kernel(
    const uint8_t* __restrict__ src, const uint8_t* __restrict__ obs,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ wt1, const float* __restrict__ bt1,
    const float* __restrict__ wt2, const float* __restrict__ bt2,
    float* __restrict__ partials, AEShape sh, DropCfg cfg) {
    const int n = blockIdx.y;
    const int Y0 = blockIdx.x * sh.RY;

    extern __shared__ float smem[];
    AEBand b = ae_band_layout(smem, sh, Y0);
    float* red = b.end;                                      // 32
    uint8_t* xs = reinterpret_cast<uint8_t*>(red + 32);      // IR x (W + 2)
    ae_band_forward<DROP>(b, xs, src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, sh, n, cfg);

    // decoder stage 2 (transpose conv + sigmoid) and the squared error
    decoder_stage2_error<DROP>(b, red, obs, sh, Y0, n, cfg, partials);
}

template <bool DROP>
static int launch_as(const void* src, const void* obs, const void* w1, const void* b1,
                     const void* w2, const void* b2, const void* wt1, const void* bt1,
                     const void* wt2, const void* bt2, void* partials, int N,
                     const AEShape& sh, size_t bytes, const DropCfg& cfg, cudaStream_t s) {
    const auto kernel = ae_loss_fwd_kernel<DROP>;
    cudaError_t e = allow_smem(kernel, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int bands = (sh.H + sh.RY - 1) / sh.RY;
    KERNEL_LAUNCH(kernel, dim3(bands, N), 256, bytes, s,
                  static_cast<const uint8_t*>(src), static_cast<const uint8_t*>(obs),
                  static_cast<const float*>(w1), static_cast<const float*>(b1),
                  static_cast<const float*>(w2), static_cast<const float*>(b2),
                  static_cast<const float*>(wt1), static_cast<const float*>(bt1),
                  static_cast<const float*>(wt2), static_cast<const float*>(bt2),
                  static_cast<float*>(partials), sh, cfg);
    return static_cast<int>(cudaGetLastError());
}

// smem must equal the layout above (ops/cuda_head.py::_ae_smem); partials is
// scratch of N x bands floats, bands = ceil(H / RY).
extern "C" int ae_loss_fwd_launch(const void* src, const void* obs, const void* w1,
                                  const void* b1, const void* w2, const void* b2,
                                  const void* wt1, const void* bt1, const void* wt2,
                                  const void* bt2, void* partials, void* err, int N,
                                  int H, int W, int C1, int C2, int CMID, int COUT,
                                  int RY, long long smem, double drop_p,
                                  unsigned long long seed, int device, void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (C1 > MAXC || C2 > MAXC || CMID > MAXC || COUT > MAXC || RY % 4 ||
        drop_p < 0.0 || drop_p >= 1.0)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t bytes = static_cast<size_t>(smem);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int bands = (H + RY - 1) / RY;
    const AEShape sh{H, W, C1, C2, CMID, COUT, RY};
    const DropCfg cfg = make_drop_cfg(drop_p, seed);
    const int rc = drop_p > 0.0
        ? launch_as<true>(src, obs, w1, b1, w2, b2, wt1, bt1, wt2, bt2, partials, N, sh, bytes, cfg, s)
        : launch_as<false>(src, obs, w1, b1, w2, b2, wt1, bt1, wt2, bt2, partials, N, sh, bytes, cfg, s);
    if (rc != 0) return rc;
    KERNEL_LAUNCH(row_sums_kernel, (N + 127) / 128, 128, 0, s,
                  static_cast<const float*>(partials), bands, static_cast<float*>(err), N);
    return static_cast<int>(cudaGetLastError());
}
