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
//      then the decoder's backward of the band (decoder_bwd.cuh): its part
//      of dWt2, dbt2, dWt1 and dbt1, and the middle cotangent (gmid,
//      [N, CMID, H/2, W/2]);
//   2. deconv_input_grad_kernel: the embedding cotangent (gemb,
//      [N, C2, H/4, W/4]) from gmid and wt1, one thread an element;
//   3. the encoder's backward (encoder_bwd.cuh) with gemb as its cotangent;
//   4. column_sums_kernel adds the blocks' partial sums in a fixed order.
//
// Fusing the stages into one band kernel (nested halos out to 15 input rows
// either side) is left for later.  Bound: operations, as the forward.
#include "decoder_bwd.cuh"
#include "encoder_bwd.cuh"

__host__ __device__ inline size_t ae_bwd_decoder_smem(const AEShape& sh) {
    return 4 * (ae_band_floats(sh) + decoder_bwd_floats(sh)) +
           static_cast<size_t>(sh.RY + 14) * (sh.W + 2);
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
    const int n = blockIdx.y;
    const int Y0 = blockIdx.x * sh.RY;

    extern __shared__ float smem[];
    AEBand b = ae_band_layout(smem, sh, Y0);
    float* scratch = b.end;                  // decoder_bwd_floats
    uint8_t* xs = reinterpret_cast<uint8_t*>(scratch + decoder_bwd_floats(sh));
    ae_band_forward<DROP>(b, xs, src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, sh, n, cfg);
    decoder_backward_band<DROP>(b, scratch, obs + static_cast<size_t>(n) * sh.COUT * sh.H * sh.W,
                                gbar[n], gmid, partials, sh, Y0, n, cfg);
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
    KERNEL_LAUNCH(deconv_input_grad_kernel, blocks, 256, 0, s, static_cast<const float*>(gmid),
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
