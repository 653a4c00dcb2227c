// ae2d_fwd: the whole wrapper autoencoder and its error at AE2D's widths
// (C1 = 4, C2 = 2, CMID = 1, COUT = 1), specialised at compile time.
//
// Replaces carle_tpu/ops/pallas_head.py::make_fused_ae_loss's forward kernel
// _ae_fwd_kernel (all-ones row mask) for every caller in the package (AE2D,
// Prediction and Surprise); ae_loss_fwd.cu stays the generic instantiation.
// It computes what ae_loss_fwd.cu computes (its header has the net), err[n] =
// sum over (H, W) of (obs - ae(src))^2, with the same Philox dropout.
//
// Bound on an H100: operations.  With stage 1 a table lookup, 24 float32
// multiply-adds a cell (stage 2 18, the middle stage 2, the last 4) against 2
// bytes read (src and obs); with dropout 2.5 Philox draws a cell (stage 1 and
// the last stage once a cell, stage 2 and the middle stage once a position of
// the half-resolution grid), whose integer multiplies and logic outweigh the
// multiply-adds (chip_smoke.py counts a draw's operations by pipe from its
// SASS).  The generic kernel instead spent its time issuing instructions
// (loads of weights, branches, divisions): ae2d.cuh says what this design
// does about each.
//
// A block owns a band of RY output rows of one universe and works back
// through the net as the generic kernel does (the band layout of
// ae_bands.cuh): it stages RY + 14 input rows as bits, computes the stage-1
// band by table (RY/2 + 6 rows), the embedding band (RY/4 + 2 rows) and the
// middle band (RY/2 + 2 rows) into shared memory, then the reconstruction of
// its rows and the squared error, one partial sum a block; a second launch
// adds a universe's partials in a fixed order.  SAVE (the training forward,
// ops/cuda_head.py::AELossFn) also writes the embedding of the block's own
// rows and, with dropout, the keep bits of its own positions (Ae2dSaved), so
// the backward (ae2d_bwd.cu) neither recomputes the encoder for the decoder
// nor draws a random number.
#include "ae2d.cuh"

template <bool DROP, bool SAVE, typename SRC, typename OBS>
__global__ void __launch_bounds__(AE2D_THREADS, AE2D_FWD_BLOCKS)
ae2d_fwd_kernel(const SRC* __restrict__ src, const OBS* __restrict__ obs, Ae2dWeights wp,
                float* __restrict__ partials, Ae2dSaved sv, Ae2dShape sh, DropCfg cfg) {
    constexpr int KEEP = DROP ? KEEP_DRAW : KEEP_NONE;
    const Ae2dDims d(sh);
    const int n = blockIdx.y;
    const int Y0 = blockIdx.x * sh.RY;
    const int XW = d.XW(), M0 = Y0 / 2 - 1;

    extern __shared__ float smem[];
    float4* tab = reinterpret_cast<float4*>(smem);       // 512
    float* x1s = smem + 4 * 512;                           // 4 x XR x XW
    float* es = x1s + 4 * d.XR() * XW;                     // 2 x ER x EW
    float* ms = es + 2 * d.ER() * d.EW();                  // MR x XW
    float* red = ms + d.MR() * XW;                         // 32
    uint32_t* bits = reinterpret_cast<uint32_t*>(red + 32);   // IR x NS
    uint8_t* kms = reinterpret_cast<uint8_t*>(bits + d.IR() * d.NS());  // RY/2 x W1

    load_weights(wp);
    __syncthreads();
    build_table<4>(tab, ae2d_w + AE_W1, ae2d_w + AE_B1);
    stage_bits(bits, cells_at(src, static_cast<size_t>(n) * sh.H * sh.W), Y0 - 7, d.IR(), -1,
               d.NS(), sh.H, sh.W);
    __syncthreads();
    ae2d_stage1<KEEP, SAVE>(tab, bits, x1s, d, Y0, n, cfg, sv.keep1);
    __syncthreads();
    ae2d_stage2<KEEP, SAVE>(x1s, es, d, Y0, n, cfg, sv);
    __syncthreads();
    const Win esw{es, Y0 / 4 - 1, -1, d.ER(), d.EW()}, msw{ms, M0, -1, d.MR(), XW};
    dec2_middle<KEEP, SAVE && DROP, false>(esw, msw, Y0 / 4, sh.RY / 4 + 1, 0, d.We + 1, d.H1,
                                           d.W1, 0, 0, n, cfg, nullptr, kms, Y0 / 2, sh.RY / 2,
                                           0, d.W1);
    __syncthreads();

    // the last stage and the squared error on the block's rows
    const float part = dec2_error<float, DROP, SAVE, false>(
        msw, Y0 / 2, sh.RY / 2, 0, d.W1, 0, 0, sh.H, sh.W,
        cells_at(obs, static_cast<size_t>(n) * sh.H * sh.W), nullptr, n, cfg,
        SAVE && DROP ? sv.keepd + static_cast<size_t>(n) * d.H1 * d.W1 : nullptr, kms);
    block_sum_to(part, red, partials + static_cast<size_t>(n) * gridDim.x + blockIdx.x);
}

template <bool DROP, bool SAVE, typename SRC, typename OBS>
static cudaError_t launch_as(const void* src, const void* obs, const Ae2dWeights& wp,
                             void* partials, const Ae2dSaved& sv, int N, const Ae2dShape& sh, size_t bytes,
                             const DropCfg& cfg, cudaStream_t s) {
    const auto kernel = ae2d_fwd_kernel<DROP, SAVE, SRC, OBS>;
    cudaError_t e = allow_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    KERNEL_LAUNCH(kernel, dim3((sh.H + sh.RY - 1) / sh.RY, N), AE2D_THREADS, bytes, s,
                  static_cast<const SRC*>(src), static_cast<const OBS*>(obs), wp,
                  static_cast<float*>(partials), sv, sh, cfg);
    return cudaGetLastError();
}

template <bool DROP, bool SAVE>
static cudaError_t launch_kinds(int src_kind, int obs_kind, const void* src, const void* obs,
                                const Ae2dWeights& wp, void* partials, const Ae2dSaved& sv, int N,
                                const Ae2dShape& sh, size_t bytes, const DropCfg& cfg,
                                cudaStream_t s) {
    if (src_kind == KIND_U32)
        return obs_kind == KIND_U32
            ? launch_as<DROP, SAVE, uint32_t, uint32_t>(src, obs, wp, partials, sv, N, sh, bytes, cfg, s)
            : launch_as<DROP, SAVE, uint32_t, uint8_t>(src, obs, wp, partials, sv, N, sh, bytes, cfg, s);
    return obs_kind == KIND_U32
        ? launch_as<DROP, SAVE, uint8_t, uint32_t>(src, obs, wp, partials, sv, N, sh, bytes, cfg, s)
        : launch_as<DROP, SAVE, uint8_t, uint8_t>(src, obs, wp, partials, sv, N, sh, bytes, cfg, s);
}

// w1 .. bt2: the eight float32 weight tensors, contiguous (ae2d.cuh's
// shapes); partials: scratch of
// N x ceil(H / RY) floats; err [N].  emb (null: not saving) receives the
// embedding [N, 2, H/4, W/4], and with dropout keep1, keep2 and keepd the
// keep bits (ae2d.cuh::Ae2dSaved).  smem must equal ae2d_fwd_smem (ops/
// cuda_head.py computes the same).  src_kind, obs_kind: KIND_U8 cells (a
// 4-byte aligned plane) or KIND_U32 packed words, each on its own.
extern "C" int ae2d_fwd_launch(const void* src, const void* obs, const void* w1,
                               const void* b1, const void* w2, const void* b2, const void* wt1,
                               const void* bt1, const void* wt2, const void* bt2, void* partials, void* err, void* emb, void* keep1, void* keep2,
                               void* keepd, int N, int H, int W, int RY, long long smem,
                               int src_kind, int obs_kind, double drop_p,
                               unsigned long long seed, int device, void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const Ae2dShape sh{H, W, RY};
    const bool save = emb != nullptr, drop = drop_p > 0.0;
    if (RY % 4 || RY < 4 || H % 4 || W % 4 || drop_p < 0.0 || drop_p >= 1.0 ||
        !cell_kinds_ok(src_kind, obs_kind, W) ||
        static_cast<size_t>(smem) != ae2d_fwd_smem(sh, save && drop) ||
        (save && drop && (keep1 == nullptr || keep2 == nullptr || keepd == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Ae2dWeights wp{{static_cast<const float*>(w1), static_cast<const float*>(b1),
                          static_cast<const float*>(w2), static_cast<const float*>(b2),
                          static_cast<const float*>(wt1), static_cast<const float*>(bt1),
                          static_cast<const float*>(wt2), static_cast<const float*>(bt2)}};
    const Ae2dSaved sv{static_cast<float*>(emb), static_cast<uint16_t*>(keep1),
                       static_cast<uint8_t*>(keep2), static_cast<uint8_t*>(keepd)};
    const DropCfg cfg = make_drop_cfg(drop_p, seed);
    const size_t bytes = static_cast<size_t>(smem);
    if (drop)
        e = save ? launch_kinds<true, true>(src_kind, obs_kind, src, obs, wp, partials, sv, N, sh, bytes, cfg, s)
                 : launch_kinds<true, false>(src_kind, obs_kind, src, obs, wp, partials, sv, N, sh, bytes, cfg, s);
    else
        e = save ? launch_kinds<false, true>(src_kind, obs_kind, src, obs, wp, partials, sv, N, sh, bytes, cfg, s)
                 : launch_kinds<false, false>(src_kind, obs_kind, src, obs, wp, partials, sv, N, sh, bytes, cfg, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    KERNEL_LAUNCH(row_sums_kernel, (N + 127) / 128, 128, 0, s,
                  static_cast<const float*>(partials), (H + RY - 1) / RY,
                  static_cast<float*>(err), N);
    return static_cast<int>(cudaGetLastError());
}

// Registers, static shared memory, spilled bytes and resident blocks a
// multiprocessor of the band kernel (common.cuh::kernel_occupancy), uint8
// src and obs.
extern "C" int ae2d_fwd_occupancy(int drop, int save, long long smem, int device, int* out) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t bytes = static_cast<size_t>(smem);
    if (drop)
        return save ? kernel_occupancy(ae2d_fwd_kernel<true, true, uint8_t, uint8_t>, AE2D_THREADS, bytes, out)
                    : kernel_occupancy(ae2d_fwd_kernel<true, false, uint8_t, uint8_t>, AE2D_THREADS, bytes, out);
    return save ? kernel_occupancy(ae2d_fwd_kernel<false, true, uint8_t, uint8_t>, AE2D_THREADS, bytes, out)
                : kernel_occupancy(ae2d_fwd_kernel<false, false, uint8_t, uint8_t>, AE2D_THREADS, bytes, out);
}
