// dec2_fwd: both decoder stages and the error of the decoder loss at the
// package's one decoder width (C2 = 2, CMID = 1, COUT = 1), specialised at
// compile time.
//
// Replaces carle_tpu/ops/pallas_head.py::make_fused_decoder_loss's forward
// kernel _decoder_loss_fwd_kernel and, with per-instance error row weights
// em [N, H], that of make_fused_decoder_loss_banded, for every caller in the
// package (Prediction's and Surprise's two-kernel autoencoder, the bands of
// BandTiling); decoder_loss_fwd.cu stays the generic instantiation.  It
// computes what decoder_loss_fwd.cu computes,
//
//   err[n] = sum over (H, W) of em[n, y] (obs - decoder(x))^2,
//
// with the same Philox dropout (dec2.cuh has the net).  The TRAINING forward
// (keepd not null) also writes every keep bit it draws (dec2.cuh's keepd
// layout), so the backward (dec2_bwd.cu) draws none.
//
// Bound on an H100: operations.  Without dropout 8 float32 multiply-adds
// and a sigmoid an output against an eighth of a byte of packed obs; with
// dropout 1.25 Philox draws an output (one a middle position, one an output
// cell), whose integer multiplies and logic outweigh the arithmetic.  The
// generic kernel spent its time issuing instructions: a 16-step walk with
// branches for each transpose-convolution output that uses 4 of its taps,
// runtime widths under MAXC register arrays, a shared load for every
// multiply-add's weight, an integer division an element.  Here the parity
// stencils and the parity-grouped weights of dec2.cuh, compile-time widths
// and grid_walk's (row, column) walk remove each; and rows whose weight is
// zero (a band's margins under BandTiling: a fifth of its rows) are neither
// computed nor drawn: their error is an exact zero.
//
// A block owns RY output rows and TX output columns of one instance
// (ops/cuda_stages.py::_dec2_plan): it stages the embedding window its
// outputs read (a row and a column of the embedding a side, zero outside
// it), computes the middle window (a middle row and column a side) into
// shared memory, then its outputs and their squared error, one partial sum a
// block; a second launch adds an instance's partials in a fixed order.  The
// squared errors are the generic kernel's float32 terms bit for bit; they
// are added in float64 (on Prediction's bands an instance's error sums
// 524,288 of them, where float32's order alone moves the sum by ~2e-6).
// Instances beyond the grid's 65,535 rows go in further launches.
#include "dec2.cuh"

// The block's sum of the threads' parts in a fixed order (warp trees, then
// the warps in turn) into *out.  Every thread calls it.
__device__ __forceinline__ void block_sum_double(double part, double* out) {
    __shared__ double red[32];
    const int tid = threadIdx.x, nt = blockDim.x;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_down_sync(0xffffffffu, part, off);
    if ((tid & 31) == 0) red[tid >> 5] = part;
    __syncthreads();
    if (tid == 0) {
        double s = 0.0;
        for (int w = 0; w < (nt + 31) / 32; ++w) s += red[w];
        *out = s;
    }
}

// err[n] = the sum of instance n's K block partials, in order, as float32.
__global__ void dec2_err_sums(const double* __restrict__ partials, int K,
                              float* __restrict__ err, int N) {
    for (int n = blockIdx.x * blockDim.x + threadIdx.x; n < N; n += gridDim.x * blockDim.x) {
        double s = 0.0;
        for (int k = 0; k < K; ++k) s += partials[static_cast<size_t>(n) * K + k];
        err[n] = static_cast<float>(s);
    }
}

template <bool DROP, bool SAVE, typename OBS>
__global__ void __launch_bounds__(DEC2_THREADS, DEC2_FWD_BLOCKS)
dec2_fwd_kernel(const float* __restrict__ x, const OBS* __restrict__ obs, Dec2Weights wp,
                const float* __restrict__ em, double* __restrict__ partials,
                uint8_t* __restrict__ keepd, Dec2Shape sh, int N0, DropCfg cfg) {
    constexpr int KEEP = DROP ? KEEP_DRAW : KEEP_NONE;
    const Dec2Block b(sh, N0);
    const int H = sh.H, W = sh.W, H1 = H / 2, W1 = W / 2, He = H / 4, We = W / 4;
    const int Y0 = b.Y0, X0 = b.X0, RY = b.RY, TX = b.TX, n = b.n;

    extern __shared__ float smem[];
    const Win es{smem, Y0 / 4 - 1, X0 / 4 - 1, RY / 4 + 2, TX / 4 + 2};
    const Win ms{es.p + 2 * es.rows * es.cols, Y0 / 2 - 1, X0 / 2 - 1, RY / 2 + 2, TX / 2 + 2};
    uint8_t* kms = reinterpret_cast<uint8_t*>(ms.p + ms.rows * ms.cols);   // RY/2 x TX/2 (SAVE)

    dec2_load_weights(wp.wt1, wp.bt1, wp.wt2, wp.bt2);
    dec2_stage_emb(es, x + static_cast<size_t>(n) * 2 * He * We, He, We);
    // the rows that weigh: the own outputs' (whose positions i are computed)
    // and, two output rows wider a side, those whose middle rows the block
    // computes (its own middle bits are saved for the neighbours' outputs too)
    const float* em_n = em != nullptr ? em + static_cast<size_t>(n) * H : nullptr;
    int i_lo = -DEC2_ALL, i_hi = DEC2_ALL, m_lo = -DEC2_ALL, m_hi = DEC2_ALL;
    if (em_n != nullptr) {
        int lo, hi;
        weighted_rows(em_n, Y0, Y0 + RY, lo, hi);
        i_lo = lo >> 1;
        i_hi = (hi + 1) >> 1;
        weighted_rows(em_n, max(Y0 - 2, 0), min(Y0 + RY + 2, H), lo, hi);
        m_lo = lo < hi ? (lo - 1) >> 1 : DEC2_ALL;
        m_hi = lo < hi ? ((hi - 2) >> 1) + 2 : -DEC2_ALL;
    }
    __syncthreads();
    dec2_middle<KEEP, SAVE, true>(es, ms, Y0 / 4, RY / 4 + 1, X0 / 4, TX / 4 + 1, H1, W1, m_lo,
                                  m_hi, n, cfg, nullptr, kms, Y0 / 2, RY / 2, X0 / 2, TX / 2);
    __syncthreads();
    const double part = dec2_error<double, DROP, SAVE, true>(
        ms, Y0 / 2, RY / 2, X0 / 2, TX / 2, i_lo, i_hi, H, W,
        cells_at(obs, static_cast<size_t>(n) * H * W), em_n, n, cfg,
        SAVE ? keepd + static_cast<size_t>(n) * H1 * W1 : nullptr, kms);
    block_sum_double(part, partials + static_cast<size_t>(n) * gridDim.x + blockIdx.x);
}

template <bool DROP, bool SAVE, typename OBS>
static cudaError_t launch_as(const void* x, const void* obs, const Dec2Weights& wp,
                             const void* em, void* partials, void* keepd, int N,
                             const Dec2Shape& sh, size_t bytes, const DropCfg& cfg,
                             cudaStream_t s) {
    const auto kernel = dec2_fwd_kernel<DROP, SAVE, OBS>;
    cudaError_t e = allow_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    const int T = min(sh.TX, sh.W);
    const int blocks = ((sh.H + sh.RY - 1) / sh.RY) * ((sh.W + T - 1) / T);
    for (int n0 = 0; n0 < N; n0 += MAX_GRID_Y) {
        KERNEL_LAUNCH(kernel, dim3(blocks, grid_rows(N, n0)), DEC2_THREADS, bytes, s,
                      static_cast<const float*>(x), static_cast<const OBS*>(obs), wp,
                      static_cast<const float*>(em), static_cast<double*>(partials),
                      static_cast<uint8_t*>(keepd), sh, n0, cfg);
        e = cudaGetLastError();
        if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
}

template <bool DROP, bool SAVE>
static cudaError_t launch_obs(int obs_kind, const void* x, const void* obs,
                              const Dec2Weights& wp, const void* em, void* partials,
                              void* keepd, int N, const Dec2Shape& sh, size_t bytes,
                              const DropCfg& cfg, cudaStream_t s) {
    if (obs_kind == KIND_U8)
        return launch_as<DROP, SAVE, uint8_t>(x, obs, wp, em, partials, keepd, N, sh, bytes, cfg, s);
    if (obs_kind == KIND_U32)
        return launch_as<DROP, SAVE, uint32_t>(x, obs, wp, em, partials, keepd, N, sh, bytes, cfg, s);
    return launch_as<DROP, SAVE, float>(x, obs, wp, em, partials, keepd, N, sh, bytes, cfg, s);
}

// x [N, 2, H/4, W/4] float32; obs [N, 1, H, W] as KIND_F32, KIND_U8 cells or
// KIND_U32 packed words (W a multiple of 32); wt1 .. bt2 the decoder's
// weights (dec2.cuh::Dec2Weights); em float32 [N, H] row weights or null;
// partials: scratch of N x ceil(H / RY) x ceil(W / TX) doubles; err [N].
// keepd (not null: the training forward, with dropout) receives every keep
// bit, uint8 [N, H/2, W/2].  RY, TX: a block's output rows and columns
// (multiples of 4; TX >= W for the whole width).  smem must equal
// dec2_fwd_smem (ops/cuda_stages.py computes the same).
extern "C" int dec2_fwd_launch(const void* x, const void* obs, const void* wt1, const void* bt1,
                               const void* wt2, const void* bt2, const void* em, void* partials,
                               void* err, void* keepd, int N, int H, int W, int RY, int TX,
                               long long smem, int obs_kind, double drop_p,
                               unsigned long long seed, int device, void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const bool drop = drop_p > 0.0, save = keepd != nullptr;
    if (RY % 4 || RY < 4 || TX % 4 || TX < 4 || H % 4 || W % 4 || drop_p < 0.0 ||
        drop_p >= 1.0 || (save && !drop) || obs_kind < KIND_F32 || obs_kind > KIND_U32 ||
        (obs_kind == KIND_U32 && W % 32) ||
        static_cast<size_t>(smem) != dec2_fwd_smem(W, RY, TX, save))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Dec2Weights wp{static_cast<const float*>(wt1), static_cast<const float*>(bt1),
                         static_cast<const float*>(wt2), static_cast<const float*>(bt2)};
    const Dec2Shape sh{H, W, RY, TX};
    const DropCfg cfg = make_drop_cfg(drop_p, seed);
    const size_t bytes = static_cast<size_t>(smem);
    if (save)
        e = launch_obs<true, true>(obs_kind, x, obs, wp, em, partials, keepd, N, sh, bytes, cfg, s);
    else if (drop)
        e = launch_obs<true, false>(obs_kind, x, obs, wp, em, partials, keepd, N, sh, bytes, cfg, s);
    else
        e = launch_obs<false, false>(obs_kind, x, obs, wp, em, partials, keepd, N, sh, bytes, cfg, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int T = TX < W ? TX : W;
    KERNEL_LAUNCH(dec2_err_sums, (N + 127) / 128, 128, 0, s, static_cast<const double*>(partials),
                  ((H + RY - 1) / RY) * ((W + T - 1) / T), static_cast<float*>(err), N);
    return static_cast<int>(cudaGetLastError());
}

// Registers, static shared memory, spilled bytes and resident blocks a
// multiprocessor of the band kernel (common.cuh::kernel_occupancy) on uint8
// obs: mode 0 without dropout, 1 with, 2 with dropout saving the bits.
extern "C" int dec2_fwd_occupancy(int mode, long long smem, int device, int* out) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t bytes = static_cast<size_t>(smem);
    if (mode == 2)
        return kernel_occupancy(dec2_fwd_kernel<true, true, uint8_t>, DEC2_THREADS, bytes, out);
    if (mode == 1)
        return kernel_occupancy(dec2_fwd_kernel<true, false, uint8_t>, DEC2_THREADS, bytes, out);
    return kernel_occupancy(dec2_fwd_kernel<false, false, uint8_t>, DEC2_THREADS, bytes, out);
}
