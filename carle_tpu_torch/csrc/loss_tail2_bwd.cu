// loss_tail2_bwd: the gradients of loss_tail2_fwd's stage and error at the
// package's two stage widths (CIN = 2 or 1, COUT = 1), relu or sigmoid,
// specialised at compile time.
//
// Replaces carle_tpu/ops/pallas_head.py::make_fused_loss_tail's backward
// kernel _loss_tail_bwd_kernel for every caller in the package; tail.cu's
// loss_tail_bwd stays the generic instantiation for other widths.  From x,
// the weights, obs [N, 1, 2h, 2w] (uint8 cells, packed uint32 words with 2w a
// multiple of 32, or float32) and the cotangent gbar [N] of the error it
// gives dW [CIN, 1, 4, 4], db [1] and gx [N, CIN, h, w], where the
// activation's cotangent is
//
//   g = 2 gbar[n] (y - obs),   y = act(drop(conv_transpose(x, wt, k4 s2 p1) + b))
//
// and the dropout keep bits are drawn by element (philox.cuh: the forward's
// and the twin's bits; the loss tail's forward saves none).
//
// Bound on an H100: the Philox draws with dropout, else bytes (x and obs read,
// gx written).  The generic kernel walked deconv_preact's 16 taps for every
// cotangent position, staged whole rows with one block of 256 threads a
// multiprocessor, and reduced dW with a block reduction a tap.  Here
// tail2_bwd.cuh's kernel (the tail's backward, row 7b) on the cotangent
// policy ObsRows: obs is staged where g was (float32 obs in gz's place by
// 16-byte pieces, uint8 cells by 16-byte pieces and packed words by 4-byte
// ones into a tile of their own: a byte or a bit a position where g took
// four), y is recomputed by the parity stencils, and g is formed in the
// generic kernel's order of operations (2 gbar[n], times y - obs; then
// y (1 - y) or the relu gate; then the keep scale), so gx is the generic
// kernel's bit for bit; dW and db go by warp exchanges into one partial row
// a block, added in a fixed order by column_sums_kernel (no atomics).
// Instances beyond the grid's 65,535 rows go in further launches.
#include "tail2_bwd.cuh"

// The loss tail's cotangent 2 gbar[n] (y - obs), in the generic kernel's
// order of operations.
struct ObsCotangent {
    const float* __restrict__ gbar;
    __device__ float scale(int n) const { return 2.f * gbar[n]; }
    __device__ float value(float o, float y, float s) const { return s * (y - o); }
};

// The cotangent from obs [N, 1, 2h, 2w] of the type OBS.
template <typename OBS>
struct ObsRows;

// float32: obs staged in gz's place, as the tail's g.
template <>
struct ObsRows<float> : ObsCotangent {
    const float* __restrict__ obs;
    __device__ void stage(const Win& gz, uint8_t*, const Tail2Shape& sh, int n) const {
        tail2_stage_rows16(gz, obs + static_cast<size_t>(n) * 4 * sh.h * sh.w, 2 * sh.h,
                           2 * sh.w);
    }
    __device__ void quad(const Win& gz, const uint8_t*, const Tail2Shape&, int y, int x,
                         float (&v)[4]) const {
        const float4 o = *reinterpret_cast<const float4*>(gz.at(y, x));
        v[0] = o.x;
        v[1] = o.y;
        v[2] = o.z;
        v[3] = o.w;
    }
};

// uint8 cells: a tile row holds gz's columns from the 16-byte boundary at or
// before gz.c0 (a byte a position), copied 16 bytes at a time where rows are
// whole 16-byte pieces (2w a multiple of 16), else 4.
template <>
struct ObsRows<uint8_t> : ObsCotangent {
    const uint8_t* __restrict__ obs;
    __host__ __device__ static int cols(int T) { return (2 * T + 20 + 15) / 16 * 16; }
    __host__ __device__ static size_t tile_bytes(int RI, int T) {
        return static_cast<size_t>(2 * RI + 4) * cols(T);
    }
    __device__ void stage(const Win& gz, uint8_t* tile, const Tail2Shape& sh, int n) const {
        const int H2 = 2 * sh.h, W2 = 2 * sh.w, C = cols(min(sh.TJ, sh.w)), c0 = gz.c0 & ~15;
        const uint8_t* obs_n = obs + static_cast<size_t>(n) * H2 * W2;
        const int piece = W2 % 16 == 0 ? 16 : 4;
        grid_walk(gz.rows, C / piece, [&](int lr, int k) {
            const int y = gz.r0 + lr, xo = c0 + piece * k;
            const bool in = y >= 0 && y < H2 && xo >= 0 && xo < W2;
            float* dst = reinterpret_cast<float*>(tile + lr * C + piece * k);
            const float* src =
                reinterpret_cast<const float*>(obs_n + (in ? static_cast<size_t>(y) * W2 + xo : 0));
            if (piece == 16)
                copy_async16(dst, src, in);
            else
                copy_async4(dst, src, in);
        });
    }
    // x a multiple of 4: the four bytes in one aligned read
    __device__ void quad(const Win& gz, const uint8_t* tile, const Tail2Shape& sh, int y, int x,
                         float (&v)[4]) const {
        const int C = cols(min(sh.TJ, sh.w));
        const uint32_t q =
            *reinterpret_cast<const uint32_t*>(tile + (y - gz.r0) * C + x - (gz.c0 & ~15));
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = static_cast<float>((q >> (8 * k)) & 0xffu);
    }
};

// packed words: a tile row holds the words of gz's columns (zero outside the
// row), copied 4 bytes at a time.
template <>
struct ObsRows<uint32_t> : ObsCotangent {
    const uint32_t* __restrict__ obs;
    __host__ __device__ static int words(int T) { return (2 * T + 8 + 31) / 32 + 1; }
    __host__ __device__ static size_t tile_bytes(int RI, int T) {
        return 4 * static_cast<size_t>(2 * RI + 4) * words(T);
    }
    __device__ void stage(const Win& gz, uint8_t* tile, const Tail2Shape& sh, int n) const {
        const int H2 = 2 * sh.h, NW = 2 * sh.w / 32, U = words(min(sh.TJ, sh.w));
        const int k0 = gz.c0 >> 5;
        const uint32_t* obs_n = obs + static_cast<size_t>(n) * H2 * NW;
        grid_walk(gz.rows, U, [&](int lr, int k) {
            const int y = gz.r0 + lr, g = k0 + k;
            const bool in = y >= 0 && y < H2 && g >= 0 && g < NW;
            copy_async4(reinterpret_cast<float*>(tile) + lr * U + k,
                        reinterpret_cast<const float*>(obs_n +
                                                       (in ? static_cast<size_t>(y) * NW + g : 0)),
                        in);
        });
    }
    // x a multiple of 4: its four bits in one word
    __device__ void quad(const Win& gz, const uint8_t* tile, const Tail2Shape& sh, int y, int x,
                         float (&v)[4]) const {
        const int U = words(min(sh.TJ, sh.w));
        const uint32_t q = reinterpret_cast<const uint32_t*>(
                               tile)[(y - gz.r0) * U + (x >> 5) - (gz.c0 >> 5)] >>
                           (x & 31);
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = static_cast<float>((q >> k) & 1u);
    }
};

// Shared memory of a block: tail2_bwd.cuh's, then the obs tile of obs_kind.
__host__ __device__ inline size_t loss_tail2_bwd_smem(int obs_kind, int CIN, int w, int RI,
                                                      int TJ) {
    const int T = TJ < w ? TJ : w;
    return tail2_bwd_tile_at(CIN, w, RI, TJ) +
           (obs_kind == KIND_U8    ? ObsRows<uint8_t>::tile_bytes(RI, T)
            : obs_kind == KIND_U32 ? ObsRows<uint32_t>::tile_bytes(RI, T)
                                   : 0);
}

struct LossBwdArgs {
    const void *x, *wt, *b, *obs, *gbar;
    void *partials, *gx;
    int N;
    Tail2Shape sh;
    size_t bytes;
    int stage;
};

template <int CIN, int ACT, int KEEP, typename OBS>
static cudaError_t launch_as(const LossBwdArgs& a, const DropCfg& cfg, cudaStream_t s) {
    const auto kernel = tail2_bwd_kernel<CIN, ACT, KEEP, ObsRows<OBS>>;
    cudaError_t e = allow_smem(kernel, a.bytes);
    if (e != cudaSuccess) return e;
    const int T = min(a.sh.TJ, a.sh.w);
    const int blocks = ((a.sh.h + a.sh.RI - 1) / a.sh.RI) * ((a.sh.w + T - 1) / T);
    const Tail2Weights wp{static_cast<const float*>(a.wt), static_cast<const float*>(a.b)};
    const ObsRows<OBS> cot{{static_cast<const float*>(a.gbar)}, static_cast<const OBS*>(a.obs)};
    for (int n0 = 0; n0 < a.N; n0 += MAX_GRID_Y) {
        KERNEL_LAUNCH(kernel, dim3(blocks, grid_rows(a.N, n0)), TAIL2_THREADS, a.bytes, s,
                      static_cast<const float*>(a.x), wp, cot, nullptr, static_cast<float*>(a.gx),
                      static_cast<float*>(a.partials), a.sh, n0, a.stage, cfg);
        e = cudaGetLastError();
        if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
}

template <int CIN, int ACT, int KEEP>
static cudaError_t launch_obs(int obs_kind, const LossBwdArgs& a, const DropCfg& cfg,
                              cudaStream_t s) {
    if (obs_kind == KIND_U8) return launch_as<CIN, ACT, KEEP, uint8_t>(a, cfg, s);
    if (obs_kind == KIND_U32) return launch_as<CIN, ACT, KEEP, uint32_t>(a, cfg, s);
    return launch_as<CIN, ACT, KEEP, float>(a, cfg, s);
}

template <int CIN, int ACT>
static cudaError_t launch_keep(bool drop, int obs_kind, const LossBwdArgs& a, const DropCfg& cfg,
                               cudaStream_t s) {
    return drop ? launch_obs<CIN, ACT, KEEP_DRAW>(obs_kind, a, cfg, s)
                : launch_obs<CIN, ACT, KEEP_NONE>(obs_kind, a, cfg, s);
}

template <int CIN>
static cudaError_t launch_act(int act, bool drop, int obs_kind, const LossBwdArgs& a,
                              const DropCfg& cfg, cudaStream_t s) {
    return act == TAIL2_RELU ? launch_keep<CIN, TAIL2_RELU>(drop, obs_kind, a, cfg, s)
                             : launch_keep<CIN, TAIL2_SIGMOID>(drop, obs_kind, a, cfg, s);
}

// x [N, CIN, h, w] float32 (w even), wt [CIN, 1, 4, 4], b [1]; obs [N, 1, 2h,
// 2w] as KIND_F32 or KIND_U8 (16-byte aligned) or KIND_U32 packed words (2w a
// multiple of 32, 4-byte aligned); gbar [N].  partials: scratch of N x
// ceil(h / RI) x ceil(w / TJ) x (16 CIN + 1) floats; grads receives dW then
// db; gx [N, CIN, h, w].  RI, TJ, act, stage as loss_tail2_fwd_launch.  smem
// must equal loss_tail2_bwd_smem (ops/cuda_stages.py computes the same).
extern "C" int loss_tail2_bwd_launch(const void* x, const void* wt, const void* b,
                                     const void* obs, const void* gbar, void* partials,
                                     void* grads, void* gx, int N, int CIN, int h, int w, int RI,
                                     int TJ, long long smem, int act, int obs_kind, int stage,
                                     double drop_p, unsigned long long seed, int device,
                                     void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const uintptr_t align = obs_kind == KIND_U32 ? 4 : 16;
    if ((CIN != 1 && CIN != 2) || (act != TAIL2_RELU && act != TAIL2_SIGMOID) || N < 1 || h < 1 ||
        w < 2 || w % 2 || RI < 1 || TJ < 2 || TJ % 2 || drop_p < 0.0 || drop_p >= 1.0 ||
        obs_kind < KIND_F32 || obs_kind > KIND_U32 || (obs_kind == KIND_U32 && (2 * w) % 32) ||
        reinterpret_cast<uintptr_t>(obs) % align ||
        static_cast<size_t>(smem) != loss_tail2_bwd_smem(obs_kind, CIN, w, RI, TJ))
        return static_cast<int>(cudaErrorInvalidValue);
    const LossBwdArgs a{x, wt, b, obs, gbar, partials, gx, N, Tail2Shape{h, w, RI, TJ},
                        static_cast<size_t>(smem), stage};
    const DropCfg cfg = make_drop_cfg(drop_p, seed);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool drop = drop_p > 0.0;
    e = CIN == 1 ? launch_act<1>(act, drop, obs_kind, a, cfg, s)
                 : launch_act<2>(act, drop, obs_kind, a, cfg, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int T = TJ < w ? TJ : w;
    const int K = 16 * CIN + 1;
    KERNEL_LAUNCH(column_sums_kernel, K, 128, 0, s, static_cast<const float*>(partials),
                  N * ((h + RI - 1) / RI) * ((w + T - 1) / T), K, static_cast<float*>(grads));
    return static_cast<int>(cudaGetLastError());
}

template <int CIN, int ACT, typename OBS>
static int occupancy_as(int drop, size_t bytes, int* out) {
    return drop ? kernel_occupancy(tail2_bwd_kernel<CIN, ACT, KEEP_DRAW, ObsRows<OBS>>,
                                   TAIL2_THREADS, bytes, out)
                : kernel_occupancy(tail2_bwd_kernel<CIN, ACT, KEEP_NONE, ObsRows<OBS>>,
                                   TAIL2_THREADS, bytes, out);
}

template <int CIN, int ACT>
static int occupancy_obs(int obs_kind, int drop, size_t bytes, int* out) {
    if (obs_kind == KIND_U8) return occupancy_as<CIN, ACT, uint8_t>(drop, bytes, out);
    if (obs_kind == KIND_U32) return occupancy_as<CIN, ACT, uint32_t>(drop, bytes, out);
    return occupancy_as<CIN, ACT, float>(drop, bytes, out);
}

// Registers, static shared memory, spilled bytes and resident blocks a
// multiprocessor of the instantiation (CIN, act, dropout, obs_kind) at smem
// bytes.
extern "C" int loss_tail2_bwd_occupancy(int cin, int act, int drop, int obs_kind,
                                        long long smem, int device, int* out) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t bytes = static_cast<size_t>(smem);
    if (cin == 1)
        return act == TAIL2_RELU ? occupancy_obs<1, TAIL2_RELU>(obs_kind, drop, bytes, out)
                                 : occupancy_obs<1, TAIL2_SIGMOID>(obs_kind, drop, bytes, out);
    return act == TAIL2_RELU ? occupancy_obs<2, TAIL2_RELU>(obs_kind, drop, bytes, out)
                             : occupancy_obs<2, TAIL2_SIGMOID>(obs_kind, drop, bytes, out);
}
