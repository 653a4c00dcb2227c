// loss_tail2_fwd: one decoder stage fused with its per-instance squared error,
// at the package's two stage widths (CIN = 2 or 1, COUT = 1), relu or
// sigmoid, specialised at compile time.
//
// Replaces carle_tpu/ops/pallas_head.py::make_fused_loss_tail's forward
// kernel _loss_tail_fwd_kernel for every caller in the package (the
// autoencoder by four kernels, SpaceSharding's loss_tail_spatial); tail.cu's
// loss_tail_fwd stays the generic instantiation for other widths.
//
//   err[n] = sum over (2h, 2w) of (obs - act(drop(conv_transpose(x, wt, k4 s2 p1) + b)))^2
//
// with obs uint8 cells, packed uint32 words (2w a multiple of 32) or float32,
// and the same Philox dropout as tail.cu: each output is the generic kernel's
// and tail2_fwd.cu's bit for bit, so err differs from the generic kernel's
// only in the order of its sum.  No keep bits are saved: the backward
// (tail.cu's loss_tail_bwd) draws its own.
//
// Bound on an H100: bytes (the input x read once, a quarter of a float an
// output, and obs read once).  The generic kernel staged whole rows, walked
// the transpose convolution over runtime widths for each output with a
// shared load a multiply-add, and added the error of one output a thread a
// step.  Here a block owns RI input rows and TJ input columns (tail2.cuh,
// ops/cuda_stages.py::_tail2_plan) and a thread the 2 x 4 outputs of an input
// pair (tail2.cuh::tail2_pair); it reads the matching obs from the block's
// obs tile (ObsTile: staged with the input window; uint8 a 4-byte read a row,
// packed 4 bits of one word a row, float32 a 16-byte read a row) and adds
// (obs - y)^2 into a register.  The block's sum goes in a fixed
// order (block_sums: warp trees, then the warps in turn) to one partial a
// block; a second launch adds an instance's partials in order (row_sums_kernel).
// No float atomics: two runs give the same bits.  Instances beyond the grid's
// 65,535 rows go in further launches.
#include "tail2.cuh"

// The block's obs, output rows [2 i0, 2 i0 + 2 ri) and columns [2 j0, 2 j0 +
// 2 tj), staged in shared memory by asynchronous copies issued with the input
// window's, so the block waits for memory once (a thread that loaded its obs
// beside its outputs waited once an output row): a row of `units` 4-byte
// units (uint8: 2 tj bytes; float32: 2 tj floats, copied 16 bytes at a time;
// packed: the words that hold its 2 tj bits).  obs_quad reads the four values
// of tile row lr, columns c .. c + 3 (c = 2 (j - j0)) as floats.
template <typename OBS>
struct ObsTile;
template <>
struct ObsTile<uint8_t> {
    static constexpr int VEC = 1;  // units a copy
    __device__ static int units(int, int tj) { return tj / 2; }
    // unit 0 of output row y's part of the tile
    __device__ static const float* row(const uint8_t* obs_n, int y, int j0, int W2) {
        return reinterpret_cast<const float*>(obs_n + static_cast<size_t>(y) * W2 + 2 * j0);
    }
};
template <>
struct ObsTile<float> {
    static constexpr int VEC = 4;
    __device__ static int units(int, int tj) { return 2 * tj; }
    __device__ static const float* row(const float* obs_n, int y, int j0, int W2) {
        return obs_n + static_cast<size_t>(y) * W2 + 2 * j0;
    }
};
template <>
struct ObsTile<uint32_t> {
    static constexpr int VEC = 1;
    __device__ static int units(int j0, int tj) {
        return ((2 * j0 + 2 * tj - 1) >> 5) - ((2 * j0) >> 5) + 1;
    }
    __device__ static const float* row(const uint32_t* obs_n, int y, int j0, int W2) {
        return reinterpret_cast<const float*>(obs_n +
                                              ((static_cast<size_t>(y) * W2 + 2 * j0) >> 5));
    }
};

__device__ __forceinline__ void obs_quad(const uint8_t* t, int units, int lr, int c, int,
                                         float (&v)[4]) {
    const uint32_t q = *reinterpret_cast<const uint32_t*>(t + lr * 4 * units + c);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = static_cast<float>((q >> (8 * k)) & 0xffu);
}
__device__ __forceinline__ void obs_quad(const float* t, int units, int lr, int c, int,
                                         float (&v)[4]) {
    const float4 f = *reinterpret_cast<const float4*>(t + lr * units + c);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
}
// c: the column 2 (j - j0) in the tile; x0 = 2 j0, so bit (x0 + c) & 31 of
// staged word ((x0 + c) >> 5) - (x0 >> 5)
__device__ __forceinline__ void obs_quad(const uint32_t* t, int units, int lr, int c, int x0,
                                         float (&v)[4]) {
    const uint32_t q = t[lr * units + ((x0 + c) >> 5) - (x0 >> 5)] >> ((x0 + c) & 31);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = static_cast<float>((q >> k) & 1u);
}

// Shared memory of the obs tile past the input window (16-byte aligned), for
// obs_kind's type, RI rows and TJ columns of input a block (T = min(TJ, w)).
__host__ __device__ inline size_t loss_tail2_smem(int obs_kind, int CIN, int w, int RI, int TJ) {
    const int T = TJ < w ? TJ : w;
    const size_t units = obs_kind == KIND_U8    ? T / 2
                         : obs_kind == KIND_F32 ? 2 * T
                                                : (2 * T) / 32 + 2;
    return (tail2_fwd_smem(CIN, w, RI, TJ) + 15) / 16 * 16 + 4 * units * 2 * RI;
}

template <int CIN, int ACT, bool DROP, typename OBS>
__global__ void __launch_bounds__(TAIL2_THREADS, TAIL2_FWD_BLOCKS)
loss_tail2_fwd_kernel(const float* __restrict__ x, Tail2Weights wp, const OBS* __restrict__ obs,
                      float* __restrict__ partials, Tail2Shape sh, int N0, int stage,
                      DropCfg cfg) {
    using Tile = ObsTile<OBS>;
    const Tail2Block bk(sh, N0);
    const int h = sh.h, w = sh.w, W2 = 2 * w, n = bk.n;

    extern __shared__ float smem[];
    __shared__ float red[TAIL2_THREADS / 32];
    const Win xs{smem, bk.i0 - 1, bk.j0 - 1, bk.ri + 2, bk.tj + 2};
    float* tile = smem + (tail2_fwd_smem(CIN, w, sh.RI, sh.TJ) + 15) / 16 * 4;
    const int units = Tile::units(bk.j0, bk.tj);
    const OBS* obs_n = cells_at(obs, static_cast<size_t>(n) * 4 * h * w);
    tail2_stage_input<CIN>(xs, x + static_cast<size_t>(n) * CIN * h * w, h, w);
    grid_walk(2 * bk.ri, units / Tile::VEC, [&](int lr, int u) {
        const float* src = Tile::row(obs_n, 2 * bk.i0 + lr, bk.j0, W2) + u * Tile::VEC;
        float* dst = tile + lr * units + u * Tile::VEC;
        if (Tile::VEC == 4)
            copy_async16(dst, src, true);
        else
            copy_async4(dst, src, true);
    });
    tail2_load_weights<CIN>(wp);
    copies_wait();
    __syncthreads();

    const OBS* t = reinterpret_cast<const OBS*>(tile);
    float part[1] = {0.f};
    grid_walk(bk.ri, bk.tj / 2, [&](int lr, int lp) {
        const int i = bk.i0 + lr, j = bk.j0 + 2 * lp;
        float s = 0.f;
        tail2_pair<CIN, ACT, DROP>(xs, i, j, n, stage, cfg, [&](int a, const float (&yv)[4]) {
            float o[4];
            obs_quad(t, units, 2 * lr + a, 4 * lp, 2 * bk.j0, o);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float d = o[q] - yv[q];
                s += d * d;
            }
        });
        part[0] += s;
    });
    block_sums<1>(part, red, partials + static_cast<size_t>(n) * gridDim.x + blockIdx.x);
}

struct LossArgs {
    const void *x, *wt, *b, *obs;
    void *partials, *err;
    int N;
    Tail2Shape sh;
    size_t bytes;
    int stage;
};

template <int CIN, int ACT, bool DROP, typename OBS>
static cudaError_t launch_as(const LossArgs& a, const DropCfg& cfg, cudaStream_t s) {
    const auto kernel = loss_tail2_fwd_kernel<CIN, ACT, DROP, OBS>;
    cudaError_t e = allow_smem(kernel, a.bytes);
    if (e != cudaSuccess) return e;
    const int T = min(a.sh.TJ, a.sh.w);
    const int blocks = ((a.sh.h + a.sh.RI - 1) / a.sh.RI) * ((a.sh.w + T - 1) / T);
    const Tail2Weights wp{static_cast<const float*>(a.wt), static_cast<const float*>(a.b)};
    for (int n0 = 0; n0 < a.N; n0 += MAX_GRID_Y) {
        KERNEL_LAUNCH(kernel, dim3(blocks, grid_rows(a.N, n0)), TAIL2_THREADS, a.bytes, s,
                      static_cast<const float*>(a.x), wp, static_cast<const OBS*>(a.obs),
                      static_cast<float*>(a.partials), a.sh, n0, a.stage, cfg);
        e = cudaGetLastError();
        if (e != cudaSuccess) return e;
    }
    KERNEL_LAUNCH(row_sums_kernel, (a.N + 127) / 128, 128, 0, s,
                  static_cast<const float*>(a.partials), blocks, static_cast<float*>(a.err), a.N);
    return cudaGetLastError();
}

template <int CIN, int ACT, bool DROP>
static cudaError_t launch_obs(int obs_kind, const LossArgs& a, const DropCfg& cfg,
                              cudaStream_t s) {
    if (obs_kind == KIND_U8) return launch_as<CIN, ACT, DROP, uint8_t>(a, cfg, s);
    if (obs_kind == KIND_U32) return launch_as<CIN, ACT, DROP, uint32_t>(a, cfg, s);
    return launch_as<CIN, ACT, DROP, float>(a, cfg, s);
}

template <int CIN, int ACT>
static cudaError_t launch_drop(bool drop, int obs_kind, const LossArgs& a, const DropCfg& cfg,
                               cudaStream_t s) {
    return drop ? launch_obs<CIN, ACT, true>(obs_kind, a, cfg, s)
                : launch_obs<CIN, ACT, false>(obs_kind, a, cfg, s);
}

template <int CIN>
static cudaError_t launch_act(int act, bool drop, int obs_kind, const LossArgs& a,
                              const DropCfg& cfg, cudaStream_t s) {
    return act == TAIL2_RELU ? launch_drop<CIN, TAIL2_RELU>(drop, obs_kind, a, cfg, s)
                             : launch_drop<CIN, TAIL2_SIGMOID>(drop, obs_kind, a, cfg, s);
}

// x [N, CIN, h, w] float32 (w even), wt [CIN, 1, 4, 4], b [1]; obs [N, 1, 2h,
// 2w] as KIND_F32 (16-byte aligned), KIND_U8 (4-byte aligned) or KIND_U32
// packed words (2w a multiple of 32); partials: scratch of N x (the grid's
// blocks an instance) floats; err [N].  RI, TJ: a block's input rows and
// columns (TJ even; TJ >= w for the whole width); act 0 relu, 1 sigmoid;
// stage the dropout stage (philox.cuh).  smem must equal loss_tail2_smem
// (ops/cuda_stages.py computes the same).
extern "C" int loss_tail2_fwd_launch(const void* x, const void* wt, const void* b,
                                     const void* obs, void* partials, void* err, int N, int CIN,
                                     int h, int w, int RI, int TJ, long long smem, int act,
                                     int obs_kind, int stage, double drop_p,
                                     unsigned long long seed, int device, void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const uintptr_t align = obs_kind == KIND_F32 ? 16 : 4;
    if ((CIN != 1 && CIN != 2) || (act != TAIL2_RELU && act != TAIL2_SIGMOID) || N < 1 || h < 1 ||
        w < 2 || w % 2 || RI < 1 || TJ < 2 || TJ % 2 || drop_p < 0.0 || drop_p >= 1.0 ||
        obs_kind < KIND_F32 || obs_kind > KIND_U32 || (obs_kind == KIND_U32 && (2 * w) % 32) ||
        reinterpret_cast<uintptr_t>(obs) % align ||
        static_cast<size_t>(smem) != loss_tail2_smem(obs_kind, CIN, w, RI, TJ))
        return static_cast<int>(cudaErrorInvalidValue);
    const LossArgs a{x, wt, b, obs, partials, err, N, Tail2Shape{h, w, RI, TJ},
                     static_cast<size_t>(smem), stage};
    const DropCfg cfg = make_drop_cfg(drop_p, seed);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool drop = drop_p > 0.0;
    e = CIN == 1 ? launch_act<1>(act, drop, obs_kind, a, cfg, s)
                 : launch_act<2>(act, drop, obs_kind, a, cfg, s);
    return static_cast<int>(e);
}

// Registers, static shared memory, spilled bytes and resident blocks a
// multiprocessor (common.cuh::kernel_occupancy) of the instantiation (CIN,
// act, dropout, obs_kind) at smem bytes.
extern "C" int loss_tail2_fwd_occupancy(int cin, int act, int drop, int obs_kind,
                                        long long smem, int device, int* out) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t bytes = static_cast<size_t>(smem);
#define LT2_OCC(C, A, D, O)                                                                 \
    if (cin == C && act == A && drop == D)                                                  \
        return kernel_occupancy(loss_tail2_fwd_kernel<C, A, D, O>, TAIL2_THREADS, bytes, out);
#define LT2_OCC_OBS(O)                                                                      \
    LT2_OCC(1, TAIL2_RELU, 0, O) LT2_OCC(1, TAIL2_RELU, 1, O) LT2_OCC(1, TAIL2_SIGMOID, 0, O) \
    LT2_OCC(1, TAIL2_SIGMOID, 1, O) LT2_OCC(2, TAIL2_RELU, 0, O) LT2_OCC(2, TAIL2_RELU, 1, O) \
    LT2_OCC(2, TAIL2_SIGMOID, 0, O) LT2_OCC(2, TAIL2_SIGMOID, 1, O)
    if (obs_kind == KIND_U8) { LT2_OCC_OBS(uint8_t) }
    else if (obs_kind == KIND_U32) { LT2_OCC_OBS(uint32_t) }
    else { LT2_OCC_OBS(float) }
#undef LT2_OCC_OBS
#undef LT2_OCC
    return static_cast<int>(cudaErrorInvalidValue);
}
