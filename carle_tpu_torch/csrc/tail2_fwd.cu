// tail2_fwd: one decoder stage at the package's two stage widths (CIN = 2 or
// 1, COUT = 1), relu or sigmoid, specialised at compile time.
//
// Replaces carle_tpu/ops/pallas_head.py::make_fused_tail's forward kernel
// _tail_fwd_kernel for every caller in the package (ae_forward's two stages,
// SpaceSharding's tail_spatial, the autoencoder by four kernels); tail.cu
// stays the generic instantiation for other widths.  It computes what
// tail.cu's tail_fwd_kernel computes,
//
//   y = act(drop(conv_transpose(x, wt, k4 s2 p1) + b)),
//
// with the same Philox dropout, y bit for bit the generic kernel's.  The
// TRAINING forward (keep not null) also writes every keep bit it draws
// (tail2.cuh's layout), so the backward (tail2_bwd.cu) draws none.
//
// Bound on an H100: bytes (4 bytes an output written, a quarter of that read
// a channel, against 4 CIN multiply-adds and an activation an output); with
// dropout a Philox draw an output, whose integer work outweighs the bytes.
// The generic kernel spent its time issuing instructions: a 16-step walk with
// branches for each output that uses 4 of its taps, runtime widths under
// MAXC register arrays, a shared load for every multiply-add's weight, an
// integer division and one 4-byte store an output, and a band of whole rows
// staged in shared memory.  Here a thread owns the 2 x 4 outputs of an input
// pair (i, j), (i, j + 1): it loads the 3 x 4 input window they read from
// the block's staged window into registers (two 8-byte loads a row and a
// channel), computes the eight pre-activations by the parity stencils with
// the weights broadcast from shared memory, and stores each output row as one
// 16-byte store.  A block owns RI input rows and TJ input columns
// (ops/cuda_stages.py::_tail2_plan sizes the grid from the card's
// multiprocessor count).  Instances beyond the grid's 65,535 rows go in
// further launches.
#include "tail2.cuh"

template <int CIN, int ACT, bool DROP, bool SAVE>
__global__ void __launch_bounds__(TAIL2_THREADS, TAIL2_FWD_BLOCKS)
tail2_fwd_kernel(const float* __restrict__ x, Tail2Weights wp, float* __restrict__ out,
                 uint8_t* __restrict__ keep, Tail2Shape sh, int N0, int stage, DropCfg cfg) {
    const Tail2Block bk(sh, N0);
    const int h = sh.h, w = sh.w, W2 = 2 * w, n = bk.n;

    extern __shared__ float smem[];
    const Win xs{smem, bk.i0 - 1, bk.j0 - 1, bk.ri + 2, bk.tj + 2};
    tail2_stage_input<CIN>(xs, x + static_cast<size_t>(n) * CIN * h * w, h, w);
    tail2_load_weights<CIN>(wp);
    copies_wait();
    __syncthreads();

    const int plane = xs.rows * xs.cols;
    float* out_n = out + static_cast<size_t>(n) * 4 * h * w;
    grid_walk(bk.ri, bk.tj / 2, [&](int lr, int lp) {
        const int i = bk.i0 + lr, j = bk.j0 + 2 * lp;
        // X[c][r][q]: input (i - 1 + r, j - 1 + q)
        float X[CIN][3][4];
        const float* p = xs.at(i - 1, j - 1);
#pragma unroll
        for (int c = 0; c < CIN; ++c)
#pragma unroll
            for (int r = 0; r < 3; ++r) {
                const float2 lo = *reinterpret_cast<const float2*>(p + c * plane + r * xs.cols);
                const float2 hi = *reinterpret_cast<const float2*>(p + c * plane + r * xs.cols + 2);
                X[c][r][0] = lo.x;
                X[c][r][1] = lo.y;
                X[c][r][2] = hi.x;
                X[c][r][3] = hi.y;
            }
        unsigned bits = 0;   // byte t: input (i, j + t), bit 2a + b
#pragma unroll
        for (int a = 0; a < 2; ++a) {
            float yv[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                // output (2i + a, 2j + q) = (2i + a, 2 (j + t) + b): parity
                // (1 - a, 1 - b), its window ending at input (i + a, j + t + b)
                const int t = q >> 1, b = q & 1, e = t + b;
                float r = tail2_bias;
#pragma unroll
                for (int c = 0; c < CIN; ++c)
                    r = parity_preact(tail2_wp[c * 4 + (1 - a) * 2 + (1 - b)], r,
                                      X[c][a + 1][e + 1], X[c][a + 1][e], X[c][a][e + 1],
                                      X[c][a][e]);
                if (DROP) {
                    const unsigned k = drop_keep_group(cfg, stage, n, 0, 2 * i + a, 2 * j + q) & 1u;
                    bits |= k << (8 * t + 2 * a + b);
                    r = k ? r * cfg.scale : 0.f;
                }
                yv[q] = tail2_act<ACT>(r);
            }
            *reinterpret_cast<float4*>(out_n + static_cast<size_t>(2 * i + a) * W2 + 2 * j) =
                make_float4(yv[0], yv[1], yv[2], yv[3]);
        }
        if (SAVE)
            *reinterpret_cast<uint16_t*>(keep + (static_cast<size_t>(n) * h + i) * w + j) =
                static_cast<uint16_t>(bits);
    });
}

struct FwdArgs {
    const void *x, *wt, *b;
    void *out, *keep;
    int N;
    Tail2Shape sh;
    size_t bytes;
    int stage;
};

template <int CIN, int ACT, bool DROP, bool SAVE>
static cudaError_t launch_as(const FwdArgs& a, const DropCfg& cfg, cudaStream_t s) {
    const auto kernel = tail2_fwd_kernel<CIN, ACT, DROP, SAVE>;
    cudaError_t e = allow_smem(kernel, a.bytes);
    if (e != cudaSuccess) return e;
    const int T = min(a.sh.TJ, a.sh.w);
    const int blocks = ((a.sh.h + a.sh.RI - 1) / a.sh.RI) * ((a.sh.w + T - 1) / T);
    const Tail2Weights wp{static_cast<const float*>(a.wt), static_cast<const float*>(a.b)};
    for (int n0 = 0; n0 < a.N; n0 += MAX_GRID_Y) {
        KERNEL_LAUNCH(kernel, dim3(blocks, grid_rows(a.N, n0)), TAIL2_THREADS, a.bytes, s,
                      static_cast<const float*>(a.x), wp, static_cast<float*>(a.out),
                      static_cast<uint8_t*>(a.keep), a.sh, n0, a.stage, cfg);
        e = cudaGetLastError();
        if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
}

// mode 0 without dropout, 1 with, 2 with dropout saving the bits
template <int CIN, int ACT>
static cudaError_t launch_mode(int mode, const FwdArgs& a, const DropCfg& cfg, cudaStream_t s) {
    if (mode == 2) return launch_as<CIN, ACT, true, true>(a, cfg, s);
    if (mode == 1) return launch_as<CIN, ACT, true, false>(a, cfg, s);
    return launch_as<CIN, ACT, false, false>(a, cfg, s);
}

template <int CIN>
static cudaError_t launch_act(int act, int mode, const FwdArgs& a, const DropCfg& cfg,
                              cudaStream_t s) {
    return act == TAIL2_RELU ? launch_mode<CIN, TAIL2_RELU>(mode, a, cfg, s)
                             : launch_mode<CIN, TAIL2_SIGMOID>(mode, a, cfg, s);
}

// x [N, CIN, h, w] float32 (w even), wt [CIN, 1, 4, 4], b [1]; out [N, 1, 2h,
// 2w]; keep (not null: the training forward, with dropout) receives every
// keep bit, uint8 [N, h, w].  RI, TJ: a block's input rows and columns (TJ
// even; TJ >= w for the whole width); act 0 relu, 1 sigmoid; stage the
// dropout stage (philox.cuh).  smem must equal tail2_fwd_smem
// (ops/cuda_stages.py computes the same).
extern "C" int tail2_fwd_launch(const void* x, const void* wt, const void* b, void* out,
                                void* keep, int N, int CIN, int h, int w, int RI, int TJ,
                                long long smem, int act, int stage, double drop_p,
                                unsigned long long seed, int device, void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const bool drop = drop_p > 0.0, save = keep != nullptr;
    if ((CIN != 1 && CIN != 2) || (act != TAIL2_RELU && act != TAIL2_SIGMOID) || h < 1 ||
        w < 2 || w % 2 || RI < 1 || TJ < 2 || TJ % 2 || drop_p < 0.0 || drop_p >= 1.0 ||
        (save && !drop) || static_cast<size_t>(smem) != tail2_fwd_smem(CIN, w, RI, TJ))
        return static_cast<int>(cudaErrorInvalidValue);
    const FwdArgs a{x, wt, b, out, keep, N, Tail2Shape{h, w, RI, TJ},
                    static_cast<size_t>(smem), stage};
    const DropCfg cfg = make_drop_cfg(drop_p, seed);
    const int mode = save ? 2 : drop ? 1 : 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    e = CIN == 1 ? launch_act<1>(act, mode, a, cfg, s) : launch_act<2>(act, mode, a, cfg, s);
    return static_cast<int>(e);
}

template <int CIN, int ACT>
static int occupancy_as(int mode, size_t bytes, int* out) {
    if (mode == 2)
        return kernel_occupancy(tail2_fwd_kernel<CIN, ACT, true, true>, TAIL2_THREADS, bytes, out);
    if (mode == 1)
        return kernel_occupancy(tail2_fwd_kernel<CIN, ACT, true, false>, TAIL2_THREADS, bytes, out);
    return kernel_occupancy(tail2_fwd_kernel<CIN, ACT, false, false>, TAIL2_THREADS, bytes, out);
}

// Registers, static shared memory, spilled bytes and resident blocks a
// multiprocessor (common.cuh::kernel_occupancy) of the instantiation (CIN,
// act, mode: 0 without dropout, 1 with, 2 saving the bits) at smem bytes.
extern "C" int tail2_fwd_occupancy(int cin, int act, int mode, long long smem, int device,
                                   int* out) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t bytes = static_cast<size_t>(smem);
    if (cin == 1)
        return act == TAIL2_RELU ? occupancy_as<1, TAIL2_RELU>(mode, bytes, out)
                                 : occupancy_as<1, TAIL2_SIGMOID>(mode, bytes, out);
    return act == TAIL2_RELU ? occupancy_as<2, TAIL2_RELU>(mode, bytes, out)
                             : occupancy_as<2, TAIL2_SIGMOID>(mode, bytes, out);
}
