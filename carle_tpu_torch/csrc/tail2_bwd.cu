// tail2_bwd: the gradients of tail2_fwd's stage at the package's two stage
// widths (CIN = 2 or 1, COUT = 1), relu or sigmoid, specialised at compile
// time.
//
// Replaces carle_tpu/ops/pallas_head.py::make_fused_tail's backward kernel
// _tail_bwd_kernel for every caller in the package; tail.cu stays the generic
// instantiation for other widths.  From the input x, the weights, the
// cotangent g [N, 1, 2h, 2w] of the activation and the dropout keep bits it
// gives dW [CIN, 1, 4, 4], db [1] and gx [N, CIN, h, w].  The keep bits are
// the training forward's (keep not null: tail2_fwd.cu saved them, so no
// random number is drawn here) or, for a caller that asks for the gradients
// alone, drawn again by element (philox.cuh), the same bits.
//
// Bound on an H100: bytes (g and x read, gx written: about 5 bytes an output
// at one channel) against 12 CIN multiply-adds and an activation's
// derivative an output; with bits drawn here, a Philox draw an output.  The
// generic kernel walked deconv_preact's 16 taps for every cotangent
// position, drew Philox again, summed dW with a block reduction for each of
// its 16 taps, and staged its band of whole rows, so on the spatial tier's
// slot blocks one block of 256 threads held a multiprocessor alone.  Here
// tail2_bwd.cuh's kernel on g (GradRows): small windows (ops/cuda_stages.py::
// _tail2_plan, at least two blocks a multiprocessor), the parity stencils, dW
// and db in registers, warp exchanges and one partial row a block, gx in the
// generic kernel's order; column_sums_kernel adds the partial rows in a fixed
// order (the same bits every run, no atomics).  Instances beyond the grid's
// 65,535 rows go in further launches.
#include "tail2_bwd.cuh"

struct BwdArgs {
    const void *x, *wt, *b, *g, *keep;
    void *partials, *gx;
    int N;
    Tail2Shape sh;
    size_t bytes;
    int stage;
};

template <int CIN, int ACT, int KEEP>
static cudaError_t launch_as(const BwdArgs& a, const DropCfg& cfg, cudaStream_t s) {
    const auto kernel = tail2_bwd_kernel<CIN, ACT, KEEP, GradRows>;
    cudaError_t e = allow_smem(kernel, a.bytes);
    if (e != cudaSuccess) return e;
    const int T = min(a.sh.TJ, a.sh.w);
    const int blocks = ((a.sh.h + a.sh.RI - 1) / a.sh.RI) * ((a.sh.w + T - 1) / T);
    const Tail2Weights wp{static_cast<const float*>(a.wt), static_cast<const float*>(a.b)};
    for (int n0 = 0; n0 < a.N; n0 += MAX_GRID_Y) {
        KERNEL_LAUNCH(kernel, dim3(blocks, grid_rows(a.N, n0)), TAIL2_THREADS, a.bytes, s,
                      static_cast<const float*>(a.x), wp,
                      GradRows{static_cast<const float*>(a.g)},
                      static_cast<const uint8_t*>(a.keep), static_cast<float*>(a.gx),
                      static_cast<float*>(a.partials), a.sh, n0, a.stage, cfg);
        e = cudaGetLastError();
        if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
}

template <int CIN, int ACT>
static cudaError_t launch_keep(int keep, const BwdArgs& a, const DropCfg& cfg, cudaStream_t s) {
    if (keep == KEEP_READ) return launch_as<CIN, ACT, KEEP_READ>(a, cfg, s);
    if (keep == KEEP_DRAW) return launch_as<CIN, ACT, KEEP_DRAW>(a, cfg, s);
    return launch_as<CIN, ACT, KEEP_NONE>(a, cfg, s);
}

template <int CIN>
static cudaError_t launch_act(int act, int keep, const BwdArgs& a, const DropCfg& cfg,
                              cudaStream_t s) {
    return act == TAIL2_RELU ? launch_keep<CIN, TAIL2_RELU>(keep, a, cfg, s)
                             : launch_keep<CIN, TAIL2_SIGMOID>(keep, a, cfg, s);
}

// x, wt, b, N, CIN, h, w, RI, TJ, act, stage as tail2_fwd_launch; g [N, 1,
// 2h, 2w] the activation's cotangent; keep: what tail2_fwd_launch saved for
// the same inputs, weights, dropout and seed (null: draw the bits, or none
// without dropout).  partials: scratch of N x ceil(h / RI) x ceil(w / TJ) x
// (16 CIN + 1) floats; grads receives dW then db; gx [N, CIN, h, w].  smem
// must equal tail2_bwd_smem.
extern "C" int tail2_bwd_launch(const void* x, const void* wt, const void* b, const void* g,
                                const void* keep, void* partials, void* grads, void* gx, int N,
                                int CIN, int h, int w, int RI, int TJ, long long smem, int act,
                                int stage, double drop_p, unsigned long long seed, int device,
                                void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const bool drop = drop_p > 0.0;
    if ((CIN != 1 && CIN != 2) || (act != TAIL2_RELU && act != TAIL2_SIGMOID) || h < 1 ||
        w < 2 || w % 2 || RI < 1 || TJ < 2 || TJ % 2 || drop_p < 0.0 || drop_p >= 1.0 ||
        (keep != nullptr && !drop) ||
        static_cast<size_t>(smem) != tail2_bwd_smem(CIN, w, RI, TJ))
        return static_cast<int>(cudaErrorInvalidValue);
    const BwdArgs a{x, wt, b, g, keep, partials, gx, N, Tail2Shape{h, w, RI, TJ},
                    static_cast<size_t>(smem), stage};
    const DropCfg cfg = make_drop_cfg(drop_p, seed);
    const int mode = keep != nullptr ? KEEP_READ : drop ? KEEP_DRAW : KEEP_NONE;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    e = CIN == 1 ? launch_act<1>(act, mode, a, cfg, s) : launch_act<2>(act, mode, a, cfg, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int T = TJ < w ? TJ : w;
    const int K = 16 * CIN + 1;
    KERNEL_LAUNCH(column_sums_kernel, K, 128, 0, s, static_cast<const float*>(partials),
                  N * ((h + RI - 1) / RI) * ((w + T - 1) / T), K, static_cast<float*>(grads));
    return static_cast<int>(cudaGetLastError());
}

template <int CIN, int ACT>
static int occupancy_as(int keep, size_t bytes, int* out) {
    if (keep == KEEP_READ)
        return kernel_occupancy(tail2_bwd_kernel<CIN, ACT, KEEP_READ, GradRows>, TAIL2_THREADS,
                                bytes, out);
    if (keep == KEEP_DRAW)
        return kernel_occupancy(tail2_bwd_kernel<CIN, ACT, KEEP_DRAW, GradRows>, TAIL2_THREADS,
                                bytes, out);
    return kernel_occupancy(tail2_bwd_kernel<CIN, ACT, KEEP_NONE, GradRows>, TAIL2_THREADS, bytes,
                            out);
}

// Registers, static shared memory, spilled bytes and resident blocks a
// multiprocessor of the instantiation (CIN, act, keep: bit_table.cuh's
// KEEP_NONE, KEEP_DRAW, KEEP_READ) at smem bytes.
extern "C" int tail2_bwd_occupancy(int cin, int act, int keep, long long smem, int device,
                                   int* out) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t bytes = static_cast<size_t>(smem);
    if (cin == 1)
        return act == TAIL2_RELU ? occupancy_as<1, TAIL2_RELU>(keep, bytes, out)
                                 : occupancy_as<1, TAIL2_SIGMOID>(keep, bytes, out);
    return act == TAIL2_RELU ? occupancy_as<2, TAIL2_RELU>(keep, bytes, out)
                             : occupancy_as<2, TAIL2_SIGMOID>(keep, bytes, out);
}
