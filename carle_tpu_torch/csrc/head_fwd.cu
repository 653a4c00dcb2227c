// head_fwd: one conv stage of a wrapper net in one kernel.
//
// Replaces carle_tpu/ops/pallas_head.py::make_fused_head's forward kernel
// _head_fwd_kernel.
//
//   out = maxpool_P(relu(drop(conv3x3(x, w) + b)))    [O, H/P, W/P]
//
// with zero padding 1; x is [N, C, H, W] float32, or the universe as uint8
// cells or packed uint32 words [N, 1, H, W/32], which are converted while they
// are staged (common.cuh; the TPU wrapper casts before its kernel).
// relu and max commute, so a pooled value is relu(max over the window of the
// pre-activation).  Dropout (drop_p > 0) is in-kernel Philox indexed by the
// element at dropout stage `stage` (philox.cuh): stage 0 or 1 draws the bits
// the two-stage encoder and the whole-autoencoder kernels draw for their
// first or second convolution.
//
// Bound on an H100: bytes for a float32 input of few output channels (4 C
// bytes read a position against 18 C O flops), operations for cells.  Design:
// encoder_fwd's second stage with the band staged from device memory.  A
// block owns a band of R output rows and a tile of T output columns of one
// universe, stages the R P + 2 input rows of every channel over the tile's
// T P columns and one halo column each side (clamped to the universe: zero
// only past its edges) in shared memory as floats, and one thread computes a
// pool window for all output channels.  A universe too wide for one band of
// the whole width takes several tiles (ops/cuda_stages.py::_head_bands); one
// tile, T = W / P, is the untiled launch.  Dropout's Philox counter is keyed
// by the global column, so tiles draw the untiled mask.
#include "net_stages.cuh"

// T: output columns a tile.
__host__ __device__ inline size_t head_fwd_smem(int C, int O, int T, int P, int R) {
    return 4 * (static_cast<size_t>(O) * C * 9 + O +
                static_cast<size_t>(C) * (R * P + 2) * (T * P + 2));
}

// TILED as head_bwd.cu's: without it the untiled kernel (TC = W / P).
template <typename T, int P, bool DROP, bool TILED>
__global__ void head_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                                const float* __restrict__ b, float* __restrict__ out, int C,
                                int O, int H, int W, int R, int TCt, int stage, DropCfg cfg) {
    const int Ho = H / P, Wo = W / P;
    const int TC = TILED ? TCt : Wo;
    const int tiles = TILED ? (Wo + TC - 1) / TC : 1;
    const int n = blockIdx.y;
    const int o0 = (TILED ? blockIdx.x / tiles : blockIdx.x) * R;  // first output row of the band
    const int oc0 = TILED ? (blockIdx.x % tiles) * TC : 0;         // first output column of the tile
    const int xr0 = o0 * P - 1;                // first input row held
    const int xc0 = oc0 * P - 1;               // first input column held
    const int XR = R * P + 2, XW = TC * P + 2;  // input rows and columns held
    const int TW = min(TC, Wo - oc0);          // the tile's output columns
    const int tid = threadIdx.x, nt = blockDim.x;

    extern __shared__ float smem[];
    float* ws = smem;                      // O * C * 9
    float* bs = ws + O * C * 9;            // O
    float* xs = bs + O;                    // C x XR x XW

    copy_floats(ws, w, O * C * 9);
    copy_floats(bs, b, O);
    if (TILED)
        stage_planes_window<T>(xs, cells_at(x, static_cast<size_t>(n) * C * H * W), C, xr0,
                               XR, xc0, XW, H, W);
    else
        stage_planes<T, 1>(xs, cells_at(x, static_cast<size_t>(n) * C * H * W), C, xr0, XR, H,
                           W);
    __syncthreads();

    float* on = out + static_cast<size_t>(n) * O * Ho * Wo;
    for (int i = tid; i < R * TW; i += nt) {
        const int lr = i / TW, lc = i - lr * TW;
        const int orow = o0 + lr, oc = oc0 + lc;
        if (orow >= Ho) continue;
        float m[MAXC];
#pragma unroll
        for (int o = 0; o < MAXC; ++o) m[o] = NEG_INF;
        for (int py = 0; py < P; ++py)
            for (int px = 0; px < P; ++px) {
                const int y = orow * P + py, xx = oc * P + px;
                float acc[MAXC];
                encoder_stage2_preact(xs, XR, XW, y - xr0, xx - xc0, ws, bs, C, O, acc);
                unsigned keep = 0;
                if (DROP) keep = drop_keep_bits(cfg, stage, n, O, y, xx);
#pragma unroll
                for (int o = 0; o < MAXC; ++o) {
                    if (DROP) acc[o] = drop_apply(acc[o], keep, o, cfg.scale);
                    m[o] = fmaxf(m[o], acc[o]);
                }
            }
#pragma unroll
        for (int o = 0; o < MAXC; ++o)
            if (o < O) on[(static_cast<size_t>(o) * Ho + orow) * Wo + oc] = fmaxf(m[o], 0.f);
    }
}

struct HeadFwdArgs {
    const void *x, *w, *b;
    void* out;
    int N, C, O, H, W, R, TC, stage;
    size_t smem;
};

template <typename T, int P, bool DROP>
static int launch_as(const HeadFwdArgs& a, const DropCfg& cfg, cudaStream_t s) {
    if (a.TC < 1 || a.smem != head_fwd_smem(a.C, a.O, a.TC, P, a.R))
        return static_cast<int>(cudaErrorInvalidValue);
    const auto kernel = a.TC < a.W / P ? head_fwd_kernel<T, P, DROP, true>
                                       : head_fwd_kernel<T, P, DROP, false>;
    cudaError_t e = allow_smem(kernel, a.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int Ho = a.H / P, Wo = a.W / P;
    const int blocks = ((Ho + a.R - 1) / a.R) * ((Wo + a.TC - 1) / a.TC);
    KERNEL_LAUNCH(kernel, dim3(blocks, a.N), 256, a.smem, s,
                  static_cast<const T*>(a.x), static_cast<const float*>(a.w),
                  static_cast<const float*>(a.b), static_cast<float*>(a.out), a.C, a.O, a.H,
                  a.W, a.R, a.TC, a.stage, cfg);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
static int launch_pool(const HeadFwdArgs& a, double drop_p, const DropCfg& cfg,
                       cudaStream_t s) {
    if (drop_p > 0.0) return launch_as<T, P, true>(a, cfg, s);
    return launch_as<T, P, false>(a, cfg, s);
}

template <typename T>
static int launch_type(const HeadFwdArgs& a, int pool, double drop_p, const DropCfg& cfg,
                       cudaStream_t s) {
    if (pool == 2) return launch_pool<T, 2>(a, drop_p, cfg, s);
    if (pool == 4) return launch_pool<T, 4>(a, drop_p, cfg, s);
    if (pool == 8) return launch_pool<T, 8>(a, drop_p, cfg, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

// TC: output columns a tile (W / pool: one tile).  smem must equal
// head_fwd_smem (ops/cuda_stages.py::_head_fwd_smem).
extern "C" int head_fwd_launch(const void* x, const void* w, const void* b, void* out, int N,
                               int C, int O, int H, int W, int pool, int R, int TC,
                               long long smem,
                               int x_kind, int stage, double drop_p,
                               unsigned long long seed, int device, void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (C > MAXC || O > MAXC || drop_p < 0.0 || drop_p >= 1.0)
        return static_cast<int>(cudaErrorInvalidValue);
    const HeadFwdArgs a{x, w, b, out, N, C, O, H, W, R, TC, stage, static_cast<size_t>(smem)};
    const DropCfg cfg = make_drop_cfg(drop_p, seed);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_kind == KIND_U8) return launch_type<uint8_t>(a, pool, drop_p, cfg, s);
    if (x_kind == KIND_U32) return launch_type<uint32_t>(a, pool, drop_p, cfg, s);
    return launch_type<float>(a, pool, drop_p, cfg, s);
}
