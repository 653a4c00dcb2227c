// tail and loss_tail: one decoder stage of the wrapper autoencoder, forward
// and backward, alone or fused with the reconstruction error.
//
// Replaces carle_tpu/ops/pallas_head.py::make_fused_tail (_tail_fwd_kernel,
// _tail_bwd_kernel) and make_fused_loss_tail (_loss_tail_fwd_kernel,
// _loss_tail_bwd_kernel).
//
//   y = act(drop(conv_transpose(x, wt, k4 s2 p1) + b))    [COUT, 2h, 2w]
//   tail:      out = y
//   loss_tail: err[n] = sum over (COUT, 2h, 2w) of (obs - y)^2
//
// x [N, CIN, h, w] float32, wt in torch's layout [CIN, COUT, 4, 4], act relu or
// sigmoid, obs cells (uint8, or packed uint32 words [N, COUT, 2h, 2w/32]) or a
// float32 frame.  Dropout (drop_p > 0) is
// in-kernel Philox indexed by the element at dropout stage `stage`
// (philox.cuh): stage 2 or 3 draws the bits the whole-autoencoder kernel draws
// for its first or second transpose convolution.  The loss tail is the tail
// with the error sum in place of the store (forward) and 2 (y - obs) gbar[n]
// in place of the cotangent tensor g (backward).
//
// Forward: a block owns a band of RY output rows of one universe, stages the
// RY/2 + 2 input rows they read (zero outside) in shared memory; one thread
// an output position, all output channels.  The error goes through one
// partial a block and a second launch that adds them in a fixed order.
//
// Backward: a block owns RI input rows and the 2 RI output rows above them.
// It recomputes the pre-activation on its output rows and one row to either
// side, gates the cotangent by the activation's derivative and the dropout
// mask (gz, in shared memory with a zero column each side), sums its part of
// dW [CIN, COUT, 4, 4] and db over its own output rows, and writes
//   gx[c, iy, ix] = sum_o,ky,kx wt[c, o, ky, kx] gz[o, 2 iy - 1 + ky, 2 ix - 1 + kx]
// for its own input rows: the halo rows of gz are recomputed, never added
// twice, and nothing is added atomically (the same bits every run).
// column_sums_kernel adds the blocks' partials.
//
// Bound on an H100: bytes (4 to 5 bytes a position moved against 8 CIN COUT
// flops at the decoder's one or two channels).
#include "net_stages.cuh"

constexpr int ACT_RELU = 0, ACT_SIGMOID = 1;
// what the last argument is: no obs (tail), obs as cells, as floats, as packed words
constexpr int MODE_TENSOR = 0, MODE_OBS_U8 = 1, MODE_OBS_F32 = 2, MODE_OBS_U32 = 3;
constexpr int RED16_FLOATS = 32 * 16;

template <int ACT>
__device__ __forceinline__ float tail_act(float r) {
    return ACT == ACT_RELU ? fmaxf(r, 0.f) : 1.f / (1.f + expf(-r));
}

template <int MODE>
__device__ __forceinline__ float obs_value(const void* obs, size_t i) {
    return MODE == MODE_OBS_U8    ? cell_value(static_cast<const uint8_t*>(obs), i)
           : MODE == MODE_OBS_U32 ? cell_value(static_cast<const uint32_t*>(obs), i)
                                  : cell_value(static_cast<const float*>(obs), i);
}

__host__ __device__ inline size_t tail_fwd_smem(int CIN, int COUT, int w, int RY) {
    return 4 * (static_cast<size_t>(CIN) * COUT * 16 + COUT +
                static_cast<size_t>(CIN) * (RY / 2 + 2) * w + 32);
}

__host__ __device__ inline size_t tail_bwd_smem(int CIN, int COUT, int w, int RI) {
    return 4 * (static_cast<size_t>(CIN) * COUT * 16 + COUT +
                static_cast<size_t>(CIN) * (RI + 2) * w +
                static_cast<size_t>(COUT) * (2 * RI + 2) * (2 * w + 2) + RED16_FLOATS);
}

// out: the activation [N, COUT, 2h, 2w] (MODE_TENSOR) or one partial error sum
// a block [N, bands].
template <int ACT, bool DROP, int MODE>
__global__ void tail_fwd_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                                const float* __restrict__ b, const void* __restrict__ obs,
                                float* __restrict__ out, int CIN, int COUT, int h, int w,
                                int RY, int stage, DropCfg cfg) {
    const int H2 = 2 * h, W2 = 2 * w;
    const int n = blockIdx.y, band = blockIdx.x;
    const int Y0 = band * RY;
    const int I0 = Y0 / 2 - 1, IR = RY / 2 + 2;  // input rows held
    const int tid = threadIdx.x, nt = blockDim.x;

    extern __shared__ float smem[];
    float* wts = smem;                     // CIN * COUT * 16
    float* bts = wts + CIN * COUT * 16;    // COUT
    float* xs = bts + COUT;                // CIN x IR x w
    float* red = xs + CIN * IR * w;        // 32

    copy_floats(wts, wt, CIN * COUT * 16);
    copy_floats(bts, b, COUT);
    stage_planes<float, 0>(xs, x + static_cast<size_t>(n) * CIN * h * w, CIN, I0, IR, h, w);
    __syncthreads();

    const size_t base = static_cast<size_t>(n) * COUT * H2 * W2;
    float part[1] = {0.f};
    for (int i = tid; i < RY * W2; i += nt) {
        const int lr = i / W2, xo = i - lr * W2;
        const int gy = Y0 + lr;
        if (gy >= H2) continue;
        float acc[MAXC];
        deconv_preact(xs, I0, IR, 0, w, wts, bts, CIN, COUT, gy, xo, acc);
        unsigned keep = 0;
        if (DROP) keep = drop_keep_bits(cfg, stage, n, COUT, gy, xo);
#pragma unroll
        for (int o = 0; o < MAXC; ++o) {
            if (o < COUT) {
                const float r = DROP ? drop_apply(acc[o], keep, o, cfg.scale) : acc[o];
                const float y = tail_act<ACT>(r);
                const size_t at = base + (static_cast<size_t>(o) * H2 + gy) * W2 + xo;
                if (MODE == MODE_TENSOR) {
                    out[at] = y;
                } else {
                    const float d = obs_value<MODE>(obs, at) - y;
                    part[0] += d * d;
                }
            }
        }
    }
    if (MODE != MODE_TENSOR)
        block_sums<1>(part, red, out + static_cast<size_t>(n) * gridDim.x + band);
}

// up: the cotangent g [N, COUT, 2h, 2w] of the activation (MODE_TENSOR) or obs;
// gbar [N] only with obs.  partials: one row a block of CIN COUT 16 + COUT.
template <int ACT, bool DROP, int MODE>
__global__ void tail_bwd_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                                const float* __restrict__ b, const void* __restrict__ up,
                                const float* __restrict__ gbar, float* __restrict__ gx,
                                float* __restrict__ partials, int CIN, int COUT, int h, int w,
                                int RI, int stage, DropCfg cfg) {
    const int H2 = 2 * h, W2 = 2 * w;
    const int n = blockIdx.y;
    const int i0 = blockIdx.x * RI;            // first input row owned
    const int I0 = i0 - 1, IR = RI + 2;        // input rows held
    const int Y0 = 2 * i0;                     // first output row owned
    const int GYR = 2 * RI + 2, GYW = W2 + 2;  // gz rows from Y0 - 1, columns from -1
    const int tid = threadIdx.x, nt = blockDim.x;

    extern __shared__ float smem[];
    float* wts = smem;                     // CIN * COUT * 16
    float* bts = wts + CIN * COUT * 16;    // COUT
    float* xs = bts + COUT;                // CIN x IR x w
    float* gys = xs + CIN * IR * w;        // COUT x GYR x GYW
    float* red = gys + COUT * GYR * GYW;   // RED16_FLOATS

    copy_floats(wts, wt, CIN * COUT * 16);
    copy_floats(bts, b, COUT);
    stage_planes<float, 0>(xs, x + static_cast<size_t>(n) * CIN * h * w, CIN, I0, IR, h, w);
    __syncthreads();

    // (a) gz: the cotangent of the pre-activation on rows Y0 - 1 .. Y0 + 2 RI
    const size_t base = static_cast<size_t>(n) * COUT * H2 * W2;
    const float gb2 = MODE == MODE_TENSOR ? 0.f : 2.f * gbar[n];
    for (int i = tid; i < GYR * GYW; i += nt) {
        const int lr = i / GYW, lc = i - lr * GYW;
        const int gy = Y0 - 1 + lr, xo = lc - 1;
        const bool inside = gy >= 0 && gy < H2 && xo >= 0 && xo < W2;
        float acc[MAXC];
        unsigned keep = 0;
        if (inside) {
            deconv_preact(xs, I0, IR, 0, w, wts, bts, CIN, COUT, gy, xo, acc);
            if (DROP) keep = drop_keep_bits(cfg, stage, n, COUT, gy, xo);
        }
#pragma unroll
        for (int o = 0; o < MAXC; ++o) {
            if (o < COUT) {
                float gc = 0.f;
                if (inside) {
                    const float r = DROP ? drop_apply(acc[o], keep, o, cfg.scale) : acc[o];
                    const float y = tail_act<ACT>(r);
                    const size_t at = base + (static_cast<size_t>(o) * H2 + gy) * W2 + xo;
                    const float gv = MODE == MODE_TENSOR
                                         ? static_cast<const float*>(up)[at]
                                         : gb2 * (y - obs_value<MODE>(up, at));
                    gc = ACT == ACT_RELU ? (r > 0.f ? gv : 0.f) : gv * y * (1.f - y);
                    if (DROP) gc = ((keep >> o) & 1u) ? gc * cfg.scale : 0.f;
                }
                gys[(o * GYR + lr) * GYW + lc] = gc;
            }
        }
    }
    __syncthreads();

    const int K_w = CIN * COUT * 16;
    float* row = partials + (static_cast<size_t>(n) * gridDim.x + blockIdx.x) * (K_w + COUT);
    const int y_end = min(Y0 + 2 * RI, H2);    // owned output rows [Y0, y_end)

    // (b) this band's part of dW [CIN, COUT, 4, 4] and db [COUT]
    for (int c = 0; c < CIN; ++c)
        for (int o = 0; o < COUT; ++o) {
            float v[16];
#pragma unroll
            for (int k = 0; k < 16; ++k) v[k] = 0.f;
            for (int i = tid; i < IR * w; i += nt) {
                const int lr = i / w, ix = i - lr * w;
                const float xv = xs[(c * IR + lr) * w + ix];
                const int ybase = 2 * (I0 + lr) - 1, xbase = 2 * ix - 1;
#pragma unroll
                for (int ky = 0; ky < 4; ++ky) {
                    const int yr = ybase + ky;
                    if (yr < Y0 || yr >= y_end) continue;
                    const float* gp = gys + (o * GYR + yr - (Y0 - 1)) * GYW + xbase + 1;
#pragma unroll
                    for (int kx = 0; kx < 4; ++kx) v[ky * 4 + kx] += xv * gp[kx];
                }
            }
            block_sums<16>(v, red, row + (c * COUT + o) * 16);
        }
    for (int o = 0; o < COUT; ++o) {
        float bsum[1] = {0.f};
        for (int i = tid; i < (y_end - Y0) * W2; i += nt) {
            const int lr = i / W2, xo = i - lr * W2;
            bsum[0] += gys[(o * GYR + lr + 1) * GYW + xo + 1];
        }
        block_sums<1>(bsum, red, row + K_w + o);
    }

    // (c) the input cotangent on the band's own input rows
    float* gxn = gx + static_cast<size_t>(n) * CIN * h * w;
    for (int i = tid; i < RI * w; i += nt) {
        const int lr = i / w, ix = i - lr * w;
        const int iy = i0 + lr;
        if (iy >= h) continue;
        for (int c = 0; c < CIN; ++c) {
            float s = 0.f;
            for (int o = 0; o < COUT; ++o) {
                const float* wp = wts + (c * COUT + o) * 16;
#pragma unroll
                for (int ky = 0; ky < 4; ++ky) {
                    const float* gp = gys + (o * GYR + 2 * lr + ky) * GYW + 2 * ix;
#pragma unroll
                    for (int kx = 0; kx < 4; ++kx) s += wp[ky * 4 + kx] * gp[kx];
                }
            }
            gxn[(static_cast<size_t>(c) * h + iy) * w + ix] = s;
        }
    }
}

struct TailArgs {
    const void *x, *wt, *b, *up, *gbar;  // up: obs, or g in the tail's backward
    void *out, *partials, *grads;        // forward: out or (partials, out = err)
    int N, CIN, COUT, h, w, R, stage;
    size_t smem;
};

template <int ACT, bool DROP, int MODE>
static int forward_as(const TailArgs& a, const DropCfg& cfg, cudaStream_t s) {
    const auto kernel = tail_fwd_kernel<ACT, DROP, MODE>;
    cudaError_t e = allow_smem(kernel, a.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int bands = (2 * a.h + a.R - 1) / a.R;
    float* dst = static_cast<float*>(MODE == MODE_TENSOR ? a.out : a.partials);
    KERNEL_LAUNCH(kernel, dim3(bands, a.N), 256, a.smem, s, static_cast<const float*>(a.x),
                  static_cast<const float*>(a.wt), static_cast<const float*>(a.b), a.up, dst,
                  a.CIN, a.COUT, a.h, a.w, a.R, a.stage, cfg);
    e = cudaGetLastError();
    if (e != cudaSuccess || MODE == MODE_TENSOR) return static_cast<int>(e);
    KERNEL_LAUNCH(row_sums_kernel, (a.N + 127) / 128, 128, 0, s,
                  static_cast<const float*>(a.partials), bands, static_cast<float*>(a.out), a.N);
    return static_cast<int>(cudaGetLastError());
}

template <int ACT, bool DROP, int MODE>
static int backward_as(const TailArgs& a, const DropCfg& cfg, cudaStream_t s) {
    const auto kernel = tail_bwd_kernel<ACT, DROP, MODE>;
    cudaError_t e = allow_smem(kernel, a.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int bands = (a.h + a.R - 1) / a.R;
    KERNEL_LAUNCH(kernel, dim3(bands, a.N), 256, a.smem, s, static_cast<const float*>(a.x),
                  static_cast<const float*>(a.wt), static_cast<const float*>(a.b), a.up,
                  static_cast<const float*>(a.gbar), static_cast<float*>(a.out),
                  static_cast<float*>(a.partials), a.CIN, a.COUT, a.h, a.w, a.R, a.stage, cfg);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const int K = a.CIN * a.COUT * 16 + a.COUT;
    KERNEL_LAUNCH(column_sums_kernel, K, 128, 0, s, static_cast<const float*>(a.partials),
                  bands * a.N, K, static_cast<float*>(a.grads));
    return static_cast<int>(cudaGetLastError());
}

template <int ACT, bool DROP, int MODE>
static int run_as(const TailArgs& a, bool backward, const DropCfg& cfg, cudaStream_t s) {
    return backward ? backward_as<ACT, DROP, MODE>(a, cfg, s) : forward_as<ACT, DROP, MODE>(a, cfg, s);
}

template <int ACT, bool DROP>
static int run_mode(const TailArgs& a, int mode, bool backward, const DropCfg& cfg,
                    cudaStream_t s) {
    if (mode == MODE_TENSOR) return run_as<ACT, DROP, MODE_TENSOR>(a, backward, cfg, s);
    if (mode == MODE_OBS_U8) return run_as<ACT, DROP, MODE_OBS_U8>(a, backward, cfg, s);
    if (mode == MODE_OBS_U32) return run_as<ACT, DROP, MODE_OBS_U32>(a, backward, cfg, s);
    return run_as<ACT, DROP, MODE_OBS_F32>(a, backward, cfg, s);
}

static int run(const TailArgs& a, int act, int mode, bool backward, double drop_p,
               unsigned long long seed, int device, void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t want = backward ? tail_bwd_smem(a.CIN, a.COUT, a.w, a.R)
                                 : tail_fwd_smem(a.CIN, a.COUT, a.w, a.R);
    if (a.CIN > MAXC || a.COUT > MAXC || drop_p < 0.0 || drop_p >= 1.0 || a.smem != want ||
        (act != ACT_RELU && act != ACT_SIGMOID) || (!backward && a.R % 2) ||
        (mode == MODE_OBS_U32 && (2 * a.w) % 32))
        return static_cast<int>(cudaErrorInvalidValue);
    const DropCfg cfg = make_drop_cfg(drop_p, seed);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (act == ACT_RELU)
        return drop_p > 0.0 ? run_mode<ACT_RELU, true>(a, mode, backward, cfg, s)
                            : run_mode<ACT_RELU, false>(a, mode, backward, cfg, s);
    return drop_p > 0.0 ? run_mode<ACT_SIGMOID, true>(a, mode, backward, cfg, s)
                        : run_mode<ACT_SIGMOID, false>(a, mode, backward, cfg, s);
}

// obs_kind (KIND_F32, KIND_U8, KIND_U32 in common.cuh) as a mode.
static int obs_mode(int obs_kind) {
    return obs_kind == KIND_U8 ? MODE_OBS_U8 : obs_kind == KIND_U32 ? MODE_OBS_U32 : MODE_OBS_F32;
}

// The four launchers: h and w are the input's extent, act 0 relu / 1 sigmoid,
// R the band (RY output rows forward, RI input rows backward), smem
// tail_fwd_smem or tail_bwd_smem (ops/cuda_stages.py computes the same).
// Scratch: forward partials N x ceil(2h / RY) (loss tail only); backward
// partials N x ceil(h / RI) x (CIN COUT 16 + COUT); grads receives dW then db.

extern "C" int tail_fwd_launch(const void* x, const void* wt, const void* b, void* out, int N,
                               int CIN, int COUT, int h, int w, int RY, long long smem,
                               int act, int stage, double drop_p, unsigned long long seed,
                               int device, void* stream) {
    const TailArgs a{x, wt, b, nullptr, nullptr, out, nullptr, nullptr, N, CIN, COUT, h, w, RY,
                     stage, static_cast<size_t>(smem)};
    return run(a, act, MODE_TENSOR, false, drop_p, seed, device, stream);
}

extern "C" int tail_bwd_launch(const void* x, const void* wt, const void* b, const void* g,
                               void* partials, void* grads, void* gx, int N, int CIN, int COUT,
                               int h, int w, int RI, long long smem, int act, int stage,
                               double drop_p, unsigned long long seed, int device,
                               void* stream) {
    const TailArgs a{x, wt, b, g, nullptr, gx, partials, grads, N, CIN, COUT, h, w, RI, stage,
                     static_cast<size_t>(smem)};
    return run(a, act, MODE_TENSOR, true, drop_p, seed, device, stream);
}

extern "C" int loss_tail_fwd_launch(const void* x, const void* wt, const void* b,
                                    const void* obs, void* partials, void* err, int N, int CIN,
                                    int COUT, int h, int w, int RY, long long smem, int act,
                                    int obs_kind, int stage, double drop_p,
                                    unsigned long long seed, int device, void* stream) {
    const TailArgs a{x, wt, b, obs, nullptr, err, partials, nullptr, N, CIN, COUT, h, w, RY,
                     stage, static_cast<size_t>(smem)};
    return run(a, act, obs_mode(obs_kind), false, drop_p, seed, device,
               stream);
}

extern "C" int loss_tail_bwd_launch(const void* x, const void* wt, const void* b,
                                    const void* obs, const void* gbar, void* partials,
                                    void* grads, void* gx, int N, int CIN, int COUT, int h,
                                    int w, int RI, long long smem, int act, int obs_kind,
                                    int stage, double drop_p, unsigned long long seed,
                                    int device, void* stream) {
    const TailArgs a{x, wt, b, obs, gbar, gx, partials, grads, N, CIN, COUT, h, w, RI, stage,
                     static_cast<size_t>(smem)};
    return run(a, act, obs_mode(obs_kind), true, drop_p, seed, device,
               stream);
}
