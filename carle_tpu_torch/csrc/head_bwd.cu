// head_bwd: the gradients of head_fwd.
//
// Replaces carle_tpu/ops/pallas_head.py::make_fused_head's backward kernel
// _head_bwd_kernel: from x, w, b, the dropout seed and the cotangent g of the
// pooled output it gives dW [O, C, 3, 3], db [O] and, with need_dx, the input
// cotangent gx [N, C, H, W], recomputing the forward with its dropout mask.
//
// Staged as encoder_bwd.cuh, each launch's blocks owning their positions
// exclusively (no float is added atomically: the same bits every run):
//
//   1. head_bwd_kernel: a block owns a band of R output rows of one universe.
//      It recomputes the pre-activations of its R P input rows, routes g
//      through the pool (ties share equally: g / count to every element equal
//      to the window maximum, the tie test on the activation as the TPU
//      kernel's _pool_route), the relu gate and the dropout mask, sums its
//      part of dW and db, and with need_dx writes that cotangent of the
//      pre-activation (gc, [N, O, H, W]) to device memory;
//   2. conv_input_grad_kernel (need_dx): gx as the transpose 3x3 convolution
//      of gc with w, one thread an element, the one-row halo of gc read from
//      device memory;
//   3. column_sums_kernel adds the blocks' partial sums in a fixed order.
//
// Bound: operations (the recompute, dW and the input cotangent).
#include "net_stages.cuh"

constexpr int RED_FLOATS = 32 * 9;  // block_sums scratch for 9 values a thread

__host__ __device__ inline size_t head_bwd_smem(int C, int O, int W, int P, int R) {
    return 4 * (static_cast<size_t>(O) * C * 9 + O +
                static_cast<size_t>(C) * (R * P + 2) * (W + 2) +
                static_cast<size_t>(O) * R * P * W + RED_FLOATS);
}

template <typename T, int P, bool DROP>
__global__ void head_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                                const float* __restrict__ b, const float* __restrict__ g,
                                float* __restrict__ gc_out, float* __restrict__ partials,
                                int C, int O, int H, int W, int R, int stage, DropCfg cfg) {
    const int Ho = H / P, Wo = W / P;
    const int n = blockIdx.y;
    const int o0 = blockIdx.x * R;
    const int xr0 = o0 * P - 1, XR = R * P + 2, XW = W + 2, GR = R * P;
    const int tid = threadIdx.x, nt = blockDim.x;

    extern __shared__ float smem[];
    float* ws = smem;                      // O * C * 9
    float* bs = ws + O * C * 9;            // O
    float* xs = bs + O;                    // C x XR x XW
    float* gcs = xs + C * XR * XW;         // O x GR x W: cotangent of the pre-activation
    float* red = gcs + O * GR * W;         // RED_FLOATS

    copy_floats(ws, w, O * C * 9);
    copy_floats(bs, b, O);
    stage_planes<T, 1>(xs, x + static_cast<size_t>(n) * C * H * W, C, xr0, XR, H, W);
    __syncthreads();

    // route g through the pool, relu and dropout: one thread a pool window
    const float* gn = g + static_cast<size_t>(n) * O * Ho * Wo;
    float* gcn = gc_out ? gc_out + static_cast<size_t>(n) * O * H * W : nullptr;
    for (int i = tid; i < R * Wo; i += nt) {
        const int lr = i / Wo, oc = i - lr * Wo;
        const int orow = o0 + lr;
        if (orow >= Ho) {  // ragged last band: nothing to add from these rows
            for (int o = 0; o < O; ++o)
                for (int py = 0; py < P; ++py)
                    for (int px = 0; px < P; ++px)
                        gcs[(o * GR + lr * P + py) * W + oc * P + px] = 0.f;
            continue;
        }
        // pass 1: window maximum of the activation and how many reach it
        float m[MAXC], cnt[MAXC];
#pragma unroll
        for (int o = 0; o < MAXC; ++o) { m[o] = -1.f; cnt[o] = 0.f; }
        for (int py = 0; py < P; ++py)
            for (int px = 0; px < P; ++px) {
                const int y = orow * P + py, xx = oc * P + px;
                float acc[MAXC];
                encoder_stage2_preact(xs, XR, XW, y - xr0, xx + 1, ws, bs, C, O, acc);
                unsigned keep = 0;
                if (DROP) keep = drop_keep_bits(cfg, stage, n, O, y, xx);
#pragma unroll
                for (int o = 0; o < MAXC; ++o) {
                    const float d = DROP ? drop_apply(acc[o], keep, o, cfg.scale) : acc[o];
                    const float a = fmaxf(d, 0.f);
                    if (a > m[o]) { m[o] = a; cnt[o] = 1.f; }
                    else if (a == m[o]) cnt[o] += 1.f;
                }
            }
        float gq[MAXC];
#pragma unroll
        for (int o = 0; o < MAXC; ++o)
            gq[o] = o < O ? gn[(static_cast<size_t>(o) * Ho + orow) * Wo + oc] / cnt[o] : 0.f;
        // pass 2: the same pre-activations again, now routed
        for (int py = 0; py < P; ++py)
            for (int px = 0; px < P; ++px) {
                const int y = orow * P + py, xx = oc * P + px;
                float acc[MAXC];
                encoder_stage2_preact(xs, XR, XW, y - xr0, xx + 1, ws, bs, C, O, acc);
                unsigned keep = 0;
                if (DROP) keep = drop_keep_bits(cfg, stage, n, O, y, xx);
#pragma unroll
                for (int o = 0; o < MAXC; ++o) {
                    if (o < O) {
                        const float d = DROP ? drop_apply(acc[o], keep, o, cfg.scale) : acc[o];
                        // d > 0 implies kept, and then the activation is d itself
                        float gc = (d > 0.f && d == m[o]) ? gq[o] : 0.f;
                        if (DROP) gc *= cfg.scale;
                        gcs[(o * GR + lr * P + py) * W + xx] = gc;
                        if (gcn) gcn[(static_cast<size_t>(o) * H + y) * W + xx] = gc;
                    }
                }
            }
    }
    __syncthreads();

    // this band's part of dW [O, C, 3, 3] and db [O]
    float* row = partials + (static_cast<size_t>(n) * gridDim.x + blockIdx.x) * (O * C * 9 + O);
    for (int o = 0; o < O; ++o) {
        for (int c = 0; c < C; ++c) {
            float v[9];
#pragma unroll
            for (int k = 0; k < 9; ++k) v[k] = 0.f;
            for (int i = tid; i < GR * W; i += nt) {
                const int y = i / W, xx = i - y * W;
                const float gc = gcs[(o * GR + y) * W + xx];
                const float* p = xs + (c * XR + y) * XW + xx;  // tap (0, 0) of (y, xx)
#pragma unroll
                for (int dy = 0; dy < 3; ++dy)
#pragma unroll
                    for (int dx = 0; dx < 3; ++dx) v[dy * 3 + dx] += p[dy * XW + dx] * gc;
            }
            block_sums<9>(v, red, row + (o * C + c) * 9);
        }
        float bsum[1] = {0.f};
        for (int i = tid; i < GR * W; i += nt) bsum[0] += gcs[o * GR * W + i];
        block_sums<1>(bsum, red, row + O * C * 9 + o);
    }
}

// gx[n, c, y, x] = sum_o,dy,dx w[o, c, dy, dx] gc[n, o, y + 1 - dy, x + 1 - dx]:
// the input cotangent of the zero-padded 3x3 convolution, one thread an
// element.
__global__ void conv_input_grad_kernel(const float* __restrict__ gc,
                                       const float* __restrict__ w, float* __restrict__ gx,
                                       int N, int C, int O, int H, int W) {
    const size_t total = static_cast<size_t>(N) * C * H * W;
    for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
         i += static_cast<size_t>(gridDim.x) * blockDim.x) {
        const int xx = static_cast<int>(i % W);
        const int y = static_cast<int>((i / W) % H);
        const int c = static_cast<int>((i / (static_cast<size_t>(W) * H)) % C);
        const int n = static_cast<int>(i / (static_cast<size_t>(W) * H * C));
        float s = 0.f;
        for (int o = 0; o < O; ++o) {
            const float* gp = gc + (static_cast<size_t>(n) * O + o) * H * W;
            const float* wp = w + (o * C + c) * 9;
            for (int dy = 0; dy < 3; ++dy) {
                const int gy = y + 1 - dy;
                if (gy < 0 || gy >= H) continue;
                for (int dx = 0; dx < 3; ++dx) {
                    const int gxx = xx + 1 - dx;
                    if (gxx >= 0 && gxx < W) s += wp[dy * 3 + dx] * gp[static_cast<size_t>(gy) * W + gxx];
                }
            }
        }
        gx[i] = s;
    }
}

struct HeadBwdArgs {
    const void *x, *w, *b, *g;
    void *gc, *partials, *grads, *gx;  // gc and gx null without need_dx
    int N, C, O, H, W, R, stage;
    size_t smem;
};

template <typename T, int P, bool DROP>
static int launch_as(const HeadBwdArgs& a, const DropCfg& cfg, cudaStream_t s) {
    if (a.smem != head_bwd_smem(a.C, a.O, a.W, P, a.R))
        return static_cast<int>(cudaErrorInvalidValue);
    const auto kernel = head_bwd_kernel<T, P, DROP>;
    cudaError_t e = allow_smem(kernel, a.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int Ho = a.H / P, bands = (Ho + a.R - 1) / a.R;
    KERNEL_LAUNCH(kernel, dim3(bands, a.N), 256, a.smem, s, static_cast<const T*>(a.x),
                  static_cast<const float*>(a.w), static_cast<const float*>(a.b),
                  static_cast<const float*>(a.g), static_cast<float*>(a.gc),
                  static_cast<float*>(a.partials), a.C, a.O, a.H, a.W, a.R, a.stage, cfg);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    if (a.gx) {
        const size_t total = static_cast<size_t>(a.N) * a.C * a.H * a.W;
        KERNEL_LAUNCH(conv_input_grad_kernel, static_cast<int>((total + 255) / 256), 256, 0, s,
                      static_cast<const float*>(a.gc), static_cast<const float*>(a.w),
                      static_cast<float*>(a.gx), a.N, a.C, a.O, a.H, a.W);
        e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int K = a.O * a.C * 9 + a.O;
    KERNEL_LAUNCH(column_sums_kernel, K, 128, 0, s, static_cast<const float*>(a.partials),
                  bands * a.N, K, static_cast<float*>(a.grads));
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
static int launch_pool(const HeadBwdArgs& a, double drop_p, const DropCfg& cfg,
                       cudaStream_t s) {
    if (drop_p > 0.0) return launch_as<T, P, true>(a, cfg, s);
    return launch_as<T, P, false>(a, cfg, s);
}

template <typename T>
static int launch_type(const HeadBwdArgs& a, int pool, double drop_p, const DropCfg& cfg,
                       cudaStream_t s) {
    if (pool == 2) return launch_pool<T, 2>(a, drop_p, cfg, s);
    if (pool == 4) return launch_pool<T, 4>(a, drop_p, cfg, s);
    if (pool == 8) return launch_pool<T, 8>(a, drop_p, cfg, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

// Scratch: partials N x ceil(H / (pool R)) x (O C 9 + O) floats, and with
// need_dx gc N x O x H x W; grads receives dW then db; gx (and gc) are null
// without need_dx.  smem must equal head_bwd_smem
// (ops/cuda_stages.py::_head_bwd_smem).
extern "C" int head_bwd_launch(const void* x, const void* w, const void* b, const void* g,
                               void* gc, void* partials, void* grads, void* gx, int N, int C,
                               int O, int H, int W, int pool, int R, long long smem,
                               int x_is_u8, int stage, double drop_p,
                               unsigned long long seed, int device, void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (C > MAXC || O > MAXC || drop_p < 0.0 || drop_p >= 1.0 || (gx != nullptr) != (gc != nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const HeadBwdArgs a{x, w, b, g, gc, partials, grads, gx, N, C, O, H, W, R, stage,
                        static_cast<size_t>(smem)};
    const DropCfg cfg = make_drop_cfg(drop_p, seed);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_is_u8) return launch_type<uint8_t>(a, pool, drop_p, cfg, s);
    return launch_type<float>(a, pool, drop_p, cfg, s);
}
