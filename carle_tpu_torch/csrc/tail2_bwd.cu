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
// slot blocks one block of 256 threads held a multiprocessor alone.  Here a
// block owns RI input rows and TJ input columns (ops/cuda_stages.py::
// _tail2_plan: small windows, at least two blocks a multiprocessor), and a
// thread works on the 2 x 4 outputs of an input pair (i, j), (i, j + 1), as
// the forward does:
//
//   1. the block stages, by asynchronous copies, g on the 2 x 4 blocks of
//      its pairs and of one pair and row of pairs a side (16-byte pieces),
//      the input window those read, and the saved keep bytes;
//   2. a thread recomputes its block's pre-activations by the parity
//      stencils, gates g by the activation's derivative and the keep bits
//      into the cotangent gz (in g's place in shared memory: the pairs a side
//      are recomputed, never added twice) and, for its own pairs, adds each
//      output's part of dW and db in registers;
//   3. the warps sum them by halving exchanges (a warp's 16 CIN dW values in
//      16 CIN - 1 shuffles), then the warps in a fixed order, into one
//      partial row a block;
//   4. gx of the own pairs from the 4 x 6 cotangent window they read (three
//      16-byte loads a row): the generic kernel's sum (taps in ky, kx order),
//      so gx is its bits;
//
// and column_sums_kernel adds the partial rows in a fixed order (the same
// bits every run, no atomics).  Instances beyond the grid's 65,535 rows go in
// further launches.
#include "tail2.cuh"

// The sums over a warp of each of its lanes' M values (M a power of two, 2 to
// 32) by halving exchanges: at each step a lane keeps half of its m values
// and adds the other half of lane l ^ o's, so the warp spends M - 1 shuffles
// and then log2(32 / M) more.  Lane l returns value l / (32 / M)'s total.
// The steps recurse at compile time, so every index is a constant and v
// stays in registers.  (The emulated build runs one lane a block, which
// writes its M values itself.)
#ifndef CUDA_EMULATION
template <int M, int m = M>
__device__ __forceinline__ float warp_sums(float (&v)[M], int lane) {
    if constexpr (m > 1) {
        constexpr int o = 16 * m / M;
        const bool upper = lane & o;
#pragma unroll
        for (int k = 0; k < m / 2; ++k) {
            const float send = upper ? v[k] : v[k + m / 2];
            const float keep = upper ? v[k + m / 2] : v[k];
            v[k] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
        return warp_sums<M, m / 2>(v, lane);
    } else {
#pragma unroll
        for (int o = 16 / M; o > 0; o >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
        return v[0];
    }
}
#endif

template <int CIN, int ACT, int KEEP>
__global__ void __launch_bounds__(TAIL2_THREADS, tail2_bwd_blocks(CIN))
tail2_bwd_kernel(const float* __restrict__ x, Tail2Weights wp, const float* __restrict__ g,
                 const uint8_t* __restrict__ keep, float* __restrict__ gx,
                 float* __restrict__ partials, Tail2Shape sh, int N0, int stage, DropCfg cfg) {
    constexpr bool DROP = KEEP != KEEP_NONE;
    constexpr int KW = 16 * CIN, K = KW + 1;   // dW, then db
    const Tail2Block bk(sh, N0);
    const int h = sh.h, w = sh.w, H2 = 2 * h, W2 = 2 * w, n = bk.n;
    const int i0 = bk.i0, j0 = bk.j0, ri = bk.ri, tj = bk.tj;

    // gz: g, then the pre-activation's cotangent in its place, on the 2 x 4
    // output blocks of the pairs (i, j), i in [i0 - 1, i0 + ri], j in {j0 - 2,
    // j0, .., j0 + tj}: rows 2 i0 - 2 .., columns 2 j0 - 4 .., 16-byte pieces
    extern __shared__ float smem[];
    const Win gz{smem, 2 * i0 - 2, 2 * j0 - 4, 2 * ri + 4, 2 * tj + 8};
    // the input those blocks read: rows i0 - 2 .. i0 + ri + 1, columns j0 - 3 ..
    const Win xs{gz.p + gz.rows * gz.cols, i0 - 2, j0 - 3, ri + 4, tj + 6};
    float* red = xs.p + CIN * xs.rows * xs.cols;   // (TAIL2_THREADS / 32) x K
    // the keep bytes of the pairs' inputs: rows i0 - 1 .., columns j0 - 2 ..
    uint8_t* ks = reinterpret_cast<uint8_t*>(red + (TAIL2_THREADS / 32) * K);
    const int KR = ri + 2, KC = tj + 4;

    const float* g_n = g + static_cast<size_t>(n) * H2 * W2;
    grid_walk(gz.rows, gz.cols / 4, [&](int lr, int k) {
        const int y = gz.r0 + lr, xo = gz.c0 + 4 * k;
        const bool in = y >= 0 && y < H2 && xo >= 0 && xo < W2;
        copy_async16(gz.p + lr * gz.cols + 4 * k,
                     g_n + (in ? static_cast<size_t>(y) * W2 + xo : 0), in);
    });
    tail2_stage_input<CIN>(xs, x + static_cast<size_t>(n) * CIN * h * w, h, w);
    tail2_load_weights<CIN>(wp);
    if (KEEP == KEEP_READ) {   // byte pairs, four loads a thread in flight before their stores
        const uint16_t* keep_n = reinterpret_cast<const uint16_t*>(keep + static_cast<size_t>(n) * h * w);
        uint16_t* ks2 = reinterpret_cast<uint16_t*>(ks);
        const int cols = KC / 2, total = KR * cols, nt = blockDim.x;
        for (int e0 = threadIdx.x; e0 < total; e0 += 4 * nt) {
            uint16_t v[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int e = e0 + k * nt, lr = e / cols, lc = e - lr * cols;
                const int r = i0 - 1 + lr, c = j0 - 2 + 2 * lc;
                v[k] = (e < total && r >= 0 && r < h && c >= 0 && c < w)
                    ? keep_n[(static_cast<size_t>(r) * w + c) / 2] : 0;
            }
#pragma unroll
            for (int k = 0; k < 4; ++k)
                if (e0 + k * nt < total) ks2[e0 + k * nt] = v[k];
        }
    }
    copies_wait();
    __syncthreads();

    const int plane = xs.rows * xs.cols;
    float dw[KW], db = 0.f;
#pragma unroll
    for (int k = 0; k < KW; ++k) dw[k] = 0.f;
    grid_walk(ri + 2, tj / 2 + 2, [&](int li, int lp) {
        const int i = i0 - 1 + li, j = j0 - 2 + 2 * lp;
        const bool own = li >= 1 && li <= ri && lp >= 1 && lp <= tj / 2;
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
        if (KEEP == KEEP_READ)
            bits = *reinterpret_cast<const uint16_t*>(ks + li * KC + 2 * lp);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
            const int y = 2 * i + a;
            float4* gp = reinterpret_cast<float4*>(gz.at(y, 2 * j));
            const float4 g4 = *gp;
            const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
            float gc[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                // output (2i + a, 2j + q): parity (1 - a, 1 - b), its window
                // ending at input (i + a, j + t + b)
                const int t = q >> 1, b = q & 1, e = t + b, xo = 2 * j + q;
                float r = tail2_bias;
#pragma unroll
                for (int c = 0; c < CIN; ++c)
                    r = parity_preact(tail2_wp[c * 4 + (1 - a) * 2 + (1 - b)], r,
                                      X[c][a + 1][e + 1], X[c][a + 1][e], X[c][a][e + 1],
                                      X[c][a][e]);
                unsigned k = 1;
                if (KEEP == KEEP_READ)
                    k = (bits >> (8 * t + 2 * a + b)) & 1u;
                else if (KEEP == KEEP_DRAW)
                    k = drop_keep_group(cfg, stage, n, 0, y, xo) & 1u;
                if (DROP) r = k ? r * cfg.scale : 0.f;
                float c_ = 0.f;
                if (ACT == TAIL2_RELU) {
                    c_ = r > 0.f ? gv[q] : 0.f;
                } else {
                    const float yv = 1.f / (1.f + expf(-r));
                    c_ = gv[q] * yv * (1.f - yv);
                }
                if (DROP) c_ = k ? c_ * cfg.scale : 0.f;
                // zero outside the output (where g was staged as zero)
                gc[q] = y >= 0 && y < H2 && xo >= 0 && xo < W2 ? c_ : 0.f;
                if (own) {
#pragma unroll
                    for (int c = 0; c < CIN; ++c)
                        parity_wgrad(dw + 16 * c, 1 - a, 1 - b, gc[q], X[c][a + 1][e + 1],
                                     X[c][a + 1][e], X[c][a][e + 1], X[c][a][e]);
                    db += gc[q];
                }
            }
            *gp = make_float4(gc[0], gc[1], gc[2], gc[3]);
        }
    });

    // the block's partial row: warps, then the warps in turn
    float* row = partials + (static_cast<size_t>(n) * gridDim.x + blockIdx.x) * K;
#ifdef CUDA_EMULATION
    for (int k = 0; k < KW; ++k) red[k] = dw[k];   // one lane a block
    red[KW] = db;
#else
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float total = warp_sums<KW>(dw, lane);
    if (lane % (32 / KW) == 0) red[warp * K + lane / (32 / KW)] = total;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) db += __shfl_xor_sync(0xffffffffu, db, o);
    if (lane == 0) red[warp * K + KW] = db;
#endif
    __syncthreads();   // also between gz's writes and its reads below
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
        float sum = 0.f;
        for (int v = 0; v < (blockDim.x + 31) / 32; ++v) sum += red[v * K + k];
        row[k] = sum;
    }

    // gx of the own pairs: gz rows 2i - 1 .. 2i + 2, columns 2j - 1 .. 2j + 4
    float* gx_n = gx + static_cast<size_t>(n) * CIN * h * w;
    grid_walk(ri, tj / 2, [&](int li, int lp) {
        const int i = i0 + li, j = j0 + 2 * lp;
        float G[4][6];
#pragma unroll
        for (int ky = 0; ky < 4; ++ky) {
            const float4* q = reinterpret_cast<const float4*>(gz.at(2 * i - 1 + ky, 2 * j - 4));
            const float4 l4 = q[0], m4 = q[1], r4 = q[2];
            G[ky][0] = l4.w;
            G[ky][1] = m4.x;
            G[ky][2] = m4.y;
            G[ky][3] = m4.z;
            G[ky][4] = m4.w;
            G[ky][5] = r4.x;
        }
#pragma unroll
        for (int c = 0; c < CIN; ++c) {
            float s0 = 0.f, s1 = 0.f;
#pragma unroll
            for (int ky = 0; ky < 4; ++ky)
#pragma unroll
                for (int kx = 0; kx < 4; ++kx) {
                    const float wk = parity_tap(tail2_wp + 4 * c, ky, kx);
                    s0 += wk * G[ky][kx];
                    s1 += wk * G[ky][kx + 2];
                }
            *reinterpret_cast<float2*>(gx_n + (static_cast<size_t>(c) * h + i) * w + j) =
                make_float2(s0, s1);
        }
    });
}

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
    const auto kernel = tail2_bwd_kernel<CIN, ACT, KEEP>;
    cudaError_t e = allow_smem(kernel, a.bytes);
    if (e != cudaSuccess) return e;
    const int T = min(a.sh.TJ, a.sh.w);
    const int blocks = ((a.sh.h + a.sh.RI - 1) / a.sh.RI) * ((a.sh.w + T - 1) / T);
    const Tail2Weights wp{static_cast<const float*>(a.wt), static_cast<const float*>(a.b)};
    for (int n0 = 0; n0 < a.N; n0 += MAX_GRID_Y) {
        KERNEL_LAUNCH(kernel, dim3(blocks, grid_rows(a.N, n0)), TAIL2_THREADS, a.bytes, s,
                      static_cast<const float*>(a.x), wp, static_cast<const float*>(a.g),
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
        return kernel_occupancy(tail2_bwd_kernel<CIN, ACT, KEEP_READ>, TAIL2_THREADS, bytes, out);
    if (keep == KEEP_DRAW)
        return kernel_occupancy(tail2_bwd_kernel<CIN, ACT, KEEP_DRAW>, TAIL2_THREADS, bytes, out);
    return kernel_occupancy(tail2_bwd_kernel<CIN, ACT, KEEP_NONE>, TAIL2_THREADS, bytes, out);
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
