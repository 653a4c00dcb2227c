// head2_bwd: the gradients of head_fwd's conv stage at the package's three
// stage widths, specialised at compile time (C, O, P):
//
//   (1, 4, 2)  AE2D's first convolution (carle_tpu_torch/mcl/ae.py) on the
//              universe's cells, uint8 or packed words, or on float32 cells
//   (1, 4, 4)  RND's first convolution (mcl/rnd.py) on cells
//   (4, 2, 2)  AE2D's second convolution on float32, with or without the
//              input cotangent gx (nets.ae_loss_by_stages' second head)
//
// Replaces carle_tpu/ops/pallas_head.py::make_fused_head's backward kernel
// _head_bwd_kernel at those widths; head_bwd.cu stays the generic kernel for
// the others.  From x, w [O, C, 3, 3], b [O], the dropout seed and the
// cotangent g [N, O, H/P, W/P] of the pooled output it gives dW, db and, at
// (4, 2, 2) with need_dx, gx [N, C, H, W]:
//
//   out = maxpool_P(relu(drop(conv3x3(x, w) + b)))
//
// Bound on an H100: bytes (x and g read once, gx written) against the
// Philox draws with dropout; stage 1 on cells is a table lookup.  The
// generic kernel computed every pre-activation twice (two passes, each with
// its own Philox draw), staged the input as floats and the cotangent of the
// pre-activation as a float tile, summed dW by O C block reductions of 9
// values over runtime channel loops, passed gc through device memory for a
// second launch that formed gx (9 O loads from device memory an element),
// and added the blocks' partial sums in a third launch.  Here one launch:
//
//   - A block is persistent: it walks tiles of RB pooled rows and TW pooled
//     columns of the universes (tile blockIdx.x, then every gridDim.x-th),
//     and keeps its dW and db in registers across them.
//   - A thread owns whole pool windows and computes each window's P P O
//     pre-activations once: on cells by bit_table.cuh's lookup (the rows
//     staged as bits), on floats by bit_table.cuh's stage2_window from the
//     staged tile (cp.async).  It draws one Philox value a pixel (philox.cuh,
//     indexed by the element: head_fwd's and the twin's bits), and keeps the
//     window maximum, the tie count and the routed cotangent in registers.
//     Ties share equally (cuda_head._pool_route).  On cells a tap is 0 or 1,
//     so dW adds the routed cotangent times the count of tied pixels with the
//     tap set (bit_table.cuh's spread table); on floats a routed pixel adds
//     its 9 C taps.
//   - With need_dx the block also routes the windows of one ring around its
//     tile into the tile of gc in shared memory (the halo recomputed, never
//     read from device memory), then forms gx of its own pixels from it in
//     the generic kernel's order (o, dy, dx), so gx is the generic kernel's
//     bit for bit.
//   - dW and db: warp sums by halving exchanges, the warps in a fixed order
//     into one partial row a block, and the last block to finish (an integer
//     counter, zeroed by the launcher) adds the rows in a fixed order.  No
//     float is added atomically: the same bits every run.
//
// Every pre-activation is summed in the generic kernel's order (bias, then
// channel, dy, dx), so the activations and the pool ties are its own; only
// the weight-gradient sums run in another order.
#include "bit_table.cuh"

constexpr int HEAD2_THREADS = 256;
// Resident blocks a multiprocessor each instantiation is compiled for (its
// register cap): two on cells (124 registers at pool 2 without a spill, 128
// and 24 bytes spilled at pool 4, on an H100); one on floats, whose 74 sums
// of dW and db and the window's 4 x 4 x 4 inputs spilled 544 bytes a thread
// at two (225 registers at one).
constexpr int head2_blocks(int C) { return C == 1 ? 2 : 1; }

// The universe [H, W] of each instance and a tile: RB pooled rows, TW pooled
// columns (TW >= W / P: the whole width).
struct Head2Shape {
    int N, H, W, RB, TW;
};

// w [O, C, 3, 3], b [O], float32, contiguous.
struct Head2Weights {
    const float *w, *b;
};

// Words a staged bit row needs for TW windows of P cells (bit_table.cuh's
// window_indices reads one word past its last).
__host__ __device__ inline int head2_words(int P, int TW) { return (P * TW + 2 + 62) / 32 + 1; }

// Shared memory: on cells the table (512 entries of 4 channels), the spread
// table, the bit rows (P RB + 2 of them) and the warps' partial sums; on
// floats the input tile (C planes of XR x XW), with dx the tile of gc (O
// planes of 2 (RB + 2) x 2 (TW + 2)), and the warps' partial sums.
__host__ __device__ inline size_t head2_bwd_smem(int C, int O, int P, int binary, int dx,
                                                 int RB, int TW) {
    const size_t red = 4 * static_cast<size_t>(HEAD2_THREADS / 32) * (O * C * 9 + O);
    if (binary)
        return 4 * 512 * static_cast<size_t>(O) + 512 * static_cast<size_t>(P == 4 ? 8 : 4) +
               4 * static_cast<size_t>(P * RB + 2) * head2_words(P, TW) + red;
    const int h = dx ? 1 : 0;
    const size_t XR = 2 * (RB + 2 * h) + 2, XW = 2 * (TW + 2 * h) + 2;
    return 4 * (static_cast<size_t>(C) * XR * XW +
                (dx ? static_cast<size_t>(O) * 2 * (RB + 2) * 2 * (TW + 2) : 0)) + red;
}

// Tile t of the launch: instance n, pooled rows [o0, o0 + R), pooled columns
// [oc0, oc0 + TC).
struct Head2Tile {
    int n, o0, R, oc0, TC;
    __device__ Head2Tile(const Head2Shape& s, int P, int t) {
        const int Ho = s.H / P, Wo = s.W / P;
        const int tiles = (Wo + s.TW - 1) / s.TW, bands = (Ho + s.RB - 1) / s.RB;
        n = t / (bands * tiles);
        const int rest = t - n * bands * tiles;
        const int band = rest / tiles, tile = rest - band * tiles;
        o0 = band * s.RB;
        R = min(s.RB, Ho - o0);
        oc0 = tile * s.TW;
        TC = min(s.TW, Wo - oc0);
    }
};

// The block's K = O C 9 + O sums (dW, then db) into its partial row, and the
// last block's fixed-order sum of all rows into grads.  red holds
// HEAD2_THREADS / 32 x K floats.  Every thread of the block calls it.
template <int K, int OFF = 0>
__device__ __forceinline__ void head2_warp_sums(float (&v)[K], float* red) {
    if constexpr (OFF < K) {
        constexpr int REST = K - OFF;
        constexpr int M = REST >= 32 ? 32 : REST >= 16 ? 16 : REST >= 8 ? 8 : REST >= 4 ? 4
                                                                                : REST >= 2 ? 2 : 1;
#ifdef CUDA_EMULATION   // one lane a block
#pragma unroll
        for (int i = 0; i < M; ++i) red[OFF + i] = v[OFF + i];
#else
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
        float part[M];
#pragma unroll
        for (int i = 0; i < M; ++i) part[i] = v[OFF + i];
        const float total = warp_sums<M>(part, lane);
        if (lane % (32 / M) == 0) red[warp * K + OFF + lane / (32 / M)] = total;
#endif
        head2_warp_sums<K, OFF + M>(v, red);
    }
}

template <int K>
__device__ __forceinline__ void head2_sums(float (&v)[K], float* red, float* __restrict__ partials,
                                           unsigned* counter, float* __restrict__ grads) {
    __shared__ bool last;
    const int tid = threadIdx.x, nt = blockDim.x, warps = (nt + 31) / 32;
    head2_warp_sums<K>(v, red);
    __syncthreads();
    float* row = partials + static_cast<size_t>(blockIdx.x) * K;
    for (int k = tid; k < K; k += nt) {
        float s = 0.f;
        for (int w = 0; w < warps; ++w) s += red[w * K + k];
        row[k] = s;
    }
    __threadfence();   // the row is visible to the last block before the count
    __syncthreads();
    if (tid == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    // the rows in a fixed order: segment s of value k takes rows s, s + segs,
    // ... in turn, then the segments in turn
    const int segs = max(1, nt / K);
    for (int i = tid; i < segs * K; i += nt) {
        const int k = i % K, s = i / K;
        float sum = 0.f;
        for (int r = s; r < static_cast<int>(gridDim.x); r += segs)
            sum += __ldcg(partials + static_cast<size_t>(r) * K + k);
        red[s * K + k] = sum;
    }
    __syncthreads();
    for (int k = tid; k < K; k += nt) {
        float sum = 0.f;
        for (int s = 0; s < segs; ++s) sum += red[s * K + k];
        grads[k] = sum;
    }
}

// -- on cells: C = 1, O = 4, the first stage by table -------------------------

template <int P, bool DROP, typename SRC>
__global__ void __launch_bounds__(HEAD2_THREADS, head2_blocks(1))
head2_cells_kernel(const SRC* __restrict__ x, Head2Weights wp, const float* __restrict__ g,
                   float* __restrict__ partials, unsigned* counter, float* __restrict__ grads,
                   Head2Shape sh, int stage, DropCfg cfg) {
    constexpr int O = 4, K = O * 9 + O;
    using SpreadT = typename Spread<P>::type;
    __shared__ float ws[O * 9], bs[O];
    extern __shared__ float smem[];
    float4* tab = reinterpret_cast<float4*>(smem);                       // 512
    SpreadT* spread = reinterpret_cast<SpreadT*>(tab + 512);             // 512
    const int NS = head2_words(P, sh.TW);
    uint32_t* bits = reinterpret_cast<uint32_t*>(spread + 512);          // (P RB + 2) x NS
    float* red = reinterpret_cast<float*>(bits + (P * sh.RB + 2) * NS);  // warps x K
    copy_floats(ws, wp.w, O * 9);
    copy_floats(bs, wp.b, O);
    __syncthreads();
    build_table<O>(tab, ws, bs);
    build_spread<P>(spread);

    const int Ho = sh.H / P, Wo = sh.W / P;
    const int tiles = sh.N * ((Ho + sh.RB - 1) / sh.RB) * ((Wo + sh.TW - 1) / sh.TW);
    float acc[K];   // dW [4][9], then db [4]
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.f;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Head2Tile tl(sh, P, t);
        const int I0 = P * tl.o0 - 1, K0 = (P * tl.oc0 - 1) >> 5;
        __syncthreads();   // the last tile's bit rows are read
        stage_bits(bits, cells_at(x, static_cast<size_t>(tl.n) * sh.H * sh.W), I0,
                   P * tl.R + 2, K0, NS, sh.H, sh.W);
        __syncthreads();
        const float* gn = g + static_cast<size_t>(tl.n) * O * Ho * Wo;
        grid_walk(tl.R, tl.TC, [&](int lr, int lc) {
            const int r = tl.o0 + lr, c = tl.oc0 + lc;
            // the window's cotangents first: their loads are in flight while
            // the window is recomputed (a load under the relu gate's branch
            // would wait where it is used)
            float gv[O];
#pragma unroll
            for (int o = 0; o < O; ++o) gv[o] = gn[(static_cast<size_t>(o) * Ho + r) * Wo + c];
            unsigned idx[P * P];
            window_indices<P>(bits, NS, I0, K0, r, c, idx);
            // the window's maximum, how many reach it, and their taps as counts
            float m[O], cnt[O];
            SpreadT taps[O];
#pragma unroll
            for (int o = 0; o < O; ++o) { m[o] = -1.f; cnt[o] = 0.f; taps[o] = 0; }
#pragma unroll
            for (int p = 0; p < P * P; ++p) {
                float z[O];
                channels(tab[idx[p]], z);
                const SpreadT sp = spread[idx[p]];
                const unsigned keep =
                    DROP ? drop_keep_group(cfg, stage, tl.n, 0, P * r + p / P, P * c + p % P) : 0u;
#pragma unroll
                for (int o = 0; o < O; ++o) {
                    if (DROP) z[o] = drop_apply(z[o], keep, o, cfg.scale);
                    const float a = fmaxf(z[o], 0.f);
                    if (a > m[o]) { m[o] = a; cnt[o] = 1.f; taps[o] = sp; }
                    else if (a == m[o]) { cnt[o] += 1.f; taps[o] += sp; }
                }
            }
#pragma unroll
            for (int o = 0; o < O; ++o) {
                if (m[o] > 0.f) {   // the relu gate: a zero maximum passes nothing
                    float coef = gv[o] / cnt[o];
                    if (DROP) coef *= cfg.scale;
                    acc[O * 9 + o] += coef * cnt[o];
#pragma unroll
                    for (int j = 0; j < 9; ++j) acc[o * 9 + j] += coef * tap_count<P>(taps[o], j);
                }
            }
        });
    }
    head2_sums<K>(acc, red, partials, counter, grads);
}

// -- on floats at pool 2: (C, O) = (1, 4) or (4, 2) ---------------------------

template <int C, int O, bool DROP, bool DX>
__global__ void __launch_bounds__(HEAD2_THREADS, head2_blocks(C))
head2_floats_kernel(const float* __restrict__ x, Head2Weights wp, const float* __restrict__ g,
                    float* __restrict__ gx, float* __restrict__ partials, unsigned* counter,
                    float* __restrict__ grads, Head2Shape sh, int stage, DropCfg cfg) {
    constexpr int K = O * C * 9 + O, HALO = DX ? 1 : 0;
    __shared__ float ws[O * C * 9], bs[O];
    extern __shared__ float smem[];
    // the input rows and columns the tile's windows and their ring read
    const int XR = 2 * (sh.RB + 2 * HALO) + 2, XW = 2 * (sh.TW + 2 * HALO) + 2;
    const int GR = 2 * (sh.RB + 2), GW = 2 * (sh.TW + 2);
    float* xs = smem;                                       // C x XR x XW
    float* gcs = xs + C * XR * XW;                          // O x GR x GW (DX)
    float* red = gcs + (DX ? O * GR * GW : 0);              // warps x K
    copy_floats(ws, wp.w, O * C * 9);
    copy_floats(bs, wp.b, O);

    const int Ho = sh.H / 2, Wo = sh.W / 2;
    const int tiles = sh.N * ((Ho + sh.RB - 1) / sh.RB) * ((Wo + sh.TW - 1) / sh.TW);
    float acc[K];   // dW [O][C][9], then db [O]
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.f;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Head2Tile tl(sh, 2, t);
        const int X0 = 2 * (tl.o0 - HALO) - 1, XC0 = 2 * (tl.oc0 - HALO) - 1;
        __syncthreads();   // the last tile's xs and gcs are read
        const float* x_n = x + static_cast<size_t>(tl.n) * C * sh.H * sh.W;
        grid_walk(XR, XW, [&](int lr, int lc) {
            const int r = X0 + lr, col = XC0 + lc;
            const bool inside = r >= 0 && r < sh.H && col >= 0 && col < sh.W;
            const size_t at = inside ? static_cast<size_t>(r) * sh.W + col : 0;
#pragma unroll
            for (int c = 0; c < C; ++c)
                copy_async4(xs + (c * XR + lr) * XW + lc,
                            x_n + static_cast<size_t>(c) * sh.H * sh.W + at, inside);
        });
        copies_wait();
        __syncthreads();
        const float* gn = g + static_cast<size_t>(tl.n) * O * Ho * Wo;
        // the tile's windows and (DX) the ring around them: window (e, f) at
        // local (le, lf), its first pixel's tap (0, 0) at xs (2 le, 2 lf)
        grid_walk(tl.R + 2 * HALO, tl.TC + 2 * HALO, [&](int le, int lf) {
            const int e = tl.o0 - HALO + le, f = tl.oc0 - HALO + lf;
            float* gq_out = gcs + 2 * (le + 1 - HALO) * GW + 2 * (lf + 1 - HALO);
            const bool inside = e >= 0 && e < Ho && f >= 0 && f < Wo;
            float gv[O];   // in flight while the window is recomputed
#pragma unroll
            for (int o = 0; o < O; ++o)
                gv[o] = inside ? gn[(static_cast<size_t>(o) * Ho + e) * Wo + f] : 0.f;
            if (!inside) {
                if (DX) {
#pragma unroll
                    for (int o = 0; o < O; ++o) {
                        float* q = gq_out + o * GR * GW;
                        q[0] = q[1] = q[GW] = q[GW + 1] = 0.f;
                    }
                }
                return;
            }
            float z[4][O];
            stage2_window<C, O>(xs, XR, XW, 2 * le, 2 * lf, ws, bs, z);
            float m[O], cnt[O];
#pragma unroll
            for (int o = 0; o < O; ++o) { m[o] = -1.f; cnt[o] = 0.f; }
#pragma unroll
            for (int p = 0; p < 4; ++p) {
                const unsigned keep =
                    DROP ? drop_keep_group(cfg, stage, tl.n, 0, 2 * e + (p >> 1), 2 * f + (p & 1))
                         : 0u;
#pragma unroll
                for (int o = 0; o < O; ++o) {
                    if (DROP) z[p][o] = drop_apply(z[p][o], keep, o, cfg.scale);
                    const float a = fmaxf(z[p][o], 0.f);
                    if (a > m[o]) { m[o] = a; cnt[o] = 1.f; }
                    else if (a == m[o]) cnt[o] += 1.f;
                }
            }
            const bool own = le >= HALO && le < HALO + tl.R && lf >= HALO && lf < HALO + tl.TC;
#pragma unroll
            for (int o = 0; o < O; ++o) {
                // d > 0 implies kept, and then the activation is d itself
                float gq = m[o] > 0.f ? gv[o] / cnt[o] : 0.f;
                if (DROP) gq *= cfg.scale;
                unsigned tied = 0;
#pragma unroll
                for (int p = 0; p < 4; ++p) {
                    const bool routed = z[p][o] > 0.f && z[p][o] == m[o];
                    tied |= static_cast<unsigned>(routed) << p;
                    if (DX) gq_out[o * GR * GW + (p >> 1) * GW + (p & 1)] = routed ? gq : 0.f;
                }
                if (!own) continue;
                acc[O * C * 9 + o] += gq * static_cast<float>(__popc(tied));
                while (tied) {   // a routed pixel adds its 9 C taps
                    const int p = __ffs(tied) - 1;
                    tied &= tied - 1;
                    const float* base = xs + (2 * le + (p >> 1)) * XW + 2 * lf + (p & 1);
#pragma unroll
                    for (int c = 0; c < C; ++c)
#pragma unroll
                        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
                            for (int dx = 0; dx < 3; ++dx)
                                acc[(o * C + c) * 9 + dy * 3 + dx] +=
                                    gq * base[(c * XR + dy) * XW + dx];
                }
            }
        });
        if constexpr (DX) {
            __syncthreads();
            // gx of the own pixels, the generic kernel's sum (o, dy, dx): pixel
            // (2 e + py, 2 f + px) reads gc rows 2 (le + 1) + py - 1 .. + 1
            float* gx_n = gx + static_cast<size_t>(tl.n) * C * sh.H * sh.W;
            grid_walk(tl.R, tl.TC, [&](int lr, int lc) {
                const int y0 = 2 * (tl.o0 + lr), x0 = 2 * (tl.oc0 + lc);
                float G[O][4][4];   // gc rows y0 - 1 .. y0 + 2, columns x0 - 1 .. x0 + 2
#pragma unroll
                for (int o = 0; o < O; ++o)
#pragma unroll
                    for (int i = 0; i < 4; ++i)
#pragma unroll
                        for (int j = 0; j < 4; ++j)
                            G[o][i][j] = gcs[(o * GR + 2 * (lr + 1) - 1 + i) * GW +
                                             2 * (lc + 1) - 1 + j];
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    float s[4];
#pragma unroll
                    for (int p = 0; p < 4; ++p) s[p] = 0.f;
#pragma unroll
                    for (int o = 0; o < O; ++o)
#pragma unroll
                        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
                            for (int dx = 0; dx < 3; ++dx) {
                                const float wk = ws[(o * C + c) * 9 + dy * 3 + dx];
#pragma unroll
                                for (int p = 0; p < 4; ++p)
                                    s[p] += wk * G[o][(p >> 1) + 2 - dy][(p & 1) + 2 - dx];
                            }
                    float* q = gx_n + (static_cast<size_t>(c) * sh.H + y0) * sh.W + x0;
                    *reinterpret_cast<float2*>(q) = make_float2(s[0], s[1]);
                    *reinterpret_cast<float2*>(q + sh.W) = make_float2(s[2], s[3]);
                }
            });
        }
    }
    head2_sums<K>(acc, red, partials, counter, grads);
}

// -- launchers ------------------------------------------------------------------

struct Head2Args {
    const void *x, *g;
    Head2Weights wp;
    void *gx, *partials, *grads;
    unsigned* counter;
    Head2Shape sh;
    int grid, stage;
    size_t smem;
    cudaStream_t stream;
};

template <typename Kernel, typename... Args>
static cudaError_t head2_launch_as(Kernel kernel, const Head2Args& a, Args... args) {
    cudaError_t e = allow_smem(kernel, a.smem);
    if (e != cudaSuccess) return e;
    KERNEL_LAUNCH(kernel, a.grid, HEAD2_THREADS, a.smem, a.stream, args...);
    return cudaGetLastError();
}

template <int P, typename SRC>
static cudaError_t launch_cells(const Head2Args& a, bool drop, const DropCfg& cfg) {
    const SRC* x = static_cast<const SRC*>(a.x);
    const float* g = static_cast<const float*>(a.g);
    float *partials = static_cast<float*>(a.partials), *grads = static_cast<float*>(a.grads);
    if (drop)
        return head2_launch_as(head2_cells_kernel<P, true, SRC>, a, x, a.wp, g, partials,
                               a.counter, grads, a.sh, a.stage, cfg);
    return head2_launch_as(head2_cells_kernel<P, false, SRC>, a, x, a.wp, g, partials, a.counter,
                           grads, a.sh, a.stage, cfg);
}

template <int C, int O, bool DX>
static cudaError_t launch_floats(const Head2Args& a, bool drop, const DropCfg& cfg) {
    const float* x = static_cast<const float*>(a.x);
    const float* g = static_cast<const float*>(a.g);
    float *gx = static_cast<float*>(a.gx), *partials = static_cast<float*>(a.partials);
    float* grads = static_cast<float*>(a.grads);
    if (drop)
        return head2_launch_as(head2_floats_kernel<C, O, true, DX>, a, x, a.wp, g, gx, partials,
                               a.counter, grads, a.sh, a.stage, cfg);
    return head2_launch_as(head2_floats_kernel<C, O, false, DX>, a, x, a.wp, g, gx, partials,
                           a.counter, grads, a.sh, a.stage, cfg);
}

// Whether head2_bwd_launch takes (C, O, pool) on x_kind cells, with gx
// (need_dx) or without: ops/cuda_stages.py::head_route asks the same.
__host__ __device__ inline bool head2_takes(int C, int O, int pool, int x_kind, int need_dx) {
    const bool cells = x_kind == KIND_U8 || x_kind == KIND_U32;
    if (C == 1 && O == 4 && (pool == 2 || pool == 4))
        return !need_dx && (cells || pool == 2);
    return C == 4 && O == 2 && pool == 2 && x_kind == KIND_F32;
}

// x [N, C, H, W] (float32, uint8 cells, or packed words [N, 1, H, W/32]), w,
// b float32; g float32 [N, O, H/pool, W/pool]; gx float32 [N, C, H, W] or
// null without need_dx.  partials: scratch of grid x (O C 9 + O) floats,
// counter: one unsigned of scratch (zeroed here); grads receives dW then db.
// A launch of `grid` blocks walks tiles of RB pooled rows and TW pooled
// columns.  smem must equal head2_bwd_smem (ops/cuda_stages.py::
// _head2_bwd_smem).
extern "C" int head2_bwd_launch(const void* x, const void* w, const void* b, const void* g,
                                void* gx, void* partials, void* counter, void* grads, int N,
                                int C, int O, int H, int W, int pool, int RB, int TW, int grid,
                                long long smem, int x_kind, int stage, double drop_p,
                                unsigned long long seed, int device, void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const bool cells = x_kind == KIND_U8 || x_kind == KIND_U32;
    if (!head2_takes(C, O, pool, x_kind, gx != nullptr) || N < 1 || H % pool || W % pool ||
        RB < 1 || TW < 1 || grid < 1 || drop_p < 0.0 || drop_p >= 1.0 ||
        (x_kind == KIND_U8 && W % 4) || (x_kind == KIND_U32 && W % 32) ||
        static_cast<size_t>(smem) !=
            head2_bwd_smem(C, O, pool, cells, gx != nullptr, RB, TW))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    unsigned* count = static_cast<unsigned*>(counter);
    e = cudaMemsetAsync(count, 0, sizeof(unsigned), s);
    if (e != cudaSuccess) return static_cast<int>(e);
    const Head2Args a{x, g, Head2Weights{static_cast<const float*>(w), static_cast<const float*>(b)},
                      gx, partials, grads, count, Head2Shape{N, H, W, RB, TW}, grid, stage,
                      static_cast<size_t>(smem), s};
    const DropCfg cfg = make_drop_cfg(drop_p, seed);
    const bool drop = drop_p > 0.0;
    if (cells) {
        if (pool == 2)
            e = x_kind == KIND_U8 ? launch_cells<2, uint8_t>(a, drop, cfg)
                                  : launch_cells<2, uint32_t>(a, drop, cfg);
        else
            e = x_kind == KIND_U8 ? launch_cells<4, uint8_t>(a, drop, cfg)
                                  : launch_cells<4, uint32_t>(a, drop, cfg);
    } else if (C == 1) {
        e = launch_floats<1, 4, false>(a, drop, cfg);
    } else {
        e = gx ? launch_floats<4, 2, true>(a, drop, cfg) : launch_floats<4, 2, false>(a, drop, cfg);
    }
    return static_cast<int>(e);
}

// Registers, static shared memory, spilled bytes and resident blocks a
// multiprocessor of the instantiation at (C, O, pool) on x_kind cells,
// dropout on or off, with gx or without, at smem bytes.
extern "C" int head2_bwd_occupancy(int C, int O, int pool, int x_kind, int drop, int need_dx,
                                   long long smem, int device, int* out) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!head2_takes(C, O, pool, x_kind, need_dx)) return static_cast<int>(cudaErrorInvalidValue);
    const size_t bytes = static_cast<size_t>(smem);
    const int t = HEAD2_THREADS;
    if (x_kind == KIND_U8 || x_kind == KIND_U32) {
        if (pool == 2)
            return drop ? kernel_occupancy(head2_cells_kernel<2, true, uint8_t>, t, bytes, out)
                        : kernel_occupancy(head2_cells_kernel<2, false, uint8_t>, t, bytes, out);
        return drop ? kernel_occupancy(head2_cells_kernel<4, true, uint8_t>, t, bytes, out)
                    : kernel_occupancy(head2_cells_kernel<4, false, uint8_t>, t, bytes, out);
    }
    if (C == 1)
        return drop ? kernel_occupancy(head2_floats_kernel<1, 4, true, false>, t, bytes, out)
                    : kernel_occupancy(head2_floats_kernel<1, 4, false, false>, t, bytes, out);
    if (need_dx)
        return drop ? kernel_occupancy(head2_floats_kernel<4, 2, true, true>, t, bytes, out)
                    : kernel_occupancy(head2_floats_kernel<4, 2, false, true>, t, bytes, out);
    return drop ? kernel_occupancy(head2_floats_kernel<4, 2, true, false>, t, bytes, out)
                : kernel_occupancy(head2_floats_kernel<4, 2, false, false>, t, bytes, out);
}
