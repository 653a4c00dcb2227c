// head2_fwd: head_fwd's conv stage at the package's three stage widths,
// specialised at compile time (C, O, P):
//
//   (1, 4, 2)  AE2D's first convolution (carle_tpu_torch/mcl/ae.py) on the
//              universe's cells, uint8 or packed words, or on float32 cells
//   (1, 4, 4)  RND's first convolution (mcl/rnd.py) on cells
//   (4, 2, 2)  AE2D's second convolution on float32 (nets.ae_loss_by_stages'
//              second head)
//
// Replaces carle_tpu/ops/pallas_head.py::make_fused_head's forward kernel
// _head_fwd_kernel at those widths; head_fwd.cu stays the generic kernel for
// the others.
//
//   out = maxpool_P(relu(drop(conv3x3(x, w) + b)))    [N, O, H/P, W/P]
//
// Bound on an H100: bytes.  At AE2D's first convolution on uint8 cells the
// output (16 bytes a pooled window of 4 cells) is 4/5 of what moves, so the
// stores set the time.  The generic kernel staged the input as floats (cells
// too), recomputed every pixel's 9 C taps from shared memory over runtime
// channel loops into MAXC-wide register arrays, and stored each output
// channel a 4-byte word at a time.  Here:
//
//   - Blocks are persistent and walk the tiles of head2.cuh (RB pooled rows,
//     TW pooled columns), so a block builds its table once.
//   - A thread owns a run of RUN = 4 adjacent pool windows of one pooled row
//     and keeps their maxima in registers; each channel's four values leave
//     in one 16-byte store, so a warp writes 512 contiguous bytes a channel.
//   - On cells the tile's rows are staged as bits (uint8 cells packed as they
//     are staged, packed words as they come) and a pixel's O pre-activations
//     are one shared load of bit_table.cuh's table, which is the generic
//     kernel's sum bit for bit; a thread takes the run's P + 2 rows of bits
//     with one funnel shift each.  The lookups, not the stores, held the
//     first version (pool 4, a quarter of the stores, took as long as pool
//     2): random neighbourhoods put several lanes of a 16-byte load on one
//     bank group, so the table is kept in 8 interleaved copies, one a lane
//     of each 8 the load serves at once (64 KB + 8 KB for the table built
//     before it is copied: 3 blocks a multiprocessor; scripts/port_ab.py
//     plans-9a builds and times 1, 2, 4 and 8 copies at 2 to 4 blocks).
//   - On floats the tile is staged by cp.async and a window's four pixels are
//     bit_table.cuh's stage2_window, summed in the generic order (bias, then
//     channel, dy, dx).
//   - Dropout draws one Philox value a pixel for its O channels (philox.cuh,
//     indexed by the element: the generic kernel's and the twin's mask).
//
// The window's maximum is taken over its pixels in the generic kernel's order
// (py, then px) from -inf, and relu after it, so every output is the generic
// kernel's bit for bit.
#include "head2.cuh"

constexpr int HEAD2_RUN = 4;   // pool windows a thread: a 16-byte store a channel
// Resident blocks a multiprocessor each instantiation is compiled for (its
// register cap): 3 on cells (the table's copies take 72 KB), 2 on floats.
// Copies of the table on cells, interleaved by entry: lane l reads copy
// l % COPIES, so the 8 lanes a 16-byte shared load serves at once read 8
// different bank groups whatever their neighbourhoods (one copy: random
// neighbourhoods conflict).
constexpr int HEAD2_FWD_CELL_BLOCKS = 3;
constexpr int HEAD2_FWD_COPIES = 8;
constexpr int HEAD2_FWD_FLOAT_BLOCKS = 2;

// Shared memory: on cells the table's copies (512 entries of O channels
// each), the table built once before it is copied (with several copies), and
// the bit rows (P RB + 2 of them); on floats the input tile (C planes of
// 2 RB + 2 rows and 2 TW + 2 columns).
__host__ __device__ inline size_t head2_fwd_smem(int C, int O, int P, int binary, int RB,
                                                 int TW) {
    constexpr int tables = HEAD2_FWD_COPIES + (HEAD2_FWD_COPIES > 1);
    if (binary)
        return 4 * 512 * static_cast<size_t>(O) * tables +
               4 * static_cast<size_t>(P * RB + 2) * head2_words(P, TW);
    return 4 * static_cast<size_t>(C) * (2 * RB + 2) * (2 * TW + 2);
}

// The run of pool windows [c0, c0 + count) of pooled row r: relu of each
// window's maximum m[k][o], channel o's row of out_n [O, Ho, Wo] in one
// 16-byte store where the run is whole and Wo a multiple of 4 (vec).
template <int O>
__device__ __forceinline__ void head2_store_run(float* __restrict__ out_n, int Ho, int Wo, int r,
                                                int c0, int count, bool vec,
                                                const float (&m)[HEAD2_RUN][O]) {
#pragma unroll
    for (int o = 0; o < O; ++o) {
        float* q = out_n + (static_cast<size_t>(o) * Ho + r) * Wo + c0;
        if (vec && count == HEAD2_RUN) {
            *reinterpret_cast<float4*>(q) = make_float4(fmaxf(m[0][o], 0.f), fmaxf(m[1][o], 0.f),
                                                        fmaxf(m[2][o], 0.f), fmaxf(m[3][o], 0.f));
        } else {
#pragma unroll
            for (int k = 0; k < HEAD2_RUN; ++k)
                if (k < count) q[k] = fmaxf(m[k][o], 0.f);
        }
    }
}

// -- on cells: C = 1, O = 4, the pre-activations by table ----------------------

template <int P, bool DROP, typename SRC>
__global__ void __launch_bounds__(HEAD2_THREADS, HEAD2_FWD_CELL_BLOCKS)
head2_fwd_cells_kernel(const SRC* __restrict__ x, Head2Weights wp, float* __restrict__ out,
                       Head2Shape sh, int stage, DropCfg cfg) {
    constexpr int O = 4, K = HEAD2_FWD_COPIES;
    __shared__ float ws[O * 9], bs[O];
    extern __shared__ float smem[];
    float4* tab = reinterpret_cast<float4*>(smem);                  // 512 K: entry i, copy c
    float4* base = tab + 512 * K;                                   // 512 (K > 1)
    const int NS = head2_words(P, sh.TW);
    uint32_t* bits = reinterpret_cast<uint32_t*>(base + (K > 1 ? 512 : 0));   // (P RB + 2) x NS
    copy_floats(ws, wp.w, O * 9);
    copy_floats(bs, wp.b, O);
    __syncthreads();
    build_table<O>(K > 1 ? base : tab, ws, bs);
    if (K > 1) {
        __syncthreads();
        for (int i = threadIdx.x; i < 512 * K; i += blockDim.x) tab[i] = base[i / K];
    }
    const int copy = threadIdx.x % K;

    const int Ho = sh.H / P, Wo = sh.W / P;
    const bool vec = Wo % HEAD2_RUN == 0;
    const int tiles = head2_tiles(sh, P);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Head2Tile tl(sh, P, t);
        const int I0 = P * tl.o0 - 1, K0 = (P * tl.oc0 - 1) >> 5;
        __syncthreads();   // the table is built, the last tile's bit rows are read
        stage_bits(bits, cells_at(x, static_cast<size_t>(tl.n) * sh.H * sh.W), I0,
                   P * tl.R + 2, K0, NS, sh.H, sh.W);
        __syncthreads();
        float* out_n = out + static_cast<size_t>(tl.n) * O * Ho * Wo;
        grid_walk(tl.R, (tl.TC + HEAD2_RUN - 1) / HEAD2_RUN, [&](int lr, int lu) {
            const int r = tl.o0 + lr, c0 = tl.oc0 + HEAD2_RUN * lu;
            const int count = min(HEAD2_RUN, tl.oc0 + tl.TC - c0);
            // the run's P + 2 bit rows from its first window's left halo
            // column: bit 3 dy + dx of pixel (py, px) of window k is bit
            // P k + px + dx of row py + dy
            const uint32_t* row = bits + (P * lr) * NS;
            const int p0 = P * c0 - 1 - 32 * K0;
            unsigned seg[P + 2];
#pragma unroll
            for (int q = 0; q < P + 2; ++q) seg[q] = row_bits(row + q * NS, p0);
            float m[HEAD2_RUN][O];
#pragma unroll
            for (int k = 0; k < HEAD2_RUN; ++k) {
#pragma unroll
                for (int o = 0; o < O; ++o) m[k][o] = NEG_INF;
                if (k >= count) continue;
#pragma unroll
                for (int py = 0; py < P; ++py)
#pragma unroll
                    for (int px = 0; px < P; ++px) {
                        const int s = P * k + px;
                        const unsigned idx = ((seg[py] >> s) & 7u) |
                                             (((seg[py + 1] >> s) & 7u) << 3) |
                                             (((seg[py + 2] >> s) & 7u) << 6);
                        float z[O];
                        channels(tab[idx * K + copy], z);
                        const unsigned keep =
                            DROP ? drop_keep_group(cfg, stage, tl.n, 0, P * r + py,
                                                   P * (c0 + k) + px)
                                 : 0u;
#pragma unroll
                        for (int o = 0; o < O; ++o) {
                            if (DROP) z[o] = drop_apply(z[o], keep, o, cfg.scale);
                            m[k][o] = fmaxf(m[k][o], z[o]);
                        }
                    }
            }
            head2_store_run<O>(out_n, Ho, Wo, r, c0, count, vec, m);
        });
    }
}

// -- on floats at pool 2: (C, O) = (1, 4) or (4, 2) ---------------------------

template <int C, int O, bool DROP>
__global__ void __launch_bounds__(HEAD2_THREADS, HEAD2_FWD_FLOAT_BLOCKS)
head2_fwd_floats_kernel(const float* __restrict__ x, Head2Weights wp, float* __restrict__ out,
                        Head2Shape sh, int stage, DropCfg cfg) {
    __shared__ float ws[O * C * 9], bs[O];
    extern __shared__ float smem[];
    const int XR = 2 * sh.RB + 2, XW = 2 * sh.TW + 2;
    float* xs = smem;   // C x XR x XW
    copy_floats(ws, wp.w, O * C * 9);
    copy_floats(bs, wp.b, O);

    const int Ho = sh.H / 2, Wo = sh.W / 2;
    const bool vec = Wo % HEAD2_RUN == 0;
    const int tiles = head2_tiles(sh, 2);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Head2Tile tl(sh, 2, t);
        __syncthreads();   // the last tile's xs is read
        head2_stage_floats<C>(xs, x + static_cast<size_t>(tl.n) * C * sh.H * sh.W,
                              2 * tl.o0 - 1, XR, 2 * tl.oc0 - 1, XW, sh.H, sh.W);
        copies_wait();
        __syncthreads();
        float* out_n = out + static_cast<size_t>(tl.n) * O * Ho * Wo;
        grid_walk(tl.R, (tl.TC + HEAD2_RUN - 1) / HEAD2_RUN, [&](int lr, int lu) {
            const int r = tl.o0 + lr, c0 = tl.oc0 + HEAD2_RUN * lu;
            const int count = min(HEAD2_RUN, tl.oc0 + tl.TC - c0);
            float m[HEAD2_RUN][O];
#pragma unroll
            for (int k = 0; k < HEAD2_RUN; ++k) {
#pragma unroll
                for (int o = 0; o < O; ++o) m[k][o] = NEG_INF;
                if (k >= count) continue;
                // window (r, c0 + k): its first pixel's tap (0, 0) at xs
                // (2 lr, 2 (c0 + k - oc0))
                float z[4][O];
                stage2_window<C, O>(xs, XR, XW, 2 * lr, 2 * (c0 + k - tl.oc0), ws, bs, z);
#pragma unroll
                for (int p = 0; p < 4; ++p) {
                    const unsigned keep =
                        DROP ? drop_keep_group(cfg, stage, tl.n, 0, 2 * r + (p >> 1),
                                               2 * (c0 + k) + (p & 1))
                             : 0u;
#pragma unroll
                    for (int o = 0; o < O; ++o) {
                        if (DROP) z[p][o] = drop_apply(z[p][o], keep, o, cfg.scale);
                        m[k][o] = fmaxf(m[k][o], z[p][o]);
                    }
                }
            }
            head2_store_run<O>(out_n, Ho, Wo, r, c0, count, vec, m);
        });
    }
}

// -- launchers ------------------------------------------------------------------

struct Head2FwdArgs {
    const void* x;
    Head2Weights wp;
    float* out;
    Head2Shape sh;
    int grid, stage;
    size_t smem;
    cudaStream_t stream;
};

template <typename SRC, typename Kernel>
static cudaError_t head2_fwd_as(Kernel kernel, const Head2FwdArgs& a, const DropCfg& cfg) {
    cudaError_t e = allow_smem(kernel, a.smem);
    if (e != cudaSuccess) return e;
    KERNEL_LAUNCH(kernel, a.grid, HEAD2_THREADS, a.smem, a.stream, static_cast<const SRC*>(a.x),
                  a.wp, a.out, a.sh, a.stage, cfg);
    return cudaGetLastError();
}

template <int P, typename SRC>
static cudaError_t launch_cells(const Head2FwdArgs& a, bool drop, const DropCfg& cfg) {
    return drop ? head2_fwd_as<SRC>(head2_fwd_cells_kernel<P, true, SRC>, a, cfg)
                : head2_fwd_as<SRC>(head2_fwd_cells_kernel<P, false, SRC>, a, cfg);
}

template <int C, int O>
static cudaError_t launch_floats(const Head2FwdArgs& a, bool drop, const DropCfg& cfg) {
    return drop ? head2_fwd_as<float>(head2_fwd_floats_kernel<C, O, true>, a, cfg)
                : head2_fwd_as<float>(head2_fwd_floats_kernel<C, O, false>, a, cfg);
}

// Whether head2_fwd_launch takes (C, O, pool) on x_kind cells:
// ops/cuda_stages.py::head_fwd_route asks the same.
__host__ __device__ inline bool head2_fwd_takes(int C, int O, int pool, int x_kind) {
    const bool cells = x_kind == KIND_U8 || x_kind == KIND_U32;
    if (C == 1 && O == 4) return pool == 2 || (pool == 4 && cells);
    return C == 4 && O == 2 && pool == 2 && x_kind == KIND_F32;
}

// x [N, C, H, W] (float32, uint8 cells, or packed words [N, 1, H, W/32]), w
// [O, C, 3, 3], b [O] float32; out float32 [N, O, H/pool, W/pool].  A launch
// of `grid` blocks walks tiles of RB pooled rows and TW pooled columns (TW a
// multiple of 4 unless it holds the whole width).  smem must equal
// head2_fwd_smem (ops/cuda_stages.py::_head2_fwd_smem).
extern "C" int head2_fwd_launch(const void* x, const void* w, const void* b, void* out, int N,
                                int C, int O, int H, int W, int pool, int RB, int TW, int grid,
                                long long smem, int x_kind, int stage, double drop_p,
                                unsigned long long seed, int device, void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const bool cells = x_kind == KIND_U8 || x_kind == KIND_U32;
    if (!head2_fwd_takes(C, O, pool, x_kind) || N < 1 || H % pool || W % pool || RB < 1 ||
        TW < 1 || (TW < W / pool && TW % HEAD2_RUN) || grid < 1 || drop_p < 0.0 ||
        drop_p >= 1.0 || (x_kind == KIND_U8 && W % 4) || (x_kind == KIND_U32 && W % 32) ||
        static_cast<size_t>(smem) != head2_fwd_smem(C, O, pool, cells, RB, TW))
        return static_cast<int>(cudaErrorInvalidValue);
    const Head2FwdArgs a{x,
                         Head2Weights{static_cast<const float*>(w), static_cast<const float*>(b)},
                         static_cast<float*>(out),
                         Head2Shape{N, H, W, RB, TW},
                         grid,
                         stage,
                         static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream)};
    const DropCfg cfg = make_drop_cfg(drop_p, seed);
    const bool drop = drop_p > 0.0;
    if (cells) {
        if (pool == 2)
            e = x_kind == KIND_U8 ? launch_cells<2, uint8_t>(a, drop, cfg)
                                  : launch_cells<2, uint32_t>(a, drop, cfg);
        else
            e = x_kind == KIND_U8 ? launch_cells<4, uint8_t>(a, drop, cfg)
                                  : launch_cells<4, uint32_t>(a, drop, cfg);
    } else {
        e = C == 1 ? launch_floats<1, 4>(a, drop, cfg) : launch_floats<4, 2>(a, drop, cfg);
    }
    return static_cast<int>(e);
}

template <typename SRC>
static int cells_occupancy(int pool, int drop, size_t bytes, int* out) {
    const int t = HEAD2_THREADS;
    if (pool == 2)
        return drop ? kernel_occupancy(head2_fwd_cells_kernel<2, true, SRC>, t, bytes, out)
                    : kernel_occupancy(head2_fwd_cells_kernel<2, false, SRC>, t, bytes, out);
    return drop ? kernel_occupancy(head2_fwd_cells_kernel<4, true, SRC>, t, bytes, out)
                : kernel_occupancy(head2_fwd_cells_kernel<4, false, SRC>, t, bytes, out);
}

template <int C, int O>
static int floats_occupancy(int drop, size_t bytes, int* out) {
    return drop ? kernel_occupancy(head2_fwd_floats_kernel<C, O, true>, HEAD2_THREADS, bytes, out)
                : kernel_occupancy(head2_fwd_floats_kernel<C, O, false>, HEAD2_THREADS, bytes,
                                   out);
}

// Registers, static shared memory, spilled bytes and resident blocks a
// multiprocessor of the instantiation at (C, O, pool) on x_kind cells,
// dropout on or off, at smem bytes.
extern "C" int head2_fwd_occupancy(int C, int O, int pool, int x_kind, int drop, long long smem,
                                   int device, int* out) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!head2_fwd_takes(C, O, pool, x_kind)) return static_cast<int>(cudaErrorInvalidValue);
    const size_t bytes = static_cast<size_t>(smem);
    if (x_kind == KIND_U8) return cells_occupancy<uint8_t>(pool, drop, bytes, out);
    if (x_kind == KIND_U32) return cells_occupancy<uint32_t>(pool, drop, bytes, out);
    return C == 1 ? floats_occupancy<1, 4>(drop, bytes, out)
                  : floats_occupancy<4, 2>(drop, bytes, out);
}
