// bit_multi_step: K Life-like generations on bit-packed universes, in two
// layouts and with the rule as data or fixed at compile time.
//
// Replaces carle_tpu/ops/pallas_bitpack.py::
//   bit_multi_step_pallas            (row-major, rule as data; kernels
//                                     _multi_step_kernel, _multi_step_kernel_vec)
//   bit_multi_step_pallas_static     (row-major, rule fixed; _static_multi_step_kernel)
//   bit_multi_step_pallas_static_cm  (column-major, rule fixed; _static_multi_step_kernel_cm)
//   bit_multi_step_pallas_cm         (column-major, rule as data; _multi_step_kernel_cm,
//                                     _multi_step_kernel_vec_cm)
// The TPU functions' `scheme` variants (h, v, vc, vd, multi-stream ...) are
// TPU scheduling choices; this file ports the arithmetic once.
//
// The row-major word update is common.cuh's step_word_rows, which the
// row-sharded halo kernels (halo_step.cu) run too.
//
// Row-major layout (carle_tpu/ops/bitpack.py::pack_grid): a universe is
// [H, NW] words and bit j of word k is the cell in column 32k + j.  The
// left/right neighbour words come from funnel shifts across the word
// boundary (torus over the word axis), the Moore count is built bit-sliced
// (planes n0..n3) by a carry-save adder tree.
//
// Column-major layout (pack_grid_cm): a universe is [H/32, W] words and bit j
// of word (k, c) is the cell in row 32k + j of column c.  The vertical
// neighbours are in-word shifts with one carry bit from the word above or
// below, the horizontal ones are whole words: a thread walks a strip of
// columns and carries the vertical triple planes (weight 1 and 2) of the
// columns to its left and centre, so each column's triple is built once.
// Neighbouring threads take neighbouring word rows, and the resident copy's
// rows are padded by one word, so a warp's loads spread over the banks of
// shared memory.
// The count includes the centre cell (count9, 0-9): the dead branch reads
// birth[count9], the alive branch survive[count9 - 1].
//
// The rule: as DATA, the 18-bit mask becomes all-ones/all-zeros leaf words of
// a multiplexer tree over the count planes, so every ruleset, scalar or per
// universe, runs the same code.  FIXED (a library built with
// -DSTATIC_RULE=<mask>), the leaves are compile-time constants and the
// compiler folds the tree away: for Life the decision is a few LOP3s
// (~n3 & ~n2 & n1 & (n0 | g)).  One library is built per mask on first use
// (ops/cuda_build.py), as the JAX function recompiles per (birth, survive).
//
// Bound on an H100: operations.  ~37 integer operations a word a generation
// with the rule as data (a row's pair planes built once; chip_smoke.py counts
// them), fewer fixed, against 8 bytes moved a word per launch, so the integer
// ALUs are the limit once a universe stays on chip (one generation a launch
// is bound by the bytes).
//
// Row-major with the rule as data, bit_words_launch (counted as
// bit_multi_step_words), or fixed, bit_static_words_launch (counted as
// bit_multi_step_static_words; ops/cuda_bitpack.py::words_plan picks the
// regime by shape, and 8 rows a thread for a fixed rule: its 16 operations a
// word weigh the 4-row plan's ghost-row planes more).  K = 1 at any size, and K > 1 on universes too large for shared
// memory (a launch a generation): bit_words.cuh's streaming kernel, a thread a
// strip of rows of V words carrying the rows above and at the centre as
// words and pair planes, so a row is read once a strip and its planes built
// once; no shared memory, universes folded into the grid.  K > 1 on
// universes of 1-8 words a row: bit_regs_kernel keeps each universe in
// registers for all K generations, one barrier a generation (below), or
// with fewer universes than multiprocessors splits one over a thread-block
// cluster of 16 blocks.  One launch.
//
// The present kernels (bit_multi_step_resident, bit_step_global) serve the
// other engines and the row-major shapes words_plan leaves to them (K > 1 on
// universes whose two copies fit shared memory but not a block's registers),
// and every shape with cuda_bitpack.BIT_WORDS off: the resident kernels give
// each universe one block that holds it in shared memory for all K
// generations (ping-pong between two copies, 16 KB at 256x256 in either
// layout, 64 KB at 512x512), the counterpart of the TPU kernels keeping the
// grid in VMEM, so device memory is read once and written once a launch.
// Universes whose two copies do not fit a block's 227 KB take the fallback:
// one launch per generation through device memory.
#include "bit_regs.cuh"
#include "common.cuh"

// The same tree over ten leaves l0 .. l9 indexed by count9 (0-9).
__device__ __forceinline__ uint32_t fold10(const uint32_t* l, uint32_t n0,
                                           uint32_t n1, uint32_t n2, uint32_t n3) {
    const uint32_t p0 = mux(l[0], l[1], n0), p1 = mux(l[2], l[3], n0);
    const uint32_t p2 = mux(l[4], l[5], n0), p3 = mux(l[6], l[7], n0);
    const uint32_t p4 = mux(l[8], l[9], n0);
    const uint32_t q0 = mux(p0, p1, n1), q1 = mux(p2, p3, n1), q2 = p4 & ~n1;
    const uint32_t r0 = mux(q0, q1, n2), r1 = q2 & ~n2;
    return mux(r0, r1, n3);
}

// Next state of word k of row r of a row-major universe at `src` ([H, NW]).
__device__ __forceinline__ uint32_t step_word(const uint32_t* src, int H,
                                              int NW, int r, int k,
                                              const Leaves& leaves) {
    const int ru = r == 0 ? H - 1 : r - 1;
    const int rd = r == H - 1 ? 0 : r + 1;
    return step_word_rows(src + ru * NW, src + r * NW, src + rd * NW, NW, k, leaves);
}

// Column-major: the vertical triple (the cell and its two vertical
// neighbours) of a word g between the words above (up) and below (dn) it in
// its column, as planes p0 (weight 1) and p1 (weight 2).
__device__ __forceinline__ void triple_planes(uint32_t up, uint32_t g, uint32_t dn,
                                              uint32_t& p0, uint32_t& p1) {
    const uint32_t u = __funnelshift_l(up, g, 1);  // row r-1 at r
    const uint32_t d = __funnelshift_r(g, dn, 1);  // row r+1 at r
    csa(u, g, d, p0, p1);
}

// The same from the words above (up) and below (dn) word (k, c) in memory.
__device__ __forceinline__ void vertical_triple(const uint32_t* src, int HW, int S, int k,
                                                int c, uint32_t& g, uint32_t& p0,
                                                uint32_t& p1) {
    const int ku = k == 0 ? HW - 1 : k - 1;
    const int kd = k == HW - 1 ? 0 : k + 1;
    g = src[k * S + c];
    triple_planes(src[ku * S + c], g, src[kd * S + c], p0, p1);
}

// Column-major: next state of a word from the vertical triples of its own
// column (g, p0, p1) and of its west (w0, w1) and east (e0, e1) columns.
__device__ __forceinline__ uint32_t step_cm(uint32_t g, uint32_t p0, uint32_t p1,
                                            uint32_t w0, uint32_t w1, uint32_t e0,
                                            uint32_t e1, const uint32_t* dead10,
                                            const uint32_t* alive10) {
    uint32_t s1, c1, s2, c2;
    csa(w0, p0, e0, s1, c1);   // weight-1 triple
    csa(w1, p1, e1, s2, c2);   // weight-2 triple
    const uint32_t cc = c1 & s2;
    const uint32_t n0 = s1, n1 = c1 ^ s2, n2 = c2 ^ cc, n3 = c2 & cc;
    return (fold10(dead10, n0, n1, n2, n3) & ~g) | (fold10(alive10, n0, n1, n2, n3) & g);
}

// Leaves indexed by count9: dead [b0 .. b8, 0], alive [0, s0 .. s8].
__device__ __forceinline__ void leaves10(const Leaves& l, uint32_t* dead10, uint32_t* alive10) {
    dead10[9] = 0u;
    alive10[0] = 0u;
#pragma unroll
    for (int v = 0; v < 9; ++v) {
        dead10[v] = l.dead[v];
        alive10[v + 1] = l.alive[v];
    }
}

constexpr int CM_STRIP = 8;  // columns a thread walks in the column-major kernels

// One generation of a column-major universe src -> dst ([HW, W], row stride
// S); the block's threads share the (word row, strip) items, word rows first.
__device__ __forceinline__ void generation_cm(const uint32_t* src, uint32_t* dst, int HW,
                                              int W, int S, const uint32_t* dead10,
                                              const uint32_t* alive10) {
    const int strips = (W + CM_STRIP - 1) / CM_STRIP;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nt = blockDim.x * blockDim.y;
    for (int i = tid; i < HW * strips; i += nt) {
        const int k = i % HW, c0 = (i / HW) * CM_STRIP;
        const int c1 = min(c0 + CM_STRIP, W);
        uint32_t gw, w0, w1, g, p0, p1;
        vertical_triple(src, HW, S, k, c0 == 0 ? W - 1 : c0 - 1, gw, w0, w1);
        vertical_triple(src, HW, S, k, c0, g, p0, p1);
        for (int c = c0; c < c1; ++c) {
            uint32_t ge, e0, e1;
            vertical_triple(src, HW, S, k, c == W - 1 ? 0 : c + 1, ge, e0, e1);
            dst[k * S + c] = step_cm(g, p0, p1, w0, w1, e0, e1, dead10, alive10);
            w0 = p0; w1 = p1;
            g = ge; p0 = e0; p1 = e1;
        }
    }
}

// One block per universe, resident in shared memory for all `steps`; A x B is
// [H, NW] (row-major) or [HW, W] (column-major, rows padded to B + 1 words
// in shared memory).
template <int RULE, bool CM>
__global__ void bit_multi_step_resident(const uint32_t* __restrict__ in,
                                        const int32_t* __restrict__ rule,
                                        int rule_stride,
                                        uint32_t* __restrict__ out, int A,
                                        int B, int steps) {
    extern __shared__ float smem[];  // 2 x A x S words
    const int n = blockIdx.x;
    const int S = CM ? B + 1 : B;
    const size_t words = static_cast<size_t>(A) * B;
    uint32_t* cur = reinterpret_cast<uint32_t*>(smem);
    uint32_t* nxt = cur + static_cast<size_t>(A) * S;
    const uint32_t* src = in + n * words;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthreads = blockDim.x * blockDim.y;
    for (size_t i = tid; i < words; i += nthreads) cur[CM ? (i / B) * S + i % B : i] = src[i];
    const Leaves leaves = make_leaves(rule_of<RULE>(rule, rule_stride, n));
    uint32_t dead10[10], alive10[10];
    leaves10(leaves, dead10, alive10);
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
        if (CM) {
            generation_cm(cur, nxt, A, B, S, dead10, alive10);
        } else {
            for (int r = threadIdx.y; r < A; r += blockDim.y)
                for (int k = threadIdx.x; k < B; k += blockDim.x)
                    nxt[r * B + k] = step_word(cur, A, B, r, k, leaves);
        }
        __syncthreads();
        uint32_t* t = cur;
        cur = nxt;
        nxt = t;
    }
    uint32_t* dst = out + n * words;
    for (size_t i = tid; i < words; i += nthreads) dst[i] = cur[CM ? (i / B) * S + i % B : i];
}

// Fallback: one generation through device memory, one thread per word (a
// grid-stride loop, which the launch sizes to one pass).
template <int RULE, bool CM>
__global__ void bit_step_global(const uint32_t* __restrict__ in,
                                const int32_t* __restrict__ rule,
                                int rule_stride, uint32_t* __restrict__ out,
                                int A, int B) {
    const int n = blockIdx.y;
    const size_t words = static_cast<size_t>(A) * B;
    const Leaves leaves = make_leaves(rule_of<RULE>(rule, rule_stride, n));
    uint32_t dead10[10], alive10[10];
    leaves10(leaves, dead10, alive10);
    const uint32_t* src = in + n * words;
    for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < words;
         i += static_cast<size_t>(gridDim.x) * blockDim.x) {
        const int r = static_cast<int>(i / B);
        const int k = static_cast<int>(i - static_cast<size_t>(r) * B);
        if (CM) {
            uint32_t gw, w0, w1, g, p0, p1, ge, e0, e1;
            vertical_triple(src, A, B, r, k == 0 ? B - 1 : k - 1, gw, w0, w1);
            vertical_triple(src, A, B, r, k, g, p0, p1);
            vertical_triple(src, A, B, r, k == B - 1 ? 0 : k + 1, ge, e0, e1);
            out[n * words + i] = step_cm(g, p0, p1, w0, w1, e0, e1, dead10, alive10);
        } else {
            out[n * words + i] = step_word(src, A, B, r, k, leaves);
        }
    }
}

template <int RULE, bool CM>
static int launch(const void* in, const void* rule, int rule_stride, void* out,
                  void* scratch, int N, int A, int B, int steps, int resident,
                  cudaStream_t s) {
    const uint32_t* src = static_cast<const uint32_t*>(in);
    const int32_t* rb = static_cast<const int32_t*>(rule);
    cudaError_t err;
    if (resident) {
        const auto kernel = bit_multi_step_resident<RULE, CM>;
        const size_t smem = 2 * static_cast<size_t>(A) * (CM ? B + 1 : B) * sizeof(uint32_t);
        err = allow_smem(kernel, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        const int bx = CM ? 256 : (B < 32 ? B : 32);
        const dim3 block(bx, 256 / bx);
        KERNEL_LAUNCH(kernel, N, block, smem, s, src, rb, rule_stride,
                      static_cast<uint32_t*>(out), A, B, steps);
        return static_cast<int>(cudaGetLastError());
    }
    const size_t words = static_cast<size_t>(A) * B;
    if (steps == 0) {
        err = cudaMemcpyAsync(out, in, N * words * sizeof(uint32_t),
                              cudaMemcpyDeviceToDevice, s);
        return static_cast<int>(err);
    }
    // ping-pong so that the last generation lands in `out`
    uint32_t* bufs[2] = {static_cast<uint32_t*>(scratch), static_cast<uint32_t*>(out)};
    const dim3 blocks(static_cast<unsigned>((words + 255) / 256), N);
    const auto kernel = bit_step_global<RULE, CM>;
    for (int t = 0; t < steps; ++t) {
        uint32_t* dst = bufs[(steps - t) % 2];
        KERNEL_LAUNCH(kernel, blocks, 256, 0, s, src, rb, rule_stride, dst, A, B);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
        src = dst;
    }
    return static_cast<int>(cudaSuccess);
}

// -- The redesigned row-major engine: bit_words_launch with the rule as data,
// bit_static_words_launch (-DSTATIC_RULE) with it fixed.  The same kernels,
// the rule a template argument, so a fixed rule folds its mux tree.
//
// K > 1: each universe stays resident across generations, in REGISTERS
// (bit_regs.cuh: a thread owns R rows of V adjacent words, one barrier an
// exchange of ghost rows, or a thread-block cluster of CL blocks a universe).
template <int RULE, int V, int L, int R, int CL, int G>
__global__ void __launch_bounds__(256, 2)
    bit_regs_kernel(const uint32_t* __restrict__ in, const int32_t* __restrict__ rule,
                    int rule_stride, uint32_t* __restrict__ out, int N, int H, int steps) {
    constexpr int NW = V * L;
    extern __shared__ float smem[];  // [2][blockDim][2 G][V] words
    const RegsPlace at = regs_place<L, R, CL>(threadIdx.x, blockDim.x, N, H);
    const size_t plane = static_cast<size_t>(H) * NW;
    const size_t first = static_cast<size_t>(at.rank * (H / CL) + at.rg * R) * NW + at.lane * V;
    uint32_t st[R][V];
#pragma unroll
    for (int i = 0; i < R; ++i) load_words<V>(in + at.nn * plane + first + i * NW, st[i]);
    const Leaves leaves = make_leaves(rule_of<RULE>(rule, rule_stride, at.nn));
    regs_generations<V, L, R, CL, G>(st, leaves, at, reinterpret_cast<uint32_t*>(smem), steps);
    if (at.live) {
#pragma unroll
        for (int i = 0; i < R; ++i) store_words<V>(out + at.n * plane + first + i * NW, st[i]);
    }
}

#ifndef CUDA_EMULATION
// A launch in clusters of `cluster` blocks along x.
template <typename... Params, typename... Args>
static cudaError_t cluster_launch(void (*kernel)(Params...), unsigned blocks, int threads,
                                  size_t smem, cudaStream_t s, int cluster, Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (cluster > 8) {  // past the portable size: Hopper takes 16
        const cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return err;
    }
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}
#endif

template <int RULE, int V, int L, int R, int CL, int G>
static int regs_launch(const uint32_t* in, const int32_t* rule, int rule_stride, uint32_t* out,
                       int N, int H, int steps, int threads, cudaStream_t s) {
    const int per = H / CL / R * L;
    if (H % (CL * R) || threads < per || threads > 256 || threads % per ||
        (L > 1 && threads % 32) || H / CL / R < G)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto kernel = bit_regs_kernel<RULE, V, L, R, CL, G>;
    const size_t smem = regs_smem(threads, V, G);
    const unsigned blocks = CL > 1 ? static_cast<unsigned>(N) * CL
                                   : static_cast<unsigned>((N + threads / per - 1) / (threads / per));
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if constexpr (CL == 1) {
        KERNEL_LAUNCH_THREADED(kernel, blocks, threads, smem, s, in, rule, rule_stride, out, N, H,
                               steps);
    } else {
#ifdef CUDA_EMULATION
        return static_cast<int>(cudaErrorInvalidValue);  // no clusters on the host
#else
        err = cluster_launch(kernel, blocks, threads, smem, s, CL, in, rule, rule_stride, out, N,
                             H, steps);
        if (err != cudaSuccess) return static_cast<int>(err);
#endif
    }
    return static_cast<int>(cudaGetLastError());
}

// Row-major [N, H, NW], K = steps generations: regime 0 streams one
// generation a launch through device memory (bit_words.cuh's
// bit_stream_kernel: V words, strips of S rows, `threads` a block), ping-pong
// through scratch so the last lands in out; regime 1 keeps each universe in
// registers for all K (bit_regs_kernel<RULE, V, L, R, CL, G>, `threads` a
// block).  steps == 0 copies.
template <int RULE>
static int words_launch(const void* in, const void* rule, int rule_stride, void* out,
                        void* scratch, int N, int H, int NW, int steps, int regime, int V, int L,
                        int R, int CL, int G, int S, int threads, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint32_t* src = static_cast<const uint32_t*>(in);
    const int32_t* rb = static_cast<const int32_t*>(rule);
    if (N < 1 || H < 1 || NW < 1 || steps < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (steps == 0)
        return static_cast<int>(cudaMemcpyAsync(
            out, in, static_cast<size_t>(N) * H * NW * sizeof(uint32_t),
            cudaMemcpyDeviceToDevice, st));
    if (regime == 1) {
        if (V * L != NW) return static_cast<int>(cudaErrorInvalidValue);
#define BIT_REGS_CASE(v, l, r, cl, g)                                                         \
    if (V == v && L == l && R == r && CL == cl && G == g)                                     \
        return regs_launch<RULE, v, l, r, cl, g>(src, rb, rule_stride,                        \
                                                 static_cast<uint32_t*>(out), N, H, steps,    \
                                                 threads, st);
        BIT_REGS_PLANS(BIT_REGS_CASE)
#undef BIT_REGS_CASE
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (regime != 0) return static_cast<int>(cudaErrorInvalidValue);
    uint32_t* bufs[2] = {static_cast<uint32_t*>(scratch), static_cast<uint32_t*>(out)};
    for (int t = 0; t < steps; ++t) {
        uint32_t* dst = bufs[(steps - t) % 2];
        const SlotTable<1> table{{{src, dst, src, src}}};  // a universe is its own ring
        const int rc = stream_launch<RULE, 1>(table, 1, rb, rule_stride, N, H, NW, V, S, threads,
                                              st);
        if (rc != 0) return rc;
        src = dst;
    }
    return static_cast<int>(cudaSuccess);
}

// Registers, static shared memory, spills and resident blocks a
// multiprocessor (common.cuh::kernel_occupancy) of the streaming kernel
// (regime 0, V words) or of bit_regs_kernel<RULE, V, L, R, CL, G> (regime 1),
// for `threads` a block.
template <int RULE>
static int words_occupancy(int regime, int V, int L, int R, int CL, int G, int threads,
                           int device, int* out) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (regime == 0) {
        if (V == 4) return kernel_occupancy(bit_stream_kernel<RULE, 4, 1>, threads, 0, out);
        if (V == 1) return kernel_occupancy(bit_stream_kernel<RULE, 1, 1>, threads, 0, out);
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t smem = regs_smem(threads, V, G);
#define BIT_REGS_OCC(v, l, r, cl, g)                           \
    if (V == v && L == l && R == r && CL == cl && G == g)      \
        return kernel_occupancy(bit_regs_kernel<RULE, v, l, r, cl, g>, threads, smem, out);
    BIT_REGS_PLANS(BIT_REGS_OCC)
#undef BIT_REGS_OCC
    return static_cast<int>(cudaErrorInvalidValue);
}

// -- The redesigned column-major engine with the rule fixed:
// bit_static_cm_words_launch (-DSTATIC_RULE), counted as
// bit_multi_step_static_cm_words (ops/cuda_bitpack.py::cm_plan picks the
// plan by shape).  Each universe [HW, W] stays in REGISTERS for all K
// generations: a thread holds CM_COLUMNS adjacent columns x all HW word rows,
// and L = W / CM_COLUMNS adjacent lanes of one warp (a power of two, at most
// 32) cover the width.  The torus over the height wraps inside the thread (a
// column's words are all its own).  The thread walks its word rows, builds
// each column's vertical triple planes once (the words above carried from the
// row before), and takes the planes of the column west of its first and east
// of its last from the neighbouring lanes by __shfl_sync, the universe's first
// and last lanes closing the torus over the width: no shared memory and no
// barrier.  At W = 256 a universe is exactly one warp (measured faster than 4
// columns a thread over two warps, PERF.md row 11a).  Same update as step_cm:
// bit for bit the present kernels.
constexpr int CM_COLUMNS = 8;

template <int RULE, int HW>
__global__ void __launch_bounds__(256, 2)
    bit_cm_regs_kernel(const uint32_t* __restrict__ in, const int32_t* __restrict__ rule,
                       int rule_stride, uint32_t* __restrict__ out, int N, int W, int steps) {
    constexpr int C = CM_COLUMNS;
    const int tid = threadIdx.x, nt = blockDim.x;
    const int L = W / C;  // lanes a universe, a power of two up to a warp's
    const int u = tid / L, lane = tid - u * L;
    const int n = static_cast<int>(blockIdx.x) * (nt / L) + u;
    const bool live = n < N;  // the last block's spare lanes compute a copy, store nothing
    const int nn = live ? n : N - 1;
    const size_t plane = static_cast<size_t>(HW) * W;
    uint32_t st[C][HW];
#pragma unroll
    for (int k = 0; k < HW; ++k) {
        uint32_t w[C];
        load_words<C>(in + nn * plane + static_cast<size_t>(k) * W + lane * C, w);
#pragma unroll
        for (int c = 0; c < C; ++c) st[c][k] = w[c];
    }
    uint32_t dead10[10], alive10[10];
    leaves10(make_leaves(rule_of<RULE>(rule, rule_stride, nn)), dead10, alive10);
    const auto shfl = [L, tid](uint32_t v, int delta) {
        return __shfl_sync(0xffffffffu, v, (tid + delta) & (L - 1), L);
    };
    for (int s = 0; s < steps; ++s) {
        uint32_t first[C], prev[C];  // word rows 0 and k - 1 before this generation
#pragma unroll
        for (int k = 0; k < HW; ++k) {
            uint32_t p0[C], p1[C];
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const uint32_t up = k == 0 ? st[c][HW - 1] : prev[c];
                const uint32_t dn = k + 1 < HW ? st[c][k + 1] : (k == 0 ? st[c][0] : first[c]);
                triple_planes(up, st[c][k], dn, p0[c], p1[c]);
            }
            const uint32_t w0 = shfl(p0[C - 1], -1), w1 = shfl(p1[C - 1], -1);
            const uint32_t e0 = shfl(p0[0], 1), e1 = shfl(p1[0], 1);
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const uint32_t g = st[c][k];
                const uint32_t nv =
                    step_cm(g, p0[c], p1[c], c == 0 ? w0 : p0[c - 1], c == 0 ? w1 : p1[c - 1],
                            c + 1 < C ? p0[c + 1] : e0, c + 1 < C ? p1[c + 1] : e1, dead10,
                            alive10);
                if (k == 0) first[c] = g;
                prev[c] = g;
                st[c][k] = nv;
            }
        }
    }
    if (live) {
#pragma unroll
        for (int k = 0; k < HW; ++k) {
            uint32_t w[C];
#pragma unroll
            for (int c = 0; c < C; ++c) w[c] = st[c][k];
            store_words<C>(out + n * plane + static_cast<size_t>(k) * W + lane * C, w);
        }
    }
}

// The word rows HW an instantiation holds.  ops/cuda_bitpack.py reads this
// list (CM_PLANS): keep it one macro.
#define BIT_CM_PLANS(X) X(1) X(2) X(4) X(8)

// Column-major [N, HW, W], K = steps generations by bit_cm_regs_kernel<RULE,
// HW> in blocks of `threads` (a multiple of 32 and of L = W / CM_COLUMNS,
// which is a power of two up to 32).  steps == 0 copies.
template <int RULE>
static int cm_words_launch(const void* in, const void* rule, int rule_stride, void* out, int N,
                           int HW, int W, int steps, int threads, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (N < 1 || HW < 1 || W < CM_COLUMNS || W % CM_COLUMNS || steps < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int L = W / CM_COLUMNS;
    if ((L & (L - 1)) || L > 32 || threads < 32 || threads > 256 || threads % 32 ||
        reinterpret_cast<uintptr_t>(in) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    if (steps == 0)
        return static_cast<int>(cudaMemcpyAsync(
            out, in, static_cast<size_t>(N) * HW * W * sizeof(uint32_t),
            cudaMemcpyDeviceToDevice, st));
    const unsigned blocks = static_cast<unsigned>((N + threads / L - 1) / (threads / L));
    const uint32_t* src = static_cast<const uint32_t*>(in);
    const int32_t* rb = static_cast<const int32_t*>(rule);
    uint32_t* dst = static_cast<uint32_t*>(out);
#define BIT_CM_CASE(hw)                                                                       \
    if (HW == hw) {                                                                           \
        const auto kernel = bit_cm_regs_kernel<RULE, hw>;                                     \
        KERNEL_LAUNCH_THREADED(kernel, blocks, threads, 0, st, src, rb, rule_stride, dst, N, \
                               W, steps);                                                     \
        return static_cast<int>(cudaGetLastError());                                          \
    }
    BIT_CM_PLANS(BIT_CM_CASE)
#undef BIT_CM_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}

// Registers, static shared memory, spills and resident blocks a
// multiprocessor of bit_cm_regs_kernel<RULE, HW> for `threads` a block.
template <int RULE>
static int cm_words_occupancy(int HW, int threads, int device, int* out) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
#define BIT_CM_OCC(hw) \
    if (HW == hw) return kernel_occupancy(bit_cm_regs_kernel<RULE, hw>, threads, 0, out);
    BIT_CM_PLANS(BIT_CM_OCC)
#undef BIT_CM_OCC
    return static_cast<int>(cudaErrorInvalidValue);
}

#ifndef STATIC_RULE
// -- The rule as data: a scalar (rule_stride 0) or one int32 a universe (1).
extern "C" int bit_words_launch(const void* in, const void* rule, int rule_stride, void* out,
                                void* scratch, int N, int H, int NW, int steps, int regime,
                                int V, int L, int R, int CL, int G, int S, int threads,
                                int device, void* stream) {
    return words_launch<-1>(in, rule, rule_stride, out, scratch, N, H, NW, steps, regime, V, L,
                            R, CL, G, S, threads, device, stream);
}

extern "C" int bit_words_occupancy(int regime, int V, int L, int R, int CL, int G, int threads,
                                   int device, int* out) {
    return words_occupancy<-1>(regime, V, L, R, CL, G, threads, device, out);
}

// The present kernels (bit_multi_step_resident, bit_step_global).
// Row-major [N, H, NW].
extern "C" int bit_multi_step_launch(const void* in, const void* rule,
                                     int rule_stride, void* out, void* scratch,
                                     int N, int H, int NW, int steps,
                                     int resident, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch<-1, false>(in, rule, rule_stride, out, scratch, N, H, NW, steps, resident,
                             static_cast<cudaStream_t>(stream));
}

// Column-major [N, HW, W].
extern "C" int bit_multi_step_cm_launch(const void* in, const void* rule,
                                        int rule_stride, void* out, void* scratch,
                                        int N, int HW, int W, int steps,
                                        int resident, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch<-1, true>(in, rule, rule_stride, out, scratch, N, HW, W, steps, resident,
                            static_cast<cudaStream_t>(stream));
}
#else
// The rule fixed at compile time: -DSTATIC_RULE=<18-bit mask>.
static_assert(STATIC_RULE >= 0 && STATIC_RULE < (1 << 18), "an 18-bit rule mask");

// The redesigned kernels, row-major [N, H, NW] (bit_words_launch's regimes
// and plans, the rule folded).
extern "C" int bit_static_words_launch(const void* in, void* out, void* scratch, int N, int H,
                                       int NW, int steps, int regime, int V, int L, int R,
                                       int CL, int G, int S, int threads, int device,
                                       void* stream) {
    return words_launch<STATIC_RULE>(in, nullptr, 0, out, scratch, N, H, NW, steps, regime, V, L,
                                     R, CL, G, S, threads, device, stream);
}

extern "C" int bit_static_words_occupancy(int regime, int V, int L, int R, int CL, int G,
                                          int threads, int device, int* out) {
    return words_occupancy<STATIC_RULE>(regime, V, L, R, CL, G, threads, device, out);
}

// The redesigned column-major kernel, [N, HW, W] (cm_words_launch's plans).
extern "C" int bit_static_cm_words_launch(const void* in, void* out, int N, int HW, int W,
                                          int steps, int threads, int device, void* stream) {
    return cm_words_launch<STATIC_RULE>(in, nullptr, 0, out, N, HW, W, steps, threads, device,
                                        stream);
}

extern "C" int bit_static_cm_words_occupancy(int HW, int threads, int device, int* out) {
    return cm_words_occupancy<STATIC_RULE>(HW, threads, device, out);
}

// The present kernels; cm selects the column-major layout ([N, HW, W]) over
// the row-major one ([N, H, NW]).
extern "C" int bit_multi_step_static_launch(const void* in, void* out, void* scratch,
                                            int N, int A, int B, int steps, int resident,
                                            int cm, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (cm)
        return launch<STATIC_RULE, true>(in, nullptr, 0, out, scratch, N, A, B, steps,
                                         resident, s);
    return launch<STATIC_RULE, false>(in, nullptr, 0, out, scratch, N, A, B, steps,
                                      resident, s);
}
#endif
