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
#include "bit_words.cuh"
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
// neighbours) of word (k, c) of a [HW, W] universe with row stride S as
// planes p0 (weight 1) and p1 (weight 2); g is the word itself.
__device__ __forceinline__ void vertical_triple(const uint32_t* src, int HW, int S, int k,
                                                int c, uint32_t& g, uint32_t& p0,
                                                uint32_t& p1) {
    const int ku = k == 0 ? HW - 1 : k - 1;
    const int kd = k == HW - 1 ? 0 : k + 1;
    g = src[k * S + c];
    const uint32_t u = __funnelshift_l(src[ku * S + c], g, 1);  // row r-1 at r
    const uint32_t d = __funnelshift_r(g, src[kd * S + c], 1);  // row r+1 at r
    csa(u, g, d, p0, p1);
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
// K > 1: each universe stays resident across generations, in REGISTERS.  A
// thread owns R rows of V adjacent words; L = NW / V lanes (adjacent threads)
// cover a row and pass their edge words by lane shuffles.  Once an exchange
// each thread stores its top row into the slots of the threads above it and
// its bottom row into the slots of those below (shared memory), builds its
// own rows' pair planes, waits at one barrier and reads its ghost rows from
// its own slots: one barrier an exchange (the slots alternate), every other
// operand a register.  An exchange runs G generations: G = 1 trades one
// ghost row a side; G = 2 (one row a thread) trades two, and the thread
// computes the rows above and below its own once more itself (three rows,
// then its own), so one barrier serves two generations.  CL = 1: a block
// holds whole universes (threads / (H / R * L) of them).  CL > 1: a universe
// is split over a thread-block cluster of CL blocks, a band of H / CL rows
// each, so its generations run on CL multiprocessors (the server's /rollout:
// one universe, many generations); the bands' edge rows are stored into the
// neighbouring blocks' slots through distributed shared memory before a split
// cluster barrier (arrive, own planes, wait).
#ifndef CUDA_EMULATION
#include <cooperative_groups.h>

template <int CL>
__device__ __forceinline__ void band_arrive() {
    if constexpr (CL > 1) asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

template <int CL>
__device__ __forceinline__ void band_wait() {
    if constexpr (CL > 1)
        asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    else
        __syncthreads();
}

template <int CL>
__device__ __forceinline__ int band_rank() {
    if constexpr (CL > 1)
        return static_cast<int>(cooperative_groups::this_cluster().block_rank());
    else
        return 0;
}

// p (this block's shared memory) in the block of cluster rank `rank`.
template <int CL>
__device__ __forceinline__ uint32_t* band_ptr(uint32_t* p, int rank) {
    if constexpr (CL > 1)
        return cooperative_groups::this_cluster().map_shared_rank(p, rank);
    else
        return p;
}
#else
// The host build runs clusters of one block: the block barrier at the wait,
// its own shared memory; lane shuffles are the shim's.
template <int CL>
__device__ __forceinline__ void band_arrive() {}
template <int CL>
__device__ __forceinline__ void band_wait() { __syncthreads(); }
template <int CL>
__device__ __forceinline__ int band_rank() { return 0; }
template <int CL>
__device__ __forceinline__ uint32_t* band_ptr(uint32_t* p, int) { return p; }
#endif

// Lane (lane + delta) mod L of the caller's L adjacent lanes.
template <int L>
__device__ __forceinline__ uint32_t lane_word(uint32_t v, int delta) {
    if constexpr (L > 1)
        return __shfl_sync(0xffffffffu, v, (static_cast<int>(threadIdx.x) + delta) & (L - 1), L);
    else
        return v;
}

// A row's words with their pair planes, the row's west and east edge words
// from the neighbouring lanes (wrapping: the torus over the width).
template <int V, int L>
__device__ __forceinline__ void lane_row(const uint32_t (&w)[V], RowPlanes<V>& p) {
    const uint32_t west = lane_word<L>(w[V - 1], -1);
    const uint32_t east = lane_word<L>(w[0], 1);
    row_planes<V>(w, west, east, p);
}

template <int RULE, int V, int L, int R, int CL, int G>
__global__ void __launch_bounds__(256, 2)
    bit_regs_kernel(const uint32_t* __restrict__ in, const int32_t* __restrict__ rule,
                    int rule_stride, uint32_t* __restrict__ out, int N, int H, int steps) {
    static_assert(G == 1 || (G == 2 && R == 1), "two generations an exchange: a row a thread");
    constexpr int NW = V * L, SLOTS = 2 * G;  // slots: the G rows above, then the G below
    extern __shared__ float smem[];           // [2][blockDim][SLOTS][V] words
    uint32_t* ex = reinterpret_cast<uint32_t*>(smem);
    const int tid = threadIdx.x, nt = blockDim.x;
    const int groups = H / CL / R;  // row groups a band
    const int per = groups * L;     // threads a band
    const int u = tid / per, t = tid - u * per;
    const int rg = t / L, lane = t - rg * L;
    const int rank = band_rank<CL>();
    const int n = CL > 1 ? static_cast<int>(blockIdx.x) / CL
                         : static_cast<int>(blockIdx.x) * (nt / per) + u;
    const bool live = n < N;  // the last block's spare bands compute a copy and store nothing
    const int nn = live ? n : N - 1;
    const size_t plane = static_cast<size_t>(H) * NW;
    const size_t first = static_cast<size_t>(rank * (H / CL) + rg * R) * NW + lane * V;
    uint32_t st[R][V];
#pragma unroll
    for (int i = 0; i < R; ++i) load_words<V>(in + nn * plane + first + i * NW, st[i]);
    const Leaves leaves = make_leaves(rule_of<RULE>(rule, rule_stride, nn));
    // The thread j row groups away (j < 0: above; across a band's edge, the
    // neighbouring band's, in the same universe) and its cluster rank.
    int away_t[SLOTS], away_rank[SLOTS];
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
        const int j = k < G ? k - G : k - G + 1;  // -G .. -1, 1 .. G
        int g = rg + j, r = rank;
        if (g < 0) {
            g += groups;
            r = (rank + CL - 1) % CL;
        } else if (g >= groups) {
            g -= groups;
            r = (rank + 1) % CL;
        }
        away_t[k] = u * per + g * L + lane;
        away_rank[k] = r;
    }
    if constexpr (CL > 1) {  // every block of the cluster has started before the first
        band_arrive<CL>();   // store into its shared memory
        band_wait<CL>();
    }
    for (int s = 0; s < steps; s += G) {
        uint32_t* buf = ex + static_cast<size_t>((s / G) & 1) * nt * SLOTS * V;
        // my top row is row j below for the thread j above (its slot G - 1 + j),
        // my bottom row row j above for the thread j below (its slot G - j)
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
            const int j = k < G ? G - k : k - G + 1;
            uint32_t* slot = buf + (away_t[k] * SLOTS + (k < G ? G - 1 + j : G - j)) * V;
            store_words<V>(away_rank[k] == rank ? slot : band_ptr<CL>(slot, away_rank[k]),
                           k < G ? st[0] : st[R - 1]);
        }
        band_arrive<CL>();
        RowPlanes<V> up, mid, dn;
        lane_row<V, L>(st[0], mid);
        band_wait<CL>();
        const uint32_t* mine = buf + tid * SLOTS * V;
        uint32_t w[V];
        if constexpr (G == 2) {
            if (s + 1 < steps) {  // two generations: the rows above and below, then its own
                RowPlanes<V> a2, b2;
                load_words<V>(mine, w);
                lane_row<V, L>(w, a2);
                load_words<V>(mine + V, w);
                lane_row<V, L>(w, up);
                load_words<V>(mine + 2 * V, w);
                lane_row<V, L>(w, dn);
                load_words<V>(mine + 3 * V, w);
                lane_row<V, L>(w, b2);
                uint32_t na[V], nb[V];
                step_row<V>(a2, up, mid, leaves, na);
                step_row<V>(mid, dn, b2, leaves, nb);
                step_row<V>(up, mid, dn, leaves, st[0]);
                lane_row<V, L>(na, up);
                lane_row<V, L>(st[0], mid);
                lane_row<V, L>(nb, dn);
                step_row<V>(up, mid, dn, leaves, st[0]);
                continue;
            }
        }
        load_words<V>(mine + (G - 1) * V, w);  // the row above
        lane_row<V, L>(w, up);
#pragma unroll
        for (int i = 0; i < R; ++i) {
            if (i + 1 < R) {
                lane_row<V, L>(st[i + 1], dn);
            } else {
                load_words<V>(mine + G * V, w);  // the row below
                lane_row<V, L>(w, dn);
            }
            step_row<V>(up, mid, dn, leaves, st[i]);
            up = mid;
            mid = dn;
        }
    }
    // (a neighbour's last stores into this block landed before its last wait)
    if (live) {
#pragma unroll
        for (int i = 0; i < R; ++i) store_words<V>(out + n * plane + first + i * NW, st[i]);
    }
}

// The (V, L, R, CL, G) instantiations a plan may name: NW = V L words a row.
// ops/cuda_bitpack.py reads this list (REGS_PLANS): keep it one macro.
#define BIT_REGS_PLANS(X)                                                                  \
    X(8, 1, 4, 1, 1) X(8, 1, 1, 1, 1) X(4, 1, 4, 1, 1) X(4, 1, 1, 1, 1) X(2, 1, 4, 1, 1) \
    X(2, 1, 1, 1, 1) X(1, 1, 4, 1, 1) X(1, 1, 1, 1, 1) X(2, 4, 1, 1, 2) X(2, 4, 1, 16, 2) \
    X(8, 1, 8, 1, 1)

// Shared memory of a block of bit_regs_kernel: two sets of 2 G slots a thread.
static inline size_t regs_smem(int threads, int V, int G) {
    return 2 * static_cast<size_t>(threads) * 2 * G * V * sizeof(uint32_t);
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
