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
// Bound on an H100: operations.  ~45 integer operations a word a generation
// with the rule as data (chip_smoke.py counts them), fewer fixed, against 8
// bytes moved a word per launch, so the integer ALUs are the limit once a
// universe stays on chip.  Design: the resident kernels give each universe one
// block that holds it in shared memory for all K generations (ping-pong
// between two copies, 16 KB at 256x256 in either layout, 64 KB at 512x512),
// the counterpart of the TPU kernels keeping the grid in VMEM, so device
// memory is read once and written once a launch.  Universes whose two copies
// do not fit a block's 227 KB take the fallback: one launch per generation
// through device memory.
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

#ifndef STATIC_RULE
// Rule as data: a scalar (rule_stride 0) or one int32 a universe (1).
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
// The rule fixed at compile time: -DSTATIC_RULE=<18-bit mask>.  cm selects
// the column-major layout ([N, HW, W]) over the row-major one ([N, H, NW]).
static_assert(STATIC_RULE >= 0 && STATIC_RULE < (1 << 18), "an 18-bit rule mask");

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
