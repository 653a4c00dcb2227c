// ca_multi_step: K action-free Life-like generations on uint8 universes.
//
// Replaces carle_tpu/ops/pallas_ca.py::ca_multi_step_pallas (kernel bodies
// _multi_step_kernel and _multi_step_kernel_vec).
//
// out[n, i, j] after each generation = (rule[n] >> (count + 9 * alive)) & 1,
// count the 8 torus neighbours; the rule is one int32 for the batch
// (rule_stride 0) or one per universe (rule_stride 1).  Cells are 0 or 1
// (the env's contract; the twin's rule index and both kernels assume it).
//
// Bound on an H100: operations.  The work is the packed update's 37 integer
// operations a word of 32 cells a generation (the generations can run on
// bits) against one read and one write of each byte.
//
// The redesigned kernel, ca_bits_launch (counted as ca_multi_step_bits;
// ops/cuda_ca.py::bits_plan picks the plan by shape): K > 1 on universes of
// W = 32 V cells a row (V = 1, 2, 4 or 8 words) whose packed form a block's
// registers hold.  The uint8 function runs on bits inside one launch: the
// load packs (a warp reads each row its lanes own as 32 consecutive bytes an
// instruction, one a lane, and __ballot_sync makes them the row's word: bit
// j = lane j = column 32k + j, ops/bitpack.py::pack_grid's order; the owner
// keeps it), bit_regs.cuh's generations run in registers with the rule as
// data (R rows a thread, one barrier a generation), and the store unpacks
// (the owner's word goes to the warp by __shfl_sync, lane j writes bit j as
// byte 32k + j).  So the cells cross device memory once each way and every
// access of a warp is 32 adjacent bytes.
//
// The present kernel (ca_multi_step_launch) serves the other shapes (K <= 1,
// widths not a multiple of 32, universes the registers do not hold) and every
// shape with cuda_ca.CA_MULTI_BITS off.  Four cells a 32-bit word (SWAR): a
// byte is a cell, so the three rows' bytes add without carries into column
// sums (0-3), and the column sums of the word and its two neighbours,
// funnel-shifted by a byte, add into the count including the centre (0-9).
// The rule index of a cell is then count9 + 8 * alive (0-17), one variable
// shift of the mask a byte: 19 operations a word of 4 cells.  A thread walks
// a strip of rows down one column of words and carries the three rows' words
// of its column and both neighbour columns, so it loads three words a step;
// neighbouring threads take neighbouring columns, so a warp's loads hit 32
// different banks of shared memory.  The update (column_sums_rows,
// step_cells4) is common.cuh's, which the row-sharded halo kernels
// (halo_step.cu) run too.  One block a universe holds it in shared memory for
// all K generations (ping-pong between two copies: 128 KB at 256 x 256), the
// counterpart of the TPU kernel keeping the grid in VMEM.  Universes whose two
// copies do not fit a block's 227 KB take the fallback: one launch per
// generation through device memory.  W must be a multiple of 4.
#include "bit_regs.cuh"
#include "common.cuh"

constexpr int U8_STRIP = 16;  // rows a thread walks down a column of words

// Column sums (up + mid + down, a byte each) of word q of row r of a
// [H, QW] universe of 4-cell words; mid is the row's own word.
__device__ __forceinline__ uint32_t column_sums(const uint32_t* src, int H, int QW, int r,
                                                int q, uint32_t& mid) {
    const int ru = r == 0 ? H - 1 : r - 1;
    const int rd = r == H - 1 ? 0 : r + 1;
    return column_sums_rows(src + ru * QW, src + r * QW, src + rd * QW, q, mid);
}

// The words of row r at columns qw, q, qe.
__device__ __forceinline__ void row_words(const uint32_t* src, int QW, int r, int qw, int q,
                                          int qe, uint32_t& w, uint32_t& c, uint32_t& e) {
    const uint32_t* row = src + r * QW;
    w = row[qw];
    c = row[q];
    e = row[qe];
}

// One generation of a [H, QW] universe of words src -> dst.
__device__ __forceinline__ void generation_u8(const uint32_t* src, uint32_t* dst, int H,
                                              int QW, int rb) {
    const int strips = (H + U8_STRIP - 1) / U8_STRIP;
    const int tid = threadIdx.x, nt = blockDim.x;
    for (int i = tid; i < QW * strips; i += nt) {
        const int q = i % QW, r0 = (i / QW) * U8_STRIP;
        const int r1 = min(r0 + U8_STRIP, H);
        const int qw = q == 0 ? QW - 1 : q - 1, qe = q == QW - 1 ? 0 : q + 1;
        uint32_t uw, uc, ue, mw, mc, me;  // rows r - 1 and r at columns qw, q, qe
        row_words(src, QW, r0 == 0 ? H - 1 : r0 - 1, qw, q, qe, uw, uc, ue);
        row_words(src, QW, r0, qw, q, qe, mw, mc, me);
        for (int r = r0; r < r1; ++r) {
            uint32_t dw, dc, de;
            row_words(src, QW, r == H - 1 ? 0 : r + 1, qw, q, qe, dw, dc, de);
            dst[r * QW + q] = step_cells4(uw + mw + dw, uc + mc + dc, ue + me + de, mc, rb);
            uw = mw; uc = mc; ue = me;
            mw = dw; mc = dc; me = de;
        }
    }
}

// One block per universe, resident in shared memory for all `steps`.
__global__ void ca_multi_step_resident(const uint32_t* __restrict__ in,
                                       const int32_t* __restrict__ rule, int rule_stride,
                                       uint32_t* __restrict__ out, int H, int QW, int steps) {
    extern __shared__ float smem[];  // 2 x H x QW words
    const int n = blockIdx.x;
    const size_t words = static_cast<size_t>(H) * QW;
    uint32_t* cur = reinterpret_cast<uint32_t*>(smem);
    uint32_t* nxt = cur + words;
    const uint32_t* src = in + n * words;
    const int tid = threadIdx.x, nt = blockDim.x;
    for (size_t i = tid; i < words; i += nt) cur[i] = src[i];
    const int rb = rule[static_cast<size_t>(n) * rule_stride];
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
        generation_u8(cur, nxt, H, QW, rb);
        __syncthreads();
        uint32_t* t = cur;
        cur = nxt;
        nxt = t;
    }
    uint32_t* dst = out + n * words;
    for (size_t i = tid; i < words; i += nt) dst[i] = cur[i];
}

// Fallback: one generation through device memory, one thread per word (a
// grid-stride loop, which the launch sizes to one pass).
__global__ void ca_step_words_global(const uint32_t* __restrict__ in,
                                     const int32_t* __restrict__ rule, int rule_stride,
                                     uint32_t* __restrict__ out, int H, int QW) {
    const int n = blockIdx.y;
    const size_t words = static_cast<size_t>(H) * QW;
    const uint32_t* src = in + n * words;
    const int rb = rule[static_cast<size_t>(n) * rule_stride];
    for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < words;
         i += static_cast<size_t>(gridDim.x) * blockDim.x) {
        const int r = static_cast<int>(i / QW);
        const int q = static_cast<int>(i - static_cast<size_t>(r) * QW);
        uint32_t mid, unused;
        const uint32_t sw = column_sums(src, H, QW, r, q == 0 ? QW - 1 : q - 1, unused);
        const uint32_t s = column_sums(src, H, QW, r, q, mid);
        const uint32_t se = column_sums(src, H, QW, r, q == QW - 1 ? 0 : q + 1, unused);
        out[n * words + i] = step_cells4(sw, s, se, mid, rb);
    }
}

// grid, out, scratch: uint8 [N, H, W] (W % 4 == 0, 4-byte aligned).
extern "C" int ca_multi_step_launch(const void* grid, const void* rule, int rule_stride,
                                    void* out, void* scratch, int N, int H, int W, int steps,
                                    int resident, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (W % 4) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint32_t* src = static_cast<const uint32_t*>(grid);
    const int32_t* rb = static_cast<const int32_t*>(rule);
    const int QW = W / 4;
    const size_t words = static_cast<size_t>(H) * QW;
    if (resident) {
        const size_t smem = 2 * words * sizeof(uint32_t);
        err = allow_smem(ca_multi_step_resident, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        KERNEL_LAUNCH(ca_multi_step_resident, N, 1024, smem, s, src, rb, rule_stride,
                      static_cast<uint32_t*>(out), H, QW, steps);
        return static_cast<int>(cudaGetLastError());
    }
    if (steps == 0) {
        err = cudaMemcpyAsync(out, grid, N * words * sizeof(uint32_t),
                              cudaMemcpyDeviceToDevice, s);
        return static_cast<int>(err);
    }
    uint32_t* bufs[2] = {static_cast<uint32_t*>(scratch), static_cast<uint32_t*>(out)};
    const dim3 blocks(static_cast<unsigned>((words + 255) / 256), N);
    for (int t = 0; t < steps; ++t) {
        uint32_t* dst = bufs[(steps - t) % 2];
        KERNEL_LAUNCH(ca_step_words_global, blocks, 256, 0, s, src, rb, rule_stride, dst, H,
                      QW);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
        src = dst;
    }
    return static_cast<int>(cudaSuccess);
}

// -- The redesigned kernel: [N, H, 32 V] cells, R rows a thread (H % R == 0).
template <int V, int R>
__global__ void __launch_bounds__(256, 2)
    ca_bits_kernel(const uint8_t* __restrict__ in, const int32_t* __restrict__ rule,
                   int rule_stride, uint8_t* __restrict__ out, int N, int H, int steps) {
    constexpr int W = 32 * V;
    extern __shared__ float smem[];  // [2][blockDim][2][V] words
    const int tid = threadIdx.x, nt = blockDim.x;
    const RegsPlace at = regs_place<1, R, 1>(tid, nt, N, H);
    const int lane = tid & 31, base = tid - lane;  // the block is whole warps
    uint32_t st[R][V];
    for (int g = 0; g < 32; ++g) {  // the rows of lane g, the warp together
        const RegsPlace o = regs_place<1, R, 1>(base + g, nt, N, H);
        const uint8_t* p = in + (static_cast<size_t>(o.nn) * H + o.rg * R) * W + lane;
#pragma unroll
        for (int i = 0; i < R; ++i) {
#pragma unroll
            for (int k = 0; k < V; ++k) {
                const uint32_t word = __ballot_sync(0xffffffffu, p[i * W + 32 * k] != 0);
                if (lane == g) st[i][k] = word;
            }
        }
    }
    const Leaves leaves = make_leaves(rule_of<-1>(rule, rule_stride, at.nn));
    regs_generations<V, 1, R, 1, 1>(st, leaves, at, reinterpret_cast<uint32_t*>(smem), steps);
    for (int g = 0; g < 32; ++g) {
        const RegsPlace o = regs_place<1, R, 1>(base + g, nt, N, H);
        uint8_t* q = out + (static_cast<size_t>(o.nn) * H + o.rg * R) * W + lane;
#pragma unroll
        for (int i = 0; i < R; ++i) {
#pragma unroll
            for (int k = 0; k < V; ++k) {
                const uint32_t word = __shfl_sync(0xffffffffu, st[i][k], g);
                if (o.live) q[i * W + 32 * k] = static_cast<uint8_t>((word >> lane) & 1u);
            }
        }
    }
}

// The (V, R) instantiations a plan may name: W = 32 V cells a row, R rows a
// thread (4, or 1 where 4 do not divide the rows; 8 measured slower).
// ops/cuda_ca.py reads this list (BITS_PLANS): keep it one macro.
#define CA_BITS_PLANS(X) \
    X(8, 4) X(8, 1) X(4, 4) X(4, 1) X(2, 4) X(2, 1) X(1, 4) X(1, 1)

// grid, out: uint8 [N, H, W]; W = 32 V, R rows a thread, `threads` a block
// (a multiple of H / R and of 32: the last universes of a block past N are
// spare, computed and not stored).  steps == 0 copies.
extern "C" int ca_bits_launch(const void* grid, const void* rule, int rule_stride, void* out,
                              int N, int H, int W, int steps, int V, int R, int threads,
                              int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (N < 1 || H < 1 || R < 1 || H % R || steps < 0 || W != 32 * V)
        return static_cast<int>(cudaErrorInvalidValue);
    const int per = H / R;
    if (threads < per || threads > 256 || threads % per || threads % 32)
        return static_cast<int>(cudaErrorInvalidValue);
    if (steps == 0)
        return static_cast<int>(cudaMemcpyAsync(out, grid, static_cast<size_t>(N) * H * W,
                                                cudaMemcpyDeviceToDevice, s));
    const unsigned blocks = static_cast<unsigned>((N + threads / per - 1) / (threads / per));
    const size_t smem = regs_smem(threads, V, 1);
    const uint8_t* src = static_cast<const uint8_t*>(grid);
    const int32_t* rb = static_cast<const int32_t*>(rule);
    uint8_t* dst = static_cast<uint8_t*>(out);
#define CA_BITS_CASE(v, r)                                                                     \
    if (V == v && R == r) {                                                                    \
        const auto kernel = ca_bits_kernel<v, r>;                                              \
        err = allow_smem(kernel, smem);                                                        \
        if (err != cudaSuccess) return static_cast<int>(err);                                  \
        KERNEL_LAUNCH_THREADED(kernel, blocks, threads, smem, s, src, rb, rule_stride, dst, N, \
                               H, steps);                                                      \
        return static_cast<int>(cudaGetLastError());                                           \
    }
    CA_BITS_PLANS(CA_BITS_CASE)
#undef CA_BITS_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}

// Registers, static shared memory, spills and resident blocks a
// multiprocessor (common.cuh::kernel_occupancy) of ca_bits_kernel<V, R> for
// `threads` a block.
extern "C" int ca_bits_occupancy(int V, int R, int threads, int device, int* out) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
#define CA_BITS_OCC(v, r) \
    if (V == v && R == r)  \
        return kernel_occupancy(ca_bits_kernel<v, r>, threads, regs_smem(threads, v, 1), out);
    CA_BITS_PLANS(CA_BITS_OCC)
#undef CA_BITS_OCC
    return static_cast<int>(cudaErrorInvalidValue);
}
