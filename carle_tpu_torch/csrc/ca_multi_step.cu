// ca_multi_step: K action-free Life-like generations on uint8 universes.
//
// Replaces carle_tpu/ops/pallas_ca.py::ca_multi_step_pallas (kernel bodies
// _multi_step_kernel and _multi_step_kernel_vec).
//
// out[n, i, j] after each generation = (rule[n] >> (count + 9 * alive)) & 1,
// count the 8 torus neighbours; the rule is one int32 for the batch
// (rule_stride 0) or one per universe (rule_stride 1).
//
// Four cells a 32-bit word (SWAR): a byte is a cell, 0 or 1, so the three
// rows' bytes add without carries into column sums (0-3), and the column
// sums of the word and its two neighbours, funnel-shifted by a byte, add into
// the count including the centre (0-9).  The rule index of a cell is then
// count9 + 8 * alive (0-17), one variable shift of the mask a byte.  A thread
// walks a strip of rows down one column of words and carries the three rows'
// words of its column and both neighbour columns, so it loads three words a
// step; neighbouring threads take neighbouring columns, so a warp's loads hit
// 32 different banks of shared memory.
//
// The update (column_sums_rows, step_cells4) is common.cuh's, which the
// row-sharded halo kernels (halo_step.cu) run too.
//
// Bound on an H100: operations.  About 20 integer operations a word of four
// cells a generation (chip_smoke.py counts them) against 2 bytes moved a
// cell a launch.  Design: one block a universe holds it in shared memory for
// all K generations (ping-pong between two copies: 128 KB at 256 x 256), the
// counterpart of the TPU kernel keeping the grid in VMEM, so device memory is
// read once and written once a launch.  Universes whose two copies do not fit
// a block's 227 KB take the fallback: one launch per generation through device
// memory.  W must be a multiple of 4.
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
