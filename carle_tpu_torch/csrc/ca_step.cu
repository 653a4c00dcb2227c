// ca_step: one Life-like generation with the toggle action and the
// batch-global master reset fused in.
//
// Replaces carle_tpu/ops/pallas_ca.py::ca_step_pallas (kernel bodies
// _step_kernel and _step_kernel_vec) and the master reset that
// carle_tpu/env.py::env_step applies to its output.
//
// out[n] = 0 where the reset flag (a device byte, never read by the host) is
// set; otherwise out[n, i, j] = (rule[n] >> (count + 9 * alive)) & 1, where
// alive is the cell after the XOR with the action window (any nonzero action
// byte toggles) and count its 8 torus neighbours (also after the XOR).  The
// rule is one int32 for the batch (rule_stride 0) or one per universe
// (rule_stride 1).
//
// Bound on an H100: bytes.  The function reads each cell once and writes it
// once (plus the action window), about 2.1 bytes a cell at the paths' shapes,
// against ~5 integer operations a cell, so 3.35 TB/s of device memory is the
// limit.  Two kernels:
//
// ca_step_words (W % 16 == 0: every width a main path runs).  A block owns a
// band of rows of one universe (instances folded into blockIdx.x) and stages
// the band plus one wrapped halo row above and below in shared memory: the
// band's three contiguous runs (halo above, band, halo below) as 1-D bulk
// copies on the Tensor Memory Accelerator completing on an mbarrier, the
// action's bytes loaded while they are in flight and XOR-ed into the staged
// window.  A thread then walks a strip of rows down one 16-byte column (4
// words of 4 cells), carrying three rows' words in registers, and updates
// through common.cuh's column_sums_rows arithmetic and step_cells4, the
// update ca_multi_step.cu and halo_step.cu run; it stores 16 bytes a row,
// neighbouring threads on neighbouring addresses (ca_words.cuh, shared with
// halo_words.cu's kernel on row shards).  The rule and the flag are
// loaded beside the band, so a block waits for device memory about once.
// When the reset flag is set a block writes zeros and reads nothing else.
//
// ca_step_kernel (any width: the byte kernel).  The same band staging a byte
// a thread, one cell an output.
//
// The action is the unpadded [N, AH, AW] patch read in place at the window
// offsets (r0, c0), which may cut words anywhere: the TPU kernel took a
// pre-padded full frame, a second full-size read the card does not need.
#include "ca_words.cuh"

__global__ void __launch_bounds__(256) ca_step_words_kernel(
    const uint8_t* __restrict__ grid, const uint8_t* __restrict__ action,
    const int32_t* __restrict__ rule, int rule_stride, const uint8_t* __restrict__ reset,
    uint8_t* __restrict__ out, int H, int W, int AH, int AW, int r0, int c0, int band_rows,
    int bands, int strip) {
    extern __shared__ float smem[];  // [BAR_BYTES][band_rows + 2][W] bytes
    const int n = blockIdx.x / bands;
    const int row0 = (blockIdx.x - n * bands) * band_rows;
    const int rows = min(band_rows, H - row0);
    const int V = W / 16;  // 16-byte columns a row
    const int tid = threadIdx.x, nt = blockDim.x;
    const size_t plane = static_cast<size_t>(H) * W;
    uint4* o4 = reinterpret_cast<uint4*>(out + n * plane) + static_cast<size_t>(row0) * V;
    const int rb = rule[static_cast<size_t>(n) * rule_stride];  // in flight with the flag
    if (reset != nullptr && *reset) {
        for (int i = tid; i < rows * V; i += nt) o4[i] = make_uint4(0, 0, 0, 0);
        return;
    }
    const uint8_t* g = grid + n * plane;
    const uint8_t* a = action + static_cast<size_t>(n) * AH * AW;
    const bool aligned = ((c0 | AW) & 15) == 0 && (reinterpret_cast<uintptr_t>(action) & 15) == 0;
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
    uint8_t* tile = reinterpret_cast<uint8_t*>(smem) + BAR_BYTES;
    uint4* tile4 = reinterpret_cast<uint4*>(tile);
    if (tid == 0) {
        const uint32_t row_bytes = static_cast<uint32_t>(W);
        bulk_barrier_init(bar);
        bulk_barrier_expect(bar, (rows + 2) * row_bytes);
        bulk_load(tile, g + static_cast<size_t>(wrap_row(row0 - 1, H)) * W, row_bytes, bar);
        bulk_load(tile + W, g + static_cast<size_t>(row0) * W, rows * row_bytes, bar);
        bulk_load(tile + static_cast<size_t>(rows + 1) * W,
                  g + static_cast<size_t>(wrap_row(row0 + rows, H)) * W, row_bytes, bar);
    }
    __syncthreads();  // the barrier is initialised before anyone waits on it
    toggle_band(tile4, a, row0 - 1, rows + 2, V, H, AH, AW, r0, c0, aligned, bar);
    __syncthreads();

    step_band(reinterpret_cast<const uint32_t*>(tile), o4, rows, V, strip, rb);
}

// The byte kernel: any width, a cell a thread.
__global__ void ca_step_kernel(const uint8_t* __restrict__ grid,
                               const uint8_t* __restrict__ action,
                               const int32_t* __restrict__ rule, int rule_stride,
                               const uint8_t* __restrict__ reset, uint8_t* __restrict__ out,
                               int H, int W, int AH, int AW, int r0, int c0, int band_rows) {
    extern __shared__ float smem[];  // (band_rows + 2) x W bytes
    uint8_t* tile = reinterpret_cast<uint8_t*>(smem);
    const int n = blockIdx.y;
    const int row0 = blockIdx.x * band_rows;
    const int rows = min(band_rows, H - row0);
    const size_t plane = static_cast<size_t>(H) * W;
    uint8_t* o = out + n * plane;
    if (reset != nullptr && *reset) {
        for (int lr = threadIdx.y; lr < rows; lr += blockDim.y)
            for (int c = threadIdx.x; c < W; c += blockDim.x)
                o[static_cast<size_t>(row0 + lr) * W + c] = 0;
        return;
    }
    const uint8_t* g = grid + n * plane;
    const uint8_t* a = action + static_cast<size_t>(n) * AH * AW;

    for (int lr = threadIdx.y; lr < rows + 2; lr += blockDim.y) {
        const int r = wrap_row(row0 - 1 + lr, H);
        const int ar = r - r0;
        const bool window_row = ar >= 0 && ar < AH;
        for (int c = threadIdx.x; c < W; c += blockDim.x) {
            uint8_t v = g[static_cast<size_t>(r) * W + c];
            const int ac = c - c0;
            if (window_row && ac >= 0 && ac < AW)
                v ^= static_cast<uint8_t>(a[static_cast<size_t>(ar) * AW + ac] != 0);
            tile[lr * W + c] = v;
        }
    }
    __syncthreads();

    const int rb = rule[static_cast<size_t>(n) * rule_stride];
    for (int lr = threadIdx.y; lr < rows; lr += blockDim.y) {
        const uint8_t* up = tile + lr * W;
        const uint8_t* mid = up + W;
        const uint8_t* dn = mid + W;
        for (int c = threadIdx.x; c < W; c += blockDim.x) {
            const int cl = c == 0 ? W - 1 : c - 1;
            const int cr = c == W - 1 ? 0 : c + 1;
            const int count = up[cl] + up[c] + up[cr] + mid[cl] + mid[cr] +
                              dn[cl] + dn[c] + dn[cr];
            o[static_cast<size_t>(row0 + lr) * W + c] =
                static_cast<uint8_t>((rb >> (count + 9 * mid[c])) & 1);
        }
    }
}

// grid, out: uint8 [N, H, W] (W % 16 == 0, 16-byte aligned); action uint8
// [N, AH, AW]; reset a device byte or null.  Blocks of `threads` threads own
// band_rows rows each, a thread `strip` rows of a 16-byte column.
extern "C" int ca_step_words_launch(const void* grid, const void* action, const void* rule,
                                    int rule_stride, const void* reset, void* out, int N, int H,
                                    int W, int AH, int AW, int r0, int c0, int band_rows,
                                    int strip, int threads, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (W % 16 || band_rows < 1 || strip < 1 || threads < 1 || threads > 256)
        return static_cast<int>(cudaErrorInvalidValue);
    const int bands = (H + band_rows - 1) / band_rows;
    const size_t smem = BAR_BYTES + static_cast<size_t>(band_rows + 2) * W;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* g = static_cast<const uint8_t*>(grid);
    const auto* a = static_cast<const uint8_t*>(action);
    const auto* rb = static_cast<const int32_t*>(rule);
    const auto* rs = static_cast<const uint8_t*>(reset);
    auto* o = static_cast<uint8_t*>(out);
    const unsigned blocks = static_cast<unsigned>(N) * bands;
    err = allow_smem(ca_step_words_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    KERNEL_LAUNCH(ca_step_words_kernel, blocks, threads, smem, s, g, a, rb, rule_stride, rs, o,
                  H, W, AH, AW, r0, c0, band_rows, bands, strip);
    return static_cast<int>(cudaGetLastError());
}

// Registers, static shared memory, spills and resident blocks a
// multiprocessor of the word kernel (common.cuh::kernel_occupancy).
extern "C" int ca_step_words_occupancy(int threads, long long smem, int device, int* out) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    return kernel_occupancy(ca_step_words_kernel, threads, static_cast<size_t>(smem), out);
}

extern "C" int ca_step_launch(const void* grid, const void* action,
                              const void* rule, int rule_stride, const void* reset, void* out,
                              int N, int H, int W, int AH, int AW, int r0,
                              int c0, int band_rows, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t smem = static_cast<size_t>(band_rows + 2) * W;
    err = allow_smem(ca_step_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 block(128, 2);
    const dim3 blocks((H + band_rows - 1) / band_rows, N);
    KERNEL_LAUNCH(ca_step_kernel, blocks, block, smem, static_cast<cudaStream_t>(stream),
                  static_cast<const uint8_t*>(grid), static_cast<const uint8_t*>(action),
                  static_cast<const int32_t*>(rule), rule_stride,
                  static_cast<const uint8_t*>(reset), static_cast<uint8_t*>(out), H, W, AH, AW,
                  r0, c0, band_rows);
    return static_cast<int>(cudaGetLastError());
}
