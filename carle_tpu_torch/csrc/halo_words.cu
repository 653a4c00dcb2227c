// halo_words: one Life-like generation of uint8 universes whose rows are split
// over the slots of a mesh (parallel/mesh.py), with the toggle action and the
// batch-global master reset fused in: the step of the uint8 spatial env mode
// (parallel/spatial_env.py) and, without an action or a flag, the bare
// generation of parallel/spatial.py::spatial_ca_step.
//
// Replaces carle_tpu/parallel/pallas_halo.py::spatial_ca_step_pallas (kernel
// _halo_kernel) and, on the env mode's path, the action XOR and the master
// reset that carle_tpu/env.py::env_step applies around the generation (there
// GSPMD partitions them over the JAX mesh).
//
// A slot holds rows [s HL, (s + 1) HL) of every universe: [N, HL, W] uint8
// cells (W % 16 == 0, every buffer 16-byte aligned).  out[n] = 0 where the
// reset flag (a device byte, never read by the host) is set; otherwise each
// cell after the XOR with the action window (any nonzero byte of the
// [N, AH, AW] action toggles; the window's rows r0 .. r0 + AH - 1 are global
// rows of the universe of H = n HL rows) steps by the rule, one int32 for the
// batch (rule_stride 0) or one a universe (1).  Columns wrap inside a slot;
// rows wrap around the ring of slots (slot 0's north is slot n - 1): the
// torus.
//
// Bound on an H100: bytes.  Each cell is read once and written once (2 bytes
// a cell, ~40 us at 8192^2), against 37 integer operations a 32-cell word on
// packed bits (chip_smoke.py::u8_bound).  The design is ca_step_words' (row
// 1; ca_words.cuh): a block owns a band of rows of one universe of one slot
// (grid x: universes x bands, grid y: the device's slots) and stages it with
// a ghost row above and below by three 1-D bulk copies on the Tensor Memory
// Accelerator, completing on one mbarrier.  At a slot's first and last row
// the ghost row is the ring neighbour's edge row, copied in place from its
// buffer (a peer copy over NVLink when the neighbour's slot is on another
// card).  The action's bytes are loaded while the copies are in flight and
// XOR-ed into every staged row the window covers, ghost rows included (a
// ghost row is its own global row: the neighbour's rows toggle as they
// would in its own block); a band the window misses only waits.  A thread
// then walks a strip of rows down one 16-byte column (4 words of 4 cells),
// three rows' words in registers, and stores 16 bytes a row.  With the flag
// set a block writes zeros and reads nothing else.
//
// Every slot of a device in one launch (the slots' pointers in a table
// passed by value), outputs in buffers of their own, so every slot reads the
// old generation: one launch a device a step.
#include "ca_words.cuh"

constexpr int MAX_SLOTS = 64;  // slots a launch covers (the table is a kernel argument)

struct WordsTable {
    const uint8_t* src[MAX_SLOTS];    // the slot's cells this generation
    uint8_t* dst[MAX_SLOTS];          // and the next
    const uint8_t* above[MAX_SLOTS];  // the slot above (its row HL - 1: the ghost row above row 0)
    const uint8_t* below[MAX_SLOTS];  // the slot below (its row 0: the ghost row past HL - 1)
    int first[MAX_SLOTS];             // the global row of the slot's row 0
};

// Whether the window's rows [r0, r0 + AH) meet the E staged rows from global
// row g0 (-1 <= g0, g0 + E <= H + 1; the rows wrap).
__device__ __forceinline__ bool window_meets(int g0, int E, int H, int r0, int AH) {
    if (AH <= 0) return false;
#pragma unroll
    for (int k = -1; k <= 1; ++k) {
        const int lo = r0 + k * H;
        if (g0 < lo + AH && lo < g0 + E) return true;
    }
    return false;
}

__global__ void __launch_bounds__(256) halo_words_kernel(
    const __grid_constant__ WordsTable t, const uint8_t* __restrict__ action,
    const int32_t* __restrict__ rule, int rule_stride, const uint8_t* __restrict__ reset, int H,
    int HL, int W, int AH, int AW, int r0, int c0, int band_rows, int bands, int strip) {
    extern __shared__ float smem[];  // [BAR_BYTES][band_rows + 2][W] bytes
    const int s = blockIdx.y;
    const int n = blockIdx.x / bands;
    const int row0 = (blockIdx.x - n * bands) * band_rows;
    const int rows = min(band_rows, HL - row0);
    const int V = W / 16;  // 16-byte columns a row
    const int tid = threadIdx.x, nt = blockDim.x;
    const size_t plane = static_cast<size_t>(HL) * W;
    uint4* o4 = reinterpret_cast<uint4*>(t.dst[s] + n * plane) + static_cast<size_t>(row0) * V;
    const int rb = rule[static_cast<size_t>(n) * rule_stride];  // in flight with the flag
    if (reset != nullptr && *reset) {
        for (int i = tid; i < rows * V; i += nt) o4[i] = make_uint4(0, 0, 0, 0);
        return;
    }
    const uint8_t* g = t.src[s] + n * plane;
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
    uint8_t* tile = reinterpret_cast<uint8_t*>(smem) + BAR_BYTES;
    if (tid == 0) {
        const uint32_t row_bytes = static_cast<uint32_t>(W);
        const uint8_t* above = row0 == 0 ? t.above[s] + n * plane + (plane - W)
                                         : g + static_cast<size_t>(row0 - 1) * W;
        const uint8_t* below = row0 + rows == HL ? t.below[s] + n * plane
                                                 : g + static_cast<size_t>(row0 + rows) * W;
        bulk_barrier_init(bar);
        bulk_barrier_expect(bar, (rows + 2) * row_bytes);
        bulk_load(tile, above, row_bytes, bar);
        bulk_load(tile + W, g + static_cast<size_t>(row0) * W, rows * row_bytes, bar);
        bulk_load(tile + static_cast<size_t>(rows + 1) * W, below, row_bytes, bar);
    }
    __syncthreads();  // the barrier is initialised before anyone waits on it
    const int g0 = t.first[s] + row0 - 1;  // the global row of staged row 0
    if (window_meets(g0, rows + 2, H, r0, AH)) {
        const uint8_t* a = action + static_cast<size_t>(n) * AH * AW;
        const bool aligned =
            ((c0 | AW) & 15) == 0 && (reinterpret_cast<uintptr_t>(action) & 15) == 0;
        toggle_band(reinterpret_cast<uint4*>(tile), a, g0, rows + 2, V, H, AH, AW, r0, c0,
                    aligned, bar);
    } else {
        bulk_barrier_wait(bar, 0);
    }
    __syncthreads();
    step_band(reinterpret_cast<const uint32_t*>(tile), o4, rows, V, strip, rb);
}

static inline size_t words_smem(int band_rows, int W) {
    return BAR_BYTES + static_cast<size_t>(band_rows + 2) * W;
}

// One generation of the S slots `slots` (of the n in the ring) that live on
// `device`: in and out hold every slot's pointer (host arrays of n), each
// [N, HL, W] uint8 cells.  action: [N, AH, AW] bytes on `device`, its window's
// first global row and column r0, c0 (AH = AW = 0: no action); reset: a
// device byte or null.  Bands of band_rows rows a block, strips of `strip`
// rows a thread, `threads` a block.
extern "C" int halo_words_launch(const void* const* in, void* const* out, const int* slots, int S,
                                 int n, const void* action, int AH, int AW, int r0, int c0,
                                 const void* rule, int rule_stride, const void* reset, int N,
                                 int HL, int W, int band_rows, int strip, int threads,
                                 int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long H = static_cast<long long>(n) * HL;
    const int bands = band_rows >= 1 ? (HL + band_rows - 1) / band_rows : 0;
    if (S < 1 || S > MAX_SLOTS || n < S || N < 1 || HL < 1 || W < 16 || W % 16 ||
        H >= (1LL << 31) || band_rows < 1 || band_rows > HL || strip < 1 || threads < 1 ||
        threads > 256 ||
        static_cast<long long>(N) * bands >= (1LL << 31) || AH < 0 || AW < 0 ||
        (AH == 0) != (AW == 0) || (AH > 0 && action == nullptr) || r0 < 0 || r0 + AH > H ||
        c0 < 0 || c0 + AW > W)
        return static_cast<int>(cudaErrorInvalidValue);
    for (int j = 0; j < n; ++j)
        if ((reinterpret_cast<uintptr_t>(in[j]) | reinterpret_cast<uintptr_t>(out[j])) % 16)
            return static_cast<int>(cudaErrorInvalidValue);
    WordsTable table;
    for (int i = 0; i < S; ++i) {
        const int j = slots[i];
        if (j < 0 || j >= n) return static_cast<int>(cudaErrorInvalidValue);
        table.src[i] = static_cast<const uint8_t*>(in[j]);
        table.dst[i] = static_cast<uint8_t*>(out[j]);
        table.above[i] = static_cast<const uint8_t*>(in[(j + n - 1) % n]);
        table.below[i] = static_cast<const uint8_t*>(in[(j + 1) % n]);
        table.first[i] = j * HL;
    }
    const size_t smem = words_smem(band_rows, W);
    err = allow_smem(halo_words_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>(N) * bands, S);
    KERNEL_LAUNCH(halo_words_kernel, grid, threads, smem, static_cast<cudaStream_t>(stream),
                  table, static_cast<const uint8_t*>(action), static_cast<const int32_t*>(rule),
                  rule_stride, static_cast<const uint8_t*>(reset), static_cast<int>(H), HL, W,
                  AH, AW, r0, c0, band_rows, bands, strip);
    return static_cast<int>(cudaGetLastError());
}

// Registers, static shared memory, spills and resident blocks a
// multiprocessor of the kernel at bands of band_rows rows of W cells
// (common.cuh::kernel_occupancy).
extern "C" int halo_words_occupancy(int band_rows, int W, int threads, int device, int* out) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    return kernel_occupancy(halo_words_kernel, threads, words_smem(band_rows, W), out);
}
