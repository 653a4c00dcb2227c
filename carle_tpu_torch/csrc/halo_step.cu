// halo_step: Life-like generations of universes whose rows are split over
// the slots of a mesh (parallel/mesh.py), each slot's rows an allocation of
// its own.
//
// Replaces carle_tpu/parallel/pallas_halo.py::
//   spatial_ca_step_pallas         (one uint8 generation; kernel _halo_kernel)
//   spatial_multi_step_pallas      (K uint8 generations; _halo_multi_kernel)
//   bit_spatial_multi_step_pallas  (K packed generations; _bit_halo_multi_kernel)
// and the fixed-rule packed path of carle_tpu/parallel/spatial.py::
// bit_spatial_multi_step(static_rules=...) (-DSTATIC_RULE=<mask>).
//
// A slot holds rows [s HL, (s + 1) HL) of every universe: [N, HL, W] uint8
// cells or [N, HL, W/32] packed words.  A generation needs one ghost row from
// each ring neighbour (slot 0's north is slot n-1: the torus), and the TPU
// kernels send those rows by remote DMA while they compute the interior.
// Here a neighbour's row is read in place, through its device pointer: a
// plain load on one card, a peer load over NVLink between cards (the mesh
// checks peer access).  The update is common.cuh's, the one the single-device
// engines run: step_word_rows on packed words (carry-save count, the rule's
// mux tree), column_sums_rows + step_cells4 on uint8 cells read 4 to a word.
// Columns stay inside a slot, so they wrap as in bit_multi_step.cu.
//
// Double buffers: generation t reads one buffer of every slot (its own rows
// and one row of each neighbour) and writes the other, so no slot overwrites
// a row a neighbour still reads.  The launch boundary on a device's stream is
// the barrier between generations; between devices the caller records an
// event on each device's stream and waits on its neighbours'
// (parallel/cuda_halo.py).  One launch covers every slot on a device, with
// the slots' own, north and south row pointers in a table passed by value:
// one launch per device per generation, not per slot.
//
// Bound on an H100: the packed update is ~45 integer operations a word a
// generation (chip_smoke.py counts them) against 8 bytes moved a word: the
// integer ALUs, ~5.6 us a generation at 8192^2.  The uint8 update moves 2
// bytes a cell (~19 operations a 4-cell word): bytes, ~40 us at 8192^2.
// Design: one thread a word through device memory, its nine loads served by
// L1 and L2; the launch count, not the arithmetic, sets the time of a short
// burst.  Keeping slots resident across generations (cooperative grid sync)
// is a later design.
#include "common.cuh"

#ifdef STATIC_RULE
static_assert(STATIC_RULE >= 0 && STATIC_RULE < (1 << 18), "an 18-bit rule mask");
#endif

constexpr int MAX_SLOTS = 64;  // slots a launch covers (the table is a kernel argument)

struct HaloTable {
    const uint32_t* src[MAX_SLOTS];    // the slot's words this generation
    uint32_t* dst[MAX_SLOTS];          // and the next
    const uint32_t* north[MAX_SLOTS];  // row HL-1 of universe 0 of the slot above
    const uint32_t* south[MAX_SLOTS];  // row 0 of universe 0 of the slot below
};

// Packed words [N, HL, NW] a slot; grid (word blocks, slots, universes).
template <int RULE>
__global__ void bit_halo_kernel(HaloTable t, const int32_t* __restrict__ rule,
                                int rule_stride, int HL, int NW) {
    const int s = blockIdx.y, n = blockIdx.z;
    const size_t plane = static_cast<size_t>(HL) * NW;
    const uint32_t* src = t.src[s] + n * plane;
    const uint32_t* north = t.north[s] + n * plane;
    const uint32_t* south = t.south[s] + n * plane;
    uint32_t* dst = t.dst[s] + n * plane;
    const Leaves leaves = make_leaves(rule_of<RULE>(rule, rule_stride, n));
    for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < plane;
         i += static_cast<size_t>(gridDim.x) * blockDim.x) {
        const int r = static_cast<int>(i / NW);
        const int k = static_cast<int>(i - static_cast<size_t>(r) * NW);
        const uint32_t* mid = src + static_cast<size_t>(r) * NW;
        const uint32_t* up = r == 0 ? north : mid - NW;
        const uint32_t* dn = r == HL - 1 ? south : mid + NW;
        dst[i] = step_word_rows(up, mid, dn, NW, k, leaves);
    }
}

// uint8 cells [N, HL, W] a slot, read as QW = W/4 words of 4 cells.
__global__ void halo_u8_kernel(HaloTable t, const int32_t* __restrict__ rule,
                               int rule_stride, int HL, int QW) {
    const int s = blockIdx.y, n = blockIdx.z;
    const size_t plane = static_cast<size_t>(HL) * QW;
    const uint32_t* src = t.src[s] + n * plane;
    const uint32_t* north = t.north[s] + n * plane;
    const uint32_t* south = t.south[s] + n * plane;
    uint32_t* dst = t.dst[s] + n * plane;
    const int rb = rule[static_cast<size_t>(n) * rule_stride];
    for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < plane;
         i += static_cast<size_t>(gridDim.x) * blockDim.x) {
        const int r = static_cast<int>(i / QW);
        const int q = static_cast<int>(i - static_cast<size_t>(r) * QW);
        const uint32_t* mid = src + static_cast<size_t>(r) * QW;
        const uint32_t* up = r == 0 ? north : mid - QW;
        const uint32_t* dn = r == HL - 1 ? south : mid + QW;
        const int qw = q == 0 ? QW - 1 : q - 1, qe = q == QW - 1 ? 0 : q + 1;
        uint32_t centre, unused;
        const uint32_t sw = column_sums_rows(up, mid, dn, qw, unused);
        const uint32_t sc = column_sums_rows(up, mid, dn, q, centre);
        const uint32_t se = column_sums_rows(up, mid, dn, qe, unused);
        dst[i] = step_cells4(sw, sc, se, centre, rb);
    }
}

// Generations [t0, t1) of `steps` on the S slots `slots` (of the n in the
// ring) that live on `device`.  in, scratch and out hold every slot's pointer
// (host arrays of n): generation t reads `in` (t = 0) or the buffer the last
// generation wrote, and writes scratch or out so that the last lands in out.
// kind: KIND_U8 (W cells a row, W % 4 == 0) or KIND_U32 (W words a row).  The
// rule is one int32 (rule_stride 0) or one a universe (1), on `device`; a
// library built with -DSTATIC_RULE fixes the packed rule and ignores it.
extern "C" int halo_step_launch(int kind, const void* const* in, void* const* scratch,
                                void* const* out, const int* slots, int S, int n,
                                const void* rule, int rule_stride, int N, int HL, int W,
                                int steps, int t0, int t1, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (S < 1 || S > MAX_SLOTS || n < S || N < 1 || N > 65535 || HL < 1 || t0 < 0 ||
        t1 > steps || (kind != KIND_U8 && kind != KIND_U32) || (kind == KIND_U8 && W % 4))
        return static_cast<int>(cudaErrorInvalidValue);
    const int NW = kind == KIND_U8 ? W / 4 : W;  // 32-bit words a row
    const size_t plane = static_cast<size_t>(HL) * NW;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int32_t* rb = static_cast<const int32_t*>(rule);
    auto buffer = [&](int t, int j) -> uint32_t* {  // what generation t writes in slot j
        return static_cast<uint32_t*>(((steps - t) % 2) ? out[j] : scratch[j]);
    };
    auto source = [&](int t, int j) -> const uint32_t* {  // what it reads
        return t == 0 ? static_cast<const uint32_t*>(in[j]) : buffer(t - 1, j);
    };
    const unsigned blocks = static_cast<unsigned>((plane + 255) / 256);
    for (int t = t0; t < t1; ++t) {
        HaloTable table;
        for (int i = 0; i < S; ++i) {
            const int j = slots[i];
            if (j < 0 || j >= n) return static_cast<int>(cudaErrorInvalidValue);
            table.src[i] = source(t, j);
            table.dst[i] = buffer(t, j);
            table.north[i] = source(t, (j + n - 1) % n) + (plane - NW);
            table.south[i] = source(t, (j + 1) % n);
        }
        const dim3 grid(blocks, S, N);
        if (kind == KIND_U8) {
            KERNEL_LAUNCH(halo_u8_kernel, grid, 256, 0, st, table, rb, rule_stride, HL, NW);
        } else {
#ifdef STATIC_RULE
            KERNEL_LAUNCH(bit_halo_kernel<STATIC_RULE>, grid, 256, 0, st, table, rb, rule_stride,
                          HL, NW);
#else
            KERNEL_LAUNCH(bit_halo_kernel<-1>, grid, 256, 0, st, table, rb, rule_stride, HL, NW);
#endif
        }
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(cudaSuccess);
}

// Let `device` read `peer`'s memory (a mesh whose slots span several cards).
extern "C" int halo_enable_peer(int device, int peer) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();  // clear the error it leaves behind
        return static_cast<int>(cudaSuccess);
    }
    return static_cast<int>(err);
}
