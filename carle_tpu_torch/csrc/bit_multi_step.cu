// bit_multi_step: K Life-like generations on bit-packed universes.
//
// Replaces carle_tpu/ops/pallas_bitpack.py::bit_multi_step_pallas (kernel
// bodies _multi_step_kernel and _multi_step_kernel_vec, step
// _bit_step_block_vd).
//
// Layout as carle_tpu/ops/bitpack.py: a universe is [H, NW] uint32 words,
// row-major, and bit j of word k is the cell in column 32k + j.  One
// generation per word: the left/right neighbour words come from funnel
// shifts across the word boundary (torus over the word axis), the Moore
// count is built bit-sliced (planes n0..n3) by a carry-save adder tree, and
// the 18-bit rule is applied as DATA by a 5-level multiplexer tree whose
// leaves are all-ones/all-zeros words made from the rule bits, so every
// ruleset, scalar or per universe, runs the same code.
//
// Bound on an H100: operations.  About 110 bit operations a word a
// generation (carle_tpu/ops/bitpack.py:11) against 8 bytes moved a word per
// launch, so the integer ALUs are the limit once a universe stays on chip.
// Design: the resident kernel gives each universe one block that holds it in
// shared memory for all K generations (ping-pong between two copies, 16 KB
// at 256x256, 64 KB at 512x512), the counterpart of the TPU kernel keeping
// the grid in VMEM, so device memory is read once and written once a launch.
// Universes whose two copies do not fit a block's 227 KB take the fallback:
// one launch per generation that reads and writes device memory.
#include "common.cuh"

struct Leaves {
    uint32_t dead[9];   // all-ones where a dead cell with v neighbours is born
    uint32_t alive[9];  // all-ones where a live cell with v neighbours survives
};

__device__ __forceinline__ Leaves make_leaves(int rb) {
    Leaves l;
#pragma unroll
    for (int v = 0; v < 9; ++v) {
        l.dead[v] = 0u - static_cast<uint32_t>((rb >> v) & 1);
        l.alive[v] = 0u - static_cast<uint32_t>((rb >> (9 + v)) & 1);
    }
    return l;
}

__device__ __forceinline__ void csa(uint32_t a, uint32_t b, uint32_t c,
                                    uint32_t& sum, uint32_t& carry) {
    const uint32_t ab = a ^ b;
    sum = ab ^ c;
    carry = (a & b) | (ab & c);
}

__device__ __forceinline__ uint32_t mux(uint32_t a, uint32_t b, uint32_t sel) {
    return (a & ~sel) | (b & sel);
}

// The mux tree of carle_tpu/ops/bitpack.py::_rule_mux: select 9 -> 5 -> 3 ->
// 2 -> 1 leaves by n0, n1, n2, n3 (odd tails only reachable with sel = 0).
__device__ __forceinline__ uint32_t fold(const uint32_t* l, uint32_t n0,
                                         uint32_t n1, uint32_t n2, uint32_t n3) {
    const uint32_t p0 = mux(l[0], l[1], n0), p1 = mux(l[2], l[3], n0);
    const uint32_t p2 = mux(l[4], l[5], n0), p3 = mux(l[6], l[7], n0);
    const uint32_t p4 = l[8] & ~n0;
    const uint32_t q0 = mux(p0, p1, n1), q1 = mux(p2, p3, n1), q2 = p4 & ~n1;
    const uint32_t r0 = mux(q0, q1, n2), r1 = q2 & ~n2;
    return mux(r0, r1, n3);
}

// Horizontal pair planes of one row: weight-1 (left ^ right) and weight-2
// (left & right) of each cell's west and east neighbours.
__device__ __forceinline__ void pair_planes(uint32_t west, uint32_t g,
                                            uint32_t east, uint32_t& a,
                                            uint32_t& b) {
    const uint32_t left = __funnelshift_l(west, g, 1);   // (g << 1) | (west >> 31)
    const uint32_t right = __funnelshift_r(g, east, 1);  // (g >> 1) | (east << 31)
    a = left ^ right;
    b = left & right;
}

// Next state of word k of row r of a universe at `src` ([H, NW], row-major).
__device__ __forceinline__ uint32_t step_word(const uint32_t* src, int H,
                                              int NW, int r, int k,
                                              const Leaves& leaves) {
    const int ru = r == 0 ? H - 1 : r - 1;
    const int rd = r == H - 1 ? 0 : r + 1;
    const int kw = k == 0 ? NW - 1 : k - 1;
    const int ke = k == NW - 1 ? 0 : k + 1;
    const uint32_t* up = src + ru * NW;
    const uint32_t* mid = src + r * NW;
    const uint32_t* dn = src + rd * NW;
    const uint32_t g = mid[k], m_t = up[k], m_b = dn[k];
    uint32_t a_t, b_t, a, b, a_b, b_b;
    pair_planes(up[kw], m_t, up[ke], a_t, b_t);
    pair_planes(mid[kw], g, mid[ke], a, b);
    pair_planes(dn[kw], m_b, dn[ke], a_b, b_b);
    uint32_t s1, c1, s2, c2, s3, c3, s4, c4;
    csa(a_t, a, a_b, s1, c1);   // weight-1 triples
    csa(m_t, m_b, s1, s2, c2);  // + the two vertical cells
    csa(b_t, b, b_b, s3, c3);   // weight-2 triples
    csa(s3, c1, c2, s4, c4);
    const uint32_t n0 = s2, n1 = s4, n2 = c3 ^ c4, n3 = c3 & c4;
    return (fold(leaves.dead, n0, n1, n2, n3) & ~g) |
           (fold(leaves.alive, n0, n1, n2, n3) & g);
}

// One block per universe, resident in shared memory for all `steps`.
__global__ void bit_multi_step_resident(const uint32_t* __restrict__ in,
                                        const int32_t* __restrict__ rule,
                                        int rule_stride,
                                        uint32_t* __restrict__ out, int H,
                                        int NW, int steps) {
    extern __shared__ uint32_t buf[];  // 2 x H x NW
    const int n = blockIdx.x;
    const size_t words = static_cast<size_t>(H) * NW;
    uint32_t* cur = buf;
    uint32_t* nxt = buf + words;
    const uint32_t* src = in + n * words;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthreads = blockDim.x * blockDim.y;
    for (size_t i = tid; i < words; i += nthreads) cur[i] = src[i];
    const Leaves leaves = make_leaves(rule[static_cast<size_t>(n) * rule_stride]);
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
        for (int r = threadIdx.y; r < H; r += blockDim.y)
            for (int k = threadIdx.x; k < NW; k += blockDim.x)
                nxt[r * NW + k] = step_word(cur, H, NW, r, k, leaves);
        __syncthreads();
        uint32_t* t = cur;
        cur = nxt;
        nxt = t;
    }
    uint32_t* dst = out + n * words;
    for (size_t i = tid; i < words; i += nthreads) dst[i] = cur[i];
}

// Fallback: one generation through device memory, one thread per word.
__global__ void bit_step_global(const uint32_t* __restrict__ in,
                                const int32_t* __restrict__ rule,
                                int rule_stride, uint32_t* __restrict__ out,
                                int H, int NW) {
    const int n = blockIdx.y;
    const size_t words = static_cast<size_t>(H) * NW;
    const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= words) return;
    const int r = static_cast<int>(i / NW);
    const int k = static_cast<int>(i - static_cast<size_t>(r) * NW);
    const Leaves leaves = make_leaves(rule[static_cast<size_t>(n) * rule_stride]);
    out[n * words + i] = step_word(in + n * words, H, NW, r, k, leaves);
}

extern "C" int bit_multi_step_launch(const void* in, const void* rule,
                                     int rule_stride, void* out, void* scratch,
                                     int N, int H, int NW, int steps,
                                     int resident, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint32_t* src = static_cast<const uint32_t*>(in);
    const int32_t* rb = static_cast<const int32_t*>(rule);
    if (resident) {
        const size_t smem = 2 * static_cast<size_t>(H) * NW * sizeof(uint32_t);
        err = allow_smem(bit_multi_step_resident, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        const int bx = NW < 32 ? NW : 32;
        const dim3 block(bx, 256 / bx);
        bit_multi_step_resident<<<N, block, smem, s>>>(
            src, rb, rule_stride, static_cast<uint32_t*>(out), H, NW, steps);
        return static_cast<int>(cudaGetLastError());
    }
    const size_t words = static_cast<size_t>(H) * NW;
    if (steps == 0) {
        err = cudaMemcpyAsync(out, in, N * words * sizeof(uint32_t),
                              cudaMemcpyDeviceToDevice, s);
        return static_cast<int>(err);
    }
    // ping-pong so that the last generation lands in `out`
    uint32_t* bufs[2] = {static_cast<uint32_t*>(scratch), static_cast<uint32_t*>(out)};
    const dim3 blocks(static_cast<unsigned>((words + 255) / 256), N);
    for (int t = 0; t < steps; ++t) {
        uint32_t* dst = bufs[(steps - t) % 2];
        bit_step_global<<<blocks, 256, 0, s>>>(src, rb, rule_stride, dst, H, NW);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
        src = dst;
    }
    return static_cast<int>(cudaSuccess);
}
