// ca_step: one Life-like generation with the toggle action fused in.
//
// Replaces carle_tpu/ops/pallas_ca.py::ca_step_pallas (kernel bodies
// _step_kernel and _step_kernel_vec).
//
// out[n, i, j] = (rule[n] >> (count + 9 * alive)) & 1, where alive is the
// cell after the XOR with the action window and count its 8 torus neighbours
// (also after the XOR).  The rule is one int32 for the batch (rule_stride 0)
// or one per universe (rule_stride 1).
//
// Bound on an H100: bytes.  The function reads each cell once and writes it
// once (plus the action window), about 2.1 bytes a cell at the battery's
// shape, against a dozen integer operations a cell, so 3.35 TB/s of device
// memory is the limit.  Design: a block owns a band of rows of one universe
// and stages the band plus one wrapped halo row above and below in shared
// memory, XOR-ing the action in while it stages, so device memory sees each
// cell once per band (plus 2 halo rows in band_rows).  The action is the
// unpadded [N, AH, AW] patch read in place at the window offsets (r0, c0):
// the TPU kernel took a pre-padded full frame, which is a second full-size
// read the card does not need.
#include "common.cuh"

__global__ void ca_step_kernel(const uint8_t* __restrict__ grid,
                               const uint8_t* __restrict__ action,
                               const int32_t* __restrict__ rule, int rule_stride,
                               uint8_t* __restrict__ out, int H, int W, int AH,
                               int AW, int r0, int c0, int band_rows) {
    extern __shared__ uint8_t tile[];  // (band_rows + 2) x W
    const int n = blockIdx.y;
    const int row0 = blockIdx.x * band_rows;
    const int rows = min(band_rows, H - row0);
    const size_t plane = static_cast<size_t>(H) * W;
    const uint8_t* g = grid + n * plane;
    const uint8_t* a = action + static_cast<size_t>(n) * AH * AW;

    for (int lr = threadIdx.y; lr < rows + 2; lr += blockDim.y) {
        int r = row0 - 1 + lr;
        r = r < 0 ? r + H : (r >= H ? r - H : r);
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
    uint8_t* o = out + n * plane;
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

extern "C" int ca_step_launch(const void* grid, const void* action,
                              const void* rule, int rule_stride, void* out,
                              int N, int H, int W, int AH, int AW, int r0,
                              int c0, int band_rows, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t smem = static_cast<size_t>(band_rows + 2) * W;
    err = allow_smem(ca_step_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 block(128, 2);
    const dim3 blocks((H + band_rows - 1) / band_rows, N);
    ca_step_kernel<<<blocks, block, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(grid), static_cast<const uint8_t*>(action),
        static_cast<const int32_t*>(rule), rule_stride, static_cast<uint8_t*>(out),
        H, W, AH, AW, r0, c0, band_rows);
    return static_cast<int>(cudaGetLastError());
}
