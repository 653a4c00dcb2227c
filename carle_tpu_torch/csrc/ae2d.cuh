// The whole wrapper autoencoder at AE2D's widths, specialised at compile
// time: C1 = 4, C2 = 2, CMID = 1, COUT = 1 (carle_tpu_torch/mcl/ae.py, and
// Prediction and Surprise through init_ae_params).  Shared by ae2d_fwd.cu
// (the forward and its error, optionally saving what the backward reads) and
// ae2d_bwd.cu (the gradients).  Other widths run the generic kernels
// (ae_loss_fwd.cu, ae_loss_bwd.cu), which these replace where they apply.
//
// What bounds the generic kernels at these widths is instruction throughput,
// not arithmetic: runtime widths under MAXC register arrays, a shared-memory
// load for every multiply-add's weight, a 16-step walk with branches for each
// transpose-convolution output that uses 4 of its taps, an integer division
// an element, and (with dropout) Philox draws recomputed in every pass.  What
// this design does about each:
//
// - Widths are constants, so every stage loop unrolls exactly.  Each block
//   copies the eight weight tensors (164 floats, passed as pointers by value)
//   into shared memory once (load_weights), with the transpose convolutions'
//   taps grouped by output parity and w2 by input channel as float4s: a
//   broadcast shared load serves four multiply-adds in every stage (stage 2
//   reads one weight for a pool window's four pixels), loaded where they are
//   used (grid_walk's barrier keeps them out of registers).  Nothing is
//   shared between launches, so launches on any streams may overlap.
// - Stage 1 by table (bit_table.cuh, shared with the encoder's enc3 kernels):
//   the input is cells, 0 or 1, so conv3x3(cells) + b1 takes
//   one of 512 values a channel, one a 9-bit neighbourhood.  Each block builds
//   the 512 x 4 table with the generic kernel's sum (bias, then the taps in
//   (dy, dx) order; a tap of 0 adds an exact zero and a tap of 1 an exact
//   weight), so every stage-1 pre-activation equals the generic kernel's bit
//   for bit, and a pixel costs one 16-byte shared load indexed by bits of the
//   staged rows.  The rows are staged as bits (uint8 cells packed while
//   staging, packed words as they come): 8 times less shared memory.
// - Transpose convolutions by output parity (dec2.cuh, shared with the
//   decoder-loss kernels at the decoder's width): each thread computes a
//   2 x 2 block of outputs from one 2 x 2 or 3 x 3 input window, the four
//   parity classes as fixed stencils, each sum in the generic order (bias,
//   then channel, ky, kx ascending).
// - Loops walk (row, column) without a division an element (grid_walk).
// - With dropout, the training forward writes each element's keep bits, and
//   the backward reads them: a training step draws each bit once (philox.cuh's
//   layout is unchanged, so the bits are the generic kernels' and the twins').
//
// Sums keep the generic order inside each pre-activation, so the activations,
// and with them the pool ties, are the generic kernels'.  Tensor cores are not
// the lever: the layers' depths (K <= 36) and widths (N <= 4) would fill an mma
// tile mostly with zeros, and TF32 would lose the twins' 1e-4 agreement, so the
// kernels stay on float32 FMA.
#pragma once

#include "dec2.cuh"

// The flat weights: w1 [4,1,3,3], b1 [4], w2 [2,4,3,3], b2 [2], wt1 [2,1,4,4],
// bt1 [1], wt2 [1,1,4,4], bt2 [1], in that order (ops/cuda_head.py packs them).
constexpr int AE_W1 = 0, AE_B1 = 36, AE_W2 = 40, AE_B2 = 112, AE_WT1 = 114, AE_BT1 = 146,
              AE_WT2 = 147, AE_BT2 = 163, AE_WEIGHTS = 164;
constexpr int AE2D_THREADS = 256;   // threads a block
// Resident blocks a multiprocessor each band kernel is compiled for (its
// register cap), as many as its shared memory holds at 32 rows: the forward
// and the decoder backward three, the encoder backward two.  (512 threads a
// block and a block fewer a multiprocessor were tried on an H100 and gained
// nothing that both the inference and the training forward kept.)
constexpr int AE2D_FWD_BLOCKS = 3, AE2D_DEC_BLOCKS = 3, AE2D_ENC_BLOCKS = 2;

// The eight weight tensors, float32 and contiguous, in the order above.
struct Ae2dWeights {
    const float* t[8];
};

// The block's copy of the weights, flat as above, and w2 again as float4s,
// so that one 16-byte shared load serves four multiply-adds:
// ae2d_w2t[o * 9 + dy * 3 + dx] = channels 0..3 of w2[o, :, dy, dx]; the
// decoder's in dec2.cuh's parity tables.
__shared__ float ae2d_w[AE_WEIGHTS];
__shared__ float4 ae2d_w2t[18];

// Fills the block's copy; every thread calls it, and a __syncthreads()
// follows before the first read.
__device__ __forceinline__ void load_weights(const Ae2dWeights& wp) {
    const int off[9] = {AE_W1, AE_B1, AE_W2, AE_B2, AE_WT1, AE_BT1, AE_WT2, AE_BT2, AE_WEIGHTS};
#pragma unroll
    for (int t = 0; t < 8; ++t)
        for (int i = off[t] + static_cast<int>(threadIdx.x); i < off[t + 1];
             i += static_cast<int>(blockDim.x))
            ae2d_w[i] = wp.t[t][i - off[t]];
    for (int i = threadIdx.x; i < 18; i += blockDim.x) {
        const float* w = wp.t[2] + (i / 9) * 36 + i % 9;   // w2[o, 0, dy, dx]
        ae2d_w2t[i] = make_float4(w[0], w[9], w[18], w[27]);
    }
    dec2_load_weights(wp.t[4], wp.t[5], wp.t[6], wp.t[7]);
}

// The universe and a band's rows.  A block owns output rows [Y0, Y0 + RY)
// (RY a multiple of 4), so stage-1 and middle rows [Y0/2, Y0/2 + RY/2) and
// embedding rows [Y0/4, Y0/4 + RY/4), each cut at its layer's extent.
struct Ae2dShape {
    int H, W, RY;
};

struct Ae2dDims {
    int H, W, H1, W1, He, We, NW, RY;
    __host__ __device__ explicit Ae2dDims(const Ae2dShape& s)
        : H(s.H), W(s.W), H1(s.H / 2), W1(s.W / 2), He(s.H / 4), We(s.W / 4),
          NW((s.W + 31) / 32), RY(s.RY) {}
    // band buffers: input bit rows from Y0 - 7, stage-1 rows from Y0/2 - 3,
    // embedding rows from Y0/4 - 1, middle rows from Y0/2 - 1
    __host__ __device__ int IR() const { return RY + 14; }
    __host__ __device__ int NS() const { return NW + 2; }       // words a bit row
    __host__ __device__ int XR() const { return RY / 2 + 6; }
    __host__ __device__ int XW() const { return W1 + 2; }       // a zero column each side
    __host__ __device__ int ER() const { return RY / 4 + 2; }
    __host__ __device__ int EW() const { return We + 2; }
    __host__ __device__ int MR() const { return RY / 2 + 2; }
};

// Saved by the training forward for the backward: the embedding and the keep
// bits of the positions each block owns.  keep1 [N, H/2, W/2]: bit 4p + c is
// channel c of stage-1 pixel p = 2 py + px of that pool window; keep2 [N, H/4,
// W/4]: bit 2p + o, channel o of stage-2 pixel p of the window; keepd [N, H/2,
// W/2]: bit 2a + b the output (2i + a, 2j + b) of the last stage, bit 4 the
// middle position (i, j) itself.
struct Ae2dSaved {
    float* emb;         // [N, 2, H/4, W/4], or null
    uint16_t* keep1;    // null without dropout
    uint8_t* keep2;
    uint8_t* keepd;
};

// -- the forward's stages --------------------------------------------------------

// Stage 1 into x1s [4][XR][XW] (rows from X0 = Y0/2 - 3, columns from -1):
// maxpool2(relu(drop(table))), zero outside [H/2, W/2].  KEEP_DRAW draws the
// bits (and SAVE keeps the block's own windows'), KEEP_READ reads keep1.
template <int KEEP, bool SAVE>
__device__ __forceinline__ void ae2d_stage1(const float4* tab, const uint32_t* bits,
                                            float* x1s, const Ae2dDims& d, int Y0, int n,
                                            const DropCfg& cfg, uint16_t* __restrict__ keep1) {
    const int XR = d.XR(), XW = d.XW(), X0 = Y0 / 2 - 3, I0 = Y0 - 7, NS = d.NS();
    const int own0 = Y0 / 2, own1 = min(Y0 / 2 + d.RY / 2, d.H1);
    grid_walk(XR, XW, [&](int lr, int lc) {
        const int r = X0 + lr, c = lc - 1;
        float* out = x1s + lr * XW + lc;
        if (r < 0 || r >= d.H1 || c < 0 || c >= d.W1) {
#pragma unroll
            for (int k = 0; k < 4; ++k) out[k * XR * XW] = 0.f;
            return;
        }
        unsigned idx[4];
        window_indices<2>(bits, NS, I0, -1, r, c, idx);
        const size_t at = (static_cast<size_t>(n) * d.H1 + r) * d.W1 + c;
        unsigned keep16 = KEEP == KEEP_READ ? keep1[at] : 0u;
        float m[4] = {NEG_INF, NEG_INF, NEG_INF, NEG_INF};
#pragma unroll
        for (int p = 0; p < 4; ++p) {
            float z[4];
            channels(tab[idx[p]], z);
            if (KEEP != KEEP_NONE) {
                unsigned keep;
                if (KEEP == KEEP_DRAW) {
                    keep = drop_keep_group(cfg, STAGE_ENC1, n, 0, 2 * r + (p >> 1), 2 * c + (p & 1));
                    keep16 |= keep << (4 * p);
                } else {
                    keep = keep16 >> (4 * p);
                }
#pragma unroll
                for (int k = 0; k < 4; ++k) z[k] = drop_apply(z[k], keep, k, cfg.scale);
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) m[k] = fmaxf(m[k], z[k]);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) out[k * XR * XW] = fmaxf(m[k], 0.f);
        if (SAVE && KEEP == KEEP_DRAW && r >= own0 && r < own1)
            keep1[at] = static_cast<uint16_t>(keep16);
    });
}

// The stage-2 pre-activations of the pool window of embedding position
// (e, f) (bit_table.cuh::stage2_window; x1s holds rows from X0 and columns
// from -1).
__device__ __forceinline__ void ae2d_stage2_window(const float* x1s, int XR, int XW, int X0,
                                                   int e, int f, float acc[4][2]) {
    stage2_window<4, 2>(x1s, XR, XW, 2 * e - 1 - X0, 2 * f, ae2d_w + AE_W2, ae2d_w + AE_B2, acc);
}

// Stage 2 into es [2][ER][EW] (rows from E0 = Y0/4 - 1, columns from -1):
// maxpool2(relu(drop(pre-activation))), zero outside the embedding.  SAVE
// writes the block's own embedding rows (and, drawing, their keep bits).
// The forward's: KEEP_NONE or KEEP_DRAW (the backward routes its own way).
template <int KEEP, bool SAVE>
__device__ __forceinline__ void ae2d_stage2(const float* x1s, float* es, const Ae2dDims& d,
                                            int Y0, int n, const DropCfg& cfg,
                                            const Ae2dSaved& sv) {
    static_assert(KEEP != KEEP_READ, "the forward draws its stage-2 bits");
    const int XR = d.XR(), XW = d.XW(), X0 = Y0 / 2 - 3;
    const int ER = d.ER(), EW = d.EW(), E0 = Y0 / 4 - 1;
    const int own0 = Y0 / 4, own1 = min(Y0 / 4 + d.RY / 4, d.He);
    grid_walk(ER, d.We, [&](int lr, int f) {
        const int e = E0 + lr;
        float* out = es + lr * EW + f + 1;
        if (e < 0 || e >= d.He) {
            out[0] = out[ER * EW] = 0.f;
            return;
        }
        float acc[4][2];
        ae2d_stage2_window(x1s, XR, XW, X0, e, f, acc);
        float m[2] = {NEG_INF, NEG_INF};
        unsigned keep8 = 0;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
            if (KEEP != KEEP_NONE) {
                const unsigned keep =
                    drop_keep_group(cfg, STAGE_ENC2, n, 0, 2 * e + (p >> 1), 2 * f + (p & 1)) & 3u;
                keep8 |= keep << (2 * p);
#pragma unroll
                for (int o = 0; o < 2; ++o) acc[p][o] = drop_apply(acc[p][o], keep, o, cfg.scale);
            }
#pragma unroll
            for (int o = 0; o < 2; ++o) m[o] = fmaxf(m[o], acc[p][o]);
        }
        const float a0 = fmaxf(m[0], 0.f), a1 = fmaxf(m[1], 0.f);
        out[0] = a0;
        out[ER * EW] = a1;
        if (SAVE && e >= own0 && e < own1) {
            const size_t at = (static_cast<size_t>(n) * 2 * d.He + e) * d.We + f;
            sv.emb[at] = a0;
            sv.emb[at + static_cast<size_t>(d.He) * d.We] = a1;
            if (KEEP == KEEP_DRAW)
                sv.keep2[(static_cast<size_t>(n) * d.He + e) * d.We + f] = static_cast<uint8_t>(keep8);
        }
    });
    for (int i = threadIdx.x; i < 2 * ER; i += blockDim.x) {   // the zero columns
        es[i * EW] = 0.f;
        es[i * EW + EW - 1] = 0.f;
    }
}

// Partial sums of the block in a fixed order (warp trees, then the warps in
// turn) into *out; red needs 32 floats.  Every thread calls it.
__device__ __forceinline__ void block_sum_to(float part, float* red, float* out) {
    const int tid = threadIdx.x, nt = blockDim.x;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_down_sync(0xffffffffu, part, off);
    if ((tid & 31) == 0) red[tid >> 5] = part;
    __syncthreads();
    if (tid == 0) {
        float s = 0.f;
        for (int w = 0; w < (nt + 31) / 32; ++w) s += red[w];
        *out = s;
    }
}

// Shared memory of the forward's band (bytes): the table, x1s, es, ms, the
// reduction scratch, the bit rows and (saving with dropout) the middle keep
// bytes.
__host__ __device__ inline size_t ae2d_fwd_smem(const Ae2dShape& s, bool save_keep) {
    const Ae2dDims d(s);
    const size_t floats = 4 * 512 + 4 * static_cast<size_t>(d.XR()) * d.XW() +
                          2 * static_cast<size_t>(d.ER()) * d.EW() +
                          static_cast<size_t>(d.MR()) * d.XW() + 32;
    return 4 * floats + 4 * static_cast<size_t>(d.IR()) * d.NS() +
           (save_keep ? static_cast<size_t>(s.RY / 2) * d.W1 : 0);
}

// Shared memory of the backward's decoder band: es, ms, the output cotangent
// (rows Y0 - 1 .. Y0 + RY, a column each side), the own middle cotangent and
// block_sums' scratch for 16 values.
__host__ __device__ inline size_t ae2d_bwd_dec_smem(const Ae2dShape& s) {
    const Ae2dDims d(s);
    return 4 * (2 * static_cast<size_t>(d.ER()) * d.EW() + static_cast<size_t>(d.MR()) * d.XW() +
                static_cast<size_t>(s.RY + 2) * (s.W + 2) +
                static_cast<size_t>(s.RY / 2) * d.W1 + 32 * 16);
}

// Shared memory of the backward's encoder band: the table, x1s, the
// embedding cotangent (rows Y0/4 - 1 .. Y0/4 + RY/4), the stage-2 cotangent
// (rows Y0/2 - 2 .. Y0/2 + RY/2 + 1, a column each side), block_sums' scratch
// for 9 values, the spread table and the bit rows.
__host__ __device__ inline size_t ae2d_bwd_enc_smem(const Ae2dShape& s) {
    const Ae2dDims d(s);
    return 4 * (4 * 512 + 4 * static_cast<size_t>(d.XR()) * d.XW() +
                2 * static_cast<size_t>(d.ER()) * d.We +
                2 * static_cast<size_t>(s.RY / 2 + 4) * d.XW() + 32 * 9) +
           4 * (512 + static_cast<size_t>(d.IR()) * d.NS());
}
