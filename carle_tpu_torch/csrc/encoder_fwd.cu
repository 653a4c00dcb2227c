// encoder_fwd: both conv stages of a wrapper-net encoder in one kernel.
//
// Replaces carle_tpu/ops/pallas_head.py::make_fused_encoder's forward kernel
// _enc_fwd_kernel (inference: dropout off, all-ones row mask).
//
//   x1  = maxpool_p1(relu(conv3x3(x, w1) + b1))      [C1, H/p1, W/p1]
//   out = maxpool_p2(relu(conv3x3(x1, w2) + b2))     [C2, H/(p1 p2), W/(p1 p2)]
//
// with zero padding 1 for both convolutions; x is the uint8 universe (one
// input channel).  relu and max commute, so each pooled value is
// relu(max over the window of the pre-activation).  Each pre-activation sums
// bias first, then the taps in (channel, dy, dx) order, as the TPU kernel's
// _conv_block does.
//
// Bound on an H100: operations.  Stage 1 does 9 C1 multiply-adds a cell on
// float32 (no tensor cores: the channels are 1 to 4 wide) against one byte
// read a cell, so the card's 67 TFLOP/s float32 rate is the limit, above
// the bytes.  Design: a block owns a band of R2 output rows of one universe.
// It stages the input rows that band needs (with a zero halo) in shared
// memory as bytes, computes the pooled stage-1 activation of the band plus
// one zero-padded halo row above and below into shared memory, then stage 2
// from there; only the pooled output is written, so the stage-1 activation
// never reaches device memory.  The halo rows are computed twice, by the
// two blocks that share them.
#include "common.cuh"

constexpr int MAXC = 8;  // channel bound for the register arrays
#define NEG_INF __int_as_float(static_cast<int>(0xff800000u))

template <int P1, int P2>
__global__ void encoder_fwd_kernel(const uint8_t* __restrict__ x,
                                   const float* __restrict__ w1,
                                   const float* __restrict__ b1,
                                   const float* __restrict__ w2,
                                   const float* __restrict__ b2,
                                   float* __restrict__ out, int H, int W, int C1,
                                   int C2, int R2) {
    const int H1 = H / P1, W1 = W / P1;
    const int Ho = H1 / P2, Wo = W1 / P2;
    const int n = blockIdx.y;
    const int o0 = blockIdx.x * R2;        // first output row of the band
    const int xr0 = o0 * P2 - 1;           // first stage-1 row held
    const int XR = R2 * P2 + 2;            // stage-1 rows held
    const int ir0 = xr0 * P1 - 1;          // first input row held
    const int IR = XR * P1 + 2;            // input rows held
    const int XW = W1 + 2, IW = W + 2;     // widths with a zero column each side

    extern __shared__ float smem[];
    float* w1s = smem;                     // C1 * 9
    float* b1s = w1s + C1 * 9;             // C1
    float* w2s = b1s + C1;                 // C2 * C1 * 9
    float* b2s = w2s + C2 * C1 * 9;        // C2
    float* x1s = b2s + C2;                 // C1 x XR x XW
    uint8_t* xs = reinterpret_cast<uint8_t*>(x1s + C1 * XR * XW);  // IR x IW

    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    for (int i = tid; i < C1 * 9; i += nt) w1s[i] = w1[i];
    for (int i = tid; i < C1; i += nt) b1s[i] = b1[i];
    for (int i = tid; i < C2 * C1 * 9; i += nt) w2s[i] = w2[i];
    for (int i = tid; i < C2; i += nt) b2s[i] = b2[i];
    const uint8_t* xn = x + static_cast<size_t>(n) * H * W;
    for (int i = tid; i < IR * IW; i += nt) {
        const int lr = i / IW, lc = i - lr * IW;
        const int r = ir0 + lr, c = lc - 1;
        xs[i] = (r >= 0 && r < H && c >= 0 && c < W)
                    ? xn[static_cast<size_t>(r) * W + c]
                    : 0;
    }
    __syncthreads();

    // stage 1: pooled activation of XR rows, zero outside the universe
    for (int i = tid; i < XR * XW; i += nt) {
        const int lr = i / XW, lc = i - lr * XW;
        const int gr = xr0 + lr, gc = lc - 1;
        float m[MAXC];
#pragma unroll
        for (int c = 0; c < MAXC; ++c) m[c] = NEG_INF;
        const bool inside = gr >= 0 && gr < H1 && gc >= 0 && gc < W1;
        if (inside) {
            for (int py = 0; py < P1; ++py)
                for (int px = 0; px < P1; ++px) {
                    // input pixel (gr*P1+py, gc*P1+px); its 3x3 taps in xs
                    const int sr = gr * P1 + py - ir0;  // local row of the pixel
                    const int sc = gc * P1 + px + 1;    // local col of the pixel
                    float t[9];
#pragma unroll
                    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
                        for (int dx = 0; dx < 3; ++dx)
                            t[dy * 3 + dx] = xs[(sr + dy - 1) * IW + sc + dx - 1];
#pragma unroll
                    for (int c = 0; c < MAXC; ++c) {
                        if (c < C1) {
                            float z = b1s[c];
#pragma unroll
                            for (int k = 0; k < 9; ++k) z += w1s[c * 9 + k] * t[k];
                            m[c] = fmaxf(m[c], z);
                        }
                    }
                }
        }
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
            if (c < C1) x1s[(c * XR + lr) * XW + lc] = inside ? fmaxf(m[c], 0.f) : 0.f;
    }
    __syncthreads();

    // stage 2: pooled output rows [o0, o0 + R2)
    float* on = out + static_cast<size_t>(n) * C2 * Ho * Wo;
    for (int i = tid; i < R2 * Wo; i += nt) {
        const int lr = i / Wo, oc = i - lr * Wo;
        const int orow = o0 + lr;
        if (orow >= Ho) continue;
        float m[MAXC];
#pragma unroll
        for (int o = 0; o < MAXC; ++o) m[o] = NEG_INF;
        for (int py = 0; py < P2; ++py)
            for (int px = 0; px < P2; ++px) {
                const int sr = orow * P2 + py - xr0;  // local row in x1s
                const int sc = oc * P2 + px + 1;      // local col in x1s
                float acc[MAXC];
#pragma unroll
                for (int o = 0; o < MAXC; ++o) acc[o] = o < C2 ? b2s[o] : 0.f;
                for (int c = 0; c < C1; ++c) {
                    const float* p = x1s + (c * XR + sr) * XW + sc;
                    float t[9];
#pragma unroll
                    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
                        for (int dx = 0; dx < 3; ++dx)
                            t[dy * 3 + dx] = p[(dy - 1) * XW + dx - 1];
#pragma unroll
                    for (int o = 0; o < MAXC; ++o) {
                        if (o < C2) {
                            const float* w = w2s + (o * C1 + c) * 9;
#pragma unroll
                            for (int k = 0; k < 9; ++k) acc[o] += w[k] * t[k];
                        }
                    }
                }
#pragma unroll
                for (int o = 0; o < MAXC; ++o) m[o] = fmaxf(m[o], acc[o]);
            }
#pragma unroll
        for (int o = 0; o < MAXC; ++o)
            if (o < C2)
                on[(static_cast<size_t>(o) * Ho + orow) * Wo + oc] = fmaxf(m[o], 0.f);
    }
}

template <int P1, int P2>
static int launch(const void* x, const void* w1, const void* b1, const void* w2,
                  const void* b2, void* out, int N, int H, int W, int C1, int C2,
                  int R2, size_t smem, cudaStream_t s) {
    cudaError_t err = allow_smem(encoder_fwd_kernel<P1, P2>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int Ho = H / (P1 * P2);
    const dim3 blocks((Ho + R2 - 1) / R2, N);
    encoder_fwd_kernel<P1, P2><<<blocks, 256, smem, s>>>(
        static_cast<const uint8_t*>(x), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<float*>(out), H, W, C1, C2, R2);
    return static_cast<int>(cudaGetLastError());
}

// smem must equal the layout above: floats for the weights and the stage-1
// band, then the staged input bytes (ops/cuda_head.py::_encoder_smem).
extern "C" int encoder_fwd_launch(const void* x, const void* w1, const void* b1,
                                  const void* w2, const void* b2, void* out,
                                  int N, int H, int W, int C1, int C2, int p1,
                                  int p2, int R2, long long smem, int device,
                                  void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (C1 > MAXC || C2 > MAXC) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t bytes = static_cast<size_t>(smem);
    if (p1 == 2 && p2 == 2) return launch<2, 2>(x, w1, b1, w2, b2, out, N, H, W, C1, C2, R2, bytes, s);
    if (p1 == 4 && p2 == 2) return launch<4, 2>(x, w1, b1, w2, b2, out, N, H, W, C1, C2, R2, bytes, s);
    if (p1 == 2 && p2 == 4) return launch<2, 4>(x, w1, b1, w2, b2, out, N, H, W, C1, C2, R2, bytes, s);
    if (p1 == 4 && p2 == 4) return launch<4, 4>(x, w1, b1, w2, b2, out, N, H, W, C1, C2, R2, bytes, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
