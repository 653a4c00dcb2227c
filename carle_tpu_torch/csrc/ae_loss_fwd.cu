// ae_loss_fwd: the whole wrapper autoencoder and its error in one kernel.
//
// Replaces carle_tpu/ops/pallas_head.py::make_fused_ae_loss's forward kernel
// _ae_fwd_kernel (inference: dropout off, all-ones row mask).
//
//   x1  = maxpool2(relu(conv3x3(src, w1) + b1))            [C1,   H/2, W/2]
//   emb = maxpool2(relu(conv3x3(x1, w2) + b2))             [C2,   H/4, W/4]
//   mid = relu(conv_transpose(emb, wt1, k4 s2 p1) + bt1)   [CMID, H/2, W/2]
//   y   = sigmoid(conv_transpose(mid, wt2, k4 s2 p1) + bt2)[COUT, H,   W]
//   err[n] = sum over (COUT, H, W) of (obs - y)^2
//
// Transpose convolutions in torch's layout (weights [Cin, Cout, 4, 4]):
// out[o, y, x] = b[o] + sum_c,ky,kx w[c, o, ky, kx] in[c, iy, ix] with
// y = 2 iy - 1 + ky, so each output reads 2 x 2 inputs a channel.  Sums run
// bias first, then (channel, ky, kx), as the TPU kernel's _deconv_block.
//
// Bound on an H100: operations.  Per cell of the universe the net does about
// 9 C1 + (9 C1 C2 + 4 C2 CMID) / 4 + 4 CMID COUT multiply-adds on float32
// (48 at the AE2D widths) against 2 bytes read (src and obs), far above the
// card's 20 flops a byte balance point for float32.  Design: a block owns a
// band of RY output rows of one universe and works back through the net: it
// stages the input rows the band needs in shared memory, computes the
// stage-1 band (RY/2 + 6 rows), the embedding band (RY/4 + 2 rows) and the
// decoder's middle band (RY/2 + 2 rows) into shared memory, each with the
// zero padding of the layer outside the universe, and then the
// reconstruction and its squared error.  No activation reaches device
// memory: each block writes one partial sum, and a second launch adds a
// universe's partials in a fixed order, so the result does not change from
// run to run.
#include "common.cuh"

constexpr int MAXC = 8;  // channel bound for the register arrays
#define NEG_INF __int_as_float(static_cast<int>(0xff800000u))

struct AEShape {
    int H, W, C1, C2, CMID, COUT, RY;
};

__global__ void ae_loss_fwd_kernel(
    const uint8_t* __restrict__ src, const uint8_t* __restrict__ obs,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ wt1, const float* __restrict__ bt1,
    const float* __restrict__ wt2, const float* __restrict__ bt2,
    float* __restrict__ partials, AEShape sh) {
    const int H = sh.H, W = sh.W, C1 = sh.C1, C2 = sh.C2, CMID = sh.CMID,
              COUT = sh.COUT, RY = sh.RY;
    const int H1 = H / 2, W1 = W / 2, He = H / 4, We = W / 4;
    const int n = blockIdx.y;
    const int band = blockIdx.x;
    const int Y0 = band * RY;
    const int IR = RY + 14, I0 = Y0 - 7, IW = W + 2;       // input rows
    const int XR = RY / 2 + 6, X0 = Y0 / 2 - 3, XW = W1 + 2;  // stage-1 rows
    const int ER = RY / 4 + 2, E0 = Y0 / 4 - 1;            // embedding rows
    const int MR = RY / 2 + 2, M0 = Y0 / 2 - 1;            // decoder middle rows

    extern __shared__ float smem[];
    float* w1s = smem;
    float* b1s = w1s + C1 * 9;
    float* w2s = b1s + C1;
    float* b2s = w2s + C2 * C1 * 9;
    float* wt1s = b2s + C2;
    float* bt1s = wt1s + C2 * CMID * 16;
    float* wt2s = bt1s + CMID;
    float* bt2s = wt2s + CMID * COUT * 16;
    float* x1s = bt2s + COUT;             // C1 x XR x XW
    float* es = x1s + C1 * XR * XW;       // C2 x ER x We
    float* ms = es + C2 * ER * We;        // CMID x MR x W1
    float* red = ms + CMID * MR * W1;     // 32
    uint8_t* xs = reinterpret_cast<uint8_t*>(red + 32);  // IR x IW

    const int tid = threadIdx.x, nt = blockDim.x;
    for (int i = tid; i < C1 * 9; i += nt) w1s[i] = w1[i];
    for (int i = tid; i < C1; i += nt) b1s[i] = b1[i];
    for (int i = tid; i < C2 * C1 * 9; i += nt) w2s[i] = w2[i];
    for (int i = tid; i < C2; i += nt) b2s[i] = b2[i];
    for (int i = tid; i < C2 * CMID * 16; i += nt) wt1s[i] = wt1[i];
    for (int i = tid; i < CMID; i += nt) bt1s[i] = bt1[i];
    for (int i = tid; i < CMID * COUT * 16; i += nt) wt2s[i] = wt2[i];
    for (int i = tid; i < COUT; i += nt) bt2s[i] = bt2[i];
    const uint8_t* xn = src + static_cast<size_t>(n) * H * W;
    for (int i = tid; i < IR * IW; i += nt) {
        const int lr = i / IW, lc = i - lr * IW;
        const int r = I0 + lr, c = lc - 1;
        xs[i] = (r >= 0 && r < H && c >= 0 && c < W) ? xn[static_cast<size_t>(r) * W + c] : 0;
    }
    __syncthreads();

    // encoder stage 1 -> x1s (zero outside the universe: stage 2's padding)
    for (int i = tid; i < XR * XW; i += nt) {
        const int lr = i / XW, lc = i - lr * XW;
        const int gr = X0 + lr, gc = lc - 1;
        const bool inside = gr >= 0 && gr < H1 && gc >= 0 && gc < W1;
        float m[MAXC];
#pragma unroll
        for (int c = 0; c < MAXC; ++c) m[c] = NEG_INF;
        if (inside) {
            for (int py = 0; py < 2; ++py)
                for (int px = 0; px < 2; ++px) {
                    const int sr = gr * 2 + py - I0, sc = gc * 2 + px + 1;
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

    // encoder stage 2 -> es (zero outside the universe: no decoder input)
    for (int i = tid; i < ER * We; i += nt) {
        const int lr = i / We, ec = i - lr * We;
        const int gr = E0 + lr;
        const bool inside = gr >= 0 && gr < He;
        float m[MAXC];
#pragma unroll
        for (int o = 0; o < MAXC; ++o) m[o] = NEG_INF;
        if (inside) {
            for (int py = 0; py < 2; ++py)
                for (int px = 0; px < 2; ++px) {
                    const int sr = gr * 2 + py - X0, sc = ec * 2 + px + 1;
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
        }
#pragma unroll
        for (int o = 0; o < MAXC; ++o)
            if (o < C2) es[(o * ER + lr) * We + ec] = inside ? fmaxf(m[o], 0.f) : 0.f;
    }
    __syncthreads();

    // decoder stage 1 (transpose conv + relu) -> ms (zero outside the universe)
    for (int i = tid; i < MR * W1; i += nt) {
        const int lr = i / W1, xm = i - lr * W1;
        const int gm = M0 + lr;
        const bool inside = gm >= 0 && gm < H1;
        float acc[MAXC];
#pragma unroll
        for (int o = 0; o < MAXC; ++o) acc[o] = o < CMID ? bt1s[o] : 0.f;
        if (inside) {
            for (int c = 0; c < C2; ++c)
                for (int ky = 0; ky < 4; ++ky) {
                    const int ty = gm + 1 - ky;
                    if (ty & 1) continue;
                    const int ey = (ty >> 1) - E0;  // local embedding row
                    for (int kx = 0; kx < 4; ++kx) {
                        const int tx = xm + 1 - kx;
                        if (tx & 1) continue;
                        const int ex = tx >> 1;
                        if (ex < 0 || ex >= We) continue;
                        const float v = es[(c * ER + ey) * We + ex];
#pragma unroll
                        for (int o = 0; o < MAXC; ++o)
                            if (o < CMID) acc[o] += wt1s[((c * CMID + o) * 4 + ky) * 4 + kx] * v;
                    }
                }
        }
#pragma unroll
        for (int o = 0; o < MAXC; ++o)
            if (o < CMID) ms[(o * MR + lr) * W1 + xm] = inside ? fmaxf(acc[o], 0.f) : 0.f;
    }
    __syncthreads();

    // decoder stage 2 (transpose conv + sigmoid) and the squared error
    const uint8_t* on = obs + static_cast<size_t>(n) * COUT * H * W;
    float part = 0.f;
    for (int i = tid; i < RY * W; i += nt) {
        const int lr = i / W, xo = i - lr * W;
        const int gy = Y0 + lr;
        if (gy >= H) continue;
        float acc[MAXC];
#pragma unroll
        for (int o = 0; o < MAXC; ++o) acc[o] = o < COUT ? bt2s[o] : 0.f;
        for (int c = 0; c < CMID; ++c)
            for (int ky = 0; ky < 4; ++ky) {
                const int ty = gy + 1 - ky;
                if (ty & 1) continue;
                const int my = (ty >> 1) - M0;  // local middle row
                for (int kx = 0; kx < 4; ++kx) {
                    const int tx = xo + 1 - kx;
                    if (tx & 1) continue;
                    const int mx = tx >> 1;
                    if (mx < 0 || mx >= W1) continue;
                    const float v = ms[(c * MR + my) * W1 + mx];
#pragma unroll
                    for (int o = 0; o < MAXC; ++o)
                        if (o < COUT) acc[o] += wt2s[((c * COUT + o) * 4 + ky) * 4 + kx] * v;
                }
            }
#pragma unroll
        for (int o = 0; o < MAXC; ++o) {
            if (o < COUT) {
                const float y = 1.f / (1.f + expf(-acc[o]));
                const float d = static_cast<float>(on[(static_cast<size_t>(o) * H + gy) * W + xo]) - y;
                part += d * d;
            }
        }
    }

    // block sum in a fixed order: warp trees, then the warps in turn
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_down_sync(0xffffffffu, part, off);
    if ((tid & 31) == 0) red[tid >> 5] = part;
    __syncthreads();
    if (tid == 0) {
        float s = 0.f;
        for (int w = 0; w < (nt + 31) / 32; ++w) s += red[w];
        partials[static_cast<size_t>(n) * gridDim.x + band] = s;
    }
}

__global__ void ae_loss_reduce(const float* __restrict__ partials, int bands,
                               float* __restrict__ err, int N) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    float s = 0.f;
    for (int b = 0; b < bands; ++b) s += partials[static_cast<size_t>(n) * bands + b];
    err[n] = s;
}

// smem must equal the layout above (ops/cuda_head.py::_ae_smem); partials is
// scratch of N x bands floats, bands = ceil(H / RY).
extern "C" int ae_loss_fwd_launch(const void* src, const void* obs, const void* w1,
                                  const void* b1, const void* w2, const void* b2,
                                  const void* wt1, const void* bt1, const void* wt2,
                                  const void* bt2, void* partials, void* err, int N,
                                  int H, int W, int C1, int C2, int CMID, int COUT,
                                  int RY, long long smem, int device, void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (C1 > MAXC || C2 > MAXC || CMID > MAXC || COUT > MAXC || RY % 4)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t bytes = static_cast<size_t>(smem);
    e = allow_smem(ae_loss_fwd_kernel, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int bands = (H + RY - 1) / RY;
    const AEShape sh{H, W, C1, C2, CMID, COUT, RY};
    ae_loss_fwd_kernel<<<dim3(bands, N), 256, bytes, s>>>(
        static_cast<const uint8_t*>(src), static_cast<const uint8_t*>(obs),
        static_cast<const float*>(w1), static_cast<const float*>(b1),
        static_cast<const float*>(w2), static_cast<const float*>(b2),
        static_cast<const float*>(wt1), static_cast<const float*>(bt1),
        static_cast<const float*>(wt2), static_cast<const float*>(bt2),
        static_cast<float*>(partials), sh);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ae_loss_reduce<<<(N + 127) / 128, 128, 0, s>>>(static_cast<const float*>(partials),
                                                   bands, static_cast<float*>(err), N);
    return static_cast<int>(cudaGetLastError());
}
