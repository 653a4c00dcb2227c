// Transpose convolutions (k4, s2, p1) by output parity, shared by the kernels
// specialised at the package's decoder widths: the decoder loss's and the
// whole autoencoder's (dec2.cuh, ae2d.cuh) and the single decoder stage's
// (tail2.cuh).
//
// Output (y, x) uses taps ky in {(y + 1) mod 2, (y + 1) mod 2 + 2} and kx
// likewise, so an output of parity (u, v) (u = ky0, v = kx0) is four
// multiply-adds a channel over the 2 x 2 window of inputs that ends at
// (iy, ix) = ((y + 1 - ky0) / 2, (x + 1 - kx0) / 2):
//
//   m11 = in(iy, ix) tap (u, v)         m10 = in(iy, ix - 1) tap (u, v + 2)
//   m01 = in(iy - 1, ix) tap (u + 2, v) m00 = in(iy - 1, ix - 1) tap (u + 2, v + 2)
//
// in that order: net_stages.cuh::deconv_preact's (bias, then channel, ky, kx
// ascending), so a stencil's pre-activation is the generic kernels' bit for
// bit.  A block keeps each channel's taps grouped by parity as float4s in
// shared memory: one broadcast load serves a stencil.
#pragma once

#include "bit_table.cuh"

// The taps of parity (u, v) of one [4, 4] kernel w, in a stencil's order.
__device__ __forceinline__ float4 parity_taps(const float* w, int u, int v) {
    return make_float4(w[u * 4 + v], w[u * 4 + v + 2], w[(u + 2) * 4 + v], w[(u + 2) * 4 + v + 2]);
}

// Tap (ky, kx) of a kernel's parity table q (four float4s, parity u * 2 + v):
// parity (ky & 1, kx & 1), place (ky >> 1) * 2 + (kx >> 1).
__device__ __forceinline__ float parity_tap(const float4* q, int ky, int kx) {
    const float4 t = q[(ky & 1) * 2 + (kx & 1)];
    const int k = (ky >> 1) * 2 + (kx >> 1);
    return k == 0 ? t.x : k == 1 ? t.y : k == 2 ? t.z : t.w;
}

// acc plus one channel's stencil: its taps w (parity_taps) times the window.
__device__ __forceinline__ float parity_preact(float4 w, float acc, float m11, float m10,
                                               float m01, float m00) {
    acc += w.x * m11;
    acc += w.y * m10;
    acc += w.z * m01;
    acc += w.w * m00;
    return acc;
}

// A weight gradient's part from one output of parity (u, v) with cotangent
// gc: each of its taps (dw[ky * 4 + kx], a [4, 4] kernel) gains gc times the
// input the tap read.
__device__ __forceinline__ void parity_wgrad(float* dw, int u, int v, float gc, float m11,
                                             float m10, float m01, float m00) {
    dw[u * 4 + v] += gc * m11;
    dw[u * 4 + v + 2] += gc * m10;
    dw[(u + 2) * 4 + v] += gc * m01;
    dw[(u + 2) * 4 + v + 2] += gc * m00;
}

// A window of a layer in a block's shared memory: `rows` x `cols` floats a
// channel plane, local (0, 0) at global (r0, c0).
struct Win {
    float* p;
    int r0, c0, rows, cols;
    __device__ float* at(int r, int c) const { return p + (r - r0) * cols + (c - c0); }
};
