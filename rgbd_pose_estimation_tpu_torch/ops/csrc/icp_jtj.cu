// Point-to-plane normal equations of one dense-ICP Gauss-Newton step.
//
// Replaces the TPU kernels `_jtj_kernel_vpu` and `_jtj_kernel_mxu` of
// rgbd_pose_estimation_tpu/ops/icp_jtj.py (`icp_jtj_jtr`): both compute the
// same sums, so one kernel covers both. Per associated pixel, with the
// augmented Jacobian row J = [n, p x n, r, 1] and r = n . (p - q), it
// accumulates the 36 upper-triangle entries of A = sum_m w_m J_m J_m^T and
// returns the symmetric 8x8: A[:6,:6] = JtJ, A[:6,6] = Jtr, A[6,6] = sum w r^2,
// A[7,7] = sum w.
//
// The TPU kernel's (10, S, 128) lane layout, its 64-sublane tile, its
// zero-weight padding and its lane-partial accumulator are shapes of that
// machine and are not carried over: this one reads what the tracker has in
// hand, p, q, n as (M, 3) and w as (M,), any M >= 1.
//
// Bound on this card: bytes, 40 a pixel read once (12.3 MB at M = 307200,
// a few microseconds), against about 87 operations a pixel; at the sizes a
// strided track uses (a few thousand pixels) the bound is far below a launch.
// The design therefore aims only at being right and repeatable:
//  - a grid-stride loop, every thread holding its 36 partial sums in
//    registers; a warp-shuffle tree, then a fixed-order sum over the warps in
//    shared memory, gives one row of 36 per block;
//  - a second small kernel sums the blocks' rows in block order and writes the
//    symmetric 8x8. No floating-point atomics anywhere: which thread sees
//    which pixel and the order of every addition depend on M and the grid
//    alone, so two runs on the same input agree to the last bit.
// Zero-weight rows are multiplied through, not skipped: a NaN in such a row
// reaches the sums, as it does in the plain version. True f32 throughout
// (CUDA cores; multiply-add contraction is allowed).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPairs = 36;  // upper triangle of the symmetric 8x8

__global__ void __launch_bounds__(kThreads)
icp_jtj_partial_kernel(const float* __restrict__ p, const float* __restrict__ q,
                       const float* __restrict__ n, const float* __restrict__ w,
                       float* __restrict__ partials, int M) {
  float acc[kPairs];
#pragma unroll
  for (int c = 0; c < kPairs; ++c) acc[c] = 0.f;

  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < M; i += stride) {
    const size_t o = 3 * static_cast<size_t>(i);
    const float px = p[o], py = p[o + 1], pz = p[o + 2];
    const float qx = q[o], qy = q[o + 1], qz = q[o + 2];
    const float nx = n[o], ny = n[o + 1], nz = n[o + 2];
    const float wi = w[i];
    float row[8];
    row[0] = nx;
    row[1] = ny;
    row[2] = nz;
    row[3] = py * nz - pz * ny;
    row[4] = pz * nx - px * nz;
    row[5] = px * ny - py * nx;
    row[6] = nx * (px - qx) + ny * (py - qy) + nz * (pz - qz);
    row[7] = 1.f;
    int c = 0;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const float wa = row[a] * wi;
#pragma unroll
      for (int b = a; b < 8; ++b) {
        acc[c] += wa * row[b];
        ++c;
      }
    }
  }

  // Warp tree, then the warps' rows in order.
  __shared__ float warp_rows[kWarps][kPairs];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < kPairs; ++c) {
    float v = acc[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_rows[warp][c] = v;
  }
  __syncthreads();
  if (threadIdx.x < kPairs) {
    float v = warp_rows[0][threadIdx.x];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) v += warp_rows[k][threadIdx.x];
    partials[static_cast<size_t>(blockIdx.x) * kPairs + threadIdx.x] = v;
  }
}

// One block of 64 threads: thread (a, b) of the 8x8 sums its pair's column of
// the (blocks, 36) partial rows in block order.
__global__ void icp_jtj_finish_kernel(const float* __restrict__ partials,
                                      float* __restrict__ out, int blocks) {
  const int a = threadIdx.x >> 3;
  const int b = threadIdx.x & 7;
  const int lo = a < b ? a : b;
  const int hi = a < b ? b : a;
  // Index of (lo, hi) in the row-major upper triangle.
  const int c = lo * 8 - (lo * (lo - 1)) / 2 + (hi - lo);
  float v = 0.f;
  for (int k = 0; k < blocks; ++k) v += partials[static_cast<size_t>(k) * kPairs + c];
  out[threadIdx.x] = v;
}

}  // namespace

// p, q, n (M, 3) f32, w (M,) f32, partials (blocks, 36) f32 scratch,
// out (8, 8) f32; all contiguous. blocks >= 1.
extern "C" int rgbd_icp_jtj_jtr(const float* p, const float* q, const float* n,
                                const float* w, float* partials, float* out,
                                int M, int blocks, cudaStream_t stream) {
  icp_jtj_partial_kernel<<<blocks, kThreads, 0, stream>>>(p, q, n, w, partials, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  icp_jtj_finish_kernel<<<1, 64, 0, stream>>>(partials, out, blocks);
  return static_cast<int>(cudaGetLastError());
}
