// Measurement variants of the exact MSAC scorer, on msac_exact.cuh's
// pose-stationary kernel (K3's and K5's).
//
// T1 replaces the TPU kernel `_kernel_A` of tools/msac_opt.py
// (`variant_A`): the production scorer's function, per pose k
// sum_n min(|R_k p_n + t_k - q_n|^2, tau^2) and sum_n [e < tau^2], with the
// poses a thread holds as an argument. On the TPU the variant sweeps KT, the
// poses of one grid step; here P poses a thread (1, 2, 4) set how many pose
// evaluations each broadcast correspondence load serves, against how many
// blocks of 32 P poses there are to fill the card.
//
// T5 replaces `_kernel_D` of the same file (`variant_D`): T1 without the
// inlier count, so that the two together measure what the count costs.
//
// Bound on this card: operations, 23*K*N f32 (T5: 20*K*N); the bytes are
// negligible. Design and NaN handling: see msac_exact.cuh.
//
// Beside them, the check behind K5's reciprocal: msac_exact.cuh takes
// rcp_rn_normal(z) for 1.f / z on normal depths below 2^126, and
// rgbd_msac_reciprocal_check counts the floats of a range on which the two
// differ in any bit.

#include "msac_exact.cuh"

namespace {

using msac_exact::kThreads;
using msac_exact::kWarps;

// For the floats with bits first + i, i < count: how many give another
// rcp_rn_normal(x) than 1.f / x, bit for bit; one count a block (summed by
// the caller), no atomics.
__global__ void __launch_bounds__(kThreads)
reciprocal_check_kernel(unsigned first, unsigned count, int* __restrict__ per_block) {
  __shared__ int s_bad[kWarps];
  int bad = 0;
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < count; i += gridDim.x * kThreads) {
    const float x = __uint_as_float(first + i);
    bad += __float_as_uint(msac_exact::rcp_rn_normal(x)) != __float_as_uint(1.f / x);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) bad += __shfl_down_sync(0xffffffffu, bad, off);
  if ((threadIdx.x & 31) == 0) s_bad[threadIdx.x >> 5] = bad;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += s_bad[w];
    per_block[blockIdx.x] = total;
  }
}

}  // namespace

// poses (K, 12) f32 [9 rotation row-major, 3 translation], p and q (N, 3)
// f32, msac and count (K,) f32; all contiguous. poses_per_thread is one of
// 1, 2, 4 (anything else: cudaErrorInvalidValue, nothing launched).
extern "C" int rgbd_msac_variant_a(const float* poses, const float* p,
                                   const float* q, float* msac, float* count,
                                   int K, int N, float tau2,
                                   int poses_per_thread, cudaStream_t stream) {
  return msac_exact::launch_poses<msac_exact::Residual3D3D, true>(
      poses_per_thread, poses, p, q, msac, count, K, N, tau2, stream);
}

// As rgbd_msac_variant_a, without the count.
extern "C" int rgbd_msac_variant_d(const float* poses, const float* p,
                                   const float* q, float* msac, int K, int N,
                                   float tau2, int poses_per_thread,
                                   cudaStream_t stream) {
  return msac_exact::launch_poses<msac_exact::Residual3D3D, false>(
      poses_per_thread, poses, p, q, msac, nullptr, K, N, tau2, stream);
}

// per_block (blocks,) int32: for the floats with bits first + i,
// i < count, how many give another rcp_rn_normal(x) than 1.f / x, counted
// by `blocks` blocks of 256 threads; the caller sums them.
extern "C" int rgbd_msac_reciprocal_check(unsigned first, unsigned count,
                                          int* per_block, int blocks,
                                          cudaStream_t stream) {
  reciprocal_check_kernel<<<blocks, kThreads, 0, stream>>>(first, count, per_block);
  return static_cast<int>(cudaGetLastError());
}
