// Minimal-set moments for RANSAC hypothesis generation.
//
// Replaces the TPU kernel `_moments_kernel` of
// rgbd_pose_estimation_tpu/ops/moments.py (`minimal_moments`). That kernel
// is a one-hot (N, KT) selection matrix times bf16 hi/lo feature planes,
// a form chosen because the TPU's gather unit is slow. On Hopper the whole
// correspondence set (24 bytes a row, 48 KB at N = 2048) sits in L1/L2, so
// each hypothesis simply gathers its m rows and sums in f32.
//
// Bound on this card: bytes, 4*(m*K + 16*K) + 24*N, i.e. well under a
// microsecond at K = 32768: the kernel is bound by its launch and by the
// latency of its dependent loads. So a thread takes one hypothesis, with m
// known at compile time (instances m = 1..8; larger m runs in chunks of 8):
// it loads its whole index row, then all 6*m coordinates of the sample,
// before the first add, so that one round trip to L2 serves the sample (at
// the engines' m = 3 the compiled code keeps that order; see
// tools/roofline.py::audit_t3_k1_sass for each m). The
// (16, K) output is written row by row, so that a warp's 32 stores are
// neighbours. Blocks of 128 threads: 256 blocks at K = 32768, at most two on
// each of the 132 SMs, one wave.
//
// The products and sums are written with explicit round-to-nearest
// intrinsics, in the order j = 0..m-1 and starting from row 0's own values,
// so that no multiply-add contraction makes the result differ from the plain
// PyTorch version's.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 8;  // rows of a sample in flight at once above m = 8

// Adds n sample rows (all kC when kExact) whose indices start at row[0];
// `first`: these are the sample's first rows, so row 0 sets the sums.
template <int kC, bool kExact>
__device__ __forceinline__ void add_rows(const int* __restrict__ row, int n, bool first,
                                         const float* __restrict__ p,
                                         const float* __restrict__ q, int N, float (&sp)[3],
                                         float (&sq)[3], float (&so)[9]) {
  int ix[kC];
#pragma unroll
  for (int j = 0; j < kC; ++j) ix[j] = kExact || j < n ? __ldg(row + j) : 0;
  float pa[kC][3], qa[kC][3];
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    // Clamped for memory safety only: indices are distinct rows < N by
    // the sampler's contract.
    const size_t r = 3 * static_cast<size_t>(min(max(ix[j], 0), N - 1));
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      pa[j][a] = kExact || j < n ? __ldg(p + r + a) : 0.f;
      qa[j][a] = kExact || j < n ? __ldg(q + r + a) : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    if (!kExact && j >= n) break;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if (j == 0 && first) {
        sp[a] = pa[0][a];
        sq[a] = qa[0][a];
      } else {
        sp[a] = __fadd_rn(sp[a], pa[j][a]);
        sq[a] = __fadd_rn(sq[a], qa[j][a]);
      }
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const float o = __fmul_rn(pa[j][a], qa[j][b]);
        so[a * 3 + b] = j == 0 && first ? o : __fadd_rn(so[a * 3 + b], o);
      }
    }
  }
}

// kM: the sample size m, or 0 for any m, in chunks of kChunk rows.
template <int kM>
__global__ void __launch_bounds__(kThreads)
minimal_moments_kernel(const int* __restrict__ idx, const float* __restrict__ p,
                       const float* __restrict__ q, float* __restrict__ out, int K, int m,
                       int N) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= K) return;
  if (kM > 0) m = kM;
  float sp[3], sq[3], so[9];
  const int* row = idx + static_cast<size_t>(k) * m;
  if (kM > 0) {
    add_rows<(kM > 0 ? kM : 1), true>(row, kM, true, p, q, N, sp, sq, so);
  } else {
    for (int j0 = 0; j0 < m; j0 += kChunk) {
      add_rows<kChunk, false>(row + j0, min(kChunk, m - j0), j0 == 0, p, q, N, sp, sq, so);
    }
  }
  const size_t stride = static_cast<size_t>(K);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    out[(0 + a) * stride + k] = sp[a];
    out[(3 + a) * stride + k] = sq[a];
  }
#pragma unroll
  for (int c = 0; c < 9; ++c) out[(6 + c) * stride + k] = so[c];
  out[15 * stride + k] = static_cast<float>(m);
}

template <int kM>
void launch(const int* idx, const float* p, const float* q, float* out, int K, int m, int N,
            cudaStream_t stream) {
  const int blocks = (K + kThreads - 1) / kThreads;
  minimal_moments_kernel<kM><<<blocks, kThreads, 0, stream>>>(idx, p, q, out, K, m, N);
}

}  // namespace

// idx (K, m) int32, p and q (N, 3) f32, out (16, K) f32; all contiguous; m >= 1.
extern "C" int rgbd_minimal_moments(const int* idx, const float* p,
                                    const float* q, float* out, int K, int m,
                                    int N, cudaStream_t stream) {
  switch (m) {
    case 1: launch<1>(idx, p, q, out, K, m, N, stream); break;
    case 2: launch<2>(idx, p, q, out, K, m, N, stream); break;
    case 3: launch<3>(idx, p, q, out, K, m, N, stream); break;
    case 4: launch<4>(idx, p, q, out, K, m, N, stream); break;
    case 5: launch<5>(idx, p, q, out, K, m, N, stream); break;
    case 6: launch<6>(idx, p, q, out, K, m, N, stream); break;
    case 7: launch<7>(idx, p, q, out, K, m, N, stream); break;
    case 8: launch<8>(idx, p, q, out, K, m, N, stream); break;
    default: launch<0>(idx, p, q, out, K, m, N, stream); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rgbd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
