// Point-to-plane normal equations of one dense-ICP Gauss-Newton step: K4,
// and the fused step that computes its rows itself.
//
// K4 (`rgbd_icp_jtj_jtr`) replaces the TPU kernels `_jtj_kernel_vpu` and
// `_jtj_kernel_mxu` of rgbd_pose_estimation_tpu/ops/icp_jtj.py
// (`icp_jtj_jtr`): both compute the same sums, so one kernel covers both. Per
// associated pixel, with the augmented Jacobian row J = [n, p x n, r, 1] and
// r = n . (p - q), it accumulates the 36 upper-triangle entries of
// A = sum_m w_m J_m J_m^T and returns the symmetric 8x8: A[:6,:6] = JtJ,
// A[:6,6] = Jtr, A[6,6] = sum w r^2, A[7,7] = sum w.
//
// The TPU kernel's (10, S, 128) lane layout, its 64-sublane tile, its
// zero-weight padding and its lane-partial accumulator are shapes of that
// machine and are not carried over: K4 reads p, q, n as (M, 3) and w as
// (M,), any M >= 1.
//
// Bound on this card: bytes, 40 a pixel read once (12.3 MB at M = 307200,
// a few microseconds), against about 87 operations a pixel; at the sizes a
// strided track uses (a few thousand pixels) the bound is far below a launch.
// The design therefore aims only at being right and repeatable:
//  - a grid-stride loop, every thread holding its 36 partial sums in
//    registers; a warp-shuffle tree, then a fixed-order sum over the warps in
//    shared memory, gives one row of 36 per block;
//  - the blocks' rows are summed in block order into the symmetric 8x8. No
//    floating-point atomics anywhere: which thread sees which pixel and the
//    order of every addition depend on M and the grid alone, so two runs on
//    the same input agree to the last bit.
// Zero-weight rows are multiplied through, not skipped: a NaN in such a row
// reaches the sums, as it does in the plain version. True f32 throughout
// (CUDA cores; multiply-add contraction is allowed).
//
// The fused step (`rgbd_icp_assoc_jtj_jtr`) is the nearest-association,
// depth-only Gauss-Newton step of icp/dense.py whose accumulation is K4:
// one thread per strided source pixel warps it by T (read on the device),
// projects it, rounds to the nearest target pixel (rintf: half to even, as
// torch.round and jnp.round), gathers the target vertex and normal straight
// from their (th, tw, 3) maps, applies the seven gates and the Huber weight
// of the plain version (ops/icp_jtj.py::icp_assoc_rows_reference) and feeds
// the row into K4's sums. p, q, n and w never reach device memory. A fresh
// step writes each pixel's target index (-1 out of bounds) to an (M,) int32
// map; a carried step reads it back and gathers at the same pixel, which is
// what the plain version's carried association holds. Its bound is the
// bytes too: the strided source rows, the gathered target rows and the index
// map, ~50-100 bytes a pixel counted in 32-byte sectors, a few microseconds
// even at M = 307200; so it is one launch: the last block to finish (an
// integer ticket after a __threadfence, atomicInc wrapping it back to 0 for
// the next launch and for CUDA-graph replays) sums the blocks' rows in block
// order. IEEE division and no fast-math, as the plain version divides.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPairs = 36;  // upper triangle of the symmetric 8x8

// acc += w J J^T (upper triangle) for the row of (p, q, n).
__device__ __forceinline__ void accumulate_row(float (&acc)[kPairs], float px, float py,
                                               float pz, float qx, float qy, float qz,
                                               float nx, float ny, float nz, float wi) {
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

// The block's 36 sums: a warp tree, then the warps' rows in order, written
// by threads 0..35 to `partial`.
__device__ __forceinline__ void block_partial(const float (&acc)[kPairs],
                                              float* __restrict__ partial) {
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
    partial[threadIdx.x] = v;
  }
}

// Thread t < 64, entry (t / 8, t % 8) of the 8x8: its pair's column of the
// (blocks, 36) partial rows summed in block order. The loads go to L2: the
// rows may have been written by other blocks of the same launch.
__device__ __forceinline__ void sum_partials(const float* __restrict__ partials,
                                             float* __restrict__ out, int blocks, int t) {
  const int a = t >> 3;
  const int b = t & 7;
  const int lo = a < b ? a : b;
  const int hi = a < b ? b : a;
  // Index of (lo, hi) in the row-major upper triangle.
  const int c = lo * 8 - (lo * (lo - 1)) / 2 + (hi - lo);
  float v = 0.f;
  for (int k = 0; k < blocks; ++k) v += __ldcg(partials + static_cast<size_t>(k) * kPairs + c);
  out[t] = v;
}

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
    accumulate_row(acc, p[o], p[o + 1], p[o + 2], q[o], q[o + 1], q[o + 2], n[o], n[o + 1],
                   n[o + 2], w[i]);
  }
  block_partial(acc, partials + static_cast<size_t>(blockIdx.x) * kPairs);
}

// One block of 64 threads writes the 8x8.
__global__ void icp_jtj_finish_kernel(const float* __restrict__ partials,
                                      float* __restrict__ out, int blocks) {
  sum_partials(partials, out, blocks, threadIdx.x);
}

// What the fused step reads and writes, fixed for one pyramid level: filled
// by the entry point below and passed to the kernel by value.
struct IcpAssocArgs {
  const float* src_v;     // (H, W, 3) source vertex map
  const float* src_n;     // (H, W, 3) source normal map
  const float* tgt_v;     // (th, tw, 3) target vertex map
  const float* tgt_n;     // (th, tw, 3) target normal map
  int* assoc;             // (M,) target pixel of each sample, -1 out of bounds
  float* partials;        // (blocks, 36) scratch
  float* out;             // (8, 8)
  unsigned int* ticket;   // 0 between launches
  int H, W, stride, Ws;   // sample (i, j) is source pixel (i*stride, j*stride), j < Ws
  int M, th, tw, blocks;  // M = ceil(H/stride) * Ws
  float fx, fy, cx, cy;   // the level's intrinsics
  float dist2;            // dist_threshold^2, rounded to f32 as the tensor comparison does
  float normal_thr, huber;
};

__global__ void __launch_bounds__(kThreads)
icp_assoc_kernel(const IcpAssocArgs a, const float* __restrict__ T, int fresh) {
  // T (4, 4) row-major: R = T[:3, :3], t = T[:3, 3]; the same for every thread.
  const float r00 = __ldg(T + 0), r01 = __ldg(T + 1), r02 = __ldg(T + 2), t0 = __ldg(T + 3);
  const float r10 = __ldg(T + 4), r11 = __ldg(T + 5), r12 = __ldg(T + 6), t1 = __ldg(T + 7);
  const float r20 = __ldg(T + 8), r21 = __ldg(T + 9), r22 = __ldg(T + 10), t2 = __ldg(T + 11);
  const float* __restrict__ src_v = a.src_v;
  const float* __restrict__ src_n = a.src_n;
  const float* __restrict__ tgt_v = a.tgt_v;
  const float* __restrict__ tgt_n = a.tgt_n;
  const float thf = static_cast<float>(a.th), twf = static_cast<float>(a.tw);

  float acc[kPairs];
#pragma unroll
  for (int c = 0; c < kPairs; ++c) acc[c] = 0.f;

  const int grid_stride = gridDim.x * blockDim.x;
  for (int m = blockIdx.x * blockDim.x + threadIdx.x; m < a.M; m += grid_stride) {
    const int i = m / a.Ws;
    const int j = m - i * a.Ws;
    const size_t s = 3 * (static_cast<size_t>(i) * a.stride * a.W + static_cast<size_t>(j) * a.stride);
    const float sx = src_v[s], sy = src_v[s + 1], sz = src_v[s + 2];
    const float mx = src_n[s], my = src_n[s + 1], mz = src_n[s + 2];
    const bool src_ok = sz > 0.f && mx * mx + my * my + mz * mz > 0.5f;

    // Warp: p = R s + t, n_src = R m.
    const float px = r00 * sx + r01 * sy + r02 * sz + t0;
    const float py = r10 * sx + r11 * sy + r12 * sz + t1;
    const float pz = r20 * sx + r21 * sy + r22 * sz + t2;
    const float ux = r00 * mx + r01 * my + r02 * mz;
    const float uy = r10 * mx + r11 * my + r12 * mz;
    const float uz = r20 * mx + r21 * my + r22 * mz;

    int idx;
    if (fresh) {
      // max(z, 1e-6) that keeps NaN, as torch.clamp does; then the pixel.
      const float z = pz < 1e-6f ? 1e-6f : pz;
      const float u = rintf(a.fx * px / z + a.cx);
      const float v = rintf(a.fy * py / z + a.cy);
      // In bounds on the rounded floats (NaN is out): the same test as on
      // the clamped int32 pixel of the plain version.
      const bool in_b = u >= 0.f && u < twf && v >= 0.f && v < thf;
      idx = in_b ? static_cast<int>(v) * a.tw + static_cast<int>(u) : -1;
      a.assoc[m] = idx;
    } else {
      idx = a.assoc[m];
    }
    float qx = 0.f, qy = 0.f, qz = 0.f, nx = 0.f, ny = 0.f, nz = 0.f;
    if (idx >= 0) {
      const size_t o = 3 * static_cast<size_t>(idx);
      qx = __ldg(tgt_v + o);
      qy = __ldg(tgt_v + o + 1);
      qz = __ldg(tgt_v + o + 2);
      nx = __ldg(tgt_n + o);
      ny = __ldg(tgt_n + o + 1);
      nz = __ldg(tgt_n + o + 2);
    }

    // The gates and the Huber weight.
    const float dx = px - qx, dy = py - qy, dz = pz - qz;
    const float dist2 = dx * dx + dy * dy + dz * dz;
    const float ncos = nx * ux + ny * uy + nz * uz;
    const float r = nx * dx + ny * dy + nz * dz;
    const bool valid = src_ok && idx >= 0 && pz > 0.f && qz > 0.f &&
                       nx * nx + ny * ny + nz * nz > 0.5f && dist2 < a.dist2 &&
                       ncos > a.normal_thr;
    const float absr = fabsf(r);
    const float w_rob = absr <= a.huber ? 1.f : a.huber / (absr < 1e-12f ? 1e-12f : absr);
    accumulate_row(acc, px, py, pz, qx, qy, qz, nx, ny, nz, valid ? w_rob : 0.f);
  }
  block_partial(acc, a.partials + static_cast<size_t>(blockIdx.x) * kPairs);

  // The last block to get here sums every block's row.
  __shared__ bool last;
  __threadfence();  // this block's row is visible to all before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(a.ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (last && threadIdx.x < 64) sum_partials(a.partials, a.out, gridDim.x, threadIdx.x);
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

// src_v, src_n (H, W, 3) and tgt_v, tgt_n (th, tw, 3) f32; assoc (M,) i32
// with M = ceil(H/stride) * ceil(W/stride); partials (blocks, 36) f32
// scratch; out (8, 8) f32; ticket one u32, 0 before the first launch (each
// launch leaves it at 0); all contiguous, blocks >= 1. The level's
// intrinsics, dist_threshold^2, normal threshold and Huber delta by value.
// T (4, 4) f32 on the device; fresh != 0 associates afresh and writes
// assoc, 0 reads it.
extern "C" int rgbd_icp_assoc_jtj_jtr(const float* src_v, const float* src_n, const float* tgt_v,
                                      const float* tgt_n, int* assoc, float* partials, float* out,
                                      unsigned int* ticket, int H, int W, int stride, int th,
                                      int tw, int blocks, float fx, float fy, float cx, float cy,
                                      float dist2, float normal_thr, float huber, const float* T,
                                      int fresh, cudaStream_t stream) {
  const int Ws = (W + stride - 1) / stride;
  const IcpAssocArgs a{src_v, src_n, tgt_v, tgt_n, assoc, partials, out, ticket,
                       H, W, stride, Ws, ((H + stride - 1) / stride) * Ws, th, tw, blocks,
                       fx, fy, cx, cy, dist2, normal_thr, huber};
  icp_assoc_kernel<<<blocks, kThreads, 0, stream>>>(a, T, fresh);
  return static_cast<int>(cudaGetLastError());
}
