// Point-to-plane normal equations of one dense-ICP Gauss-Newton step: K4,
// and the fused step that computes its rows itself. Both are one launch,
// one body: rows accumulated in registers, a block's sums, and the last
// block's finish.
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
// What bounds K4 on this card: its bytes, 40 a row read once (0.23 us at
// M = 19200, 3.7 us at M = 307200), against about 87 operations a row. At the
// sizes the tracks use (1200-38400 rows) a chain of latencies weighs more
// than the bytes: the launch, the rows' loads, the block's sums, the ticket
// and the last block's reads; at M = 307200 the loads alone come to the
// bytes bound. The design:
//  - one launch: each block writes its row of 36 sums, and the last block to
//    finish sums the rows. It is found by an integer ticket: after a
//    __syncthreads one thread draws it with an atomic increment that
//    releases the block's row and acquires the others' (cheaper than a
//    __threadfence in every thread), and that wraps back to 0, so every
//    launch leaves it at 0 for the next. Launches that share a ticket must
//    run one after another. The wrapper (ops/icp_jtj.py::_ticket) keeps one
//    for eager launches on each (device, stream), zeroed when made outside
//    any capture; a launch recorded into a CUDA graph takes a ticket of that
//    capture and stream, zeroed by a node of the same graph at every replay
//    (rgbd_capture_id below tells the two apart). So no two streams and no
//    two graphs share a ticket, and replays of one graph, which CUDA runs
//    one after another, start from 0 even if another graph ran between;
//  - the finish has all of a trip's loads in flight before it adds: thread
//    t reads float4 t % 9 of eight block rows at a time (rows t / 9, + 28,
//    ...) and adds them in block order, then 36 threads add the 28 group
//    sums in group order;
//  - a warp sums its lanes' 36 entries by a transpose reduction (31 shuffles
//    for 32 entries, each lane ending with one entry's sum) and four shuffle
//    trees, not 36 trees (180 shuffles);
//  - one row a thread, in a grid-stride loop over a block per 256 rows, at
//    most two blocks an SM: with the finish this cheap, spreading the rows
//    over more SMs beat giving a thread 2 or 4 rows in flight, which made
//    fewer blocks.
// Which thread sees which row and the order of every addition depend on M
// and the grid alone, and there are no floating-point atomics: two runs on
// the same input agree to the last bit. Zero-weight rows are multiplied
// through, not skipped: a NaN in such a row reaches the sums, as it does in
// the plain version. True f32 on the CUDA cores (multiply-add contraction
// allowed).
//
// A variant with no ticket, one thread-block cluster of up to 16 blocks
// summing through distributed shared memory, was slower at every size
// measured (4800-307200 rows).
//
// The fused step (`rgbd_icp_assoc_jtj_jtr`) is the nearest-association,
// depth-only Gauss-Newton step of icp/dense.py whose accumulation is K4's
// body: one thread per strided source pixel warps it by T (read on the
// device), projects it, rounds to the nearest target pixel (rintf: half to
// even, as torch.round and jnp.round), gathers the target vertex and normal
// straight from their (th, tw, 3) maps, applies the seven gates and the
// Huber weight of the plain version (ops/icp_jtj.py::icp_assoc_rows_reference)
// and feeds the row into K4's sums. p, q, n and w never reach device memory.
// A fresh step writes each pixel's target index (-1 out of bounds) to an (M,)
// int32 map; a carried step reads it back and gathers at the same pixel,
// which is what the plain version's carried association holds. Its bound is
// the bytes too: the strided source rows, the gathered target rows and the
// index map, ~50-100 bytes a pixel counted in 32-byte sectors, a few
// microseconds even at M = 307200. IEEE division and no fast-math, as the
// plain version divides. Its ticket belongs to the level's buffers, made with
// them, as its results and index map do: a level's calls run one after
// another.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPairs = 36;  // upper triangle of the symmetric 8x8

// One row of the normal equations: p, q, n and the weight.
struct Row {
  float px, py, pz, qx, qy, qz, nx, ny, nz, w;
};

// acc += w J J^T (upper triangle) for the row.
__device__ __forceinline__ void accumulate_row(float (&acc)[kPairs], const Row& r) {
  float row[8];
  row[0] = r.nx;
  row[1] = r.ny;
  row[2] = r.nz;
  row[3] = r.py * r.nz - r.pz * r.ny;
  row[4] = r.pz * r.nx - r.px * r.nz;
  row[5] = r.px * r.ny - r.py * r.nx;
  row[6] = r.nx * (r.px - r.qx) + r.ny * (r.py - r.qy) + r.nz * (r.pz - r.qz);
  row[7] = 1.f;
  int c = 0;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const float wa = row[a] * r.w;
#pragma unroll
    for (int b = a; b < 8; ++b) {
      acc[c] += wa * row[b];
      ++c;
    }
  }
}

// One step of a warp's transpose reduction of acc[0..2S-1]: lanes that
// differ in bit S swap halves; each keeps the half its bit selects and adds
// its partner's copy of it. After the steps S = 16, 8, 4, 2, 1, lane l holds
// the warp's sum of entry l in acc[0].
template <int S>
__device__ __forceinline__ void transpose_step(float (&acc)[kPairs], int lane) {
  const bool upper = lane & S;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float send = upper ? acc[j] : acc[j + S];
    const float keep = upper ? acc[j + S] : acc[j];
    acc[j] = keep + __shfl_xor_sync(0xffffffffu, send, S);
  }
  if constexpr (S > 1) transpose_step<S / 2>(acc, lane);
}

// The block's 36 sums, written by threads 0..35 to `partial`: a transpose reduction of entries 0-31 and shuffle trees
// of 32-35 in each warp, then the warps' rows in warp order.
__device__ __forceinline__ void block_partial(float (&acc)[kPairs], float* partial) {
  __shared__ float warp_rows[kWarps][kPairs];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  transpose_step<16>(acc, lane);
#pragma unroll
  for (int c = 32; c < kPairs; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
  }
  warp_rows[warp][lane] = acc[0];
  if (lane == 0) {
#pragma unroll
    for (int c = 32; c < kPairs; ++c) warp_rows[warp][c] = acc[c];
  }
  __syncthreads();
  if (threadIdx.x < kPairs) {
    float v = warp_rows[0][threadIdx.x];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) v += warp_rows[k][threadIdx.x];
    partial[threadIdx.x] = v;
  }
}

// The 8x8 from `rows` rows of 36 block sums (16-byte aligned) that other
// blocks of this launch wrote, read from L2, by all threads of one block.
// Thread t takes the float4 j = t % 9 of a row (entries 4j..4j+3) in rows
// g, g + 28, ... (g = t / 9 < 28), loading kBatch rows before it adds them
// in row order; then each of the first 36 threads reads its entry's 28
// group sums and adds them in group order, and writes the sum to both
// halves of the 8x8.
__device__ __forceinline__ void sum_rows(const float4* rows4, int rows, float* __restrict__ out) {
  constexpr int kChunks = kPairs / 4;
  constexpr int kGroups = kThreads / kChunks;
  constexpr int kBatch = 8;
  __shared__ float4 group_sums[kGroups][kChunks];
  const int t = threadIdx.x;
  const int j = t % kChunks;
  const int g = t / kChunks;
  if (g < kGroups) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = g; k0 < rows; k0 += kGroups * kBatch) {
      float4 x[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int k = k0 + b * kGroups;
        x[b] = k < rows ? __ldcg(rows4 + static_cast<size_t>(k) * kChunks + j)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        v.x += x[b].x;
        v.y += x[b].y;
        v.z += x[b].z;
        v.w += x[b].w;
      }
    }
    group_sums[g][j] = v;
  }
  __syncthreads();
  if (t < kPairs) {
    const float* sums = reinterpret_cast<const float*>(group_sums);
    float x[kGroups];
#pragma unroll
    for (int k = 0; k < kGroups; ++k) x[k] = sums[k * kPairs + t];
    float v = x[0];
#pragma unroll
    for (int k = 1; k < kGroups; ++k) v += x[k];
    // (a, b), a <= b, of entry t in the row-major upper triangle.
    int a = 0, first = 0;
    while (t >= first + 8 - a) first += 8 - a++;
    const int b = a + (t - first);
    out[a * 8 + b] = v;
    out[b * 8 + a] = v;
  }
}

// An atomic increment that wraps at `last` (atomicInc's), with release and
// acquire at the scope of the card: what the block wrote before a
// __syncthreads is visible to the block that draws the last ticket, which
// sees every other block's writes.
__device__ __forceinline__ unsigned int ticket_inc(unsigned int* ticket, unsigned int last) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(ticket), "r"(last) : "memory");
  return old;
}

// The body K4 and the fused step share: the rows (a thread takes row m =
// its index in the grid, then every gridDim.x * kThreads after it), the
// block's sums into partials (gridDim.x, 36), and the last block's 8x8 into
// out.
template <class Rows>
__device__ __forceinline__ void accumulate_and_finish(const Rows& rows, int M, float* partials,
                                                      float* __restrict__ out,
                                                      unsigned int* ticket) {
  float acc[kPairs];
#pragma unroll
  for (int c = 0; c < kPairs; ++c) acc[c] = 0.f;
  const int stride = gridDim.x * kThreads;
  for (int m = blockIdx.x * kThreads + threadIdx.x; m < M; m += stride) accumulate_row(acc, rows(m));
  block_partial(acc, partials + static_cast<size_t>(blockIdx.x) * kPairs);

  __shared__ bool last;
  __syncthreads();  // the block's row is written before its ticket is drawn
  if (threadIdx.x == 0) last = ticket_inc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  sum_rows(reinterpret_cast<const float4*>(partials), gridDim.x, out);
}

// K4's rows, read from p, q, n (M, 3) and w (M,).
struct MemoryRows {
  const float* __restrict__ p;
  const float* __restrict__ q;
  const float* __restrict__ n;
  const float* __restrict__ w;

  __device__ __forceinline__ Row operator()(int m) const {
    const size_t o = 3 * static_cast<size_t>(m);
    return {__ldg(p + o), __ldg(p + o + 1), __ldg(p + o + 2), __ldg(q + o), __ldg(q + o + 1),
            __ldg(q + o + 2), __ldg(n + o), __ldg(n + o + 1), __ldg(n + o + 2), __ldg(w + m)};
  }
};

__global__ void __launch_bounds__(kThreads)
icp_jtj_kernel(const MemoryRows rows, int M, float* partials, float* __restrict__ out,
               unsigned int* ticket) {
  accumulate_and_finish(rows, M, partials, out, ticket);
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

// The fused step's rows: sample m warped, associated, gated and weighted.
struct AssocRows {
  IcpAssocArgs a;
  int fresh;
  // T (4, 4) row-major: R = T[:3, :3], t = T[:3, 3]; the same for every thread.
  float r00, r01, r02, t0, r10, r11, r12, t1, r20, r21, r22, t2;

  __device__ __forceinline__ Row operator()(int m) const {
    const int i = m / a.Ws;
    const int j = m - i * a.Ws;
    const size_t s = 3 * (static_cast<size_t>(i) * a.stride * a.W + static_cast<size_t>(j) * a.stride);
    const float sx = __ldg(a.src_v + s), sy = __ldg(a.src_v + s + 1), sz = __ldg(a.src_v + s + 2);
    const float mx = __ldg(a.src_n + s), my = __ldg(a.src_n + s + 1), mz = __ldg(a.src_n + s + 2);
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
      const bool in_b = u >= 0.f && u < static_cast<float>(a.tw) && v >= 0.f &&
                        v < static_cast<float>(a.th);
      idx = in_b ? static_cast<int>(v) * a.tw + static_cast<int>(u) : -1;
      a.assoc[m] = idx;
    } else {
      idx = a.assoc[m];
    }
    float qx = 0.f, qy = 0.f, qz = 0.f, nx = 0.f, ny = 0.f, nz = 0.f;
    if (idx >= 0) {
      const size_t o = 3 * static_cast<size_t>(idx);
      qx = __ldg(a.tgt_v + o);
      qy = __ldg(a.tgt_v + o + 1);
      qz = __ldg(a.tgt_v + o + 2);
      nx = __ldg(a.tgt_n + o);
      ny = __ldg(a.tgt_n + o + 1);
      nz = __ldg(a.tgt_n + o + 2);
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
    return {px, py, pz, qx, qy, qz, nx, ny, nz, valid ? w_rob : 0.f};
  }
};

__global__ void __launch_bounds__(kThreads)
icp_assoc_kernel(const IcpAssocArgs a, const float* __restrict__ T, int fresh) {
  const AssocRows rows{a, fresh,
                       __ldg(T + 0), __ldg(T + 1), __ldg(T + 2), __ldg(T + 3),
                       __ldg(T + 4), __ldg(T + 5), __ldg(T + 6), __ldg(T + 7),
                       __ldg(T + 8), __ldg(T + 9), __ldg(T + 10), __ldg(T + 11)};
  accumulate_and_finish(rows, a.M, a.partials, a.out, a.ticket);
}

}  // namespace

// p, q, n (M, 3) f32, w (M,) f32, partials (blocks, 36) f32 scratch
// (16-byte aligned), out (8, 8) f32, ticket one u32 at 0 that no launch
// running at the same time holds (each launch leaves it at 0); all
// contiguous. blocks >= 1.
extern "C" int rgbd_icp_jtj_jtr(const float* p, const float* q, const float* n,
                                const float* w, float* partials, float* out,
                                unsigned int* ticket, int M, int blocks, cudaStream_t stream) {
  icp_jtj_kernel<<<blocks, kThreads, 0, stream>>>(MemoryRows{p, q, n, w}, M, partials, out, ticket);
  return static_cast<int>(cudaGetLastError());
}

// src_v, src_n (H, W, 3) and tgt_v, tgt_n (th, tw, 3) f32; assoc (M,) i32
// with M = ceil(H/stride) * ceil(W/stride); partials (blocks, 36) f32
// scratch (16-byte aligned); out (8, 8) f32; ticket one u32, 0 before the first launch (each
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

// The id of the CUDA-graph capture that `stream` is recording into, plus
// one; 0 when it records none.
extern "C" unsigned long long rgbd_capture_id(cudaStream_t stream) {
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  if (cudaStreamGetCaptureInfo(stream, &status, &id) != cudaSuccess ||
      status != cudaStreamCaptureStatusActive) {
    return 0;
  }
  return id + 1;
}
