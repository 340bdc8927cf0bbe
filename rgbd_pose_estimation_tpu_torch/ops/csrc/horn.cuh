// Horn's absolute orientation (Horn 1987) for one problem, in one thread's
// registers.
//
// The device twin of solvers/absolute_orientation.py::_horn_from_components:
// from the centroids of the two point sets and their centred 3x3
// cross-covariance, the optimal rotation quaternion is the eigenvector of
// Horn's symmetric 4x4 matrix with the largest eigenvalue. The same
// algorithm step for step: Frobenius scaling, a shift by 1, three normalised
// squarings, a block power iteration of two vectors with Gram-Schmidt, and
// the 2x2 Rayleigh-Ritz solve by atan2. Every product and sum is rounded on
// its own, in the order the plain version computes it (__fmul_rn and
// __fadd_rn cannot be contracted into multiply-adds), and the clamps keep a
// NaN as torch.clamp does, so that NaN inputs give a NaN pose here as there.
//
// The matrix is kept as its 10 distinct entries, in the order
// (a00, a01, a02, a03, a11, a12, a13, a22, a23, a33).

#pragma once

#include <cuda_runtime.h>

namespace horn {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// torch.clamp(x, min=lo): a NaN stays NaN (fmaxf would return lo).
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : (x < lo ? lo : x);
}

// 1, read at run time. The plain version normalises its start vectors on
// the card, with the card's rsqrt; from a constant the compiler would fold
// that rsqrt at build time, to another last bit (measured on an H100: the
// first start vector then differs by one ulp, and 30-90% of the hypotheses'
// poses differ in their last bits, by the number of power steps). A volatile
// load cannot be folded.
static __device__ float kOne = 1.f;
__device__ __forceinline__ float one_at_run_time() { return *static_cast<volatile float*>(&kOne); }

// x0*y0 + x1*y1 + x2*y2 + x3*y3, summed left to right.
__device__ __forceinline__ float dot4(float x0, float x1, float x2, float x3, float y0, float y1,
                                      float y2, float y3) {
  return add(add(add(mul(x0, y0), mul(x1, y1)), mul(x2, y2)), mul(x3, y3));
}

// Python's sum() of four products starts from the integer 0.
__device__ __forceinline__ float sum4(float x0, float x1, float x2, float x3, float y0, float y1,
                                      float y2, float y3) {
  return add(add(add(add(0.f, mul(x0, y0)), mul(x1, y1)), mul(x2, y2)), mul(x3, y3));
}

__device__ __forceinline__ float frob(const float (&a)[10]) {
  const float diag = add(add(add(mul(a[0], a[0]), mul(a[4], a[4])), mul(a[7], a[7])),
                         mul(a[9], a[9]));
  const float off = add(add(add(add(add(mul(a[1], a[1]), mul(a[2], a[2])), mul(a[3], a[3])),
                                mul(a[5], a[5])),
                            mul(a[6], a[6])),
                        mul(a[8], a[8]));
  return sqrtf(add(diag, mul(2.f, off)));
}

__device__ __forceinline__ void scale(float (&a)[10], float s) {
#pragma unroll
  for (int i = 0; i < 10; ++i) a[i] = mul(a[i], s);
}

// a <- a @ a (a symmetric).
__device__ __forceinline__ void sym_square(float (&a)[10]) {
  const float r0[4] = {a[0], a[1], a[2], a[3]};
  const float r1[4] = {a[1], a[4], a[5], a[6]};
  const float r2[4] = {a[2], a[5], a[7], a[8]};
  const float r3[4] = {a[3], a[6], a[8], a[9]};
#define HORN_DOT(x, y) dot4(x[0], x[1], x[2], x[3], y[0], y[1], y[2], y[3])
  a[0] = HORN_DOT(r0, r0);
  a[1] = HORN_DOT(r0, r1);
  a[2] = HORN_DOT(r0, r2);
  a[3] = HORN_DOT(r0, r3);
  a[4] = HORN_DOT(r1, r1);
  a[5] = HORN_DOT(r1, r2);
  a[6] = HORN_DOT(r1, r3);
  a[7] = HORN_DOT(r2, r2);
  a[8] = HORN_DOT(r2, r3);
  a[9] = HORN_DOT(r3, r3);
#undef HORN_DOT
}

__device__ __forceinline__ void matvec(const float (&a)[10], const float (&v)[4], float (&u)[4]) {
  u[0] = dot4(a[0], a[1], a[2], a[3], v[0], v[1], v[2], v[3]);
  u[1] = dot4(a[1], a[4], a[5], a[6], v[0], v[1], v[2], v[3]);
  u[2] = dot4(a[2], a[5], a[7], a[8], v[0], v[1], v[2], v[3]);
  u[3] = dot4(a[3], a[6], a[8], a[9], v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void normalize(float (&v)[4]) {
  const float inv = rsqrtf(clamp_min(dot4(v[0], v[1], v[2], v[3], v[0], v[1], v[2], v[3]), 1e-40f));
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = mul(v[i], inv);
}

// The pose (3x4, row-major [R | t]) from centroids cp, cq and the centred
// cross-covariance s = Σ w (p - cp)(q - cq)ᵀ (row-major), with `iters`
// block power steps.
__device__ __forceinline__ void from_components(const float (&cp)[3], const float (&cq)[3],
                                                const float (&s)[9], int iters,
                                                float (&T)[12]) {
  const float sxx = s[0], sxy = s[1], sxz = s[2];
  const float syx = s[3], syy = s[4], syz = s[5];
  const float szx = s[6], szy = s[7], szz = s[8];
  float a[10] = {
      add(add(sxx, syy), szz),  sub(syz, szy), sub(szx, sxz), sub(sxy, syx),
      sub(sub(sxx, syy), szz),  add(sxy, syx), add(szx, sxz),
      sub(add(-sxx, syy), szz), add(syz, szy),
      add(sub(-sxx, syy), szz),
  };
  // Scale-normalise (the quaternion does not change), so that the squarings
  // cannot overflow for points far from the origin (the pad sentinels).
  scale(a, 1.f / add(frob(a), 1e-30f));
  // Shift by the norm (now 1) and square three times, normalising each time.
  a[0] = add(a[0], 1.f);
  a[4] = add(a[4], 1.f);
  a[7] = add(a[7], 1.f);
  a[9] = add(a[9], 1.f);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    sym_square(a);
    scale(a, 1.f / clamp_min(frob(a), 1e-20f));
  }
  // Block power iteration on two vectors kept orthogonal (Gram-Schmidt):
  // the dominant 2D subspace converges even where the top two eigenvalues
  // nearly coincide (near-collinear minimal sets).
  const float one = one_at_run_time();
  float va[4] = {one, mul(0.1f, one), mul(0.2f, one), mul(0.3f, one)};
  float vb[4] = {mul(0.2f, one), mul(-0.7f, one), mul(0.6f, one), mul(-0.4f, one)};
  normalize(va);
  normalize(vb);
  float u[4];
  for (int it = 0; it < iters; ++it) {
    matvec(a, va, u);
#pragma unroll
    for (int i = 0; i < 4; ++i) va[i] = u[i];
    normalize(va);
    matvec(a, vb, u);
    const float d = sum4(va[0], va[1], va[2], va[3], u[0], u[1], u[2], u[3]);
#pragma unroll
    for (int i = 0; i < 4; ++i) vb[i] = sub(u[i], mul(d, va[i]));
    normalize(vb);
  }
  // Rayleigh-Ritz on span{va, vb}: the top eigenvector of the 2x2.
  float ua[4], ub[4];
  matvec(a, va, ua);
  matvec(a, vb, ub);
  const float ra = sum4(va[0], va[1], va[2], va[3], ua[0], ua[1], ua[2], ua[3]);
  const float rb = sum4(vb[0], vb[1], vb[2], vb[3], ua[0], ua[1], ua[2], ua[3]);
  const float rc = sum4(vb[0], vb[1], vb[2], vb[3], ub[0], ub[1], ub[2], ub[3]);
  const float t = mul(0.5f, atan2f(mul(2.f, rb), sub(ra, rc)));
  const float ct = cosf(t), st = sinf(t);
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = add(mul(ct, va[i]), mul(st, vb[i]));

  // Rotation from the (w, x, y, z) quaternion.
  const float ww = mul(v[0], v[0]), xx = mul(v[1], v[1]), yy = mul(v[2], v[2]),
              zz = mul(v[3], v[3]);
  const float wx = mul(v[0], v[1]), wy = mul(v[0], v[2]), wz = mul(v[0], v[3]);
  const float xy = mul(v[1], v[2]), xz = mul(v[1], v[3]), yz = mul(v[2], v[3]);
  const float R[9] = {
      sub(sub(add(ww, xx), yy), zz), mul(2.f, sub(xy, wz)),         mul(2.f, add(xz, wy)),
      mul(2.f, add(xy, wz)),         sub(add(sub(ww, xx), yy), zz), mul(2.f, sub(yz, wx)),
      mul(2.f, sub(xz, wy)),         mul(2.f, add(yz, wx)),         add(sub(sub(ww, xx), yy), zz),
  };
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    T[4 * r + 0] = R[3 * r + 0];
    T[4 * r + 1] = R[3 * r + 1];
    T[4 * r + 2] = R[3 * r + 2];
    T[4 * r + 3] =
        sub(cq[r], add(add(mul(R[3 * r], cp[0]), mul(R[3 * r + 1], cp[1])), mul(R[3 * r + 2], cp[2])));
  }
}

}  // namespace horn
