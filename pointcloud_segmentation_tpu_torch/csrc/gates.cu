// The gates of one Hough round for NVIDIA Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces no Pallas kernel.  pcs_round_gates replaces the XLA-fused gate
// chain of the JAX package's `_round` (pointcloud_segmentation_tpu/ops/hough.py),
// which the port ran as ~460 PyTorch ops a round (ops/gates.py
// `round_gates_plain`): from the winning cell to the acceptance gates, i.e.
// the cell centre, two distance masks each followed by an orthogonal
// least-squares fit (a masked mean, a masked 3x3 scatter and its principal
// eigenvector), the canonical direction, every inlier's t, the largest gap
// between t-adjacent inliers, the radius gate and the PCA and length gates.
//
// What bounds it on the H100: latency.  The work is a few passes over at most
// N points of 12 bytes (under 100 KB a round at N = 4,096) and five 3x3
// eigensolves, so neither bytes nor arithmetic bound it; the chain of
// dependent block-wide steps on one SM does.  As a chain of PyTorch ops each
// step was a graph node of its own (~1.35 us each on the H100).
//
// Design: one block of 1,024 threads, one launch a round.
//   * A thread keeps its first kPer points (i = tid + j * 1,024) in registers
//     across the phases; points past kPer * 1,024 are read again from device
//     memory in each phase (N up to 65,535 is served, as by the voting
//     kernels).
//   * Each masked sum (count, mean, scatter) is a warp butterfly then one
//     shared-memory exchange, after which every warp reduces the 32 warp
//     partials itself in one fixed order: one __syncthreads a reduction, and
//     every thread holds the same bits.
//   * Every thread runs the closed-form 3x3 eigensolves (ops/eigh3.py, float32,
//     in its op order) on those same bits, so the result needs no broadcast.
//   * The gap: pn is a function of t alone, so inliers of equal t have equal
//     pn and any order of ties gives the maximum adjacent gap of the stable
//     sort.  The nv inlier t's are compacted (a block scan of the mask) into
//     a key buffer padded with +inf to a power of two, bitonic-sorted in the
//     block, and the gap is the largest |pn(t[k]) - pn(t[k-1])|.  The keys
//     live in shared memory while a power of two at or above N fits in
//     kKeysShared bytes, else in a scratch buffer the wrapper allocates.  The
//     sorted ends are t_min and t_max.
//   * ifirst / ilast (the reference's radius quirk) are the first and last
//     inliers by point index, a min and a max over the block.
//
// Arithmetic.  The same operations as the chain in the same order, but for
// the order of the masked sums (the chain's PyTorch reductions have an order
// of their own, which already differs from numpy's in the oracle).  The
// distance tests are spelled as round-to-nearest intrinsics, so no product and
// sum are contracted into an FMA (the library is also built with
// --fmad=false); sqrtf, acosf and cosf are the accurate ones (no fast math).
// A division of a CUDA tensor by a Python float is a product with the float32
// reciprocal in PyTorch, so "/ 3.0" and "/ 6.0" in eigh3.py are "* kThird"
// and "* kSixth" here.  The points' type is a template: float32, or float64
// in the parity mode, whose eigensolves stay float32 as in the chain.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kGateThreads = 1024;
constexpr int kGateWarps = kGateThreads / 32;
constexpr int kPer = 4;                        // points a thread keeps in registers
constexpr size_t kKeysShared = 131072;         // most key bytes in shared memory
constexpr unsigned kFull = 0xffffffffu;
constexpr float kThird = 1.0f / 3.0f;          // PyTorch: x / 3.0 is x * RN(1/3)
constexpr float kSixth = 1.0f / 6.0f;
constexpr float kTwoPi3 = 2.0943951023931953f;

template <typename T>
struct GateArgs {
  const T* xs;               // (n, 3) centred cloud
  const T* p2;               // (n, 3) the cloud in the input frame
  const uint8_t* active;     // (n,)
  int n;
  const void* cell;          // the winner's flat cell, int32 or int64
  int cell64;
  const T* b0;               // (3,) the winner's direction
  const float* c1row;        // (3,) its plane basis
  const float* c2row;
  const T* dx;
  const T* dv;
  const float* half32;
  const float* dx32;
  const T* min_nb_denom;
  const T* rs;               // (nrs,) radius sizes
  int nrs;
  const T* shift;            // (3,)
  int minvotes;
  double min_pca;
  double rs_max;
  int nxs;
  T* keys;                   // scratch for the inlier keys, or nullptr: shared
  uint8_t* m2;               // out (n,)
  int* nv;                   // out (1,)
  uint8_t* flags;            // out: ok3, bx_zero, accept
  T* out;                    // out: a_w (3), bc (3), eig (3), t_min, t_max, closest, pca
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

// (x0 + x1) + x2 of the products: PyTorch's order for a sum over 3 elements
template <typename T>
__device__ __forceinline__ T dot3(T a0, T a1, T a2, T b0, T b1, T b2) {
  return add_rn(add_rn(mul_rn(a0, b0), mul_rn(a1, b1)), mul_rn(a2, b2));
}

// torch.clamp_min and torch.maximum, NaN passing through
template <typename T>
__device__ __forceinline__ T clamp_lo(T x, T lo) { return x < lo ? lo : x; }
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) { return (a != a || a > b) ? a : b; }
__device__ __forceinline__ float abs_of(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_of(double a) { return fabs(a); }

// sqrt(_line_distance2(x, a, b)) <= dx of ops/gates.py: point minus origin,
// its length along the unit direction, the perpendicular, its squared norm
template <typename T>
__device__ __forceinline__ bool near_line(T x0, T x1, T x2, const T (&a)[3], const T (&b)[3],
                                          T dx) {
  const T d0 = sub_rn(x0, a[0]), d1 = sub_rn(x1, a[1]), d2 = sub_rn(x2, a[2]);
  const T along = dot3(d0, d1, d2, b[0], b[1], b[2]);
  const T q0 = sub_rn(d0, mul_rn(along, b[0]));
  const T q1 = sub_rn(d1, mul_rn(along, b[1]));
  const T q2 = sub_rn(d2, mul_rn(along, b[2]));
  return sqrt_rn(dot3(q0, q1, q2, q0, q1, q2)) <= dx;
}

// symmetric 3x3: a00 a01 a02 a11 a12 a22
struct Sym3 {
  float a00, a01, a02, a11, a12, a22;
};

// ops/eigh3.py eigvalsh3, descending
__device__ void eigvalsh3(const Sym3& A, float (&e)[3]) {
  const float p1 = (A.a01 * A.a01 + A.a02 * A.a02) + A.a12 * A.a12;
  const float q = ((A.a00 + A.a11) + A.a22) * kThird;
  const float d0 = A.a00 - q, d1 = A.a11 - q, d2 = A.a22 - q;
  const float p2 = ((d0 * d0 + d1 * d1) + d2 * d2) + 2.0f * p1;
  const float p = sqrtf(clamp_lo(p2, 0.0f) * kSixth);
  const float sp = p > 0.0f ? p : 1.0f;
  const float b00 = d0 / sp, b11 = d1 / sp, b22 = d2 / sp;
  const float b01 = A.a01 / sp, b02 = A.a02 / sp, b12 = A.a12 / sp;
  const float det = (b00 * (b11 * b22 - b12 * b12) - b01 * (b01 * b22 - b12 * b02)) +
                    b02 * (b01 * b12 - b11 * b02);
  float r = det * 0.5f;
  r = r < -1.0f ? -1.0f : (r > 1.0f ? 1.0f : r);
  const float phi = acosf(r) * kThird;
  const float e1 = q + 2.0f * p * cosf(phi);
  const float e3 = q + 2.0f * p * cosf(phi + kTwoPi3);
  const float e2 = 3.0f * q - e1 - e3;
  const bool live = p > 0.0f;
  e[0] = live ? e1 : q;
  e[1] = live ? e2 : q;
  e[2] = live ? e3 : q;
}

__device__ __forceinline__ void cross(const float (&a)[3], const float (&b)[3], float (&c)[3]) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// ops/eigh3.py _eigvec_for: the largest cross product of two rows of
// A - lam I, normalised; e_x when every cross product is zero
__device__ void eigvec_for(const Sym3& A, float lam, float (&v)[3]) {
  const float off = lam * 0.0f;              // lam * I off the diagonal
  const float r0[3] = {A.a00 - lam, A.a01 - off, A.a02 - off};
  const float r1[3] = {A.a01 - off, A.a11 - lam, A.a12 - off};
  const float r2[3] = {A.a02 - off, A.a12 - off, A.a22 - lam};
  float c0[3], c1[3], c2[3];
  cross(r0, r1, c0);
  cross(r0, r2, c1);
  cross(r1, r2, c2);
  const float n0 = (c0[0] * c0[0] + c0[1] * c0[1]) + c0[2] * c0[2];
  const float n1 = (c1[0] * c1[0] + c1[1] * c1[1]) + c1[2] * c1[2];
  const float n2 = (c2[0] * c2[0] + c2[1] * c2[1]) + c2[2] * c2[2];
  float w0 = c0[0], w1 = c0[1], w2 = c0[2], nb = n0;   // the first max
  if (n1 > nb) {
    w0 = c1[0];
    w1 = c1[1];
    w2 = c1[2];
    nb = n1;
  }
  if (n2 > nb) {
    w0 = c2[0];
    w1 = c2[1];
    w2 = c2[2];
    nb = n2;
  }
  if (!(nb > 0.0f)) {
    w0 = 1.0f;
    w1 = 0.0f;
    w2 = 0.0f;
  }
  const float den = sqrtf(clamp_lo((w0 * w0 + w1 * w1) + w2 * w2, 1e-38f));
  v[0] = w0 / den;
  v[1] = w1 / den;
  v[2] = w2 / den;
}

template <typename V, int K>
__device__ __forceinline__ void warp_sum(V (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_xor_sync(kFull, v[k], off);
  }
}

// The block's sums of v, the same bits in every thread.  `part` is this
// reduction's own shared buffer, so no second barrier guards its reuse.
template <typename V, int K>
__device__ __forceinline__ void block_sum(V (&v)[K], V (*part)[K]) {
  warp_sum(v);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) part[threadIdx.x >> 5][k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = part[threadIdx.x & 31][k];
  warp_sum(v);
}

// The fit of a masked set: its float32 scatter about `mean`, accumulated
template <typename T>
__device__ __forceinline__ void add_scatter(float* s, T x0, T x1, T x2, const T (&mean)[3]) {
  const float c0 = static_cast<float>(x0 - mean[0]);
  const float c1 = static_cast<float>(x1 - mean[1]);
  const float c2 = static_cast<float>(x2 - mean[2]);
  s[0] += c0 * c0;
  s[1] += c0 * c1;
  s[2] += c0 * c2;
  s[3] += c1 * c1;
  s[4] += c1 * c2;
  s[5] += c2 * c2;
}

__device__ __forceinline__ Sym3 sym_of(const float* s) { return {s[0], s[1], s[2], s[3], s[4], s[5]}; }

// pn(t) = |a_w + t * bc| in the chain's order
template <typename T>
__device__ __forceinline__ T pn_of(T t, const T (&a)[3], const T (&b)[3]) {
  const T q0 = a[0] + t * b[0], q1 = a[1] + t * b[1], q2 = a[2] + t * b[2];
  return sqrt_rn((q0 * q0 + q1 * q1) + q2 * q2);
}

template <typename T>
__global__ void __launch_bounds__(kGateThreads) gates_kernel(const GateArgs<T> g) {
  extern __shared__ __align__(16) unsigned char gate_smem[];
  __shared__ T part1[kGateWarps][4];       // m1: count, sum of x, y, z
  __shared__ float part2[kGateWarps][6];   // m1's scatter
  __shared__ T part3[kGateWarps][6];       // m2: sums of Xs and of P2
  __shared__ int part_cnt[kGateWarps], part_first[kGateWarps], part_last[kGateWarps];
  __shared__ float part4[kGateWarps][12];  // m2's two scatters
  __shared__ T part5[kGateWarps][1];       // the largest gap

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = g.n;
  const int tail0 = kPer * kGateThreads;   // first point read anew in each phase
  T* keys = g.keys != nullptr ? g.keys : reinterpret_cast<T*>(gate_smem);
  const T dx = *g.dx;

  // the winner's cell centre on its direction's plane (float32 by spec)
  const long long cell = g.cell64 ? *static_cast<const long long*>(g.cell)
                                  : static_cast<long long>(*static_cast<const int*>(g.cell));
  const float xi = static_cast<float>(cell / g.nxs), yi = static_cast<float>(cell % g.nxs);
  const float half = *g.half32, dx32 = *g.dx32;
  const float xc = (xi + 0.5f) * dx32 - half, yc = (yi + 0.5f) * dx32 - half;
  T a0[3], b0u[3];
  {
    const T b[3] = {g.b0[0], g.b0[1], g.b0[2]};
    const T nb = sqrt_rn(dot3(b[0], b[1], b[2], b[0], b[1], b[2]));
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a0[k] = static_cast<T>(xc * g.c1row[k] + yc * g.c2row[k]);
      b0u[k] = b[k] / nb;
    }
  }

  T px[kPer], py[kPer], pz[kPer];
  unsigned act = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = tid + j * kGateThreads;
    px[j] = py[j] = pz[j] = T(0);
    if (i < n) {
      px[j] = g.xs[3 * i];
      py[j] = g.xs[3 * i + 1];
      pz[j] = g.xs[3 * i + 2];
      act |= (g.active[i] != 0 ? 1u : 0u) << j;
    }
  }

  // refinement 1: the mask about the cell's line, its count and sum
  unsigned m1 = 0;
  T s1[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (((act >> j) & 1u) && near_line(px[j], py[j], pz[j], a0, b0u, dx)) {
      m1 |= 1u << j;
      s1[0] += T(1);
      s1[1] += px[j];
      s1[2] += py[j];
      s1[3] += pz[j];
    }
  }
  for (int i = tail0 + tid; i < n; i += kGateThreads) {
    const T x0 = g.xs[3 * i], x1 = g.xs[3 * i + 1], x2 = g.xs[3 * i + 2];
    if (g.active[i] && near_line(x0, x1, x2, a0, b0u, dx)) {
      s1[0] += T(1);
      s1[1] += x0;
      s1[2] += x1;
      s1[3] += x2;
    }
  }
  block_sum(s1, part1);
  const bool ok0 = s1[0] > T(0);
  T mean1[3];
  {
    const T cnt = clamp_lo(s1[0], T(1));
#pragma unroll
    for (int k = 0; k < 3; ++k) mean1[k] = s1[k + 1] / cnt;
  }
  float sc1[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if ((m1 >> j) & 1u) add_scatter(sc1, px[j], py[j], pz[j], mean1);
  }
  for (int i = tail0 + tid; i < n; i += kGateThreads) {
    const T x0 = g.xs[3 * i], x1 = g.xs[3 * i + 1], x2 = g.xs[3 * i + 2];
    if (g.active[i] && near_line(x0, x1, x2, a0, b0u, dx)) add_scatter(sc1, x0, x1, x2, mean1);
  }
  block_sum(sc1, part2);
  T b1u[3];
  bool ok1;
  {
    const Sym3 S = sym_of(sc1);
    float e[3], v[3];
    eigvalsh3(S, e);
    eigvec_for(S, e[0], v);
    ok1 = ok0 && static_cast<T>(e[0]) > T(0);
    const T b[3] = {static_cast<T>(v[0]), static_cast<T>(v[1]), static_cast<T>(v[2])};
    const T nb = sqrt_rn(dot3(b[0], b[1], b[2], b[0], b[1], b[2]));
#pragma unroll
    for (int k = 0; k < 3; ++k) b1u[k] = b[k] / nb;
  }

  // refinement 2: the inlier mask, its count, first and last index, the sums
  // of both clouds over it, and each thread's place in the inliers' order
  unsigned m2 = 0;
  int mine = 0, first = INT_MAX, last = -1;
  T s3[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = tid + j * kGateThreads;
    if (i < n) {
      const bool in = ((act >> j) & 1u) && near_line(px[j], py[j], pz[j], mean1, b1u, dx);
      g.m2[i] = in;
      if (in) {
        m2 |= 1u << j;
        ++mine;
        first = min(first, i);
        last = i;
        s3[0] += px[j];
        s3[1] += py[j];
        s3[2] += pz[j];
        s3[3] += g.p2[3 * i];
        s3[4] += g.p2[3 * i + 1];
        s3[5] += g.p2[3 * i + 2];
      }
    }
  }
  for (int i = tail0 + tid; i < n; i += kGateThreads) {
    const T x0 = g.xs[3 * i], x1 = g.xs[3 * i + 1], x2 = g.xs[3 * i + 2];
    const bool in = g.active[i] && near_line(x0, x1, x2, mean1, b1u, dx);
    g.m2[i] = in;
    if (in) {
      ++mine;
      first = min(first, i);
      last = i;
      s3[0] += x0;
      s3[1] += x1;
      s3[2] += x2;
      s3[3] += g.p2[3 * i];
      s3[4] += g.p2[3 * i + 1];
      s3[5] += g.p2[3 * i + 2];
    }
  }
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  first = __reduce_min_sync(kFull, first);
  last = __reduce_max_sync(kFull, last);
  warp_sum(s3);
  if (lane == 31) part_cnt[warp] = incl;
  if (lane == 0) {
    part_first[warp] = first;
    part_last[warp] = last;
#pragma unroll
    for (int k = 0; k < 6; ++k) part3[warp][k] = s3[k];
  }
  __syncthreads();
  int nv, pos;
  {
    const int c = part_cnt[lane];
    int ci = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, ci, off);
      if (lane >= off) ci += v;
    }
    nv = __shfl_sync(kFull, ci, 31);
    pos = __shfl_sync(kFull, ci - c, warp) + incl - mine;   // this thread's first slot
    first = __reduce_min_sync(kFull, part_first[lane]);
    last = __reduce_max_sync(kFull, part_last[lane]);
#pragma unroll
    for (int k = 0; k < 6; ++k) s3[k] = part3[lane][k];
    warp_sum(s3);
  }
  const int ifirst = nv > 0 ? first : 0, ilast = nv > 0 ? last : n - 1;
  T mean2[3], meanp[3];
  const T cnt2 = clamp_lo(static_cast<T>(nv), T(1));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    mean2[k] = s3[k] / cnt2;
    meanp[k] = s3[3 + k] / cnt2;
  }

  // the second fit and the covariance of the inliers in the input frame
  float sc4[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) sc4[k] = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if ((m2 >> j) & 1u) {
      const int i = tid + j * kGateThreads;
      add_scatter(sc4, px[j], py[j], pz[j], mean2);
      add_scatter(sc4 + 6, g.p2[3 * i], g.p2[3 * i + 1], g.p2[3 * i + 2], meanp);
    }
  }
  for (int i = tail0 + tid; i < n; i += kGateThreads) {
    if (g.m2[i]) {
      add_scatter(sc4, g.xs[3 * i], g.xs[3 * i + 1], g.xs[3 * i + 2], mean2);
      add_scatter(sc4 + 6, g.p2[3 * i], g.p2[3 * i + 1], g.p2[3 * i + 2], meanp);
    }
  }
  block_sum(sc4, part4);
  T bc[3], aw[3], eig[3];
  bool ok3;
  {
    const Sym3 S = sym_of(sc4);
    float e[3], v[3];
    eigvalsh3(S, e);
    eigvec_for(S, e[0], v);
    ok3 = ok1 && nv >= g.minvotes && static_cast<T>(e[0]) > T(0);
    // canonical sign: the first nonzero component positive (D-SIGN)
    const T b[3] = {static_cast<T>(v[0]), static_cast<T>(v[1]), static_cast<T>(v[2])};
    T sign = T(1);
    for (int k = 2; k >= 0; --k) sign = b[k] > T(0) ? T(1) : (b[k] < T(0) ? T(-1) : sign);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      bc[k] = b[k] * sign;
      aw[k] = mean2[k] + g.shift[k];
    }
    const float denom = clamp_lo(static_cast<float>(cnt2) - 1.0f, 1.0f);
    const Sym3 C = {sc4[6] / denom, sc4[7] / denom, sc4[8] / denom,
                    sc4[9] / denom, sc4[10] / denom, sc4[11] / denom};
    float w[3];
    eigvalsh3(C, w);
#pragma unroll
    for (int k = 0; k < 3; ++k) eig[k] = static_cast<T>(w[k]);
  }
  const T bb = clamp_lo(dot3(bc[0], bc[1], bc[2], bc[0], bc[1], bc[2]), T(1e-30));
  const bool bx_zero = bc[0] == T(0);
  const T den0 = bx_zero ? T(1) : bc[0];
  // t of an inlier, and its distance from the line (the chain's prad)
  auto t_of = [&](int i, T* prad) {
    const T q0 = g.p2[3 * i], q1 = g.p2[3 * i + 1], q2 = g.p2[3 * i + 2];
    const T along = ((q0 - aw[0]) * bc[0] + (q1 - aw[1]) * bc[1]) + (q2 - aw[2]) * bc[2];
    const T ta = along / bb;
    const T j0 = aw[0] + ta * bc[0], j1 = aw[1] + ta * bc[1], j2 = aw[2] + ta * bc[2];
    if (prad != nullptr) {
      const T r0 = j0 - q0, r1 = j1 - q1, r2 = j2 - q2;
      *prad = sqrt_rn(clamp_lo((r0 * r0 + r1 * r1) + r2 * r2, T(0)));
    }
    return (j0 - aw[0]) / den0;
  };

  // the inliers' t into the key buffer, +inf up to a power of two
  int slot = pos;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if ((m2 >> j) & 1u) keys[slot++] = t_of(tid + j * kGateThreads, nullptr);
  }
  for (int i = tail0 + tid; i < n; i += kGateThreads) {
    if (g.m2[i]) keys[slot++] = t_of(i, nullptr);
  }
  int size = 1;
  while (size < nv) size <<= 1;
  for (int i = nv + tid; i < size; i += kGateThreads) keys[i] = INFINITY;
  __syncthreads();

  // bitonic sort, ascending; ties in any order
  for (int k = 2; k <= size; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = tid; q < size / 2; q += kGateThreads) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));   // bit j of i clear
        const T a = keys[i], b = keys[i + j];
        if ((a > b) == ((i & k) == 0)) {
          keys[i] = b;
          keys[i + j] = a;
        }
      }
      __syncthreads();
    }
  }

  // the largest gap between t-adjacent inliers
  T gap[1] = {T(0)};
  for (int q = 1 + tid; q < nv; q += kGateThreads) {
    gap[0] = nan_max(gap[0], abs_of(pn_of(keys[q], aw, bc) - pn_of(keys[q - 1], aw, bc)));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) gap[0] = nan_max(gap[0], __shfl_xor_sync(kFull, gap[0], off));
  if (lane == 0) part5[warp][0] = gap[0];
  __syncthreads();
  if (tid != 0) return;
  T max_gap = part5[0][0];
  for (int w = 1; w < kGateWarps; ++w) max_gap = nan_max(max_gap, part5[w][0]);
  if (nv <= 1) max_gap = T(0);

  // the gates
  const T t_min = nv > 0 ? keys[0] : T(0), t_max = nv > 0 ? keys[nv - 1] : T(0);
  T prad_first, prad_last;
  t_of(ifirst, &prad_first);
  t_of(ilast, &prad_last);
  const T radius = nan_max(prad_first, prad_last);
  T closest = g.rs[0], min_diff = abs_of(radius - g.rs[0]);
  const T diff0 = min_diff;
  for (int r = 1; r < g.nrs; ++r) {
    const T d = abs_of(radius - g.rs[r]);
    if (d < min_diff) {
      min_diff = d;
      closest = g.rs[r];
    }
  }
  const T dv = *g.dv;
  const T max_radius = clamp_lo(diff0, static_cast<T>(g.rs_max));   // reference quirk h:298-307
  const bool gate_r = (min_diff < dv) && (max_radius <= closest) && (max_gap < T(2) * dv);
  const T pca = eig[0] / clamp_lo((eig[0] + eig[1]) + eig[2], T(1e-30));
  T len2 = T(0);
  {
    const T p10 = t_min * bc[0] + aw[0], p11 = t_min * bc[1] + aw[1], p12 = t_min * bc[2] + aw[2];
    const T p20 = t_max * bc[0] + aw[0], p21 = t_max * bc[1] + aw[1], p22 = t_max * bc[2] + aw[2];
    const T d0 = p20 - p10, d1 = p21 - p11, d2 = p22 - p12;
    len2 = (d0 * d0 + d1 * d1) + d2 * d2;
  }
  const T seg_len = sqrt_rn(len2);
  const int min_nb = static_cast<int>(T(2) * closest * seg_len / *g.min_nb_denom);
  const bool accept = gate_r && pca > static_cast<T>(g.min_pca) && nv > min_nb;

  *g.nv = nv;
  g.flags[0] = ok3;
  g.flags[1] = bx_zero;
  g.flags[2] = accept;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g.out[k] = aw[k];
    g.out[3 + k] = bc[k];
    g.out[6 + k] = eig[k];
  }
  g.out[9] = t_min;
  g.out[10] = t_max;
  g.out[11] = closest;
  g.out[12] = pca;
}

template <typename T>
int launch_gates(GateArgs<T> g, void* stream) {
  if (g.n < 1 || g.n > 65535 || g.nrs < 1 || g.nxs < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t size = 1;
  while (size < static_cast<size_t>(g.n)) size <<= 1;
  size_t smem = 0;
  if (size * sizeof(T) <= kKeysShared) {
    smem = size * sizeof(T);
    g.keys = nullptr;
  } else if (g.keys == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);   // the wrapper owes a scratch buffer
  }
  static const cudaError_t ceiling = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(gates_kernel<T>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kKeysShared));
  if (ceiling != cudaSuccess) return static_cast<int>(ceiling);
  gates_kernel<T><<<1, kGateThreads, smem, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
GateArgs<T> gate_args(const void* xs, const void* p2, const void* active, int n,
                      const void* cell, int cell64, const void* b0, const void* c1row,
                      const void* c2row, const void* dx, const void* dv, const void* half32,
                      const void* dx32, const void* min_nb_denom, const void* rs, int nrs,
                      const void* shift, int minvotes, double min_pca, double rs_max, int nxs,
                      void* keys, void* m2, void* nv, void* flags, void* out) {
  GateArgs<T> g;
  g.xs = static_cast<const T*>(xs);
  g.p2 = static_cast<const T*>(p2);
  g.active = static_cast<const uint8_t*>(active);
  g.n = n;
  g.cell = cell;
  g.cell64 = cell64;
  g.b0 = static_cast<const T*>(b0);
  g.c1row = static_cast<const float*>(c1row);
  g.c2row = static_cast<const float*>(c2row);
  g.dx = static_cast<const T*>(dx);
  g.dv = static_cast<const T*>(dv);
  g.half32 = static_cast<const float*>(half32);
  g.dx32 = static_cast<const float*>(dx32);
  g.min_nb_denom = static_cast<const T*>(min_nb_denom);
  g.rs = static_cast<const T*>(rs);
  g.nrs = nrs;
  g.shift = static_cast<const T*>(shift);
  g.minvotes = minvotes;
  g.min_pca = min_pca;
  g.rs_max = rs_max;
  g.nxs = nxs;
  g.keys = static_cast<T*>(keys);
  g.m2 = static_cast<uint8_t*>(m2);
  g.nv = static_cast<int*>(nv);
  g.flags = static_cast<uint8_t*>(flags);
  g.out = static_cast<T*>(out);
  return g;
}

}  // namespace

// One launch on `stream` (no synchronise); returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernel does not take.  is64: the
// points' type is float64 (else float32).  keys: a scratch buffer of the
// next power of two at or above n elements of the points' type, needed only
// when that many do not fit in 131,072 bytes (ops/gates.py allocates it).
extern "C" int pcs_round_gates(int is64, const void* xs, const void* p2, const void* active,
                               int n, const void* cell, int cell64, const void* b0,
                               const void* c1row, const void* c2row, const void* dx,
                               const void* dv, const void* half32, const void* dx32,
                               const void* min_nb_denom, const void* rs, int nrs,
                               const void* shift, int minvotes, double min_pca, double rs_max,
                               int nxs, void* keys, void* m2, void* nv, void* flags, void* out,
                               void* stream) {
  if (is64) {
    return launch_gates(gate_args<double>(xs, p2, active, n, cell, cell64, b0, c1row, c2row, dx,
                                          dv, half32, dx32, min_nb_denom, rs, nrs, shift,
                                          minvotes, min_pca, rs_max, nxs, keys, m2, nv, flags,
                                          out), stream);
  }
  return launch_gates(gate_args<float>(xs, p2, active, n, cell, cell64, b0, c1row, c2row, dx, dv,
                                       half32, dx32, min_nb_denom, rs, nrs, shift, minvotes,
                                       min_pca, rs_max, nxs, keys, m2, nv, flags, out), stream);
}
