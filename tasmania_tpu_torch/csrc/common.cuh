// Shared device helpers of the port's kernels: the relaxed-BC select, the
// positivity clip, the third- and fifth-order upwind fluxes and their
// divergences.  Every formula keeps the operation order of the plain PyTorch
// versions in tasmania_tpu_torch/ops/, so kernel and plain version differ
// only by FMA contraction in the stencils; the column scans keep the
// roundings of a level-by-level sum (mul_rn/add_rn).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tt {

// dtype codes shared with the ctypes wrappers (tasmania_tpu_torch/ops/_lib.py)
constexpr int kFloat32 = 0;
constexpr int kFloat64 = 1;

template <typename T>
__device__ __forceinline__ T enforce(T phi, T gamma, T ref) {
  // three-way select, not a lerp: gamma == 0 keeps phi, gamma == 1 pins ref
  if (gamma == T(0)) return phi;
  if (gamma == T(1)) return ref;
  return phi - gamma * (phi - ref);
}

template <typename T>
__device__ __forceinline__ T clip_pos(T x) {
  return x > T(0) ? x : T(0);
}

__device__ __forceinline__ float tpow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double tpow(double a, double b) { return pow(a, b); }

// a product and a sum rounded separately, never contracted into an FMA: the
// column scans keep the roundings of their plain PyTorch version
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// fifth-order upwind flux at a face with velocity w and the six cell values
// pm3..pp2 around it (face between pm1 and p0)
template <typename T>
__device__ __forceinline__ T flux5(T w, T pm3, T pm2, T pm1, T p0, T pp1, T pp2) {
  T flux6 = w / T(60) * (T(37) * (p0 + pm1) - T(8) * (pp1 + pm2) + (pp2 + pm3));
  T aw = w < T(0) ? -w : w;
  return flux6 - aw / T(60) * (T(10) * (p0 - pm1) - T(5) * (pp1 - pm2) + (pp2 - pm3));
}

// a field read through the cell index c of an (nx, ny, nz) array
template <typename T>
struct Plain {
  const T* p;
  __device__ __forceinline__ T operator()(int64_t c) const { return p[c]; }
};

// the water density clip(s * q), formed on the fly from s and q
template <typename T>
struct ClipProduct {
  const T* s;
  const T* q;
  __device__ __forceinline__ T operator()(int64_t c) const { return clip_pos(s[c] * q[c]); }
};

// flux divergence of cell (i, j, k): x faces i and i+1 (u is (nx+1, ny, nz)),
// y faces j and j+1 (v is (nx, ny+1, nz)); needs 3 <= i, j and i, j < n - 3
template <typename T, typename F>
__device__ __forceinline__ T div5(const T* __restrict__ u, const T* __restrict__ v, F phi,
                                  int i, int j, int k, int nx, int ny, int nz, T dx, T dy) {
  const int64_t sx = int64_t(ny) * nz;  // x stride of a cell field
  const int64_t c = int64_t(i) * sx + int64_t(j) * nz + k;
  T fx[2], fy[2];
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int64_t cf = c + f * sx;  // cell right of face i + f
    fx[f] = flux5(u[int64_t(i + f) * sx + int64_t(j) * nz + k], phi(cf - 3 * sx), phi(cf - 2 * sx),
                  phi(cf - sx), phi(cf), phi(cf + sx), phi(cf + 2 * sx));
    const int64_t cg = c + f * nz;  // cell above face j + f
    fy[f] = flux5(v[(int64_t(i) * (ny + 1) + j + f) * nz + k], phi(cg - 3 * nz), phi(cg - 2 * nz),
                  phi(cg - nz), phi(cg), phi(cg + nz), phi(cg + 2 * nz));
  }
  return (fx[1] - fx[0]) / dx + (fy[1] - fy[0]) / dy;
}

// third-order upwind flux at a face with velocity w and the four cell values
// pm2..pp1 around it (face between pm1 and p0)
template <typename T>
__device__ __forceinline__ T flux3(T w, T pm2, T pm1, T p0, T pp1) {
  T flux4 = w / T(12) * (T(7) * (p0 + pm1) - (pp1 + pm2));
  T aw = w < T(0) ? -w : w;
  return flux4 - aw / T(12) * (T(3) * (p0 - pm1) - (pp1 - pm2));
}

// flux divergence of cell (i, j, k) with upwind fluxes of Order 3 or 5 (the
// fifth order is div5 itself); needs e <= i, j and i, j < n - e, e = 2 for
// the third order
template <int Order, typename T, typename F>
__device__ __forceinline__ T div_upwind(const T* __restrict__ u, const T* __restrict__ v, F phi,
                                        int i, int j, int k, int nx, int ny, int nz, T dx, T dy) {
  static_assert(Order == 3 || Order == 5, "upwind order 3 or 5");
  if constexpr (Order == 5) {
    return div5(u, v, phi, i, j, k, nx, ny, nz, dx, dy);
  } else {
    const int64_t sx = int64_t(ny) * nz;
    const int64_t c = int64_t(i) * sx + int64_t(j) * nz + k;
    T fx[2], fy[2];
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const int64_t cf = c + f * sx;
      fx[f] = flux3(u[int64_t(i + f) * sx + int64_t(j) * nz + k], phi(cf - 2 * sx), phi(cf - sx),
                    phi(cf), phi(cf + sx));
      const int64_t cg = c + f * nz;
      fy[f] = flux3(v[(int64_t(i) * (ny + 1) + j + f) * nz + k], phi(cg - 2 * nz), phi(cg - nz),
                    phi(cg), phi(cg + nz));
    }
    return (fx[1] - fx[0]) / dx + (fy[1] - fy[0]) / dy;
  }
}

}  // namespace tt
