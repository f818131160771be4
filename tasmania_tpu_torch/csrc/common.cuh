// Shared device helpers of the port's kernels: the relaxed-BC select, the
// positivity clip, the third- and fifth-order upwind fluxes and their
// divergences, the Shapiro filter (smoothing.cu, smooth_smag.cu), the
// asynchronous staging of a column tile's stencil cross in shared memory,
// and the tiling of the flux-form advection kernels (si_stage.cu's second
// launch, advection.cu's advection of the fields and its momentum step and
// epilogue: a tile's faces, each face flux once a block).  smag.cuh holds the
// Smagorinsky tile of smagorinsky.cu and smooth_smag.cu, column.cuh the
// column algebra of vertical advection and sedimentation.  Every formula
// keeps the operation order of the plain PyTorch versions in
// tasmania_tpu_torch/ops/, so kernel and plain version differ only by FMA
// contraction in the stencils; the column scans keep the roundings of a
// level-by-level sum (mul_rn/add_rn).  A merged kernel calls the same
// helpers as the kernels it merges, so it gives their bits.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

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
template <typename T>
__device__ __forceinline__ T tsqrt(T x) { return sqrt(x); }

// a product and a sum rounded separately, never contracted into an FMA: the
// column scans keep the roundings of their plain PyTorch version
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// fifth-order upwind flux at a face with velocity w and the six cell values
// pm3..pp2 around it (face between pm1 and p0): w/60 (...) - |w|/60 (...),
// with |w|/60 taken as |w/60| (bitwise the same: IEEE division is
// symmetric in sign), one division instead of two; flux5_scaled takes w/60
// itself, for a face whose velocity several fields share
template <typename T>
__device__ __forceinline__ T flux5_scaled(T w60, T pm3, T pm2, T pm1, T p0, T pp1, T pp2) {
  const T flux6 = w60 * (T(37) * (p0 + pm1) - T(8) * (pp1 + pm2) + (pp2 + pm3));
  const T aw60 = w60 < T(0) ? -w60 : w60;
  return flux6 - aw60 * (T(10) * (p0 - pm1) - T(5) * (pp1 - pm2) + (pp2 - pm3));
}
template <typename T>
__device__ __forceinline__ T flux5(T w, T pm3, T pm2, T pm1, T p0, T pp1, T pp2) {
  return flux5_scaled(w / T(60), pm3, pm2, pm1, p0, pp1, pp2);
}

// a field read through the cell index c of an (nx, ny, nz) array
template <typename T>
struct Plain {
  const T* p;
  __device__ __forceinline__ T operator()(int64_t c) const { return p[c]; }
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

// order-N 2-D Shapiro filter with the level's coefficient g from its 4N + 1
// taps, tap(0) the cell, tap(1 + o) and tap(1 + 2N + o) its x- and
// y-shifts by Shapiro<N>::off(o): (1 - cw g) phi + sum_o w_o g phi(x-shifts),
// then the y-shifts, in the order of fused_smoothing_plain
// (ops/smoothing_step.py: CW_2D, WEIGHTS)
template <int N>
struct Shapiro {
  static_assert(N >= 1 && N <= 3, "Shapiro order 1-3");
  static constexpr int taps = 4 * N + 1;
  __device__ static constexpr int off(int o) { return o < N ? o - N : o - N + 1; }
};
template <typename T, int N, typename F>
__device__ __forceinline__ T shapiro_taps(F tap, T g) {
  constexpr T cw = N == 1 ? T(1.0) : (N == 2 ? T(0.75) : T(0.625));
  constexpr int noff = 2 * N;
  const T w1[2] = {T(0.25), T(0.25)};
  const T w2[4] = {T(-0.0625), T(0.25), T(0.25), T(-0.0625)};
  const T w3[6] = {T(0.015625), T(-0.09375), T(0.234375), T(0.234375), T(-0.09375), T(0.015625)};
  const T* wts = N == 1 ? w1 : (N == 2 ? w2 : w3);
  T acc = (T(1) - cw * g) * tap(0);
#pragma unroll
  for (int o = 0; o < noff; ++o) acc = acc + wts[o] * g * tap(1 + o);
#pragma unroll
  for (int o = 0; o < noff; ++o) acc = acc + wts[o] * g * tap(1 + noff + o);
  return acc;
}

// the filter of the cell at index c of phi (sx, sy: the x and y strides); phi
// is a field in device memory (I = int64_t) or a tile in shared memory (I =
// int)
template <typename T, int N, typename I>
__device__ __forceinline__ T shapiro(const T* __restrict__ phi, I c, I sx, I sy, T g) {
  return shapiro_taps<T, N>(
      [&](int t) {
        if (t == 0) return phi[c];
        return t <= 2 * N ? phi[c + Shapiro<N>::off(t - 1) * sx] : phi[c + Shapiro<N>::off(t - 1 - 2 * N) * sy];
      },
      g);
}

// Bytes (4, 8 or 16) copied from device to shared memory with cp.async (no
// register holds them; both addresses aligned to Bytes), cached in L1 and
// L2 or, with L2Only and 16 bytes, in L2 alone (cp.async.cg: a block that
// stages whole crosses leaves L1 to its other loads); cp_async_commit
// closes the thread's group of copies, cp_async_wait<N> waits until at most
// N of its groups are in flight, and a __syncthreads() must follow before
// other threads read the copies
template <int Bytes, bool L2Only = false>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  static_assert(Bytes == 4 || Bytes == 8 || Bytes == 16, "cp.async of 4, 8 or 16 bytes");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (L2Only && Bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(Bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(Bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// fn(e) for e = threadIdx.x + r * Threads below n, the trip count known to
// the compiler (so that a loop of copies is unrolled and all are in flight)
template <int n, int Threads, typename F>
__device__ __forceinline__ void strided(F fn) {
#pragma unroll
  for (int r = 0; r < (n + Threads - 1) / Threads; ++r) {
    const int e = int(threadIdx.x) + r * Threads;
    if (n % Threads == 0 || e < n) fn(e);
  }
}

// A column tile's stencil cross in shared memory: the TX x TY columns at
// (x0, y0) widened by H in x along the tile's rows and by H in y along its
// columns (the corners, which no x- or y-stencil reads, are left out), levels
// k0 .. k0 + KL; the tile may reach past the grid on any side (a tile
// widened by a ring).  It is laid out as the rectangle (TX + 2H) x (TY + 2H) x KL,
// the level fastest; element (rx, ry, kk) holds cell (x0 - H + rx, y0 - H +
// ry, k0 + kk).  fn(m, g) is called for each run of V levels of the cross
// inside the (nx, ny, nz) grid, with m its first element's index in the
// rectangle and g its first cell's index in the field (32 bits: the caller
// checks nx ny nz < 2^31).  V divides KL; with V > 1 the caller guarantees
// that V divides nz (so a run lies wholly above or below nz).  With k the
// fastest thread index, a warp's runs are contiguous along k.
template <int TX, int TY, int KL, int H, int V, int Threads, typename F>
__device__ __forceinline__ void for_cross(int x0, int y0, int k0, int nx, int ny, int nz, F fn) {
  static_assert(KL % V == 0, "whole runs of V levels");
  constexpr int RY = TY + 2 * H, KV = KL / V;
  const int sx = ny * nz;
  strided<(TX + 2 * H) * TY * KV, Threads>([&](int e) {  // the tile's rows, widened in x
    const int kk = e % KV * V, col = e / KV;
    const int rx = col / TY, ry = H + col % TY;
    const int i = x0 - H + rx, j = y0 - H + ry, k = k0 + kk;
    if (unsigned(i) < unsigned(nx) && unsigned(j) < unsigned(ny) && k < nz)
      fn((rx * RY + ry) * KL + kk, i * sx + j * nz + k);
  });
  strided<TX * 2 * H * KV, Threads>([&](int e) {  // the tile's columns, widened in y
    const int kk = e % KV * V, col = e / KV;
    const int rx = H + col % TX, q = col / TX;
    const int ry = q < H ? q : TY + q;
    const int i = x0 - H + rx, j = y0 - H + ry, k = k0 + kk;
    if (unsigned(i) < unsigned(nx) && unsigned(j) < unsigned(ny) && k < nz)
      fn((rx * RY + ry) * KL + kk, i * sx + j * nz + k);
  });
}

// whether every pointer is aligned to 16 bytes and nz is a whole number of
// 16-byte runs of T: the condition of for_cross's and the kernels' 16-byte
// copies
template <typename T>
inline bool runs_of_16(int nz, std::initializer_list<const void*> ptrs) {
  if (nz % (16 / int(sizeof(T))) != 0) return false;
  for (const void* p : ptrs)
    if (p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// ---- the tiling of the flux-form advection kernels -------------------------

// a block's tile: TX x TY columns, KL levels (the fastest thread index), and
// its threads; H is the upwind stencil's reach (3 for the fifth order, 2 for
// the third); the cross of an advected field (RX x RY x KL, for_cross's
// rectangle), the x faces of the tile's rows (u, fluxes: (TX + 1) x TY x KL)
// and the y faces of its columns (v, fluxes: TX x (TY + 1) x KL), the level
// fastest in each
template <int TX_, int TY_, int KL_, int Threads_, int H_ = 3>
struct Shape {
  static_assert(H_ == 2 || H_ == 3, "third- or fifth-order stencils");
  static constexpr int TX = TX_, TY = TY_, KL = KL_, Threads = Threads_, H = H_;
  static constexpr int RY = TY + 2 * H;
  static constexpr int kRect = (TX + 2 * H) * RY * KL;
  static constexpr int kFX = (TX + 1) * TY * KL;
  static constexpr int kFY = TX * (TY + 1) * KL;
  static constexpr int kCells = TX * TY * KL;
};

// the tile's place: its first column and level, and the grid
struct Tile {
  int x0, y0, k0, nx, ny, nz, nb;
  __device__ bool interior(int i, int j) const {
    return i >= nb && i < nx - nb && j >= nb && j < ny - nb;
  }
};

// A thread's place in the tile, fixed for the block: level kk of row ty in
// the columns tx = txg + G p (p < P), and the faces whose fluxes it computes,
// each face once in the block: the x faces tx_p of its row (the last group
// also the tile's right face TX) and the y faces ty of its columns (the last
// row also the tile's top face TY).  A face is computed where an interior
// cell reads it: x face i (between cells i-1 and i) of row j for nb <= i <=
// nx-nb, nb <= j < ny-nb; y face j of column i for nb <= i < nx-nb, nb <= j
// <= ny-nb.  Their stencils lie inside the grid (nb >= H).
template <class S>
struct Lane {
  static constexpr int G = S::Threads / (S::KL * S::TY);
  static constexpr int P = S::TX / G;
  static_assert(G * S::KL * S::TY == S::Threads && G * P == S::TX, "the threads tile the block");
  int kk, ty, txg;
  unsigned fx_ok = 0;  // bit p: x face tx_p; bit P: the right face
  unsigned fy_ok = 0;  // bit p: y face ty of column p; bit P + p: its top face
  __device__ explicit Lane(const Tile& t)
      : kk(threadIdx.x % S::KL), ty(threadIdx.x / S::KL % S::TY), txg(threadIdx.x / (S::KL * S::TY)) {
    const int j = t.y0 + ty;
    const bool row = j >= t.nb && j < t.ny - t.nb;
    const bool xface_cols = t.x0 + S::TX >= t.nb && t.x0 + S::TX <= t.nx - t.nb;
    const bool top = ty == S::TY - 1 && t.y0 + S::TY >= t.nb && t.y0 + S::TY <= t.ny - t.nb;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = t.x0 + tx(p);
      if (row && i >= t.nb && i <= t.nx - t.nb) fx_ok |= 1u << p;
      if (i >= t.nb && i < t.nx - t.nb) {
        if (j >= t.nb && j <= t.ny - t.nb) fy_ok |= 1u << p;
        if (top) fy_ok |= 1u << (P + p);
      }
    }
    if (txg == G - 1 && row && xface_cols) fx_ok |= 1u << P;
  }
  __device__ int tx(int p) const { return txg + G * p; }
};

// xface(fx) for each x face and yface(tx, fy) for each y face of the thread
template <class S, typename XF, typename YF>
__device__ __forceinline__ void lane_faces(const Lane<S>& L, XF xface, YF yface) {
#pragma unroll
  for (int p = 0; p < L.P; ++p) {
    if (L.fx_ok >> p & 1u) xface(L.tx(p));
    if (L.fy_ok >> p & 1u) yface(L.tx(p), L.ty);
    if (L.fy_ok >> (L.P + p) & 1u) yface(L.tx(p), S::TY);
  }
  if (L.fx_ok >> L.P & 1u) xface(S::TX);
}

// the index of x face fx and y face (tx, fy) of the thread's row and level
// in U, FX and V, FY
template <class S>
__device__ __forceinline__ int xface_at(const Lane<S>& L, int fx) {
  return (fx * S::TY + L.ty) * S::KL + L.kk;
}
template <class S>
__device__ __forceinline__ int yface_at(const Lane<S>& L, int tx, int fy) {
  return (tx * (S::TY + 1) + fy) * S::KL + L.kk;
}

// u/60 and v/60 in place at the thread's faces, once for every field a
// block advects (each face is the same thread's in every field); fifth order
template <class S, typename T>
__device__ __forceinline__ void lane_scale_faces(const Lane<S>& L, bool level, T* U, T* V) {
  static_assert(S::H == 3, "the fifth-order flux takes w/60");
  if (!level) return;
  lane_faces(L, [&](int fx) { U[xface_at(L, fx)] /= T(60); },
             [&](int tx, int fy) { V[yface_at(L, tx, fy)] /= T(60); });
}

// the fluxes of phi's cross (R) at the thread's faces, from u's and v's
// faces (U, V; divided by 60 already where Scaled), into FX and FY; the
// third order (H = 2) takes the velocities themselves (tt::flux3, as
// div_upwind does)
template <bool Scaled, class S, typename T>
__device__ __forceinline__ void lane_fluxes(const Lane<S>& L, bool level, const T* R, const T* U,
                                            const T* V, T* FX, T* FY) {
  static_assert(S::H == 3 || !Scaled, "only the fifth-order flux takes scaled velocities");
  if (!level) return;
  auto flux = [](T w, const T* q, int s) {
    if constexpr (S::H == 3) {
      const T w60 = Scaled ? w : w / T(60);
      return flux5_scaled(w60, q[0], q[s], q[2 * s], q[3 * s], q[4 * s], q[5 * s]);
    } else {
      return flux3(w, q[0], q[s], q[2 * s], q[3 * s]);
    }
  };
  lane_faces(
      L,
      [&](int fx) {  // from cell i - H of the row
        const int e = xface_at(L, fx);
        FX[e] = flux(U[e], &R[(fx * S::RY + L.ty + S::H) * S::KL + L.kk], S::RY * S::KL);
      },
      [&](int tx, int fy) {  // from cell j - H of the column
        const int e = yface_at(L, tx, fy);
        FY[e] = flux(V[e], &R[((tx + S::H) * S::RY + fy) * S::KL + L.kk], S::KL);
      });
}

// the flux divergence of the thread's cell in column tx_p, in div5's order
template <class S, typename T>
__device__ __forceinline__ T lane_div(const Lane<S>& L, int p, const T* FX, const T* FY, T dx, T dy) {
  const int tx = L.tx(p);
  const int x = (tx * S::TY + L.ty) * S::KL + L.kk;
  const int y = (tx * (S::TY + 1) + L.ty) * S::KL + L.kk;
  return (FX[x + S::TY * S::KL] - FX[x]) / dx + (FY[y + S::KL] - FY[y]) / dy;
}

// copies of a field's cross of halo H, runs of V levels (16 bytes where V >
// 1), into shared memory
template <class S, int V, typename T>
__device__ __forceinline__ void copy_cross(T* dst, const T* __restrict__ src, const Tile& t) {
  for_cross<S::TX, S::TY, S::KL, S::H, V, S::Threads>(
      t.x0, t.y0, t.k0, t.nx, t.ny, t.nz,
      [&](int m, int g) { cp_async<V * sizeof(T)>(&dst[m], &src[g]); });
}

// the tile's faces of u ((nx+1, ny, nz)) and v ((nx, ny+1, nz)), laid out as
// the x and y fluxes
template <class S, int V, typename T>
__device__ __forceinline__ void copy_faces(T* U, T* Vf, const T* __restrict__ u,
                                           const T* __restrict__ v, const Tile& t) {
  constexpr int KV = S::KL / V;
  strided<S::kFX / V, S::Threads>([&](int e) {
    const int col = e / KV, k = t.k0 + e % KV * V;
    const int i = t.x0 + col / S::TY, j = t.y0 + col % S::TY;
    if (i <= t.nx && j < t.ny && k < t.nz)
      cp_async<V * sizeof(T)>(&U[e * V], &u[(i * t.ny + j) * t.nz + k]);
  });
  strided<S::kFY / V, S::Threads>([&](int e) {
    const int col = e / KV, k = t.k0 + e % KV * V;
    const int i = t.x0 + col / (S::TY + 1), j = t.y0 + col % (S::TY + 1);
    if (i < t.nx && j <= t.ny && k < t.nz)
      cp_async<V * sizeof(T)>(&Vf[e * V], &v[(i * (t.ny + 1) + j) * t.nz + k]);
  });
}

// whether the (nx, ny, nz) grid and its staggered u and v fit the tiles'
// 32-bit indices
inline bool fits_int32(int nx, int ny, int nz) {
  return int64_t(nx + 1) * (ny + 1) * nz <= INT32_MAX;
}

}  // namespace tt
