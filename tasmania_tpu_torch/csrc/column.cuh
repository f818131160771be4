// The column algebra of the vertical kernels: the flux coefficients of
// vertical advection (vertical_advection.cu and vadv_sed.cu), and, one warp
// per (x, y) column, the three RK3WS stages of vertical advection and of
// sedimentation with the Kessler fall velocity, both in turn on one column
// (vadv_sed.cu; sedimentation.cu keeps the same algebra a thread a level).  Each function keeps the
// operation order of its plain PyTorch version in tasmania_tpu_torch/ops/.
#pragma once

#include "common.cuh"

namespace tt {

// flux offsets d of f[m] = sum_d g_d[m] phi[m+d], in the summation order of
// the plain version (its coefficient dict's order)
template <int ORDER>
struct Flux;
template <>
struct Flux<1> {
  static constexpr int e = 1, n = 2;
  __device__ static int off(int i) { return i == 0 ? 0 : -1; }
};
template <>
struct Flux<2> {
  static constexpr int e = 1, n = 2;
  __device__ static int off(int i) { return i == 0 ? 0 : -1; }
};
template <>
struct Flux<3> {
  static constexpr int e = 2, n = 4;
  __device__ static int off(int i) { return i - 2; }
};
template <>
struct Flux<5> {
  static constexpr int e = 3, n = 6;
  __device__ static int off(int i) { return i - 3; }
};

template <typename T, int ORDER>
__device__ __forceinline__ void flux_coefficients(T wf, T* g) {
  if (ORDER == 1) {
    const T pos = wf > T(0) ? T(1) : T(0);
    g[0] = wf * pos;
    g[1] = wf * (T(1) - pos);
  } else if (ORDER == 2) {
    g[0] = g[1] = T(0.5) * wf;
  } else if (ORDER == 3) {
    const T aw = wf / T(12), bw = (wf < T(0) ? -wf : wf) / T(12);
    g[0] = bw - aw;
    g[1] = T(7) * aw - T(3) * bw;
    g[2] = T(7) * aw + T(3) * bw;
    g[3] = -(aw + bw);
  } else {
    const T aw = wf / T(60), bw = (wf < T(0) ? -wf : wf) / T(60);
    g[0] = aw - bw;
    g[1] = T(-8) * aw + T(5) * bw;
    g[2] = T(37) * aw - T(10) * bw;
    g[3] = T(37) * aw + T(10) * bw;
    g[4] = T(-8) * aw - T(5) * bw;
    g[5] = aw + bw;
  }
}

template <typename T>
struct VadvFields {
  const T* in[7];  // w, s, su, sv[, qv, qc, qr]
  T* out[6];
};

// shared memory of one warp's vadv_rk3ws_column, in values of T: the flux
// coefficients of the interfaces [e, nz+1-e) and two stage buffers
template <int ORDER>
__host__ __device__ constexpr size_t vadv_smem_values(int nf, int nz) {
  return size_t(Flux<ORDER>::n) * (nz + 1 - 2 * Flux<ORDER>::e) + 2 * size_t(nf) * nz;
}

// Vertical advection of the column at offset base: the interface velocity
// wf[m] = (w[m-1] + w[m]) / 2 and the flux coefficients once, then
// x_i = x_0 + c_i T(x_{i-1}), c = (dt/3, dt/2, dt), with
// T(phi)[k] = (f[k+1] - f[k]) / dz on levels [e, nz-e) and 0 outside, the
// mass fractions advected as s q and divided by the stage's density
// (fused_vertical_advection_rk3ws_plain).  The last stage goes to
// p.out[f][base + k], and field 5 (qr) to keep[k] instead where keep is not
// null.  Ends with __syncwarp().
template <typename T, int ORDER>
__device__ __forceinline__ void vadv_rk3ws_column(const VadvFields<T>& p, int nf, int64_t base,
                                                  int nz, double dt, T dz, T* smem, int lane,
                                                  T* keep) {
  using F = Flux<ORDER>;
  constexpr int e = F::e;
  const int nif = nz + 1 - 2 * e;  // interfaces [e, nz+1-e)
  T* g = smem;                  // g[i * nif + (m - e)]
  T* cur = g + F::n * nif;      // cur[f * nz + k]: the stage's input
  T* nxt = cur + nf * nz;

  const T* w = p.in[0] + base;
  for (int mi = lane; mi < nif; mi += 32) {
    const int m = mi + e;
    T gm[F::n];
    flux_coefficients<T, ORDER>(T(0.5) * (w[m - 1] + w[m]), gm);
#pragma unroll
    for (int i = 0; i < F::n; ++i) g[i * nif + mi] = gm[i];
  }
  for (int f = 0; f < nf; ++f)
    for (int k = lane; k < nz; k += 32) cur[f * nz + k] = p.in[1 + f][base + k];
  __syncwarp();

  for (int stage = 0; stage < 3; ++stage) {
    const T c = T(stage == 0 ? dt / 3.0 : (stage == 1 ? dt / 2.0 : dt));
    const T* s_st = cur;  // the stage's density, field 0
    for (int f = 0; f < nf; ++f) {
      const T* phi = cur + f * nz;
      const bool q = f >= 3;
      for (int k = lane; k < nz; k += 32) {
        const T x0 = p.in[1 + f][base + k];
        T tnd = T(0);
        if (k >= e && k < nz - e) {
          T flux[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = k + h;  // interface above (h = 0) and below (h = 1) level k
            T acc = T(0);
#pragma unroll
            for (int i = 0; i < F::n; ++i) {
              const int j = m + F::off(i);
              const T v = q ? s_st[j] * phi[j] : phi[j];
              const T term = g[i * nif + (m - e)] * v;
              acc = i == 0 ? term : acc + term;
            }
            flux[h] = acc;
          }
          tnd = (flux[1] - flux[0]) / dz;
          if (q) tnd = tnd * (T(1) / s_st[k]);
        }
        const T x = x0 + c * tnd;
        if (stage < 2) {
          nxt[f * nz + k] = x;
        } else if (f == 5 && keep != nullptr) {
          keep[k] = x;
        } else {
          p.out[f][base + k] = x;
        }
      }
    }
    __syncwarp();
    T* t = cur;
    cur = nxt;
    nxt = t;
  }
}

// shared memory of one warp's sed_rk3ws_column, in values of T
__host__ __device__ constexpr size_t sed_smem_values(int nz) { return 7 * size_t(nz); }

// Sedimentation of one column (surface = last level): rho, the interface
// heights hif (nz + 1) and the step's initial qr0 in; the stage-invariant
// factors once (main-level heights, 1e-3 rho, 36.34 sqrt(rho_s / rho), the
// upwind height coefficients ca, cb, cc with 1/rho folded in); then per stage
// vt = wsq (mrho max(qr, 0))^0.1346 (at stage 1 only when vt_step),
// rqv = rho qr vt, the divergence on levels [nb, nz), and
// qr_i = qr_0 + c_i T(qr_{i-1}), c = (dt/3, dt/2, dt)
// (fused_sedimentation_rk3ws_plain).  Writes qr_3 to qr_out and the stage-1
// vt to vt_out.  qr0 may lie in device or shared memory, apart from smem.
template <typename T, int ORDER>
__device__ __forceinline__ void sed_rk3ws_column(const T* __restrict__ rho_g,
                                                 const T* __restrict__ hif,
                                                 const T* __restrict__ qr0,
                                                 T* __restrict__ qr_out, T* __restrict__ vt_out,
                                                 int nz, bool vt_step, double dt, T* smem,
                                                 int lane) {
  constexpr int nb = ORDER;
  T* rho = smem;            // rho[k]
  T* ca = rho + nz;         // coefficients of level k (k >= nb)
  T* cb = ca + nz;
  T* cc = cb + nz;
  T* vt = cc + nz;          // the fall velocity in use
  T* rqv = vt + nz;         // rho qr vt of the stage
  T* q = rqv + nz;          // qr of the stage
  const T rho_s = rho_g[nz - 1];

  for (int k = lane; k < nz; k += 32) {
    rho[k] = rho_g[k];
    q[k] = qr0[k];
  }
  __syncwarp();
  for (int k = lane; k < nz; k += 32) {
    if (k < nb) continue;
    const T inv_rho = T(1) / rho[k];
    auto h = [&](int l) { return T(0.5) * (hif[l] + hif[l + 1]); };
    if (ORDER == 1) {
      ca[k] = inv_rho / (h(k - 1) - h(k));
    } else {
      const T h2 = h(k), h1 = h(k - 1), h0 = h(k - 2);
      const T d1 = h1 - h2, d2 = h0 - h2, d3 = h0 - h1;
      ca[k] = (T(2) * h2 - h1 - h0) / (d1 * d2) * inv_rho;
      cb[k] = d2 / (d1 * d3) * inv_rho;
      cc[k] = (h2 - h1) / (d2 * d3) * inv_rho;
    }
  }

  for (int stage = 0; stage < 3; ++stage) {
    const T c = T(stage == 0 ? dt / 3.0 : (stage == 1 ? dt / 2.0 : dt));
    for (int k = lane; k < nz; k += 32) {
      if (stage == 0 || !vt_step) {
        const T qk = q[k];
        const T wsq = T(36.34) * tsqrt(rho_s / rho[k]);
        vt[k] = wsq * tpow(T(1.0e-3) * rho[k] * (qk > T(0) ? qk : T(0)), T(0.1346));
        if (stage == 0) vt_out[k] = vt[k];
      }
      rqv[k] = rho[k] * q[k] * vt[k];
    }
    __syncwarp();
    for (int k = lane; k < nz; k += 32) {
      T tnd = T(0);
      if (k >= nb) {
        tnd = ORDER == 1 ? ca[k] * (rqv[k - 1] - rqv[k])
                         : ca[k] * rqv[k] + cb[k] * rqv[k - 1] + cc[k] * rqv[k - 2];
      }
      const T x = qr0[k] + c * tnd;
      if (stage == 2) {
        qr_out[k] = x;
      } else {
        q[k] = x;  // each lane rewrites only its own levels, read above
      }
    }
    __syncwarp();
  }
}

// warps a block of a one-warp-per-column kernel: as many as 48 KB of shared
// memory holds, between 1 and 4
inline int warps_per_block(size_t bytes_per_warp) {
  const int wpb = int((48 * 1024) / bytes_per_warp);
  return wpb < 1 ? 1 : (wpb > 4 ? 4 : wpb);
}

}  // namespace tt
