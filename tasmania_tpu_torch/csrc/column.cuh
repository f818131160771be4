// The column algebra of the vertical kernels, a thread R levels of a column
// (k = lane + r tpc, tpc threads a column): the three RK3WS stages of
// vertical advection (vertical_advection.cu) and of sedimentation with the
// Kessler fall velocity (sedimentation.cu), and both in turn on one column
// (vadv_sed.cu), whose advected qr stays in the thread's registers.  Each
// keeps the operation order of its plain PyTorch version in
// tasmania_tpu_torch/ops/, so the merged kernel gives the bits of the two
// kernels run in turn.
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

// a column block's fields: in w, s, su, sv[, qv, qc, qr], out the NF
// stepped fields
template <typename T, int NF>
struct Columns {
  const T* in[NF + 1];
  T* out[NF];
};

// a column's advection inputs as a thread holds them: its levels of the NF
// fields, and the velocities below and above each of its interfaces
// (interface m = k, between levels k-1 and k)
template <typename T, int NF, int R>
struct VadvIn {
  T x0[NF][R], wm[R], wk[R];
};

// every load of the thread at once, from the column at offset base (the
// flux coefficients come after, in VadvLevels's constructor, so that a
// caller's other loads are issued first)
template <int ORDER, typename T, int NF, int R>
__device__ __forceinline__ void load_vadv(VadvIn<T, NF, R>& in, const Columns<T, NF>& p, int base,
                                          bool live, int lane, int tpc, int nz) {
  constexpr int e = Flux<ORDER>::e;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = lane + r * tpc;
    const bool level = live && k < nz;
    const bool face = level && k >= e && k <= nz - e;
#pragma unroll
    for (int f = 0; f < NF; ++f) in.x0[f][r] = level ? p.in[1 + f][base + k] : T(0);
    in.wm[r] = face ? p.in[0][base + k - 1] : T(0);
    in.wk[r] = face ? p.in[0][base + k] : T(0);
  }
}

// Vertical advection of a column, R levels a thread: the interface velocity
// wf[m] = (w[m-1] + w[m]) / 2 and the flux coefficients g_d[m] (flux f[m] =
// sum_d g_d[m] phi[m+d]) once, then x_i = x_0 + c_i T(x_{i-1}), c = (dt/3,
// dt/2, dt), with T(phi)[k] = (f[k+1] - f[k]) / dz on levels [e, nz-e) and 0
// outside, the mass fractions advected as s q and divided by the stage's
// density (fused_vertical_advection_rk3ws_plain, whose division by dz
// PyTorch takes on the card as a product with 1/dz: so does this).  The
// initial state x0, the stage's state x and the coefficients stay in
// registers; a stage forms (a) each level's advected quantity, phi or s q
// (once), in shared memory, (b) each interface's flux once, in shared
// memory, (c) each level's tendency and new value, a barrier of the block
// between (a), (b) and (c).  In shared memory a level's NF values lie
// together at an odd stride P, so that every access is a constant offset
// from the thread's level and the threads of consecutive levels reach
// distinct banks.
template <typename T, int ORDER, int NF, int R>
struct VadvLevels {
  using F = Flux<ORDER>;
  static constexpr int e = F::e, P = NF | 1;
  // shared memory of one column, in values: phi of the NF fields on the nz
  // levels, their fluxes at the nz + 1 interfaces
  __host__ __device__ static constexpr int column_values(int nz) { return P * (2 * nz + 1); }

  T x0[NF][R], x[NF][R], g[F::n][R];

  // the initial state and the flux coefficients of the thread's interfaces
  __device__ explicit VadvLevels(const VadvIn<T, NF, R>& in) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int f = 0; f < NF; ++f) x0[f][r] = x[f][r] = in.x0[f][r];
      T gm[F::n];
      flux_coefficients<T, ORDER>(T(0.5) * (in.wm[r] + in.wk[r]), gm);
#pragma unroll
      for (int i = 0; i < F::n; ++i) g[i][r] = gm[i];
    }
  }

  // the three stages through the column's shared memory (column_values);
  // store(f, k, value) takes each level's last stage
  template <typename Store>
  __device__ void stages(T* smem, int lane, int tpc, int nz, T c0, T c1, T c2, T dz, Store store) {
    T* phi = smem;           // phi[k P + f]
    T* flux = phi + nz * P;  // flux[m P + f]
    const T rdz = T(1) / dz;  // PyTorch divides by the scalar dz on the card as a product with this
#pragma unroll
    for (int stage = 0; stage < 3; ++stage) {
      const T c = stage == 0 ? c0 : (stage == 1 ? c1 : c2);
      // (a) the advected quantities: phi, s q for the mass fractions
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int k = lane + r * tpc;
        if (k < nz) {
#pragma unroll
          for (int f = 0; f < NF; ++f) phi[k * P + f] = f >= 3 ? x[0][r] * x[f][r] : x[f][r];
        }
      }
      __syncthreads();
      // (b) the flux at each interface m = k in [e, nz - e], once
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int m = lane + r * tpc;
        if (m >= e && m <= nz - e) {
#pragma unroll
          for (int f = 0; f < NF; ++f) {
            const T* q = phi + m * P + f;
            T acc = g[0][r] * q[F::off(0) * P];
#pragma unroll
            for (int i = 1; i < F::n; ++i) acc = acc + g[i][r] * q[F::off(i) * P];
            flux[m * P + f] = acc;
          }
        }
      }
      __syncthreads();
      // (c) the tendencies on levels [e, nz - e) and the stage's new values
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int k = lane + r * tpc;
        if (k >= nz) continue;
        const bool inner = k >= e && k < nz - e;
        const T inv_s = NF > 3 && inner ? T(1) / x[0][r] : T(0);  // the stage's density
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          T tnd = T(0);
          if (inner) {
            const T* fl = flux + k * P + f;
            tnd = (fl[P] - fl[0]) * rdz;
            if (f >= 3) tnd = tnd * inv_s;
          }
          x[f][r] = x0[f][r] + c * tnd;
          if (stage == 2) store(f, k, x[f][r]);
        }
      }
    }
  }
};

// a column's sedimentation inputs as a thread holds them: its levels' rho,
// qr0 and the two interface heights around each, and the surface density
template <typename T, int R>
struct SedColumn {
  T rho[R], q0[R], top[R], bottom[R], rho_s;
};

// the loads of column col (rho and qr (nz levels), h_if (nz + 1)); with
// Q0 = false qr0 is left to the caller
template <bool Q0, typename T, int R>
__device__ __forceinline__ void load_sed(SedColumn<T, R>& in, const T* __restrict__ rho_g,
                                         const T* __restrict__ hif_g, const T* __restrict__ qr_g,
                                         int col, int ncol, int nz, int tpc, int lane) {
  const bool live = col < ncol;
  const int64_t base = int64_t(col) * nz;
  const T* hif = hif_g + int64_t(col) * (nz + 1);
  in.rho_s = live ? rho_g[base + nz - 1] : T(1);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = lane + r * tpc;
    const bool level = live && k < nz;
    in.rho[r] = level ? rho_g[base + k] : T(1);
    if (Q0) in.q0[r] = level ? qr_g[base + k] : T(0);
    in.top[r] = level ? hif[k] : T(0);
    in.bottom[r] = level ? hif[k + 1] : T(0);
  }
}

// shared memory of one column's sedimentation, in values: the main-level
// heights and two buffers of rho qr vt
__host__ __device__ constexpr int sed_column_values(int nz) { return 3 * nz; }

// Sedimentation of one column (surface = last level), R levels a thread:
// the stage-invariant factors once (main-level heights, 1e-3 rho, 36.34
// sqrt(rho_s / rho), the upwind height coefficients ca, cb, cc with 1/rho
// folded in); then per stage vt = wsq (mrho max(qr, 0))^0.1346 (at stage 1
// only when vt_step), rqv = rho qr vt, the divergence on levels [nb, nz),
// and qr_i = qr_0 + c_i T(qr_{i-1}), c = (dt/3, dt/2, dt)
// (fused_sedimentation_rk3ws_plain; the power is powf/pow and the root sqrt,
// as PyTorch's `** 0.5` is, each division an IEEE division).  A stage: (a)
// each level's rho qr vt into shared memory (at stage 1 also the main-level
// height); (b) one barrier of the block; (c) each level's divergence and new
// qr in registers (at stage 1 first its coefficients, from the heights of
// levels k-1 and k-2 in shared memory).  rho qr vt alternates between rq0
// and rq1 (odd says which comes first; the parity after the three stages is
// returned, for the block's next column), so one barrier a stage suffices: a
// thread writes a buffer again only after every thread has passed the
// barrier that follows its last reading.  qr_3 goes to qr_out[k] and the
// stage-1 vt to vt_out[k] where live.
template <typename T, int ORDER, int R>
__device__ __forceinline__ bool sed_stages(const SedColumn<T, R>& in, T* hm, T* rq0, T* rq1,
                                           bool odd, bool live, int lane, int tpc, int nz,
                                           bool vt_step, T c0, T c1, T c2, T* __restrict__ qr_out,
                                           T* __restrict__ vt_out) {
  constexpr int nb = ORDER;
  T q[R], h[R], vt[R], ca[R], cb[R], cc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    h[r] = T(0.5) * (in.top[r] + in.bottom[r]);
    q[r] = in.q0[r];
    vt[r] = ca[r] = cb[r] = cc[r] = T(0);
  }
#pragma unroll
  for (int stage = 0; stage < 3; ++stage) {
    const T c = stage == 0 ? c0 : (stage == 1 ? c1 : c2);
    T* rqv = odd ? rq1 : rq0;
    odd = !odd;
    // (a) the fall velocity and rho qr vt of each level
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = lane + r * tpc;
      if (k >= nz) continue;
      if (stage == 0 || !vt_step) {
        const T qk = q[r];
        const T wsq = T(36.34) * tsqrt(in.rho_s / in.rho[r]);
        vt[r] = wsq * tpow(T(1.0e-3) * in.rho[r] * (qk > T(0) ? qk : T(0)), T(0.1346));
        if (stage == 0 && live) vt_out[k] = vt[r];
      }
      rqv[k] = in.rho[r] * q[r] * vt[r];
      if (stage == 0) hm[k] = h[r];
    }
    // (b) one barrier: a buffer is written again two stages later, after
    // the barrier that follows its last reading
    __syncthreads();
    // (c) the coefficients (once), the divergence and the stage's qr
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = lane + r * tpc;
      if (k >= nz) continue;
      if (stage == 0 && k >= nb) {
        const T inv_rho = T(1) / in.rho[r];
        if (ORDER == 1) {
          ca[r] = inv_rho / (hm[k - 1] - h[r]);
        } else {
          const T h2 = h[r], h1 = hm[k - 1], h0 = hm[k - 2];
          const T d1 = h1 - h2, d2 = h0 - h2, d3 = h0 - h1;
          ca[r] = (T(2) * h2 - h1 - h0) / (d1 * d2) * inv_rho;
          cb[r] = d2 / (d1 * d3) * inv_rho;
          cc[r] = (h2 - h1) / (d2 * d3) * inv_rho;
        }
      }
      T tnd = T(0);
      if (k >= nb) {
        const T rk = in.rho[r] * q[r] * vt[r];  // rqv[k], this thread's own
        tnd = ORDER == 1 ? ca[r] * (rqv[k - 1] - rk)
                         : ca[r] * rk + cb[r] * rqv[k - 1] + cc[r] * rqv[k - 2];
      }
      const T x = in.q0[r] + c * tnd;
      if (stage == 2) {
        if (live) qr_out[k] = x;
      } else {
        q[r] = x;
      }
    }
  }
  return odd;
}

// R levels a thread, the fewest that keep a column within MaxTpc threads
// (within Threads at MaxR); tpc the levels a thread's R leaves, rounded up to
// whole warps; false where nz needs more than Threads threads at MaxR
template <int Threads, int MaxTpc, int MaxR>
inline bool column_split(int nz, int& r, int& tpc) {
  r = 1;
  while (r < MaxR && (nz + r - 1) / r > MaxTpc) r *= 2;
  tpc = ((nz + r - 1) / r + 31) / 32 * 32;
  return tpc <= Threads;
}

}  // namespace tt
