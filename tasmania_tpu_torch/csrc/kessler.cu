// Kessler microphysics then relaxed saturation adjustment, both RK2, per cell.
//
// Replaces: tasmania_tpu/ops/kessler_step.py:111 fused_kessler_satadj_rk2
// (pallas_call at :189).  Per cell, T fixed over both processes and stages:
// qvs = beta * e_s(T) / p (Tetens), p and Exner the means of the two interface
// values around the cell; Kessler RK2 on (qv, qc, qr) (autoconversion,
// accretion, rain evaporation); saturation adjustment RK2 on its (qv', qc');
// the theta tendency of both processes' stage 1.  Every expression keeps the
// operation order of fused_kessler_satadj_rk2_plain (ops/kessler_step.py); the
// powers are powf/pow and the exponential expf/exp, never the fast intrinsics.
//
// Bound on the H100: bytes.  At the flagship (161x161x120 float32) it reads 5
// cell fields and 2 interface fields and writes 4 cell fields, 137 MB, 41 us at
// 3.35 TB/s; the arithmetic (three powers and one exponential per cell) is
// about 0.1 GFLOP.  Design: one thread per cell, k (the contiguous axis)
// fastest, so each warp reads runs of 32 along k; no shared memory.

#include "common.cuh"

namespace {

template <typename T>
struct Scalars {
  T a, k1, k2, sr, beta, lhvw, dt, h, hs, dtsr, l2, cprv;
};

__device__ __forceinline__ float texp(float x) { return expf(x); }
__device__ __forceinline__ double texp(double x) { return exp(x); }

template <typename T>
__device__ __forceinline__ void kessler_tend(const Scalars<T>& c, T qvs, T rho, T qv, T qc, T qr,
                                             T& ev, T& ec, T& er) {
  const T ar = c.k1 * (qc > c.a ? qc - c.a : T(0));
  const T cr = c.k2 * qc * (qr > T(0) ? tt::tpow(qr, T(0.875)) : T(0));
  ev = qr > T(0) ? T(0.0484794) * (qvs - qv) * tt::tpow(rho * qr, T(0.65)) : T(0);
  ec = -(ar + cr);
  er = ar + cr - ev;
}

template <typename T>
__device__ __forceinline__ T adjustment(T qvs, T denom, T qv, T qc) {
  const T sat = (qvs - qv) / denom;
  return sat <= qc ? sat : qc;
}

template <typename T>
__global__ void kessler_satadj_kernel(const T* __restrict__ rho, const T* __restrict__ t,
                                      const T* __restrict__ p_if, const T* __restrict__ exn_if,
                                      const T* __restrict__ qv_in, const T* __restrict__ qc_in,
                                      const T* __restrict__ qr_in, T* __restrict__ qv_out,
                                      T* __restrict__ qc_out, T* __restrict__ qr_out,
                                      T* __restrict__ th_out, int ncol, int nz, Scalars<T> c) {
  const int64_t total = int64_t(ncol) * nz;
  for (int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += int64_t(gridDim.x) * blockDim.x) {
    const int64_t col = e / nz;
    const int64_t fi = e + col;  // interface index of the level above the cell
    const T p = T(0.5) * (p_if[fi] + p_if[fi + 1]);
    const T exn = T(0.5) * (exn_if[fi] + exn_if[fi + 1]);
    const T tv = t[e];
    const T rhov = rho[e];
    const T qvs = c.beta * (T(610.78) * texp(T(17.27) * (tv - T(273.16)) / (tv - T(35.86)))) / p;

    const T qv0 = qv_in[e], qc0 = qc_in[e], qr0 = qr_in[e];
    T ev1, ec1, er1, ev2, ec2, er2;
    kessler_tend(c, qvs, rhov, qv0, qc0, qr0, ev1, ec1, er1);
    kessler_tend(c, qvs, rhov, qv0 + c.h * ev1, qc0 + c.h * ec1, qr0 + c.h * er1, ev2, ec2, er2);
    const T qv1 = qv0 + c.dt * ev2;
    const T qc1 = qc0 + c.dt * ec2;
    qr_out[e] = qr0 + c.dt * er2;
    const T th1 = -c.lhvw / exn * ev1;

    const T denom = T(1) + qvs * c.l2 / (c.cprv * (tv * tv));
    const T d1 = adjustment(qvs, denom, qv1, qc1);
    const T d2 = adjustment(qvs, denom, qv1 + c.hs * d1, qc1 - c.hs * d1);
    qv_out[e] = qv1 + c.dtsr * d2;
    qc_out[e] = qc1 - c.dtsr * d2;
    th_out[e] = th1 - c.sr * (c.lhvw / exn) * d1;
  }
}

template <typename T>
int launch(const void* const* in, void* const* out, int ncol, int nz, const double* s,
           cudaStream_t stream) {
  // s: a, k1, k2, sr, beta, lhvw, cp, rv, dt; the products are formed in
  // double, as the plain version's python scalars are
  Scalars<T> c;
  c.a = T(s[0]); c.k1 = T(s[1]); c.k2 = T(s[2]); c.sr = T(s[3]); c.beta = T(s[4]);
  c.lhvw = T(s[5]); c.dt = T(s[8]);
  c.h = T(0.5 * s[8]); c.hs = T(0.5 * s[8] * s[3]); c.dtsr = T(s[8] * s[3]);
  c.l2 = T(s[5] * s[5]); c.cprv = T(s[6] * s[7]);
  const int64_t total = int64_t(ncol) * nz;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;
  auto I = [&](int i) { return static_cast<const T*>(in[i]); };
  auto O = [&](int i) { return static_cast<T*>(out[i]); };
  kessler_satadj_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      I(0), I(1), I(2), I(3), I(4), I(5), I(6), O(0), O(1), O(2), O(3), ncol, nz, c);
  return int(cudaGetLastError());
}

}  // namespace

// in: rho, t, p_if, exn_if, qv, qc, qr; out: qv, qc, qr, theta tendency
extern "C" int tt_kessler_satadj(int dtype, const void* const* in, void* const* out, int ncol,
                                 int nz, const double* scalars, cudaStream_t stream) {
  if (dtype == tt::kFloat32) return launch<float>(in, out, ncol, nz, scalars, stream);
  return launch<double>(in, out, ncol, nz, scalars, stream);
}
