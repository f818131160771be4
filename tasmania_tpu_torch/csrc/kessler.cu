// Kessler microphysics and relaxed saturation adjustment, each RK2, per cell:
// the two processes as one pair, or either one alone.
//
// Replaces: tasmania_tpu/ops/kessler_step.py:111 fused_kessler_satadj_rk2
// (pallas_call at :189), :39 fused_kessler_rk2 (pallas_call at :93) and :204
// fused_satadj_rk2 (pallas_call at :251).  Per cell, T fixed over the
// processes and their stages: qvs = beta * e_s(T) / p (Tetens), p and Exner
// the means of the two interface values around the cell; Kessler RK2 on
// (qv, qc, qr) (autoconversion, accretion, rain evaporation) with its
// stage-1 theta tendency; saturation adjustment RK2 on (qv, qc), adding its
// stage-1 theta tendency to the one it is given (the pair: Kessler's).  The
// three kernels share the device functions below.  Every expression keeps
// the operation order of the plain versions (ops/kessler_step.py); the powers
// are powf/pow and the exponential expf/exp, never the fast intrinsics.
//
// Bound on the H100: bytes.  At the flagship (161x161x120 float32) the pair
// and Kessler alone read 5 cell fields and 2 interface fields and write 4
// cell fields, 137 MB, 41 us at 3.35 TB/s; the adjustment alone reads 4 and
// 2 and writes 3, 112 MB, 33 us.  The arithmetic (at most three powers and
// one exponential per cell) is about 0.1 GFLOP.  Design: one thread per
// cell, k (the contiguous axis) fastest, so each warp reads runs of 32 along
// k; no shared memory.

#include "common.cuh"

namespace {

template <typename T>
struct Scalars {
  T a, k1, k2, sr, beta, lhvw, dt, h, hs, dtsr, l2, cprv;
};

__device__ __forceinline__ float texp(float x) { return expf(x); }
__device__ __forceinline__ double texp(double x) { return exp(x); }

// Exner function and saturation mixing ratio of cell e (column e / nz)
template <typename T>
__device__ __forceinline__ void thermodynamics(const Scalars<T>& c, const T* __restrict__ p_if,
                                               const T* __restrict__ exn_if, T tv, int64_t e,
                                               int nz, T& exn, T& qvs) {
  const int64_t fi = e + e / nz;  // interface index of the level above the cell
  const T p = T(0.5) * (p_if[fi] + p_if[fi + 1]);
  exn = T(0.5) * (exn_if[fi] + exn_if[fi + 1]);
  qvs = c.beta * (T(610.78) * texp(T(17.27) * (tv - T(273.16)) / (tv - T(35.86)))) / p;
}

template <typename T>
__device__ __forceinline__ void kessler_tend(const Scalars<T>& c, T qvs, T rho, T qv, T qc, T qr,
                                             T& ev, T& ec, T& er) {
  const T ar = c.k1 * (qc > c.a ? qc - c.a : T(0));
  const T cr = c.k2 * qc * (qr > T(0) ? tt::tpow(qr, T(0.875)) : T(0));
  ev = qr > T(0) ? T(0.0484794) * (qvs - qv) * tt::tpow(rho * qr, T(0.65)) : T(0);
  ec = -(ar + cr);
  er = ar + cr - ev;
}

// Kessler RK2 of (qv, qc, qr) in place; returns the stage-1 theta tendency
template <typename T>
__device__ __forceinline__ T kessler_rk2(const Scalars<T>& c, T qvs, T rho, T exn, T& qv, T& qc,
                                         T& qr) {
  T ev1, ec1, er1, ev2, ec2, er2;
  kessler_tend(c, qvs, rho, qv, qc, qr, ev1, ec1, er1);
  kessler_tend(c, qvs, rho, qv + c.h * ev1, qc + c.h * ec1, qr + c.h * er1, ev2, ec2, er2);
  qv = qv + c.dt * ev2;
  qc = qc + c.dt * ec2;
  qr = qr + c.dt * er2;
  return -c.lhvw / exn * ev1;
}

template <typename T>
__device__ __forceinline__ T adjustment(T qvs, T denom, T qv, T qc) {
  const T sat = (qvs - qv) / denom;
  return sat <= qc ? sat : qc;
}

// saturation adjustment RK2 of (qv, qc) in place; returns th_in plus its
// stage-1 theta tendency
template <typename T>
__device__ __forceinline__ T satadj_rk2(const Scalars<T>& c, T qvs, T tv, T exn, T th_in, T& qv,
                                        T& qc) {
  const T denom = T(1) + qvs * c.l2 / (c.cprv * (tv * tv));
  const T d1 = adjustment(qvs, denom, qv, qc);
  const T d2 = adjustment(qvs, denom, qv + c.hs * d1, qc - c.hs * d1);
  qv = qv + c.dtsr * d2;
  qc = qc - c.dtsr * d2;
  return th_in - c.sr * (c.lhvw / exn) * d1;
}

// in: rho, t, p_if, exn_if, qv, qc, qr; out: qv, qc, qr, theta tendency
template <typename T, bool kAdjust>
__global__ void kessler_kernel(const T* __restrict__ rho, const T* __restrict__ t,
                               const T* __restrict__ p_if, const T* __restrict__ exn_if,
                               const T* __restrict__ qv_in, const T* __restrict__ qc_in,
                               const T* __restrict__ qr_in, T* __restrict__ qv_out,
                               T* __restrict__ qc_out, T* __restrict__ qr_out,
                               T* __restrict__ th_out, int ncol, int nz, Scalars<T> c) {
  const int64_t total = int64_t(ncol) * nz;
  for (int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += int64_t(gridDim.x) * blockDim.x) {
    const T tv = t[e];
    T exn, qvs;
    thermodynamics(c, p_if, exn_if, tv, e, nz, exn, qvs);
    T qv = qv_in[e], qc = qc_in[e], qr = qr_in[e];
    T th = kessler_rk2(c, qvs, rho[e], exn, qv, qc, qr);
    if (kAdjust) th = satadj_rk2(c, qvs, tv, exn, th, qv, qc);
    qv_out[e] = qv;
    qc_out[e] = qc;
    qr_out[e] = qr;
    th_out[e] = th;
  }
}

// in: t, p_if, exn_if, qv, qc, theta tendency; out: qv, qc, theta tendency
template <typename T>
__global__ void satadj_kernel(const T* __restrict__ t, const T* __restrict__ p_if,
                              const T* __restrict__ exn_if, const T* __restrict__ qv_in,
                              const T* __restrict__ qc_in, const T* __restrict__ th_in,
                              T* __restrict__ qv_out, T* __restrict__ qc_out,
                              T* __restrict__ th_out, int ncol, int nz, Scalars<T> c) {
  const int64_t total = int64_t(ncol) * nz;
  for (int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += int64_t(gridDim.x) * blockDim.x) {
    const T tv = t[e];
    T exn, qvs;
    thermodynamics(c, p_if, exn_if, tv, e, nz, exn, qvs);
    T qv = qv_in[e], qc = qc_in[e];
    th_out[e] = satadj_rk2(c, qvs, tv, exn, th_in[e], qv, qc);
    qv_out[e] = qv;
    qc_out[e] = qc;
  }
}

enum class Process { kPair, kKessler, kAdjust };

template <typename T>
int launch(Process proc, const void* const* in, void* const* out, int ncol, int nz,
           const double* s, cudaStream_t stream) {
  // s: a, k1, k2, sr, beta, lhvw, cp, rv, dt; the products are formed in
  // double, as the plain versions' python scalars are
  Scalars<T> c;
  c.a = T(s[0]); c.k1 = T(s[1]); c.k2 = T(s[2]); c.sr = T(s[3]); c.beta = T(s[4]);
  c.lhvw = T(s[5]); c.dt = T(s[8]);
  c.h = T(0.5 * s[8]); c.hs = T(0.5 * s[8] * s[3]); c.dtsr = T(s[8] * s[3]);
  c.l2 = T(s[5] * s[5]); c.cprv = T(s[6] * s[7]);
  const int64_t total = int64_t(ncol) * nz;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;
  const unsigned grid = static_cast<unsigned>(blocks);
  auto I = [&](int i) { return static_cast<const T*>(in[i]); };
  auto O = [&](int i) { return static_cast<T*>(out[i]); };
  if (proc == Process::kAdjust) {
    satadj_kernel<T><<<grid, threads, 0, stream>>>(I(0), I(1), I(2), I(3), I(4), I(5), O(0), O(1),
                                                   O(2), ncol, nz, c);
  } else if (proc == Process::kPair) {
    kessler_kernel<T, true><<<grid, threads, 0, stream>>>(I(0), I(1), I(2), I(3), I(4), I(5), I(6),
                                                          O(0), O(1), O(2), O(3), ncol, nz, c);
  } else {
    kessler_kernel<T, false><<<grid, threads, 0, stream>>>(I(0), I(1), I(2), I(3), I(4), I(5), I(6),
                                                           O(0), O(1), O(2), O(3), ncol, nz, c);
  }
  return int(cudaGetLastError());
}

int dispatch(Process proc, int dtype, const void* const* in, void* const* out, int ncol, int nz,
             const double* scalars, cudaStream_t stream) {
  if (dtype == tt::kFloat32) return launch<float>(proc, in, out, ncol, nz, scalars, stream);
  return launch<double>(proc, in, out, ncol, nz, scalars, stream);
}

}  // namespace

// in: rho, t, p_if, exn_if, qv, qc, qr; out: qv, qc, qr, theta tendency
extern "C" int tt_kessler_satadj(int dtype, const void* const* in, void* const* out, int ncol,
                                 int nz, const double* scalars, cudaStream_t stream) {
  return dispatch(Process::kPair, dtype, in, out, ncol, nz, scalars, stream);
}

// in: rho, t, p_if, exn_if, qv, qc, qr; out: qv, qc, qr, theta tendency
extern "C" int tt_kessler_rk2(int dtype, const void* const* in, void* const* out, int ncol, int nz,
                              const double* scalars, cudaStream_t stream) {
  return dispatch(Process::kKessler, dtype, in, out, ncol, nz, scalars, stream);
}

// in: t, p_if, exn_if, qv, qc, theta tendency; out: qv, qc, theta tendency
extern "C" int tt_satadj_rk2(int dtype, const void* const* in, void* const* out, int ncol, int nz,
                             const double* scalars, cudaStream_t stream) {
  return dispatch(Process::kAdjust, dtype, in, out, ncol, nz, scalars, stream);
}
