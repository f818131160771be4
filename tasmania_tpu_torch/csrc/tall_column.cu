// Vertical advection RK3WS and sedimentation RK3WS of columns taller than
// the fused kernels take (vertical_advection.cu and vadv_sed.cu up to 1024
// levels, sedimentation.cu up to 2048): one launch a stage, a thread a cell
// and level, the stages' states through device memory, so any nz.
//
// Replaces, above those heights: tasmania_tpu/ops/vertical_advection_step.py:158
// fused_vertical_advection_rk3ws (pallas_call at :224) and
// tasmania_tpu/ops/sedimentation_step.py:123 fused_sedimentation_rk3ws
// (pallas_call at :162), whose Pallas kernels take whole columns with no
// limit in levels; the merge of the two (vertical_advection_step.py:242) runs
// them in turn (ops/vertical_advection_step.py).  The algebra and the
// boundary levels are the fused kernels' (column.cuh, and the operation
// order of the plain versions in ops/): vertical advection's interface
// velocity wf[m] = (w[m-1] + w[m]) / 2, its flux coefficients
// (tt::flux_coefficients) and f[m] = sum_d g_d[m] phi[m+d] in the same
// order, the tendency (f[k+1] - f[k]) (1/dz) on levels [e, nz-e), the mass
// fractions advected as s q and divided by the stage's density;
// sedimentation's fall velocity 36.34 sqrt(rho_s / rho) (1e-3 rho max(qr,
// 0))^0.1346, rho qr vt, the upwind height coefficients with 1/rho folded in
// and the divergence on levels [nb, nz).  x_i = x_0 + c_i T(x_{i-1}), c =
// (dt/3, dt/2, dt).
//
// Bound on the H100: bytes.  A stage reads the initial and the previous
// stage's state and writes its own: at 1100 levels and the flagship's 161 x
// 161 columns, float32, six advected fields, about 0.9 GB a step of
// vertical advection (0.27 ms at 3.35 TB/s) against the 0.5 GB the fused
// kernel would move.  Design: the simplest that takes any nz.  A thread
// forms the two interface fluxes of its level (each interface flux twice in
// all, once for each level beside it) from the neighbouring levels, which
// its warp's neighbours load too, so most of those loads hit L1; the
// sedimentation recomputes the fall velocity of the levels below its own
// (or, with the stage-1 fall velocity kept, reads them back).  Cells are
// indexed in 32 bits, as in the fused kernels (the wrappers refuse more).

#include "column.cuh"

namespace {

constexpr int kThreads = 256;

// one stage of vertical advection: in x0 (the initial state) and x (the
// previous stage's), out the stage's NF fields
template <typename T, int NF>
struct TallVadv {
  const T* w;
  const T* x0[NF];
  const T* x[NF];
  T* out[NF];
};

template <typename T, int ORDER, int NF>
__global__ void __launch_bounds__(kThreads)
    vadv_tall_stage(TallVadv<T, NF> p, int ncell, int nz, T c, T dz) {
  using F = tt::Flux<ORDER>;
  constexpr int e = F::e;
  const int64_t at = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (at >= ncell) return;
  const int idx = int(at);
  const int k = idx % nz;
  const int base = idx - k;  // the column's first level
  const bool inner = k >= e && k < nz - e;
  const T rdz = T(1) / dz;  // PyTorch divides by the scalar dz on the card as a product with this
  // the flux coefficients of the interfaces m = k and k + 1
  T g[2][F::n];
  if (inner) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = base + k + j;
      tt::flux_coefficients<T, ORDER>(T(0.5) * (p.w[m - 1] + p.w[m]), g[j]);
    }
  }
  const T inv_s = NF > 3 && inner ? T(1) / p.x[0][idx] : T(0);  // the stage's density
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    T tnd = T(0);
    if (inner) {
      T flux[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int m = base + k + j;
        // the advected quantity at level m + d: phi, or s q for a mass fraction
        auto phi = [&](int d) { return f >= 3 ? p.x[0][m + d] * p.x[f][m + d] : p.x[f][m + d]; };
        T acc = g[j][0] * phi(F::off(0));
#pragma unroll
        for (int i = 1; i < F::n; ++i) acc = acc + g[j][i] * phi(F::off(i));
        flux[j] = acc;
      }
      tnd = (flux[1] - flux[0]) * rdz;
      if (f >= 3) tnd = tnd * inv_s;
    }
    p.out[f][idx] = p.x0[f][idx] + c * tnd;
  }
}

template <typename T, int ORDER, int NF>
int vadv_launch(const void* const* in, void* const* scratch, void* const* out, int ncol, int nz,
                const double* sc, cudaStream_t stream) {
  const double dt = sc[0];
  const T cs[3] = {T(dt / 3.0), T(dt / 2.0), T(dt)};
  const int ncell = ncol * nz;
  const int blocks = (ncell + kThreads - 1) / kThreads;
  for (int stage = 0; stage < 3; ++stage) {
    TallVadv<T, NF> p;
    p.w = static_cast<const T*>(in[0]);
    for (int f = 0; f < NF; ++f) {
      p.x0[f] = static_cast<const T*>(in[1 + f]);
      // stage 0 steps the initial state; stage s > 0 the state in scratch
      // buffer (s - 1) % 2, writing the other one, the last stage the outputs
      p.x[f] = stage == 0 ? p.x0[f] : static_cast<const T*>(scratch[((stage - 1) % 2) * NF + f]);
      p.out[f] = static_cast<T*>(stage == 2 ? out[f] : scratch[(stage % 2) * NF + f]);
    }
    vadv_tall_stage<T, ORDER, NF><<<blocks, kThreads, 0, stream>>>(p, ncell, nz, cs[stage], T(sc[1]));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  return 0;
}

template <typename T, int ORDER>
int vadv_order(const void* const* in, void* const* scratch, void* const* out, int nf, int ncol,
               int nz, const double* sc, cudaStream_t stream) {
  if (nf == 3) return vadv_launch<T, ORDER, 3>(in, scratch, out, ncol, nz, sc, stream);
  return vadv_launch<T, ORDER, 6>(in, scratch, out, ncol, nz, sc, stream);
}

template <typename T>
int vadv(const void* const* in, void* const* scratch, void* const* out, int nf, int ncol, int nz,
         int order, const double* sc, cudaStream_t stream) {
  switch (order) {
    case 1: return vadv_order<T, 1>(in, scratch, out, nf, ncol, nz, sc, stream);
    case 2: return vadv_order<T, 2>(in, scratch, out, nf, ncol, nz, sc, stream);
    case 3: return vadv_order<T, 3>(in, scratch, out, nf, ncol, nz, sc, stream);
    case 5: return vadv_order<T, 5>(in, scratch, out, nf, ncol, nz, sc, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

// the fall velocity of level j of a column (first level base) from its qr
template <typename T>
__device__ __forceinline__ T fall_velocity(const T* __restrict__ rho, int base, int j, T rho_s, T q) {
  const T wsq = T(36.34) * tt::tsqrt(rho_s / rho[base + j]);
  return wsq * tt::tpow(T(1.0e-3) * rho[base + j] * (q > T(0) ? q : T(0)), T(0.1346));
}

// one stage of sedimentation (surface = last level): q the previous stage's
// qr (qr0 at stage 0), vt the stage-1 fall velocity, written at stage 0 and
// read at the later stages when vt_step; out the stage's qr
template <typename T, int ORDER>
__global__ void __launch_bounds__(kThreads)
    sed_tall_stage(const T* __restrict__ rho, const T* __restrict__ h_if, const T* __restrict__ q0,
                   const T* __restrict__ q, T* __restrict__ vt, T* __restrict__ out, int ncell,
                   int nz, bool first, bool vt_step, T c) {
  constexpr int nb = ORDER;
  const int64_t at = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (at >= ncell) return;
  const int idx = int(at);
  const int k = idx % nz;
  const int base = idx - k;
  const int col = base / nz;
  const T rho_s = rho[base + nz - 1];
  const T* hif = h_if + col * (nz + 1);
  // rho qr vt of level k - d (d = 0: this thread's; on the first stage it
  // also writes the fall velocity)
  auto rqv = [&](int d) {
    const int j = k - d;
    const T qj = q[base + j];
    T v;
    if (first || !vt_step) {
      v = fall_velocity(rho, base, j, rho_s, qj);
      if (first && d == 0) vt[idx] = v;
    } else {
      v = vt[base + j];
    }
    return rho[base + j] * qj * v;
  };
  auto height = [&](int j) { return T(0.5) * (hif[j] + hif[j + 1]); };
  T tnd = T(0);
  if (k >= nb) {
    const T inv_rho = T(1) / rho[idx];
    const T rk = rqv(0);
    if (ORDER == 1) {
      const T ca = inv_rho / (height(k - 1) - height(k));
      tnd = ca * (rqv(1) - rk);
    } else {
      const T h2 = height(k), h1 = height(k - 1), h0 = height(k - 2);
      const T d1 = h1 - h2, d2 = h0 - h2, d3 = h0 - h1;
      const T ca = (T(2) * h2 - h1 - h0) / (d1 * d2) * inv_rho;
      const T cb = d2 / (d1 * d3) * inv_rho;
      const T cc = (h2 - h1) / (d2 * d3) * inv_rho;
      tnd = ca * rk + cb * rqv(1) + cc * rqv(2);
    }
  } else if (first) {
    rqv(0);  // the fall velocity of the levels above nb
  }
  out[idx] = q0[idx] + c * tnd;
}

template <typename T, int ORDER>
int sed_launch(const void* const* in, void* const* scratch, void* const* out, int ncol, int nz,
               bool vt_step, double dt, cudaStream_t stream) {
  const T cs[3] = {T(dt / 3.0), T(dt / 2.0), T(dt)};
  const int ncell = ncol * nz;
  const int blocks = (ncell + kThreads - 1) / kThreads;
  const T* rho = static_cast<const T*>(in[0]);
  const T* h_if = static_cast<const T*>(in[1]);
  const T* q0 = static_cast<const T*>(in[2]);
  T* vt = static_cast<T*>(out[1]);
  for (int stage = 0; stage < 3; ++stage) {
    const T* q = stage == 0 ? q0 : static_cast<const T*>(scratch[(stage - 1) % 2]);
    T* dst = static_cast<T*>(stage == 2 ? out[0] : scratch[stage % 2]);
    sed_tall_stage<T, ORDER><<<blocks, kThreads, 0, stream>>>(rho, h_if, q0, q, vt, dst, ncell, nz,
                                                              stage == 0, vt_step, cs[stage]);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  return 0;
}

}  // namespace

// in: w, s, su, sv[, qv, qc, qr]; scratch: two stage states of nf fields
// (2 nf arrays of the cells' size); out: the nf stepped fields (nf = 3 or
// 6); scalars: dt, dz; ncol nz below 2^31 (no aliasing)
extern "C" int tt_vertical_advection_tall(int dtype, const void* const* in, void* const* scratch,
                                          void* const* out, int nf, int ncol, int nz, int order,
                                          const double* scalars, cudaStream_t stream) {
  if ((nf != 3 && nf != 6) || ncol < 1 || nz < 1 || int64_t(ncol) * nz > INT32_MAX)
    return int(cudaErrorInvalidValue);
  if (dtype == tt::kFloat32) return vadv<float>(in, scratch, out, nf, ncol, nz, order, scalars, stream);
  return vadv<double>(in, scratch, out, nf, ncol, nz, order, scalars, stream);
}

// in: rho, h_if (nz + 1 levels), qr; scratch: two stage states of qr; out:
// qr, vt (stage 1); ncol (nz + 1) below 2^31 (no aliasing)
extern "C" int tt_sedimentation_tall(int dtype, const void* const* in, void* const* scratch,
                                     void* const* out, int ncol, int nz, int order, int vt_step,
                                     double dt, cudaStream_t stream) {
  if (ncol < 1 || nz < 1 || int64_t(ncol) * (nz + 1) > INT32_MAX) return int(cudaErrorInvalidValue);
  if (order != 1 && order != 2) return int(cudaErrorInvalidValue);
  if (dtype == tt::kFloat32) {
    return order == 1 ? sed_launch<float, 1>(in, scratch, out, ncol, nz, vt_step != 0, dt, stream)
                      : sed_launch<float, 2>(in, scratch, out, ncol, nz, vt_step != 0, dt, stream);
  }
  return order == 1 ? sed_launch<double, 1>(in, scratch, out, ncol, nz, vt_step != 0, dt, stream)
                    : sed_launch<double, 2>(in, scratch, out, ncol, nz, vt_step != 0, dt, stream);
}
