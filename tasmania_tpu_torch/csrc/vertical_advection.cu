// Three RK3WS stages of explicit vertical advection of (s, su, sv[, qv, qc, qr]).
//
// Replaces: tasmania_tpu/ops/vertical_advection_step.py:158
// fused_vertical_advection_rk3ws (pallas_call at :224), its default gcoef=True
// flux form.  Per column: the interface velocity wf[m] = (w[m-1] + w[m]) / 2
// and the flux coefficients g_d[m] (flux f[m] = sum_d g_d[m] phi[m+d]) once;
// then x_i = x_0 + c_i T(x_{i-1}), c = (dt/3, dt/2, dt), with
// T(phi)[k] = (f[k+1] - f[k]) / dz on levels [e, nz-e) and 0 outside, the
// mass fractions advected as s q and divided by the stage's density.  The
// operation order is that of fused_vertical_advection_rk3ws_plain
// (ops/vertical_advection_step.py).
//
// Bound on the H100: bytes.  At the flagship (161x161x120 float32, moist,
// third order) it reads 7 fields and writes 6, 162 MB, 48 us at 3.35 TB/s;
// 18 tendency evaluations of 8 flops a level are about 0.05 GFLOP.  Design:
// one warp per (x, y) column.  z is the contiguous axis, so a warp's loads of
// a column are coalesced; the column's coefficients and its stage values live
// in shared memory (2 x 6 x nz + 4 x (nz - 3) values, 7.7 KB a warp in float32
// at nz = 120), with __syncwarp() between stages: the three stages never
// touch device memory.

#include "common.cuh"

namespace {

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
__device__ __forceinline__ void coefficients(T wf, T* g) {
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
struct Fields {
  const T* in[7];  // w, s, su, sv[, qv, qc, qr]
  T* out[6];
};

template <typename T, int ORDER>
__global__ void vertical_advection_kernel(Fields<T> p, int nf, int ncol, int nz, double dt,
                                          T dz) {
  using F = Flux<ORDER>;
  constexpr int e = F::e;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t col = int64_t(blockIdx.x) * (blockDim.x / 32) + warp;
  if (col >= ncol) return;  // whole warps leave together
  const int nif = nz + 1 - 2 * e;  // interfaces [e, nz+1-e)
  T* smem = reinterpret_cast<T*>(smem_raw) + int64_t(warp) * (F::n * nif + 2 * nf * nz);
  T* g = smem;                  // g[i * nif + (m - e)]
  T* cur = g + F::n * nif;      // cur[f * nz + k]: the stage's input
  T* nxt = cur + nf * nz;
  const int64_t base = col * nz;

  const T* w = p.in[0] + base;
  for (int mi = lane; mi < nif; mi += 32) {
    const int m = mi + e;
    T gm[F::n];
    coefficients<T, ORDER>(T(0.5) * (w[m - 1] + w[m]), gm);
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
        if (stage == 2) {
          p.out[f][base + k] = x;
        } else {
          nxt[f * nz + k] = x;
        }
      }
    }
    __syncwarp();
    T* t = cur;
    cur = nxt;
    nxt = t;
  }
}

template <typename T, int ORDER>
int launch_order(const Fields<T>& p, int nf, int ncol, int nz, double dt, double dz,
                 cudaStream_t stream) {
  constexpr int e = Flux<ORDER>::e;
  const size_t per_warp = sizeof(T) * (size_t(Flux<ORDER>::n) * (nz + 1 - 2 * e) + 2 * size_t(nf) * nz);
  int wpb = int((48 * 1024) / per_warp);
  wpb = wpb < 1 ? 1 : (wpb > 4 ? 4 : wpb);
  const size_t smem = per_warp * wpb;
  auto kernel = vertical_advection_kernel<T, ORDER>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const int64_t blocks = (int64_t(ncol) + wpb - 1) / wpb;
  kernel<<<static_cast<unsigned>(blocks), 32 * wpb, smem, stream>>>(p, nf, ncol, nz, dt, T(dz));
  return int(cudaGetLastError());
}

template <typename T>
int launch(const void* const* in, void* const* out, int nf, int ncol, int nz, int order,
           const double* sc, cudaStream_t stream) {
  Fields<T> p;
  for (int f = 0; f < nf + 1; ++f) p.in[f] = static_cast<const T*>(in[f]);
  for (int f = 0; f < nf; ++f) p.out[f] = static_cast<T*>(out[f]);
  switch (order) {
    case 1: return launch_order<T, 1>(p, nf, ncol, nz, sc[0], sc[1], stream);
    case 2: return launch_order<T, 2>(p, nf, ncol, nz, sc[0], sc[1], stream);
    case 3: return launch_order<T, 3>(p, nf, ncol, nz, sc[0], sc[1], stream);
    case 5: return launch_order<T, 5>(p, nf, ncol, nz, sc[0], sc[1], stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// in: w, s, su, sv[, qv, qc, qr]; out: the nf stepped fields (nf = 3 or 6);
// scalars: dt, dz
extern "C" int tt_vertical_advection_rk3ws(int dtype, const void* const* in, void* const* out,
                                           int nf, int ncol, int nz, int order,
                                           const double* scalars, cudaStream_t stream) {
  if (nf != 3 && nf != 6) return int(cudaErrorInvalidValue);
  if (dtype == tt::kFloat32) return launch<float>(in, out, nf, ncol, nz, order, scalars, stream);
  return launch<double>(in, out, nf, ncol, nz, order, scalars, stream);
}
