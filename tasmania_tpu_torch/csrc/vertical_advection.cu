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
// (ops/vertical_advection_step.py); the column algebra is
// tt::vadv_rk3ws_column (column.cuh), shared with vadv_sed.cu.
//
// Bound on the H100: bytes.  At the flagship (161x161x120 float32, moist,
// third order) it reads 7 fields and writes 6, 162 MB, 48 us at 3.35 TB/s;
// 18 tendency evaluations of 8 flops a level are about 0.05 GFLOP.  Design:
// one warp per (x, y) column.  z is the contiguous axis, so a warp's loads of
// a column are coalesced; the column's coefficients and its stage values live
// in shared memory (2 x 6 x nz + 4 x (nz - 3) values, 7.7 KB a warp in float32
// at nz = 120), with __syncwarp() between stages: the three stages never
// touch device memory.

#include "column.cuh"

namespace {

template <typename T, int ORDER>
__global__ void vertical_advection_kernel(tt::VadvFields<T> p, int nf, int ncol, int nz, double dt,
                                          T dz) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t col = int64_t(blockIdx.x) * (blockDim.x / 32) + warp;
  if (col >= ncol) return;  // whole warps leave together
  T* smem = reinterpret_cast<T*>(smem_raw) + int64_t(warp) * tt::vadv_smem_values<ORDER>(nf, nz);
  tt::vadv_rk3ws_column<T, ORDER>(p, nf, col * nz, nz, dt, dz, smem, lane, nullptr);
}

template <typename T, int ORDER>
int launch_order(const tt::VadvFields<T>& p, int nf, int ncol, int nz, double dt, double dz,
                 cudaStream_t stream) {
  const size_t per_warp = sizeof(T) * tt::vadv_smem_values<ORDER>(nf, nz);
  const int wpb = tt::warps_per_block(per_warp);
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
  tt::VadvFields<T> p;
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
