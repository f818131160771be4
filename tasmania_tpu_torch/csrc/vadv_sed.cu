// Vertical advection RK3WS of (s, su, sv, qv, qc, qr), then the fall velocity
// and sedimentation RK3WS of the advected qr, in one launch.
//
// Replaces: tasmania_tpu/ops/vertical_advection_step.py:242
// fused_vadv_sedimentation_rk3ws (pallas_call at :308), the SUS process pair
// [IsentropicVerticalAdvection(rk3ws) -> [KesslerFallVelocity,
// KesslerSedimentation](rk3ws)].  Both are column-local, so one warp runs a
// column through tt::vadv_rk3ws_column (vertical advection's algebra),
// keeps the advected qr in shared memory, and runs it through
// tt::sed_rk3ws_column (sedimentation.cu's) with the density and interface
// heights of the state before the pair.  Outputs: the advected s, su, sv,
// qv, qc, the sedimented qr and the stage-1 fall velocity; the advected qr
// never reaches device memory.  Operation order: that of
// fused_vertical_advection_rk3ws_plain followed by
// fused_sedimentation_rk3ws_plain (ops/).
//
// Bound on the H100: bytes.  At the flagship (161x161x120 float32, third-
// order advection, second-order sedimentation) it reads w, s, su, sv, qv,
// qc, qr, rho and the interface heights and writes seven fields: 199 MB,
// 59 us at 3.35 TB/s.  Design: one warp per (x, y) column with the
// column's stage values in shared memory, plus one column of
// qr between the two parts; the sedimentation's seven columns reuse the
// advection's shared memory.

#include "column.cuh"

namespace {

// shared memory of one warp, in values: the advection's buffers (which the
// sedimentation's 7 x nz reuse: nz >= 2e + 1 makes them at least 12 x nz),
// then the advected qr
template <int VORDER>
__host__ __device__ size_t per_warp_values(int nz) {
  return tt::vadv_smem_values<VORDER>(6, nz) + size_t(nz);
}

template <typename T, int VORDER, int SORDER>
__global__ void vadv_sed_kernel(tt::VadvFields<T> p, const T* __restrict__ rho,
                                const T* __restrict__ h_if, T* __restrict__ vt_out, int ncol,
                                int nz, double dt, T dz, bool vt_step) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t col = int64_t(blockIdx.x) * (blockDim.x / 32) + warp;
  if (col >= ncol) return;  // whole warps leave together
  T* smem = reinterpret_cast<T*>(smem_raw) + int64_t(warp) * per_warp_values<VORDER>(nz);
  T* qr_adv = smem + tt::vadv_smem_values<VORDER>(6, nz);
  const int64_t base = col * nz;
  // ends with __syncwarp(): qr_adv is whole, and the advection's buffers free
  tt::vadv_rk3ws_column<T, VORDER>(p, 6, base, nz, dt, dz, smem, lane, qr_adv);
  tt::sed_rk3ws_column<T, SORDER>(rho + base, h_if + col * (nz + 1), qr_adv, p.out[5] + base,
                                  vt_out + base, nz, vt_step, dt, smem, lane);
}

template <typename T, int VORDER, int SORDER>
int launch_orders(const tt::VadvFields<T>& p, const T* rho, const T* h_if, T* vt, int ncol, int nz,
                  double dt, double dz, bool vt_step, cudaStream_t stream) {
  const size_t per_warp = sizeof(T) * per_warp_values<VORDER>(nz);
  const int wpb = tt::warps_per_block(per_warp);
  const size_t smem = per_warp * wpb;
  auto kernel = vadv_sed_kernel<T, VORDER, SORDER>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const int64_t blocks = (int64_t(ncol) + wpb - 1) / wpb;
  kernel<<<static_cast<unsigned>(blocks), 32 * wpb, smem, stream>>>(p, rho, h_if, vt, ncol, nz, dt,
                                                                     T(dz), vt_step);
  return int(cudaGetLastError());
}

template <typename T, int VORDER>
int launch_vorder(const tt::VadvFields<T>& p, const T* rho, const T* h_if, T* vt, int ncol, int nz,
                  int sorder, double dt, double dz, bool vt_step, cudaStream_t stream) {
  if (sorder == 1)
    return launch_orders<T, VORDER, 1>(p, rho, h_if, vt, ncol, nz, dt, dz, vt_step, stream);
  if (sorder == 2)
    return launch_orders<T, VORDER, 2>(p, rho, h_if, vt, ncol, nz, dt, dz, vt_step, stream);
  return int(cudaErrorInvalidValue);
}

template <typename T>
int launch(const void* const* in, void* const* out, int ncol, int nz, int vorder, int sorder,
           bool vt_step, const double* sc, cudaStream_t stream) {
  tt::VadvFields<T> p;
  for (int f = 0; f < 7; ++f) p.in[f] = static_cast<const T*>(in[f]);
  for (int f = 0; f < 6; ++f) p.out[f] = static_cast<T*>(out[f]);
  const T* rho = static_cast<const T*>(in[7]);
  const T* h_if = static_cast<const T*>(in[8]);
  T* vt = static_cast<T*>(out[6]);
  switch (vorder) {
    case 1: return launch_vorder<T, 1>(p, rho, h_if, vt, ncol, nz, sorder, sc[0], sc[1], vt_step,
                                       stream);
    case 2: return launch_vorder<T, 2>(p, rho, h_if, vt, ncol, nz, sorder, sc[0], sc[1], vt_step,
                                       stream);
    case 3: return launch_vorder<T, 3>(p, rho, h_if, vt, ncol, nz, sorder, sc[0], sc[1], vt_step,
                                       stream);
    case 5: return launch_vorder<T, 5>(p, rho, h_if, vt, ncol, nz, sorder, sc[0], sc[1], vt_step,
                                       stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// in: w, s, su, sv, qv, qc, qr, rho, h_if (nz + 1 levels); out: s, su, sv,
// qv, qc advected, qr advected and sedimented, vt (stage 1) (no aliasing);
// scalars: dt, dz
extern "C" int tt_vadv_sedimentation_rk3ws(int dtype, const void* const* in, void* const* out,
                                           int ncol, int nz, int vorder, int sorder, int vt_step,
                                           const double* scalars, cudaStream_t stream) {
  if (dtype == tt::kFloat32)
    return launch<float>(in, out, ncol, nz, vorder, sorder, vt_step != 0, scalars, stream);
  return launch<double>(in, out, ncol, nz, vorder, sorder, vt_step != 0, scalars, stream);
}
