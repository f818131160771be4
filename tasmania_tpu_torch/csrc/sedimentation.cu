// Three RK3WS stages of rain sedimentation with the Kessler fall velocity.
//
// Replaces: tasmania_tpu/ops/sedimentation_step.py:123 fused_sedimentation_rk3ws
// (pallas_call at :162; body _sed_rk3ws_body at :61).  Per column (surface =
// last level): the stage-invariant factors once (main-level heights, 1e-3 rho,
// 36.34 sqrt(rho_s / rho), the upwind height coefficients ca, cb, cc with 1/rho
// folded in); then per stage vt = wsq (mrho max(qr, 0))^0.1346 (at stage 1
// only when vt_step), rqv = rho qr vt, the divergence on levels [nb, nz), and
// qr_i = qr_0 + c_i T(qr_{i-1}), c = (dt/3, dt/2, dt).  Outputs: qr_3 and the
// stage-1 vt.  Operation order as in fused_sedimentation_rk3ws_plain
// (ops/sedimentation_step.py); the power is powf/pow and the root sqrt, as
// PyTorch's `** 0.5` is.  The column algebra is tt::sed_rk3ws_column
// (column.cuh), shared with vadv_sed.cu.
//
// Bound on the H100: bytes.  At the flagship (161x161x120 float32) it reads
// rho, qr and the interface heights and writes qr and vt: 62 MB, 19 us at
// 3.35 TB/s; one or three powers a cell are about 10 Mflop of special
// functions.  Design: one warp per (x, y) column, z contiguous so the loads
// are coalesced; the column's coefficients and stage values live in shared
// memory (7 x nz values, 3.4 KB a warp in float32), __syncwarp() between the
// two halves of a stage (rqv of all levels, then the divergence).

#include "column.cuh"

namespace {

template <typename T, int ORDER>
__global__ void sedimentation_kernel(const T* __restrict__ rho_g, const T* __restrict__ hif_g,
                                     const T* __restrict__ qr_g, T* __restrict__ qr_out,
                                     T* __restrict__ vt_out, int ncol, int nz, bool vt_step,
                                     double dt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t col = int64_t(blockIdx.x) * (blockDim.x / 32) + warp;
  if (col >= ncol) return;  // whole warps leave together
  T* smem = reinterpret_cast<T*>(smem_raw) + int64_t(warp) * tt::sed_smem_values(nz);
  const int64_t base = col * nz;
  tt::sed_rk3ws_column<T, ORDER>(rho_g + base, hif_g + col * (nz + 1), qr_g + base, qr_out + base,
                                 vt_out + base, nz, vt_step, dt, smem, lane);
}

template <typename T, int ORDER>
int launch_order(const void* const* in, void* const* out, int ncol, int nz, bool vt_step,
                 double dt, cudaStream_t stream) {
  const size_t per_warp = sizeof(T) * tt::sed_smem_values(nz);
  const int wpb = tt::warps_per_block(per_warp);
  const size_t smem = per_warp * wpb;
  auto kernel = sedimentation_kernel<T, ORDER>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const int64_t blocks = (int64_t(ncol) + wpb - 1) / wpb;
  kernel<<<static_cast<unsigned>(blocks), 32 * wpb, smem, stream>>>(
      static_cast<const T*>(in[0]), static_cast<const T*>(in[1]), static_cast<const T*>(in[2]),
      static_cast<T*>(out[0]), static_cast<T*>(out[1]), ncol, nz, vt_step, dt);
  return int(cudaGetLastError());
}

template <typename T>
int launch(const void* const* in, void* const* out, int ncol, int nz, int order, bool vt_step,
           double dt, cudaStream_t stream) {
  if (order == 1) return launch_order<T, 1>(in, out, ncol, nz, vt_step, dt, stream);
  if (order == 2) return launch_order<T, 2>(in, out, ncol, nz, vt_step, dt, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// in: rho, h_if (nz + 1 levels), qr; out: qr, vt (stage 1)
extern "C" int tt_sedimentation_rk3ws(int dtype, const void* const* in, void* const* out,
                                      int ncol, int nz, int order, int vt_step, double dt,
                                      cudaStream_t stream) {
  if (dtype == tt::kFloat32)
    return launch<float>(in, out, ncol, nz, order, vt_step != 0, dt, stream);
  return launch<double>(in, out, ncol, nz, order, vt_step != 0, dt, stream);
}
