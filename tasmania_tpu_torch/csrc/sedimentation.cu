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
// PyTorch's `** 0.5` is.
//
// Bound on the H100: bytes.  At the flagship (161x161x120 float32) it reads
// rho, qr and the interface heights and writes qr and vt: 62 MB, 19 us at
// 3.35 TB/s; one or three powers a cell are about 10 Mflop of special
// functions.  Design: one warp per (x, y) column, z contiguous so the loads
// are coalesced; the column's coefficients and stage values live in shared
// memory (7 x nz values, 3.4 KB a warp in float32), __syncwarp() between the
// two halves of a stage (rqv of all levels, then the divergence).

#include "common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ T tsqrt(T x) { return sqrt(x); }

template <typename T, int ORDER>
__global__ void sedimentation_kernel(const T* __restrict__ rho_g, const T* __restrict__ hif_g,
                                     const T* __restrict__ qr_g, T* __restrict__ qr_out,
                                     T* __restrict__ vt_out, int ncol, int nz, bool vt_step,
                                     double dt) {
  constexpr int nb = ORDER;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t col = int64_t(blockIdx.x) * (blockDim.x / 32) + warp;
  if (col >= ncol) return;  // whole warps leave together
  T* smem = reinterpret_cast<T*>(smem_raw) + int64_t(warp) * 7 * nz;
  T* rho = smem;            // rho[k]
  T* ca = rho + nz;         // coefficients of level k (k >= nb)
  T* cb = ca + nz;
  T* cc = cb + nz;
  T* vt = cc + nz;          // the fall velocity in use
  T* rqv = vt + nz;         // rho qr vt of the stage
  T* q = rqv + nz;          // qr of the stage
  const int64_t base = col * nz;
  const T* hif = hif_g + col * (nz + 1);
  const T rho_s = rho_g[base + nz - 1];

  for (int k = lane; k < nz; k += 32) {
    rho[k] = rho_g[base + k];
    q[k] = qr_g[base + k];
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
        vt[k] = wsq * tt::tpow(T(1.0e-3) * rho[k] * (qk > T(0) ? qk : T(0)), T(0.1346));
        if (stage == 0) vt_out[base + k] = vt[k];
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
      const T x = qr_g[base + k] + c * tnd;
      if (stage == 2) {
        qr_out[base + k] = x;
      } else {
        q[k] = x;  // each lane rewrites only its own levels, read above
      }
    }
    __syncwarp();
  }
}

template <typename T, int ORDER>
int launch_order(const void* const* in, void* const* out, int ncol, int nz, bool vt_step,
                 double dt, cudaStream_t stream) {
  const size_t per_warp = sizeof(T) * 7 * size_t(nz);
  int wpb = int((48 * 1024) / per_warp);
  wpb = wpb < 1 ? 1 : (wpb > 4 ? 4 : wpb);
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
