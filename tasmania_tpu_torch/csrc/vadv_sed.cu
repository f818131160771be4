// Vertical advection RK3WS of (s, su, sv, qv, qc, qr), then the fall velocity
// and sedimentation RK3WS of the advected qr, in one launch.
//
// Replaces: tasmania_tpu/ops/vertical_advection_step.py:242
// fused_vadv_sedimentation_rk3ws (pallas_call at :308), the SUS process pair
// [IsentropicVerticalAdvection(rk3ws) -> [KesslerFallVelocity,
// KesslerSedimentation](rk3ws)].  Both are column-local: a column runs
// through tt::VadvLevels (vertical_advection.cu's stages) and then
// tt::sed_stages (sedimentation.cu's) with the density and interface heights
// of the state before the pair.  Outputs: the advected s, su, sv, qv, qc, the
// sedimented qr and the stage-1 fall velocity; the advected qr never leaves
// the registers.  Operation order: that of
// fused_vertical_advection_rk3ws_plain followed by
// fused_sedimentation_rk3ws_plain (ops/), so the kernel gives the bits of
// those two kernels run in turn.
//
// Bound on the H100: bytes.  At the flagship (161x161x120 float32, third-
// order advection, second-order sedimentation) it reads w, s, su, sv, qv,
// qc, qr, rho and the interface heights and writes seven fields: 199 MB,
// 59 us at 3.35 TB/s.  Design (vertical_advection.cu's column layout): a
// block a column, tpc threads (a multiple of 32, from nz at launch: 128 at
// nz = 120), a thread R of its levels, k = lane + r tpc.  Each thread issues
// every load at once, into registers: the seven advection inputs of its
// levels and the sedimentation's rho, the two interface heights of each
// level and the surface density, so that the sedimentation's loads land
// while the advection's three stages run.  The advection keeps its initial
// state and flux coefficients in registers and forms each interface flux
// once a stage through shared memory; its last stage writes the five
// advected fields and leaves qr in the thread's registers as the
// sedimentation's qr0.  After one barrier the sedimentation's three stages
// reuse the advection's shared memory: the coefficients from the heights of
// levels k-1 and k-2, rho qr vt through two alternating buffers, one barrier
// a stage.  Nothing but the inputs and the outputs touches device memory.
// A block of one column couples fewer threads at each of its ten barriers
// than vertical_advection.cu's two columns a block, and timed faster on the
// H100; so did it against blocks that step several columns in turn with
// the next one's loads in flight (sedimentation.cu's kWaves), which also
// moved the contraction of an expression and with it the last bit of qr.

#include "column.cuh"

namespace {

// the most threads a column, at kMaxR levels a thread, so nz up to kThreads
// kMaxR (the registers of kMaxR levels a thread hold without a spill in
// float64); below kMaxR a column takes at most kMaxTpc threads
constexpr int kThreads = 256;
constexpr int kMaxTpc = 128;
constexpr int kMaxR = 4;

template <typename T, int VORDER, int SORDER, int R>
__global__ void __launch_bounds__(kThreads, 1)
    vadv_sed_kernel(tt::Columns<T, 6> p, const T* __restrict__ rho, const T* __restrict__ h_if,
                    T* __restrict__ vt_out, int nz, bool vt_step, T c0, T c1, T c2, T dz) {
  using V = tt::VadvLevels<T, VORDER, 6, R>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int col = blockIdx.x, lane = threadIdx.x, tpc = blockDim.x;  // a block a column
  const int base = col * nz;
  tt::VadvIn<T, 6, R> in;
  tt::SedColumn<T, R> sed;
  tt::load_vadv<VORDER>(in, p, base, true, lane, tpc, nz);
  tt::load_sed<false>(sed, rho, h_if, static_cast<const T*>(nullptr), col, col + 1, nz, tpc, lane);
  // the advection; its qr stays in registers as the sedimentation's qr0
  V adv(in);
  adv.stages(smem, lane, tpc, nz, c0, c1, c2, dz, [&](int f, int k, T x) {
    if (f < 5) p.out[f][base + k] = x;
  });
#pragma unroll
  for (int r = 0; r < R; ++r) sed.q0[r] = adv.x[5][r];
  __syncthreads();  // every flux read: the shared memory is the sedimentation's
  tt::sed_stages<T, SORDER, R>(sed, smem, smem + nz, smem + 2 * nz, false, true, lane, tpc, nz,
                               vt_step, c0, c1, c2, p.out[5] + base, vt_out + base);
}

template <typename T, int VORDER, int SORDER, int R>
int launch_r(const tt::Columns<T, 6>& p, const T* rho, const T* h_if, T* vt, int ncol, int nz,
             int tpc, bool vt_step, const double* sc, cudaStream_t stream) {
  // the advection's buffers (7 (2 nz + 1) values), which the
  // sedimentation's 3 nz reuse
  const size_t smem = sizeof(T) * size_t(tt::VadvLevels<T, VORDER, 6, R>::column_values(nz));
  auto kernel = vadv_sed_kernel<T, VORDER, SORDER, R>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const double dt = sc[0];
  kernel<<<ncol, tpc, smem, stream>>>(p, rho, h_if, vt, nz, vt_step, T(dt / 3.0), T(dt / 2.0),
                                      T(dt), T(sc[1]));
  return int(cudaGetLastError());
}

// R levels a thread and tpc threads a column (tt::column_split)
template <typename T, int VORDER, int SORDER>
int launch_orders(const tt::Columns<T, 6>& p, const T* rho, const T* h_if, T* vt, int ncol,
                  int nz, bool vt_step, const double* sc, cudaStream_t stream) {
  int r = 1, tpc = 32;
  if (!tt::column_split<kThreads, kMaxTpc, kMaxR>(nz, r, tpc)) return int(cudaErrorInvalidValue);
  switch (r) {
    case 1: return launch_r<T, VORDER, SORDER, 1>(p, rho, h_if, vt, ncol, nz, tpc, vt_step, sc, stream);
    case 2: return launch_r<T, VORDER, SORDER, 2>(p, rho, h_if, vt, ncol, nz, tpc, vt_step, sc, stream);
    default: return launch_r<T, VORDER, SORDER, 4>(p, rho, h_if, vt, ncol, nz, tpc, vt_step, sc, stream);
  }
}

template <typename T, int VORDER>
int launch_vorder(const tt::Columns<T, 6>& p, const T* rho, const T* h_if, T* vt, int ncol, int nz,
                  int sorder, bool vt_step, const double* sc, cudaStream_t stream) {
  if (sorder == 1) return launch_orders<T, VORDER, 1>(p, rho, h_if, vt, ncol, nz, vt_step, sc, stream);
  if (sorder == 2) return launch_orders<T, VORDER, 2>(p, rho, h_if, vt, ncol, nz, vt_step, sc, stream);
  return int(cudaErrorInvalidValue);
}

template <typename T>
int launch(const void* const* in, void* const* out, int ncol, int nz, int vorder, int sorder,
           bool vt_step, const double* sc, cudaStream_t stream) {
  tt::Columns<T, 6> p;
  for (int f = 0; f < 7; ++f) p.in[f] = static_cast<const T*>(in[f]);
  for (int f = 0; f < 6; ++f) p.out[f] = static_cast<T*>(out[f]);
  const T* rho = static_cast<const T*>(in[7]);
  const T* h_if = static_cast<const T*>(in[8]);
  T* vt = static_cast<T*>(out[6]);
  switch (vorder) {
    case 1: return launch_vorder<T, 1>(p, rho, h_if, vt, ncol, nz, sorder, vt_step, sc, stream);
    case 2: return launch_vorder<T, 2>(p, rho, h_if, vt, ncol, nz, sorder, vt_step, sc, stream);
    case 3: return launch_vorder<T, 3>(p, rho, h_if, vt, ncol, nz, sorder, vt_step, sc, stream);
    case 5: return launch_vorder<T, 5>(p, rho, h_if, vt, ncol, nz, sorder, vt_step, sc, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// in: w, s, su, sv, qv, qc, qr, rho, h_if (nz + 1 levels); out: s, su, sv,
// qv, qc advected, qr advected and sedimented, vt (stage 1) (no aliasing);
// scalars: dt, dz; nz up to kThreads kMaxR (1024) and ncol (nz + 1) below 2^31
extern "C" int tt_vadv_sedimentation_rk3ws(int dtype, const void* const* in, void* const* out,
                                           int ncol, int nz, int vorder, int sorder, int vt_step,
                                           const double* scalars, cudaStream_t stream) {
  if (ncol < 1 || nz < 1 || nz > kThreads * kMaxR || int64_t(ncol) * (nz + 1) > INT32_MAX)
    return int(cudaErrorInvalidValue);
  if (dtype == tt::kFloat32)
    return launch<float>(in, out, ncol, nz, vorder, sorder, vt_step != 0, scalars, stream);
  return launch<double>(in, out, ncol, nz, vorder, sorder, vt_step != 0, scalars, stream);
}
