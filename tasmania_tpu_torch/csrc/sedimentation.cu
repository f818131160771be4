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
// PyTorch's `** 0.5` is, and each division an IEEE division.
//
// Bound on the H100: bytes.  At the flagship (161x161x120 float32) it reads
// rho, qr and the interface heights and writes qr and vt: 62 MB, 19 us at
// 3.35 TB/s; one or three powers a cell are about 10 Mflop of special
// functions, but with five IEEE divisions and a root a level the
// instructions issued come close to the bytes.  Design
// (vertical_advection.cu's): tpc threads own a column (a multiple of 32, from
// nz at launch: 128 at nz = 120), a thread R of its levels, k = lane + r tpc;
// a block of 256 threads holds 256 / tpc columns, and kWaves blocks a
// resident slot of the card step their columns in turn, the next column's
// loads in flight while one is stepped.  Each thread issues all its loads at
// once (rho, qr0, the two interface heights of each of its levels, and the
// surface density: tt::load_sed) and keeps its levels' state in registers
// for the three stages of tt::sed_stages (column.cuh, which vadv_sed.cu runs
// after its advection): the coefficients from the heights of levels k-1 and
// k-2 in shared memory, rho qr vt through two alternating buffers, one
// barrier of the block a stage.  Nothing but the inputs and the outputs
// touches device memory.

#include "column.cuh"

namespace {

constexpr int kThreads = 256;
// the most threads a column while a thread takes fewer than kMaxR levels;
// at kMaxR a column may take the whole block, so nz up to kThreads kMaxR
// (the registers of kMaxR levels a thread hold without a spill in float64)
constexpr int kMaxTpc = 128;
constexpr int kMaxR = 8;
// blocks a resident slot of the card: each block steps its columns in turn,
// timed as variants on the H100 (PERF.md)
constexpr int kWaves = 2;
// levels a thread up to which the next column's loads are in flight while
// one is stepped (their registers taken twice)
constexpr int kPrefetchR = 2;

template <typename T, int ORDER, int R>
__global__ void __launch_bounds__(kThreads)
    sedimentation_kernel(const T* __restrict__ rho_g, const T* __restrict__ hif_g,
                         const T* __restrict__ qr_g, T* __restrict__ qr_out,
                         T* __restrict__ vt_out, int ncol, int nz, int tpc, bool vt_step, T c0,
                         T c1, T c2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cpb = blockDim.x / tpc;
  const int lc = threadIdx.x / tpc, lane = threadIdx.x % tpc;
  T* hm = reinterpret_cast<T*>(smem_raw) + lc * tt::sed_column_values(nz);  // hm[k]
  T* const rq0 = hm + nz;  // rho qr vt of the even stages (counted over the
  T* const rq1 = rq0 + nz;  // block's columns), and of the odd ones
  const int stride = gridDim.x * cpb;

  constexpr bool prefetch = R <= kPrefetchR;
  tt::SedColumn<T, R> in, next;
  tt::load_sed<true>(in, rho_g, hif_g, qr_g, blockIdx.x * cpb + lc, ncol, nz, tpc, lane);
  bool odd = false;
  // the block's columns in turn (the next column's loads in flight while
  // this one is stepped, up to kPrefetchR levels a thread); every thread of
  // the block takes each turn, a thread past the last column only joining
  // the barriers
  for (int first = blockIdx.x * cpb; first < ncol; first += stride) {
    const int col = first + lc;
    const int64_t base = int64_t(col) * nz;
    if (prefetch) tt::load_sed<true>(next, rho_g, hif_g, qr_g, col + stride, ncol, nz, tpc, lane);
    odd = tt::sed_stages<T, ORDER, R>(in, hm, rq0, rq1, odd, col < ncol, lane, tpc, nz, vt_step, c0,
                                      c1, c2, qr_out + base, vt_out + base);
    if (prefetch) {
      in = next;
    } else {
      tt::load_sed<true>(in, rho_g, hif_g, qr_g, col + stride, ncol, nz, tpc, lane);
    }
  }
}

// the launch of R levels a thread at tpc threads a column: at most kWaves
// blocks a resident slot of the card
template <typename T, int ORDER, int R>
int launch_r(const void* const* in, void* const* out, int ncol, int nz, int tpc, bool vt_step,
             double dt, cudaStream_t stream) {
  const int cpb = kThreads / tpc;  // columns a block
  const size_t smem = sizeof(T) * size_t(cpb) * tt::sed_column_values(nz);
  auto kernel = sedimentation_kernel<T, ORDER, R>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, cpb * tpc, smem);
  if (err != cudaSuccess) return int(err);
  const int64_t slots = int64_t(kWaves) * sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = int(slots < (ncol + cpb - 1) / cpb ? slots : (ncol + cpb - 1) / cpb);
  kernel<<<blocks, cpb * tpc, smem, stream>>>(
      static_cast<const T*>(in[0]), static_cast<const T*>(in[1]), static_cast<const T*>(in[2]),
      static_cast<T*>(out[0]), static_cast<T*>(out[1]), ncol, nz, tpc, vt_step, T(dt / 3.0),
      T(dt / 2.0), T(dt));
  return int(cudaGetLastError());
}

// R levels a thread and tpc threads a column (tt::column_split)
template <typename T, int ORDER>
int launch_order(const void* const* in, void* const* out, int ncol, int nz, bool vt_step,
                 double dt, cudaStream_t stream) {
  int r = 1, tpc = 32;
  if (!tt::column_split<kThreads, kMaxTpc, kMaxR>(nz, r, tpc)) return int(cudaErrorInvalidValue);
  switch (r) {
    case 1: return launch_r<T, ORDER, 1>(in, out, ncol, nz, tpc, vt_step, dt, stream);
    case 2: return launch_r<T, ORDER, 2>(in, out, ncol, nz, tpc, vt_step, dt, stream);
    case 4: return launch_r<T, ORDER, 4>(in, out, ncol, nz, tpc, vt_step, dt, stream);
    default: return launch_r<T, ORDER, 8>(in, out, ncol, nz, tpc, vt_step, dt, stream);
  }
}

template <typename T>
int launch(const void* const* in, void* const* out, int ncol, int nz, int order, bool vt_step,
           double dt, cudaStream_t stream) {
  if (order == 1) return launch_order<T, 1>(in, out, ncol, nz, vt_step, dt, stream);
  if (order == 2) return launch_order<T, 2>(in, out, ncol, nz, vt_step, dt, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// in: rho, h_if (nz + 1 levels), qr; out: qr, vt (stage 1); nz up to
// kThreads kMaxR (2048)
extern "C" int tt_sedimentation_rk3ws(int dtype, const void* const* in, void* const* out,
                                      int ncol, int nz, int order, int vt_step, double dt,
                                      cudaStream_t stream) {
  if (ncol < 1 || nz < 1 || nz > kThreads * kMaxR) return int(cudaErrorInvalidValue);
  if (dtype == tt::kFloat32)
    return launch<float>(in, out, ncol, nz, order, vt_step != 0, dt, stream);
  return launch<double>(in, out, ncol, nz, order, vt_step != 0, dt, stream);
}
