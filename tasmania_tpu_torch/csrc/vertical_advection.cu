// Three RK3WS stages of explicit vertical advection of (s, su, sv[, qv, qc, qr]).
//
// Replaces: tasmania_tpu/ops/vertical_advection_step.py:158
// fused_vertical_advection_rk3ws (pallas_call at :224), its default gcoef=True
// flux form.  Per column: the interface velocity wf[m] = (w[m-1] + w[m]) / 2
// and the flux coefficients g_d[m] (flux f[m] = sum_d g_d[m] phi[m+d], in the
// plain version's order of d) once; then x_i = x_0 + c_i T(x_{i-1}),
// c = (dt/3, dt/2, dt), with T(phi)[k] = (f[k+1] - f[k]) / dz on levels
// [e, nz-e) and 0 outside, the mass fractions advected as s q and divided by
// the stage's density.  The operation order is that of
// fused_vertical_advection_rk3ws_plain (ops/vertical_advection_step.py), whose
// division by dz PyTorch takes on the card as a product with 1/dz: so does
// the kernel.
//
// Bound on the H100: bytes.  At the flagship (161x161x120 float32, moist,
// third order) it reads 7 fields and writes 6, 162 MB, 48 us at 3.35 TB/s;
// 18 tendency evaluations of about 22 flops a level are far below the
// float32 rate.  Design: tpc threads own a column (a multiple of 32, from nz
// at launch: 128 at nz = 120), a thread R of its levels, k = lane + r tpc; a
// block of 256 threads holds 256 / tpc columns.  The field count NF is a
// template parameter, so the fields' pointers are picked with constant
// indices and stay out of local memory.  The stages are tt::VadvLevels
// (column.cuh), which vadv_sed.cu runs before its sedimentation: each
// thread issues all its loads at once (NF fields and two velocities a level,
// unrolled) into registers, where the initial state stays for the three
// stages, and forms the flux coefficients of its interfaces once; a stage
// forms each level's advected quantity (phi or s q, once) and each
// interface's flux once in shared memory, then each level's tendency and
// new value in registers, written out at the last stage.  Nothing but the
// inputs and the outputs touches device memory.

#include "column.cuh"

namespace {

constexpr int kThreads = 256;
// the most threads a column: R = 1, 2, 4 or 8 levels a thread take nz up
// to 128, 256, 512 or 1024
constexpr int kMaxTpc = 128;
constexpr int kMaxR = 8;

template <typename T, int ORDER, int NF, int R>
__global__ void __launch_bounds__(kThreads)
    vertical_advection_kernel(tt::Columns<T, NF> p, int ncol, int nz, int tpc, T c0, T c1, T c2,
                              T dz) {
  using V = tt::VadvLevels<T, ORDER, NF, R>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lc = threadIdx.x / tpc, lane = threadIdx.x % tpc;
  const int col = blockIdx.x * (blockDim.x / tpc) + lc;
  const bool live = col < ncol;  // a thread past the last column only joins the barriers
  const int base = col * nz;
  tt::VadvIn<T, NF, R> in;
  tt::load_vadv<ORDER>(in, p, base, live, lane, tpc, nz);
  V adv(in);
  adv.stages(reinterpret_cast<T*>(smem_raw) + lc * V::column_values(nz), lane, tpc, nz, c0, c1,
             c2, dz, [&](int f, int k, T x) {
               if (live) p.out[f][base + k] = x;
             });
}

template <typename T, int ORDER, int NF, int R>
int launch_r(const tt::Columns<T, NF>& p, int ncol, int nz, int tpc, const double* sc,
             cudaStream_t stream) {
  const int cpb = kThreads / tpc;  // columns a block
  const size_t smem = sizeof(T) * size_t(cpb) * tt::VadvLevels<T, ORDER, NF, R>::column_values(nz);
  auto kernel = vertical_advection_kernel<T, ORDER, NF, R>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const double dt = sc[0];
  const int blocks = (ncol + cpb - 1) / cpb;
  kernel<<<blocks, cpb * tpc, smem, stream>>>(p, ncol, nz, tpc, T(dt / 3.0), T(dt / 2.0), T(dt),
                                              T(sc[1]));
  return int(cudaGetLastError());
}

// R levels a thread and tpc threads a column (tt::column_split, a column
// within kMaxTpc threads)
template <typename T, int ORDER, int NF>
int launch_fields(const void* const* in, void* const* out, int ncol, int nz, const double* sc,
                  cudaStream_t stream) {
  tt::Columns<T, NF> p;
  for (int f = 0; f < NF + 1; ++f) p.in[f] = static_cast<const T*>(in[f]);
  for (int f = 0; f < NF; ++f) p.out[f] = static_cast<T*>(out[f]);
  int r = 1, tpc = 32;
  if (!tt::column_split<kMaxTpc, kMaxTpc, kMaxR>(nz, r, tpc)) return int(cudaErrorInvalidValue);
  switch (r) {
    case 1: return launch_r<T, ORDER, NF, 1>(p, ncol, nz, tpc, sc, stream);
    case 2: return launch_r<T, ORDER, NF, 2>(p, ncol, nz, tpc, sc, stream);
    case 4: return launch_r<T, ORDER, NF, 4>(p, ncol, nz, tpc, sc, stream);
    default: return launch_r<T, ORDER, NF, 8>(p, ncol, nz, tpc, sc, stream);
  }
}

template <typename T, int ORDER>
int launch_order(const void* const* in, void* const* out, int nf, int ncol, int nz,
                 const double* sc, cudaStream_t stream) {
  if (nf == 3) return launch_fields<T, ORDER, 3>(in, out, ncol, nz, sc, stream);
  return launch_fields<T, ORDER, 6>(in, out, ncol, nz, sc, stream);
}

template <typename T>
int launch(const void* const* in, void* const* out, int nf, int ncol, int nz, int order,
           const double* sc, cudaStream_t stream) {
  switch (order) {
    case 1: return launch_order<T, 1>(in, out, nf, ncol, nz, sc, stream);
    case 2: return launch_order<T, 2>(in, out, nf, ncol, nz, sc, stream);
    case 3: return launch_order<T, 3>(in, out, nf, ncol, nz, sc, stream);
    case 5: return launch_order<T, 5>(in, out, nf, ncol, nz, sc, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// in: w, s, su, sv[, qv, qc, qr]; out: the nf stepped fields (nf = 3 or 6);
// scalars: dt, dz; nz up to 1024 and ncol nz below 2^31
extern "C" int tt_vertical_advection_rk3ws(int dtype, const void* const* in, void* const* out,
                                           int nf, int ncol, int nz, int order,
                                           const double* scalars, cudaStream_t stream) {
  if ((nf != 3 && nf != 6) || nz < 1 || nz > kMaxR * kMaxTpc || int64_t(ncol) * nz > INT32_MAX)
    return int(cudaErrorInvalidValue);
  if (dtype == tt::kFloat32) return launch<float>(in, out, nf, ncol, nz, order, scalars, stream);
  return launch<double>(in, out, nf, ncol, nz, order, scalars, stream);
}
