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
// indices and stay out of local memory.  Each thread issues all its loads
// at once (NF fields and two velocities a level, unrolled) into registers,
// where the initial state stays for the three stages, and forms the flux
// coefficients of its interfaces (interface m = k, between levels k-1 and
// k) once.  A stage: (a) each level's advected quantity, phi or s q for a
// mass fraction (formed once), into shared memory; (b) each interface's
// flux once, into shared memory; (c) each level's tendency and new value, in
// registers and, at the last stage, written out.  A barrier of the block
// between (a), (b) and (c); nothing but the inputs and the outputs touches
// device memory.  In
// shared memory a level's NF values lie together at an odd stride, so that
// every access is a constant offset from the thread's level and the
// threads of consecutive levels reach distinct banks.

#include "column.cuh"

namespace {

constexpr int kThreads = 256;
// the most threads a column: R = 1, 2, 4 or 8 levels a thread take nz up
// to 128, 256, 512 or 1024
constexpr int kMaxTpc = 128;
constexpr int kMaxR = 8;

template <typename T, int NF>
struct Columns {
  const T* in[NF + 1];  // w, s, su, sv[, qv, qc, qr]
  T* out[NF];
};

// a level's stride in shared memory, the fields fastest: odd, so that the
// threads of consecutive levels reach distinct banks
template <int NF>
__host__ __device__ constexpr int level_stride() {
  return NF | 1;
}

// shared memory of one column, in values: phi of the NF fields on the nz
// levels, their fluxes at the nz + 1 interfaces
template <int NF>
__host__ __device__ constexpr int column_values(int nz) {
  return level_stride<NF>() * (2 * nz + 1);
}

template <typename T, int ORDER, int NF, int R>
__global__ void __launch_bounds__(kThreads)
    vertical_advection_kernel(Columns<T, NF> p, int ncol, int nz, int tpc, T c0, T c1, T c2, T dz) {
  using F = tt::Flux<ORDER>;
  constexpr int e = F::e;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lc = threadIdx.x / tpc, lane = threadIdx.x % tpc;
  const int col = blockIdx.x * (blockDim.x / tpc) + lc;
  const bool live = col < ncol;  // a thread past the last column only joins the barriers
  constexpr int P = level_stride<NF>();
  T* phi = reinterpret_cast<T*>(smem_raw) + lc * column_values<NF>(nz);  // phi[k P + f]
  T* flux = phi + nz * P;                                                 // flux[m P + f]
  const int base = col * nz;
  const T rdz = T(1) / dz;  // PyTorch divides by the scalar dz on the card as a product with this

  // every load of the thread at once: its levels of the fields, and the two
  // velocities of each of its interfaces
  T x0[NF][R], x[NF][R], g[F::n][R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = lane + r * tpc;
    const bool level = live && k < nz;
    const bool face = level && k >= e && k <= nz - e;
#pragma unroll
    for (int f = 0; f < NF; ++f) x0[f][r] = level ? p.in[1 + f][base + k] : T(0);
    const T wm = face ? p.in[0][base + k - 1] : T(0);
    const T wk = face ? p.in[0][base + k] : T(0);
    T gm[F::n];
    tt::flux_coefficients<T, ORDER>(T(0.5) * (wm + wk), gm);
#pragma unroll
    for (int i = 0; i < F::n; ++i) g[i][r] = gm[i];
#pragma unroll
    for (int f = 0; f < NF; ++f) x[f][r] = x0[f][r];
  }

#pragma unroll
  for (int stage = 0; stage < 3; ++stage) {
    const T c = stage == 0 ? c0 : (stage == 1 ? c1 : c2);
    // (a) the advected quantities: phi, s q for the mass fractions
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = lane + r * tpc;
      if (k < nz) {
#pragma unroll
        for (int f = 0; f < NF; ++f) phi[k * P + f] = f >= 3 ? x[0][r] * x[f][r] : x[f][r];
      }
    }
    __syncthreads();
    // (b) the flux at each interface m = k in [e, nz - e], once
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int m = lane + r * tpc;
      if (m >= e && m <= nz - e) {
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const T* q = phi + m * P + f;
          T acc = g[0][r] * q[F::off(0) * P];
#pragma unroll
          for (int i = 1; i < F::n; ++i) acc = acc + g[i][r] * q[F::off(i) * P];
          flux[m * P + f] = acc;
        }
      }
    }
    __syncthreads();
    // (c) the tendencies on levels [e, nz - e) and the stage's new values
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = lane + r * tpc;
      if (k >= nz) continue;
      const bool inner = k >= e && k < nz - e;
      const T inv_s = NF > 3 && inner ? T(1) / x[0][r] : T(0);  // the stage's density
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        T tnd = T(0);
        if (inner) {
          const T* fl = flux + k * P + f;
          tnd = (fl[P] - fl[0]) * rdz;
          if (f >= 3) tnd = tnd * inv_s;
        }
        x[f][r] = x0[f][r] + c * tnd;
        if (stage == 2 && live) p.out[f][base + k] = x[f][r];
      }
    }
  }
}

template <typename T, int ORDER, int NF, int R>
int launch_r(const Columns<T, NF>& p, int ncol, int nz, int tpc, const double* sc,
             cudaStream_t stream) {
  const int cpb = kThreads / tpc;  // columns a block
  const size_t smem = sizeof(T) * size_t(cpb) * column_values<NF>(nz);
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

// R levels a thread, the fewest that keep a column within kMaxTpc threads;
// tpc the levels a thread's R leaves, rounded up to whole warps
template <typename T, int ORDER, int NF>
int launch_fields(const void* const* in, void* const* out, int ncol, int nz, const double* sc,
                  cudaStream_t stream) {
  Columns<T, NF> p;
  for (int f = 0; f < NF + 1; ++f) p.in[f] = static_cast<const T*>(in[f]);
  for (int f = 0; f < NF; ++f) p.out[f] = static_cast<T*>(out[f]);
  int r = 1;
  while (r < kMaxR && (nz + r - 1) / r > kMaxTpc) r *= 2;
  const int tpc = ((nz + r - 1) / r + 31) / 32 * 32;
  if (tpc > kMaxTpc) return int(cudaErrorInvalidValue);
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
