// One RK stage of the conservative Smagorinsky update of (su, sv).
//
// Replaces: tasmania_tpu/ops/smagorinsky_step.py:149 _smag_rk2_fused
// (pallas_call at :241; entry fused_smagorinsky_rk2 at :261).  The TPU kernel
// runs both RK2 stages in one launch on VMEM windows 4 columns wider than its
// tile; here each stage is one launch (the wrapper launches stage 1 into a
// scratch pair, then stage 2), the algebra of the two-launch _smag_stage (:33).
//
// Per cell of [nb, nx-nb) x [nb, ny-nb): u = su_st/s, v = sv_st/s; the strain
// (s00, s01, s11) and the viscosity nu at the four neighbours (i+-1, j) and
// (i, j+-1); the tendency 2(dx(nu s00) + dy(nu s01)), 2(dx(nu s01) + dy(nu s11));
// out = base + (c s) tendency.  Every other cell (the nb-frame) gets base, so
// the output is complete and needs no paste.  Operation order as in
// smagorinsky_stage_plain (ops/smagorinsky_step.py); the strain and tendency
// are tt::smag_strain and tt::smag_tendency (common.cuh), shared with
// smooth_smag.cu.
//
// Bound on the H100: bytes.  A stage reads s, su_st, sv_st, su_base, sv_base
// and writes two fields: 7 x 12.44 MB = 87 MB at the flagship, 26 us at
// 3.35 TB/s (both stages 174 MB, 52 us; the function itself, 3 reads and 2
// writes, 62 MB).  Design: one thread per cell, k fastest: every neighbour read
// of a warp is a run of 32 along k, and the 13-point velocity diamond of a
// cell is re-read from L1/L2 by its neighbours rather than staged in shared
// memory (simple first; the re-reads are the kernel's excess over its bound).

#include "common.cuh"

namespace {

template <typename T>
__global__ void smagorinsky_stage_kernel(const T* __restrict__ s, const T* __restrict__ su_st,
                                         const T* __restrict__ sv_st,
                                         const T* __restrict__ su_base,
                                         const T* __restrict__ sv_base, T* __restrict__ su_out,
                                         T* __restrict__ sv_out, int nx, int ny, int nz, int nb,
                                         T c, T nuc, T dx2, T dy2) {
  const int64_t sy = nz;
  const int64_t sx = int64_t(ny) * nz;
  const int64_t total = int64_t(nx) * sx;
  for (int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += int64_t(gridDim.x) * blockDim.x) {
    const int j = int((e / nz) % ny);
    const int i = int(e / sx);
    if (i < nb || i >= nx - nb || j < nb || j >= ny - nb) {
      su_out[e] = su_base[e];
      sv_out[e] = sv_base[e];
      continue;
    }
    T u_tnd, v_tnd;
    tt::smag_tendency(tt::Ratio<T>{su_st, s}, tt::Ratio<T>{sv_st, s}, e, sx, sy, nuc, dx2, dy2,
                      u_tnd, v_tnd);
    const T cs = c * s[e];
    su_out[e] = su_base[e] + cs * u_tnd;
    sv_out[e] = sv_base[e] + cs * v_tnd;
  }
}

template <typename T>
int launch(const void* const* in, void* const* out, int nx, int ny, int nz, int nb,
           const double* sc, cudaStream_t stream) {
  const int64_t total = int64_t(nx) * ny * nz;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;
  auto I = [&](int i) { return static_cast<const T*>(in[i]); };
  auto O = [&](int i) { return static_cast<T*>(out[i]); };
  smagorinsky_stage_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      I(0), I(1), I(2), I(3), I(4), O(0), O(1), nx, ny, nz, nb, T(sc[0]), T(sc[1]), T(sc[2]),
      T(sc[3]));
  return int(cudaGetLastError());
}

}  // namespace

// in: s, su_stage, sv_stage, su_base, sv_base; out: su, sv (no aliasing);
// scalars: c, cs^2 dx dy, 2 dx, 2 dy
extern "C" int tt_smagorinsky_stage(int dtype, const void* const* in, void* const* out, int nx,
                                    int ny, int nz, int nb, const double* scalars,
                                    cudaStream_t stream) {
  if (nb < 2) return int(cudaErrorInvalidValue);
  if (dtype == tt::kFloat32) return launch<float>(in, out, nx, ny, nz, nb, scalars, stream);
  return launch<double>(in, out, nx, ny, nz, nb, scalars, stream);
}
