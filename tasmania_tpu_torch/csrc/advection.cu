// The kernels of the semi-implicit stages that do not run as one whole-stage
// kernel: the two-kernel stage taken when the dynamical core is given
// tendencies, and the unfused stage of a one-dimensional relaxed boundary.
//
// Replaces: tasmania_tpu/ops/advection_step.py:140 fused_advection_fields
// (pallas_call at :246), :282 fused_momentum_step (pallas_call at :361) and
// :422 fused_momentum_epilogue (pallas_call at :579).  The algebra, per cell
// (i, j, k) of the whole (nx, ny, nz) array, with third- or fifth-order
// upwind fluxes (a template parameter; the epilogue fifth order only):
//
//   advection_fields, for each of F fields phi (field 0 the density; a field
//   flagged in q_mask enters as a mass fraction q and is advected as the
//   water density clip(s q), formed from field 0 in registers):
//     out = phi_now - dt (div(u, v, phi_int) - tnd)   on the nb-inset interior
//     out = phi_now                                    on the nb-wide frame
//     and field 0 is then enforced (relaxed BC) when gamma is given;
//   momentum_step, from the stepped density s_new and its Montgomery
//   potential:
//     su = su_now - dt (div(u, v, su_int) + (1-eps) s_now dmtg_now/dx
//                       + eps s_new dmtg_new/dx - su_tnd)   (frame: su_now),
//     sv alike;
//   momentum_epilogue, from the stepped, enforced density s_e, the Montgomery
//   potential of s_e and the stepped water densities sq:
//     su = su_now - dt (div(u, v, su_int) + (1-eps) s_now dmtg_now/dx
//                       + eps s_e dmtg/dx - su_tnd)    (frame: su_now), sv alike
//     q  = clip(sq / s_e)
//     then every output enforced (s a second time) and, with a Rayleigh
//     profile, s, su, sv damped toward the reference from the "now" values
//     with the full timestep.
//
// Every kernel writes the frame itself, so no paste follows (the TPU kernels
// leave the x-frame to XLA).  On a grid one cell deep in y (ny = 2 nb + 1)
// exactly one row is interior; its y-stencil reads rows nb - e .. nb + e, all
// inside the array, and v is zero there.  Every formula keeps the operation
// order of the plain versions in ops/advection_step.py; kernel and plain
// version differ by FMA contraction.
//
// Bound on the H100: bytes.  At the flagship (161x161x120 float32, one field
// 12.4 MB) advection_fields reads u, v and 12 cell fields (4 now, 4 int, 4
// tendencies) plus gamma and the reference and writes 4 (about 235 MB,
// 70 us at 3.35 TB/s); momentum_step reads u, v and 8 cell fields and writes
// 2 (about 150 MB, 45 us; at the mountain wave's 161x7x120, 6.6 MB and 2 us,
// below a launch's cost); momentum_epilogue reads u, v and 18 cell fields
// (momenta now and int, s now and stepped, both potentials, 3 sq, 6
// references, 2 tendencies) and writes 6 (about 324 MB, 97 us).  The
// arithmetic (an upwind divergence per field and cell) is far below the
// float32 rate.  Design: the TPU
// kernels' x-tiles, clamped tile starts and VMEM windows are Mosaic artefacts
// and are not carried over.  One thread per cell, k (the contiguous axis)
// fastest, so the stencil reads of a warp coalesce along k and the x and y
// neighbours come from L1/L2.

#include "common.cuh"

namespace {

constexpr int kMaxFields = 8;
constexpr int kMaxQ = 3;

unsigned blocks_for(int64_t n, int threads) {
  int64_t b = (n + threads - 1) / threads;
  return unsigned(b > 65535 ? 65535 : b);
}

template <typename T>
struct AdvectionArgs {
  const T *u, *v, *gamma, *ref0;
  const T* now[kMaxFields];
  const T* in[kMaxFields];
  const T* tnd[kMaxFields];  // null: no tendency for that field
  T* out[kMaxFields];
  int nf, q_mask, nx, ny, nz, nb;
  T dt, dx, dy;
};

template <int Order, typename T>
__global__ void advection_fields_kernel(AdvectionArgs<T> a) {
  const int64_t total = int64_t(a.nx) * a.ny * a.nz;
  for (int64_t c = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; c < total;
       c += int64_t(gridDim.x) * blockDim.x) {
    const int k = int(c % a.nz);
    const int j = int((c / a.nz) % a.ny);
    const int i = int(c / (int64_t(a.ny) * a.nz));
    const bool inner = i >= a.nb && i < a.nx - a.nb && j >= a.nb && j < a.ny - a.nb;
    for (int f = 0; f < a.nf; ++f) {
      const bool qp = (a.q_mask >> f) & 1;
      const T now = qp ? tt::clip_pos(a.now[0][c] * a.now[f][c]) : a.now[f][c];
      T res = now;
      if (inner) {
        T rhs = qp ? tt::div_upwind<Order>(a.u, a.v, tt::ClipProduct<T>{a.in[0], a.in[f]}, i, j,
                                           k, a.nx, a.ny, a.nz, a.dx, a.dy)
                   : tt::div_upwind<Order>(a.u, a.v, tt::Plain<T>{a.in[f]}, i, j, k, a.nx, a.ny,
                                           a.nz, a.dx, a.dy);
        if (a.tnd[f] != nullptr) rhs = rhs - a.tnd[f][c];
        res = now - a.dt * rhs;
      }
      if (f == 0 && a.gamma != nullptr) {
        res = tt::enforce(res, a.gamma[int64_t(i) * a.ny + j], a.ref0[c]);
      }
      a.out[f][c] = res;
    }
  }
}

template <typename T>
struct MomentumArgs {
  const T *u, *v, *su_now, *sv_now, *su_int, *sv_int, *s_now, *mtg_now, *s_new, *mtg_new;
  const T *su_tnd, *sv_tnd;  // both null: no tendencies
  T *su_out, *sv_out;
  int nx, ny, nz, nb;
  T dt, dx, dy, eps;
};

template <int Order, typename T>
__global__ void momentum_step_kernel(MomentumArgs<T> a) {
  const int64_t sx = int64_t(a.ny) * a.nz;
  const int64_t total = int64_t(a.nx) * sx;
  for (int64_t c = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; c < total;
       c += int64_t(gridDim.x) * blockDim.x) {
    const int k = int(c % a.nz);
    const int j = int((c / a.nz) % a.ny);
    const int i = int(c / sx);
    const T sun = a.su_now[c];
    const T svn = a.sv_now[c];
    T sup = sun, svp = svn;
    if (i >= a.nb && i < a.nx - a.nb && j >= a.nb && j < a.ny - a.nb) {
      const T sn = a.s_now[c];
      const T sw = a.s_new[c];
      const T pgx = (T(1) - a.eps) * sn * (a.mtg_now[c + sx] - a.mtg_now[c - sx]) / (T(2) * a.dx) +
                    a.eps * sw * (a.mtg_new[c + sx] - a.mtg_new[c - sx]) / (T(2) * a.dx);
      const T pgy = (T(1) - a.eps) * sn * (a.mtg_now[c + a.nz] - a.mtg_now[c - a.nz]) / (T(2) * a.dy) +
                    a.eps * sw * (a.mtg_new[c + a.nz] - a.mtg_new[c - a.nz]) / (T(2) * a.dy);
      T su_rhs = tt::div_upwind<Order>(a.u, a.v, tt::Plain<T>{a.su_int}, i, j, k, a.nx, a.ny, a.nz,
                                       a.dx, a.dy) + pgx;
      T sv_rhs = tt::div_upwind<Order>(a.u, a.v, tt::Plain<T>{a.sv_int}, i, j, k, a.nx, a.ny, a.nz,
                                       a.dx, a.dy) + pgy;
      if (a.su_tnd != nullptr) {
        su_rhs = su_rhs - a.su_tnd[c];
        sv_rhs = sv_rhs - a.sv_tnd[c];
      }
      sup = sun - a.dt * su_rhs;
      svp = svn - a.dt * sv_rhs;
    }
    a.su_out[c] = sup;
    a.sv_out[c] = svp;
  }
}

template <typename T>
struct EpilogueArgs {
  const T *u, *v, *su_now, *sv_now, *su_int, *sv_int, *s_now, *mtg_now, *s_e, *mtg;
  const T *gamma, *s_ref, *su_ref, *sv_ref, *rmat, *su_tnd, *sv_tnd;  // rmat, tnd: may be null
  const T* sq[kMaxQ];
  const T* q_ref[kMaxQ];
  T *s_out, *su_out, *sv_out;
  T* q_out[kMaxQ];
  int nq, nx, ny, nz, nb;
  T dt, dtf, dx, dy, eps;
};

template <typename T>
__global__ void momentum_epilogue_kernel(EpilogueArgs<T> a) {
  const int64_t sx = int64_t(a.ny) * a.nz;
  const int64_t total = int64_t(a.nx) * sx;
  for (int64_t c = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; c < total;
       c += int64_t(gridDim.x) * blockDim.x) {
    const int k = int(c % a.nz);
    const int j = int((c / a.nz) % a.ny);
    const int i = int(c / sx);
    const bool inner = i >= a.nb && i < a.nx - a.nb && j >= a.nb && j < a.ny - a.nb;
    const bool damp = a.rmat != nullptr;
    const T rm = damp ? a.rmat[k] : T(0);
    const T gm = a.gamma[int64_t(i) * a.ny + j];
    const T sn = a.s_now[c];
    const T se = a.s_e[c];

    // density: second enforcement, then damping
    T sf = tt::enforce(se, gm, a.s_ref[c]);
    if (damp) sf = sf - a.dtf * rm * (sn - a.s_ref[c]);
    a.s_out[c] = sf;

    // momenta with the semi-implicit pressure gradient and the tendencies
    const T sun = a.su_now[c];
    const T svn = a.sv_now[c];
    T sup = sun, svp = svn;
    if (inner) {
      const T pgx = (T(1) - a.eps) * sn * (a.mtg_now[c + sx] - a.mtg_now[c - sx]) / (T(2) * a.dx) +
                    a.eps * se * (a.mtg[c + sx] - a.mtg[c - sx]) / (T(2) * a.dx);
      const T pgy = (T(1) - a.eps) * sn * (a.mtg_now[c + a.nz] - a.mtg_now[c - a.nz]) / (T(2) * a.dy) +
                    a.eps * se * (a.mtg[c + a.nz] - a.mtg[c - a.nz]) / (T(2) * a.dy);
      T su_rhs = tt::div5(a.u, a.v, tt::Plain<T>{a.su_int}, i, j, k, a.nx, a.ny, a.nz, a.dx, a.dy) + pgx;
      T sv_rhs = tt::div5(a.u, a.v, tt::Plain<T>{a.sv_int}, i, j, k, a.nx, a.ny, a.nz, a.dx, a.dy) + pgy;
      if (a.su_tnd != nullptr) {
        su_rhs = su_rhs - a.su_tnd[c];
        sv_rhs = sv_rhs - a.sv_tnd[c];
      }
      sup = sun - a.dt * su_rhs;
      svp = svn - a.dt * sv_rhs;
    }
    T suf = tt::enforce(sup, gm, a.su_ref[c]);
    T svf = tt::enforce(svp, gm, a.sv_ref[c]);
    if (damp) {
      suf = suf - a.dtf * rm * (sun - a.su_ref[c]);
      svf = svf - a.dtf * rm * (svn - a.sv_ref[c]);
    }
    a.su_out[c] = suf;
    a.sv_out[c] = svf;

    // water species: the stepped densities back to clipped mass fractions
    for (int q = 0; q < a.nq; ++q) {
      a.q_out[q][c] = tt::enforce(tt::clip_pos(a.sq[q][c] / se), gm, a.q_ref[q][c]);
    }
  }
}

template <int Order, typename T>
int launch_advection(const void* const* ptrs, void* const* outs, int nf, int q_mask, int nx, int ny,
                     int nz, int nb, const double* s, cudaStream_t stream) {
  AdvectionArgs<T> a;
  a.u = static_cast<const T*>(ptrs[0]);
  a.v = static_cast<const T*>(ptrs[1]);
  a.gamma = static_cast<const T*>(ptrs[2]);
  a.ref0 = static_cast<const T*>(ptrs[3]);
  for (int f = 0; f < nf; ++f) {
    a.now[f] = static_cast<const T*>(ptrs[4 + f]);
    a.in[f] = static_cast<const T*>(ptrs[4 + nf + f]);
    a.tnd[f] = static_cast<const T*>(ptrs[4 + 2 * nf + f]);
    a.out[f] = static_cast<T*>(outs[f]);
  }
  a.nf = nf; a.q_mask = q_mask; a.nx = nx; a.ny = ny; a.nz = nz; a.nb = nb;
  a.dt = T(s[0]); a.dx = T(s[1]); a.dy = T(s[2]);
  const int threads = 256;
  advection_fields_kernel<Order, T>
      <<<blocks_for(int64_t(nx) * ny * nz, threads), threads, 0, stream>>>(a);
  return int(cudaGetLastError());
}

template <int Order, typename T>
int launch_momentum(const void* const* ptrs, void* const* outs, int nx, int ny, int nz, int nb,
                    const double* s, cudaStream_t stream) {
  MomentumArgs<T> a;
  const T** in[] = {&a.u, &a.v, &a.su_now, &a.sv_now, &a.su_int, &a.sv_int, &a.s_now, &a.mtg_now,
                    &a.s_new, &a.mtg_new, &a.su_tnd, &a.sv_tnd};
  const int nin = int(sizeof(in) / sizeof(in[0]));
  for (int n = 0; n < nin; ++n) *in[n] = static_cast<const T*>(ptrs[n]);
  a.su_out = static_cast<T*>(outs[0]);
  a.sv_out = static_cast<T*>(outs[1]);
  a.nx = nx; a.ny = ny; a.nz = nz; a.nb = nb;
  a.dt = T(s[0]); a.dx = T(s[1]); a.dy = T(s[2]); a.eps = T(s[3]);
  const int threads = 256;
  momentum_step_kernel<Order, T><<<blocks_for(int64_t(nx) * ny * nz, threads), threads, 0, stream>>>(a);
  return int(cudaGetLastError());
}

template <typename T>
int launch_epilogue(const void* const* ptrs, void* const* outs, int nq, int nx, int ny, int nz,
                    int nb, const double* s, cudaStream_t stream) {
  EpilogueArgs<T> a;
  const T** in[] = {&a.u, &a.v, &a.su_now, &a.sv_now, &a.su_int, &a.sv_int, &a.s_now, &a.mtg_now,
                    &a.s_e, &a.mtg, &a.gamma, &a.s_ref, &a.su_ref, &a.sv_ref, &a.rmat, &a.su_tnd,
                    &a.sv_tnd};
  const int nin = int(sizeof(in) / sizeof(in[0]));
  for (int n = 0; n < nin; ++n) *in[n] = static_cast<const T*>(ptrs[n]);
  for (int q = 0; q < nq; ++q) {
    a.sq[q] = static_cast<const T*>(ptrs[nin + q]);
    a.q_ref[q] = static_cast<const T*>(ptrs[nin + nq + q]);
    a.q_out[q] = static_cast<T*>(outs[3 + q]);
  }
  a.s_out = static_cast<T*>(outs[0]);
  a.su_out = static_cast<T*>(outs[1]);
  a.sv_out = static_cast<T*>(outs[2]);
  a.nq = nq; a.nx = nx; a.ny = ny; a.nz = nz; a.nb = nb;
  a.dt = T(s[0]); a.dtf = T(s[1]); a.dx = T(s[2]); a.dy = T(s[3]); a.eps = T(s[4]);
  const int threads = 256;
  momentum_epilogue_kernel<T><<<blocks_for(int64_t(nx) * ny * nz, threads), threads, 0, stream>>>(a);
  return int(cudaGetLastError());
}

// the stencils of order 3 read 2 cells on each side of a face, those of order 5 three
bool bad_geometry(int nx, int ny, int nb, int order) {
  return (order != 3 && order != 5) || nb < (order == 3 ? 2 : 3) || nx < 2 * nb + 1 ||
         ny < 2 * nb + 1;
}

}  // namespace

// ptrs: u, v, gamma (or null), ref0 (or null), now[nf], int[nf], tnd[nf] (each
//       may be null); outs: the nf stepped fields; q_mask: bit f set when
//       field f is a mass fraction advected as clip(field 0 * q);
// order: 3 or 5; scalars: dt, dx, dy
extern "C" int tt_advection_fields(int dtype, const void* const* ptrs, void* const* outs, int nf,
                                   int q_mask, int nx, int ny, int nz, int nb, int order,
                                   const double* scalars, cudaStream_t stream) {
  if (nf < 1 || nf > kMaxFields || (q_mask & 1) || bad_geometry(nx, ny, nb, order)) {
    return int(cudaErrorInvalidValue);
  }
  const bool f32 = dtype == tt::kFloat32;
  if (order == 3) {
    return f32 ? launch_advection<3, float>(ptrs, outs, nf, q_mask, nx, ny, nz, nb, scalars, stream)
               : launch_advection<3, double>(ptrs, outs, nf, q_mask, nx, ny, nz, nb, scalars, stream);
  }
  return f32 ? launch_advection<5, float>(ptrs, outs, nf, q_mask, nx, ny, nz, nb, scalars, stream)
             : launch_advection<5, double>(ptrs, outs, nf, q_mask, nx, ny, nz, nb, scalars, stream);
}

// ptrs: u, v, su_now, sv_now, su_int, sv_int, s_now, mtg_now, s_new, mtg_new,
//       su_tnd, sv_tnd (both or neither null); outs: su, sv; order: 3 or 5;
// scalars: dt, dx, dy, eps
extern "C" int tt_momentum_step(int dtype, const void* const* ptrs, void* const* outs, int nx,
                                int ny, int nz, int nb, int order, const double* scalars,
                                cudaStream_t stream) {
  if (bad_geometry(nx, ny, nb, order) || (ptrs[10] == nullptr) != (ptrs[11] == nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  const bool f32 = dtype == tt::kFloat32;
  if (order == 3) {
    return f32 ? launch_momentum<3, float>(ptrs, outs, nx, ny, nz, nb, scalars, stream)
               : launch_momentum<3, double>(ptrs, outs, nx, ny, nz, nb, scalars, stream);
  }
  return f32 ? launch_momentum<5, float>(ptrs, outs, nx, ny, nz, nb, scalars, stream)
             : launch_momentum<5, double>(ptrs, outs, nx, ny, nz, nb, scalars, stream);
}

// ptrs: u, v, su_now, sv_now, su_int, sv_int, s_now, mtg_now, s_e, mtg,
//       gamma, s_ref, su_ref, sv_ref, rmat (or null: no damping), su_tnd,
//       sv_tnd (both or neither null), sq[nq], q_ref[nq];
// outs: s, su, sv, q[nq]; scalars: dt, dtf, dx, dy, eps
extern "C" int tt_momentum_epilogue(int dtype, const void* const* ptrs, void* const* outs, int nq,
                                    int nx, int ny, int nz, int nb, const double* scalars,
                                    cudaStream_t stream) {
  if (nq < 0 || nq > kMaxQ || bad_geometry(nx, ny, nb, 5) ||
      (ptrs[15] == nullptr) != (ptrs[16] == nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  if (dtype == tt::kFloat32) {
    return launch_epilogue<float>(ptrs, outs, nq, nx, ny, nz, nb, scalars, stream);
  }
  return launch_epilogue<double>(ptrs, outs, nq, nx, ny, nz, nb, scalars, stream);
}
