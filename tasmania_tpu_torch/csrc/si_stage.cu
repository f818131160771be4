// One whole semi-implicit (RK3WS-SI) stage of the isentropic core.
//
// Replaces: tasmania_tpu/ops/si_stage.py:146 fused_si_stage (pallas_call at
// :733).  The algebra, per cell:
//   s_e   = enforce(s_now - dt div(u, v, s_int))         (frame: s_now)
//   mtg   = Montgomery potential of s_e (column scans)
//   su    = su_now - dt (div(u, v, su_int)
//           + (1-eps) s_now dmtg_now/dx + eps s_e dmtg/dx)  (frame: su_now)
//   q     = clip(clip(sq_now - dt div(u, v, clip(s_int q_int))) / s_e)
//   then enforce every field (s a second time) and Rayleigh-damp s, su, sv on
//   the top dd levels toward the reference, from the step-start values.
//
// Bound on the H100: bytes.  One 161x161x120 f32 field is 12.4 MB; a stage
// reads ~22 fields (u, v, 6 now, 6 int, mtg_now, 6 references, and s_e and
// mtg twice) and writes 8, about 370 MB, ~0.11 ms at 3.35 TB/s; the
// arithmetic (four 5th-order divergences per cell plus one powf per cell)
// is well under the FP32 rate.  Design: the TPU kernel's x-tiles, VMEM
// windows, edge-duplicate pads and MXU triangular scans are Mosaic artefacts
// and are not carried over.  Three launches on one stream instead:
//   A  one thread per cell (k fastest, so stencil reads coalesce along k):
//      advect s, keep "now" on the frame, enforce -> s_e (scratch);
//   B  one thread per (i, j) column: the forward pressure scan, Exner, and
//      the backward Montgomery scan -> mtg (scratch); sequential in k, with
//      the roundings of the plain version (no FMA contraction), since f32
//      summation noise in mtg (~0.03 at 3e5) would reach the momenta through
//      the pressure gradient;
//   C  one thread per cell of x columns [nb, nx-nb): momenta, water species
//      and the whole epilogue.  The nb-wide x-frame columns are composed by
//      the wrapper from "now" values and pasted with the paste kernel.
// The intermediates cost two extra field round trips (s_e, mtg): fusing them
// away (shared-memory column tiles) is later work.

#include "common.cuh"

namespace {

constexpr int kMaxQ = 3;

template <typename T>
struct Params {
  int nx, ny, nz, nb, nq, dd;
  T dt, dtf, dx, dy, eps, pt, gdz, dz, g, cp, rdcp, inv_pref;
};

template <typename T>
struct Fields {
  const T *u, *v, *s_now, *s_int, *su_now, *sv_now, *su_int, *sv_int, *mtg_now;
  const T *hs, *theta, *gamma, *s_ref, *su_ref, *sv_ref, *rmat;
  const T *q_now[kMaxQ], *q_int[kMaxQ], *q_ref[kMaxQ];
  T *q_out[kMaxQ];
  T *s_e, *mtg, *s_out, *su_out, *sv_out;
};

template <typename T>
__global__ void stage_density(Fields<T> f, Params<T> p) {
  const int64_t total = int64_t(p.nx) * p.ny * p.nz;
  for (int64_t c = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; c < total;
       c += int64_t(gridDim.x) * blockDim.x) {
    const int k = int(c % p.nz);
    const int j = int((c / p.nz) % p.ny);
    const int i = int(c / (int64_t(p.ny) * p.nz));
    T res = f.s_now[c];
    if (i >= p.nb && i < p.nx - p.nb && j >= p.nb && j < p.ny - p.nb) {
      res = res - p.dt * tt::div5(f.u, f.v, tt::Plain<T>{f.s_int}, i, j, k, p.nx, p.ny, p.nz,
                                  p.dx, p.dy);
    }
    f.s_e[c] = tt::enforce(res, f.gamma[int64_t(i) * p.ny + j], f.s_ref[c]);
  }
}

template <typename T>
__global__ void stage_montgomery(Fields<T> f, Params<T> p) {
  const int64_t ncol = int64_t(p.nx) * p.ny;
  for (int64_t col = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; col < ncol;
       col += int64_t(gridDim.x) * blockDim.x) {
    const T* s = f.s_e + col * p.nz;
    T* m = f.mtg + col * p.nz;
    // forward: p[k+1] = p[k] + g dz s[k]; m[k] holds exn[k+1] for now
    T pk = p.pt;
    for (int k = 0; k < p.nz; ++k) {
      pk = tt::add_rn(pk, tt::mul_rn(p.gdz, s[k]));
      m[k] = tt::mul_rn(p.cp, tt::tpow(tt::mul_rn(pk, p.inv_pref), p.rdcp));
    }
    // backward: mtg[nz-1] = theta_s exn[nz] + g hs + dz/2 exn[nz];
    // mtg[k] = mtg[nz-1] + dz sum_{l=k+1}^{nz-1} exn[l]
    const T exn_s = m[p.nz - 1];
    const T base = tt::add_rn(tt::add_rn(tt::mul_rn(f.theta[p.nz], exn_s), tt::mul_rn(p.g, f.hs[col])),
                              tt::mul_rn(tt::mul_rn(T(0.5), p.dz), exn_s));
    m[p.nz - 1] = base;
    T r = T(0);
    for (int k = p.nz - 2; k >= 0; --k) {
      r = tt::add_rn(r, tt::mul_rn(p.dz, m[k]));
      m[k] = tt::add_rn(base, r);
    }
  }
}

template <typename T>
__global__ void stage_momentum_epilogue(Fields<T> f, Params<T> p) {
  const int64_t sx = int64_t(p.ny) * p.nz;
  const int64_t total = int64_t(p.nx - 2 * p.nb) * sx;
  for (int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += int64_t(gridDim.x) * blockDim.x) {
    const int k = int(e % p.nz);
    const int j = int((e / p.nz) % p.ny);
    const int i = p.nb + int(e / sx);
    const int64_t c = int64_t(i) * sx + int64_t(j) * p.nz + k;
    const bool inner = j >= p.nb && j < p.ny - p.nb;
    const bool damp = k < p.dd;
    const T rm = damp ? f.rmat[k] : T(0);
    const T gm = f.gamma[int64_t(i) * p.ny + j];
    const T sn = f.s_now[c];
    const T se = f.s_e[c];

    // density: second enforcement, then damping
    T sf = tt::enforce(se, gm, f.s_ref[c]);
    if (damp) sf = sf - p.dtf * rm * (sn - f.s_ref[c]);
    f.s_out[c] = sf;

    // momenta with the semi-implicit pressure gradient
    const T sun = f.su_now[c];
    const T svn = f.sv_now[c];
    T sup = sun, svp = svn;
    if (inner) {
      const T pgx = (T(1) - p.eps) * sn * (f.mtg_now[c + sx] - f.mtg_now[c - sx]) / (T(2) * p.dx) +
                    p.eps * se * (f.mtg[c + sx] - f.mtg[c - sx]) / (T(2) * p.dx);
      const T pgy =
          (T(1) - p.eps) * sn * (f.mtg_now[c + p.nz] - f.mtg_now[c - p.nz]) / (T(2) * p.dy) +
          p.eps * se * (f.mtg[c + p.nz] - f.mtg[c - p.nz]) / (T(2) * p.dy);
      const T dsu = tt::div5(f.u, f.v, tt::Plain<T>{f.su_int}, i, j, k, p.nx, p.ny, p.nz, p.dx, p.dy);
      const T dsv = tt::div5(f.u, f.v, tt::Plain<T>{f.sv_int}, i, j, k, p.nx, p.ny, p.nz, p.dx, p.dy);
      sup = sun - p.dt * (dsu + pgx);
      svp = svn - p.dt * (dsv + pgy);
    }
    T suf = tt::enforce(sup, gm, f.su_ref[c]);
    T svf = tt::enforce(svp, gm, f.sv_ref[c]);
    if (damp) {
      suf = suf - p.dtf * rm * (sun - f.su_ref[c]);
      svf = svf - p.dtf * rm * (svn - f.sv_ref[c]);
    }
    f.su_out[c] = suf;
    f.sv_out[c] = svf;

    // water species: advect the densities, back to clipped mass fractions
    for (int q = 0; q < p.nq; ++q) {
      const T sqn = tt::clip_pos(sn * f.q_now[q][c]);
      T sqr = sqn;
      if (inner) {
        sqr = sqn - p.dt * tt::div5(f.u, f.v, tt::ClipProduct<T>{f.s_int, f.q_int[q]}, i, j, k,
                                    p.nx, p.ny, p.nz, p.dx, p.dy);
      }
      f.q_out[q][c] = tt::enforce(tt::clip_pos(sqr / se), gm, f.q_ref[q][c]);
    }
  }
}

unsigned blocks_for(int64_t n, int threads) {
  int64_t b = (n + threads - 1) / threads;
  return unsigned(b > 65535 ? 65535 : b);
}

template <typename T>
int launch(const void* const* ptrs, void* const* outs, int nq, int nx, int ny, int nz, int nb,
           int dd, const double* scalars, cudaStream_t stream) {
  Fields<T> f;
  const T** in[] = {&f.u, &f.v, &f.s_now, &f.s_int, &f.su_now, &f.sv_now, &f.su_int,
                    &f.sv_int, &f.mtg_now, &f.hs, &f.theta, &f.gamma, &f.s_ref, &f.su_ref,
                    &f.sv_ref, &f.rmat};
  const int nin = int(sizeof(in) / sizeof(in[0]));
  for (int a = 0; a < nin; ++a) *in[a] = static_cast<const T*>(ptrs[a]);
  for (int q = 0; q < nq; ++q) {
    f.q_now[q] = static_cast<const T*>(ptrs[nin + q]);
    f.q_int[q] = static_cast<const T*>(ptrs[nin + nq + q]);
    f.q_ref[q] = static_cast<const T*>(ptrs[nin + 2 * nq + q]);
    f.q_out[q] = static_cast<T*>(outs[5 + q]);
  }
  T** out[] = {&f.s_e, &f.mtg, &f.s_out, &f.su_out, &f.sv_out};
  for (int a = 0; a < 5; ++a) *out[a] = static_cast<T*>(outs[a]);

  Params<T> p;
  p.nx = nx; p.ny = ny; p.nz = nz; p.nb = nb; p.nq = nq; p.dd = dd;
  p.dt = T(scalars[0]); p.dtf = T(scalars[1]); p.dx = T(scalars[2]); p.dy = T(scalars[3]);
  p.eps = T(scalars[4]); p.pt = T(scalars[5]); p.dz = T(scalars[6]); p.g = T(scalars[7]);
  p.cp = T(scalars[8]); p.rdcp = T(scalars[9] / scalars[8]); p.inv_pref = T(1.0 / scalars[10]);
  p.gdz = T(scalars[7] * scalars[6]);

  const int threads = 256;
  stage_density<T><<<blocks_for(int64_t(nx) * ny * nz, threads), threads, 0, stream>>>(f, p);
  int err = int(cudaGetLastError());
  if (err) return err;
  stage_montgomery<T><<<blocks_for(int64_t(nx) * ny, 128), 128, 0, stream>>>(f, p);
  err = int(cudaGetLastError());
  if (err) return err;
  stage_momentum_epilogue<T>
      <<<blocks_for(int64_t(nx - 2 * nb) * ny * nz, threads), threads, 0, stream>>>(f, p);
  return int(cudaGetLastError());
}

}  // namespace

// ptrs: u, v, s_now, s_int, su_now, sv_now, su_int, sv_int, mtg_now, hs,
//       theta, gamma, s_ref, su_ref, sv_ref, rmat, q_now[nq], q_int[nq], q_ref[nq]
// outs: s_e, mtg (scratch), s, su, sv, q[nq]
// scalars: dt, dtf, dx, dy, eps, pt, dz, g, cp, rd, pref
// dd: damp the levels k < dd (0: no damping)
extern "C" int tt_si_stage(int dtype, const void* const* ptrs, void* const* outs, int nq, int nx,
                           int ny, int nz, int nb, int dd, const double* scalars,
                           cudaStream_t stream) {
  if (nq < 0 || nq > kMaxQ || nb < 3 || nx < 2 * nb + 1 || ny < 2 * nb + 1) {
    return int(cudaErrorInvalidValue);
  }
  if (dtype == tt::kFloat32) return launch<float>(ptrs, outs, nq, nx, ny, nz, nb, dd, scalars, stream);
  return launch<double>(ptrs, outs, nq, nx, ny, nz, nb, dd, scalars, stream);
}
