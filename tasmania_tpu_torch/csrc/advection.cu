// The kernels of the semi-implicit stages that do not run as one whole-stage
// kernel: the two-kernel stage taken when the dynamical core is given
// tendencies, and the unfused stage of a one-dimensional relaxed boundary.
//
// Replaces: tasmania_tpu/ops/advection_step.py:140 fused_advection_fields
// (pallas_call at :246), :282 fused_momentum_step (pallas_call at :361) and
// :422 fused_momentum_epilogue (pallas_call at :579).  The algebra, per cell
// (i, j, k) of the whole (nx, ny, nz) array, with third- or fifth-order
// upwind fluxes (a template parameter of each kernel):
//
//   advection_fields, for each of F fields phi (field 0 the density; a field
//   flagged in q_mask enters as a mass fraction q and is advected as the
//   water density clip(s q), formed from field 0):
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
// tendencies) plus gamma and the reference and writes 4 (237 MB, 71 us at
// 3.35 TB/s); momentum_step reads u, v and 8 cell fields and writes 2 (150
// MB, 45 us; at the mountain wave's 161x7x120, 6.6 MB, 2 us, below a
// launch's cost); momentum_epilogue reads u, v and 19 cell fields (momenta
// now and int, s now and stepped, both potentials, 3 sq, 6 references, 2
// tendencies) and writes 6 (336 MB, 100 us).  The arithmetic, an upwind
// divergence per field and cell, is far below the float32 rate, but its
// instructions are not free: index arithmetic, bounds tests and the IEEE
// divisions cost issue slots, and the stencils read each input several
// times.  The TPU kernels' x-tiles, clamped tile starts and VMEM windows are
// Mosaic artefacts and are not carried over.
//
// Design: si_stage.cu's second launch without the Montgomery potential (the
// tiling of common.cuh: Shape, Lane, the face-flux pass).  A block owns a
// tile of columns x a run of 8 levels, the level run the fastest block index
// (blocks in flight together read whole columns), 32-bit indices, no
// division of a flat index.  The stencil inputs are staged in shared memory
// with cp.async: an advected field's cross of halo 3 (2 at the third order),
// u's and v's faces of the tile, 16-byte copies where nz and the pointers
// allow.  Each face flux is computed once in the block, by a thread that
// owns the face in every field, into shared memory, and each divergence is
// taken there in div5's order; at the fifth order each thread divides its
// faces' velocities by 60 once for all fields (tt::flux5_scaled; the third
// order keeps tt::flux3's own division by 12 at every flux, so that its
// roundings stay those of div_upwind and of the plain versions).  The
// pointwise inputs of the thread's cells (now, tendencies, references,
// gamma) are read straight from device memory, coalesced along k, but early:
// their loads are issued before the barriers and the flux pass, whose time
// hides their latency, and consumed after.  Then the outputs of the thread's
// cells, frame included ("now" values there).
//   advection_fields: field 0's cross (the density s_int) stays in shared
//     memory for the whole block; each water density clip(s_int q_int) is
//     formed once a cell after its q_int cross lands; the other F - 1
//     fields pass through two buffers, the next one's copy issued as soon as
//     this one's fluxes are done, and each field is written as soon as its
//     divergence is known.  8 x 8 columns a block, two cells a thread,
//     where the grid gives a full wave of blocks; on a smaller grid (the
//     mountain wave's one interior row, 161x7x120) 8 x 4, one cell a
//     thread.  Shared memory
//     at 8 x 8 x 8: 28 KB in float32 at the fifth order with three or more
//     fields (56 KB in float64), less with fewer fields.
//   momentum_step and momentum_epilogue: one kernel, the epilogue a
//     compile-time switch (momentum_kernel<..., Epi>).  8 x 4 columns, one
//     cell a thread, its pointwise inputs in registers from the start (6
//     for the step, 16 for the epilogue); su_int's and sv_int's crosses of
//     halo 3 (2 at the third order), mtg_now's and mtg_new's of halo 1 for
//     the pressure gradient; the step writes su and sv, the epilogue its
//     six outputs in the plain version's order.  Shared memory 18 KB in
//     float32 (35 KB in float64).
// Measured on the H100 (161x161x120 float32, variants timed in one call):
// issuing the pointwise loads before the flux pass paid most; 16-level
// runs, 16-column tiles, 128 threads, register caps for more blocks an SM
// and loading a field's inputs an iteration ahead were all slower; one cell
// a thread is as fast as two for the epilogue and slower for the fields.

#include "common.cuh"

namespace {

constexpr int kMaxFields = 8;
constexpr int kMaxQ = 3;
// the advected fields in flight beside a kept cross: the one whose fluxes
// are computed and the next
constexpr int kAdvBufs = 2;

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

// advection_fields' shared memory in values of T: field 0's cross, u's and
// v's faces, the fluxes, and a ring of up to kAdvBufs crosses for the
// fields after the first
template <class S>
constexpr int advection_smem_values(int nf) {
  return (1 + (nf - 1 < kAdvBufs ? nf - 1 : kAdvBufs)) * S::kRect + 2 * (S::kFX + S::kFY);
}

template <class S, typename T, int V>
__global__ void __launch_bounds__(S::Threads) advection_fields_kernel(AdvectionArgs<T> a) {
  constexpr int P = tt::Lane<S>::P;
  constexpr bool kScaled = S::H == 3;  // the fifth order: u/60, v/60 once for all fields
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const S0 = reinterpret_cast<T*>(smem_raw);  // field 0's cross (the density), kept
  T* const U = S0 + S::kRect;
  T* const Vf = U + S::kFX;
  T* const FX = Vf + S::kFY;
  T* const FY = FX + S::kFX;
  T* const PHI = FY + S::kFY;  // the other fields' crosses, a ring
  // the level run is the fastest block index: blocks that run together read
  // whole columns
  const tt::Tile t{int(blockIdx.y) * S::TX, int(blockIdx.z) * S::TY, int(blockIdx.x) * S::KL,
                   a.nx, a.ny, a.nz, a.nb};
  const tt::Lane<S> L(t);
  const int k = t.k0 + L.kk, j = t.y0 + L.ty, sx = a.ny * a.nz;
  const bool level = k < a.nz;

  tt::copy_cross<S, V>(S0, a.in[0], t);
  tt::copy_faces<S, V>(U, Vf, a.u, a.v, t);
#pragma unroll
  for (int b = 0; b < kAdvBufs; ++b) {  // fields 1 and 2, a group each, the first with the inputs above
    if (1 + b < a.nf) tt::copy_cross<S, V>(PHI + b * S::kRect, a.in[1 + b], t);
    tt::cp_async_commit();
  }
  T sn[P];  // field 0's "now" at the thread's cells, for the water densities
  for (int f = 0; f < a.nf; ++f) {
    T* const phi = f == 0 ? S0 : PHI + (f - 1) % kAdvBufs * S::kRect;
    const bool qp = (a.q_mask >> f) & 1;
    const bool enforced = f == 0 && a.gamma != nullptr;
    const T* __restrict__ tnd = a.tnd[f];
    // the field's pointwise inputs at the thread's cells, loaded while its
    // cross lands and its fluxes are computed
    T nw[P], td[P], gm[P], rf[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = t.x0 + L.tx(p), c = i * sx + j * a.nz + k;
      if (i >= a.nx || j >= a.ny || !level) continue;
      nw[p] = a.now[f][c];
      if (tnd != nullptr) td[p] = tnd[c];
      if (enforced) {
        gm[p] = a.gamma[i * a.ny + j];
        rf[p] = a.ref0[c];
      }
    }
    tt::cp_async_wait<kAdvBufs - 1>();  // field f's group has landed
    __syncthreads();
    if constexpr (kScaled) {
      if (f == 0) tt::lane_scale_faces(L, level, U, Vf);
    }
    if (qp) {  // the water density clip(s_int q_int), formed once a cell
      tt::for_cross<S::TX, S::TY, S::KL, S::H, V, S::Threads>(
          t.x0, t.y0, t.k0, a.nx, a.ny, a.nz, [&](int m, int) {
#pragma unroll
            for (int w = 0; w < V; ++w) phi[m + w] = tt::clip_pos(S0[m + w] * phi[m + w]);
          });
      __syncthreads();
    }
    tt::lane_fluxes<kScaled>(L, level, phi, U, Vf, FX, FY);
    __syncthreads();
    if (f > 0) {  // every thread's fluxes of phi are done (the barrier above): refill it
      if (f + kAdvBufs < a.nf) tt::copy_cross<S, V>(phi, a.in[f + kAdvBufs], t);
      tt::cp_async_commit();
    }
    T* __restrict__ out = a.out[f];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = t.x0 + L.tx(p), c = i * sx + j * a.nz + k;
      if (i >= a.nx || j >= a.ny || !level) continue;
      T now = nw[p];
      if (f == 0) sn[p] = now;
      if (qp) now = tt::clip_pos(sn[p] * now);
      T res = now;
      if (t.interior(i, j)) {
        T rhs = tt::lane_div(L, p, FX, FY, a.dx, a.dy);
        if (tnd != nullptr) rhs = rhs - td[p];
        res = now - a.dt * rhs;
      }
      if (enforced) res = tt::enforce(res, gm[p], rf[p]);
      out[c] = res;
    }
  }
}

// the arguments of the momentum kernel: the momentum step's, and the
// epilogue's besides (momentum_epilogue passes the stepped, enforced density
// s_e as s_new and its potential as mtg_new)
template <typename T>
struct MomentumArgs {
  const T *u, *v, *su_now, *sv_now, *su_int, *sv_int, *s_now, *mtg_now, *s_new, *mtg_new;
  const T *su_tnd, *sv_tnd;                          // both null: no tendencies
  const T *gamma, *s_ref, *su_ref, *sv_ref, *rmat;  // the epilogue's; rmat may be null
  const T* sq[kMaxQ];
  const T* q_ref[kMaxQ];
  T *s_out, *su_out, *sv_out;
  T* q_out[kMaxQ];
  int nq, nx, ny, nz, nb;
  T dt, dtf, dx, dy, eps;
};

// The tile of the momentum step and the epilogue; H: the stencil's reach, 2
// (third order) or 3 (fifth).  For the step, 8 x 8 columns (two cells a
// thread) were no faster on the H100 at 161x161x120 and 167x167x120, and
// slower on the smaller grids (PERF.md, section 6)
template <int H>
using ShapeE = tt::Shape<8, 4, 8, 256, H>;  // 256 cells: one a thread
// the cross of mtg_now and mtg_new: the tile widened by 1 in x and y
template <class S>
constexpr int kRectE1 = (S::TX + 2) * (S::TY + 2) * S::KL;

// the pointwise inputs at one cell (c; the column's gamma at g): the
// momentum step's (on the frame only the "now" momenta), and with Epi the
// epilogue's
template <typename T, bool Epi>
struct Point {
  T sn, se, sun, svn, su_tnd, sv_tnd;
  T gm, s_ref, su_ref, sv_ref, sq[kMaxQ], q_ref[kMaxQ];  // Epi
  __device__ void load(const MomentumArgs<T>& a, int g, int c, bool interior) {
    sun = a.su_now[c], svn = a.sv_now[c];
    if (!Epi && !interior) return;
    sn = a.s_now[c], se = a.s_new[c];
    if (a.su_tnd != nullptr) su_tnd = a.su_tnd[c], sv_tnd = a.sv_tnd[c];
    if constexpr (Epi) {
      gm = a.gamma[g];
      s_ref = a.s_ref[c], su_ref = a.su_ref[c], sv_ref = a.sv_ref[c];
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) {
        if (q >= a.nq) break;
        sq[q] = a.sq[q][c], q_ref[q] = a.q_ref[q][c];
      }
    }
  }
};

template <class S, typename T>
constexpr size_t momentum_smem() {
  return sizeof(T) * (2 * S::kRect + 2 * (S::kFX + S::kFY) + 2 * kRectE1<S>);
}

// The momentum step (Epi false) and the momentum epilogue (Epi true): the
// momenta with the semi-implicit pressure gradient and the tendencies, "now"
// on the frame; with Epi the epilogue's enforcement, damping and water
// species besides
template <class S, typename T, int V, bool Epi>
__global__ void __launch_bounds__(S::Threads) momentum_kernel(MomentumArgs<T> a) {
  constexpr int P = tt::Lane<S>::P;
  constexpr bool kScaled = S::H == 3;  // the fifth order: u/60, v/60 once for both momenta
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const SU = reinterpret_cast<T*>(smem_raw);  // su_int's and sv_int's crosses
  T* const SV = SU + S::kRect;
  T* const U = SV + S::kRect;
  T* const Vf = U + S::kFX;
  T* const FX = Vf + S::kFY;
  T* const FY = FX + S::kFX;
  T* const MN = FY + S::kFY;  // mtg_now's and mtg_new's crosses of halo 1
  T* const MG = MN + kRectE1<S>;
  const tt::Tile t{int(blockIdx.y) * S::TX, int(blockIdx.z) * S::TY, int(blockIdx.x) * S::KL,
                   a.nx, a.ny, a.nz, a.nb};
  const tt::Lane<S> L(t);
  const int k = t.k0 + L.kk, j = t.y0 + L.ty;
  const bool level = k < a.nz;
  // whether the tile holds an interior cell: a tile of the frame alone (on
  // the one-row grid of ny = 2 nb + 1, every tile past the interior row)
  // stages nothing and computes no flux (the same for every thread)
  const bool inner = t.x0 + S::TX > a.nb && t.x0 < a.nx - a.nb && t.y0 + S::TY > a.nb &&
                     t.y0 < a.ny - a.nb;

  // two groups: the faces, the potentials and su_int; then sv_int
  if (inner) {
    tt::copy_faces<S, V>(U, Vf, a.u, a.v, t);
    tt::for_cross<S::TX, S::TY, S::KL, 1, V, S::Threads>(
        t.x0, t.y0, t.k0, t.nx, t.ny, t.nz, [&](int m, int g) {
          tt::cp_async<V * sizeof(T)>(&MN[m], &a.mtg_now[g]);
          tt::cp_async<V * sizeof(T)>(&MG[m], &a.mtg_new[g]);
        });
    tt::copy_cross<S, V>(SU, a.su_int, t);
    tt::cp_async_commit();
    tt::copy_cross<S, V>(SV, a.sv_int, t);
    tt::cp_async_commit();
  }
  // the pointwise inputs at the thread's cells, loaded while the copies land
  // and the fluxes are computed
  const int sx = a.ny * a.nz;
  const bool damp = Epi && a.rmat != nullptr;
  T rm = T(0);
  if constexpr (Epi) rm = damp && level ? a.rmat[k] : T(0);
  Point<T, Epi> in[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = t.x0 + L.tx(p), c = i * sx + j * a.nz + k;
    if (i < a.nx && j < a.ny && level) in[p].load(a, i * a.ny + j, c, t.interior(i, j));
  }
  T dsu[P] = {}, dsv[P] = {};  // the divergences of the momenta at the thread's cells
  if (inner) {
    auto divergences = [&](const T* phi, T* d) {
      tt::lane_fluxes<kScaled>(L, level, phi, U, Vf, FX, FY);
      __syncthreads();
#pragma unroll
      for (int p = 0; p < P; ++p)
        d[p] = t.interior(t.x0 + L.tx(p), j) ? tt::lane_div(L, p, FX, FY, a.dx, a.dy) : T(0);
    };
    tt::cp_async_wait<1>();
    __syncthreads();
    if constexpr (kScaled) tt::lane_scale_faces(L, level, U, Vf);
    divergences(SU, dsu);
    tt::cp_async_wait<0>();
    __syncthreads();  // also: every thread's reads of su's fluxes are done
    divergences(SV, dsv);
  }

  if (!level) return;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = t.x0 + L.tx(p);
    if (i >= a.nx || j >= a.ny) continue;
    const int c = i * sx + j * a.nz + k;
    const Point<T, Epi>& x = in[p];

    if constexpr (Epi) {  // density: second enforcement, then damping
      T sf = tt::enforce(x.se, x.gm, x.s_ref);
      if (damp) sf = sf - a.dtf * rm * (x.sn - x.s_ref);
      a.s_out[c] = sf;
    }

    // momenta with the semi-implicit pressure gradient and the tendencies
    T sup = x.sun, svp = x.svn;
    if (t.interior(i, j)) {
      constexpr int mx = (S::TY + 2) * S::KL, my = S::KL;
      const int m = ((L.tx(p) + 1) * (S::TY + 2) + L.ty + 1) * S::KL + L.kk;
      const T pgx = (T(1) - a.eps) * x.sn * (MN[m + mx] - MN[m - mx]) / (T(2) * a.dx) +
                    a.eps * x.se * (MG[m + mx] - MG[m - mx]) / (T(2) * a.dx);
      const T pgy = (T(1) - a.eps) * x.sn * (MN[m + my] - MN[m - my]) / (T(2) * a.dy) +
                    a.eps * x.se * (MG[m + my] - MG[m - my]) / (T(2) * a.dy);
      T su_rhs = dsu[p] + pgx;
      T sv_rhs = dsv[p] + pgy;
      if (a.su_tnd != nullptr) {
        su_rhs = su_rhs - x.su_tnd;
        sv_rhs = sv_rhs - x.sv_tnd;
      }
      sup = x.sun - a.dt * su_rhs;
      svp = x.svn - a.dt * sv_rhs;
    }
    if constexpr (!Epi) {  // the momentum step: no enforcement, no damping
      a.su_out[c] = sup;
      a.sv_out[c] = svp;
    } else {
      T suf = tt::enforce(sup, x.gm, x.su_ref);
      T svf = tt::enforce(svp, x.gm, x.sv_ref);
      if (damp) {
        suf = suf - a.dtf * rm * (x.sun - x.su_ref);
        svf = svf - a.dtf * rm * (x.svn - x.sv_ref);
      }
      a.su_out[c] = suf;
      a.sv_out[c] = svf;

      // water species: the stepped densities back to clipped mass fractions
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) {
        if (q >= a.nq) break;
        a.q_out[q][c] = tt::enforce(tt::clip_pos(x.sq[q] / x.se), x.gm, x.q_ref[q]);
      }
    }
  }
}

// the SMs of the current device (the tile rule of advection_fields)
int sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return int(err);
}

// a kernel's dynamic shared memory above the default 48 KB: the attribute
// first (refused above the card's 227 KB a block, and the error returned)
template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return int(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

template <class S, typename T, int V>
int launch_fields(const AdvectionArgs<T>& a, cudaStream_t stream) {
  const size_t smem = sizeof(T) * size_t(advection_smem_values<S>(a.nf));
  if (const int err = allow_smem(advection_fields_kernel<S, T, V>, smem)) return err;
  const dim3 g((a.nz + S::KL - 1) / S::KL, (a.nx + S::TX - 1) / S::TX, (a.ny + S::TY - 1) / S::TY);
  advection_fields_kernel<S, T, V><<<g, S::Threads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

// advection_fields' tile: 8 x 8 columns (two cells a thread) where the grid
// of such tiles fills every SM with a full wave of 256-thread blocks (8 an
// SM), else 8 x 4 (one cell a thread: the one-row grid of the mountain wave)
constexpr int kWaveBlocksPerSM = 8;

// H: the stencil's reach, 2 (third order) or 3 (fifth)
template <int H, typename T>
int launch_advection(const void* const* ptrs, void* const* outs, int nf, int q_mask, int nx, int ny,
                     int nz, int nb, const double* s, cudaStream_t stream) {
  AdvectionArgs<T> a = {};
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
  int sms = 0;
  if (const int err = sm_count(&sms)) return err;
  using Wide = tt::Shape<8, 8, 8, 256, H>;
  using Narrow = tt::Shape<8, 4, 8, 256, H>;
  const int64_t wide_blocks = int64_t((nz + 7) / 8) * ((nx + 7) / 8) * ((ny + 7) / 8);
  const bool wide = wide_blocks >= int64_t(kWaveBlocksPerSM) * sms;
  // 16-byte copies where every staged field's columns are whole 16-byte runs
  bool vec = tt::runs_of_16<T>(nz, {a.u, a.v});
  for (int f = 0; f < nf; ++f) vec = vec && tt::runs_of_16<T>(nz, {a.in[f]});
  constexpr int V = 16 / sizeof(T);
  if (wide) return vec ? launch_fields<Wide, T, V>(a, stream) : launch_fields<Wide, T, 1>(a, stream);
  return vec ? launch_fields<Narrow, T, V>(a, stream) : launch_fields<Narrow, T, 1>(a, stream);
}

template <class S, typename T, int V, bool Epi>
int launch_momentum_kernel(const MomentumArgs<T>& a, cudaStream_t stream) {
  const size_t smem = momentum_smem<S, T>();
  if (const int err = allow_smem(momentum_kernel<S, T, V, Epi>, smem)) return err;
  const dim3 g((a.nz + S::KL - 1) / S::KL, (a.nx + S::TX - 1) / S::TX, (a.ny + S::TY - 1) / S::TY);
  momentum_kernel<S, T, V, Epi><<<g, S::Threads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

// the ten inputs the momentum step and the epilogue share (u .. mtg_new) and
// the grid; then the kernel, 16-byte copies where every staged field's
// columns are whole 16-byte runs
template <class S, typename T, bool Epi>
int launch_momenta(MomentumArgs<T>& a, const void* const* ptrs, int nx, int ny, int nz, int nb,
                   cudaStream_t stream) {
  const T** in[] = {&a.u, &a.v, &a.su_now, &a.sv_now, &a.su_int, &a.sv_int, &a.s_now, &a.mtg_now,
                    &a.s_new, &a.mtg_new};
  for (int n = 0; n < 10; ++n) *in[n] = static_cast<const T*>(ptrs[n]);
  a.nx = nx; a.ny = ny; a.nz = nz; a.nb = nb;
  const bool vec = tt::runs_of_16<T>(nz, {a.u, a.v, a.su_int, a.sv_int, a.mtg_now, a.mtg_new});
  return vec ? launch_momentum_kernel<S, T, 16 / sizeof(T), Epi>(a, stream)
             : launch_momentum_kernel<S, T, 1, Epi>(a, stream);
}

template <int H, typename T>
int launch_momentum(const void* const* ptrs, void* const* outs, int nx, int ny, int nz, int nb,
                    const double* s, cudaStream_t stream) {
  MomentumArgs<T> a = {};
  a.su_tnd = static_cast<const T*>(ptrs[10]);
  a.sv_tnd = static_cast<const T*>(ptrs[11]);
  a.su_out = static_cast<T*>(outs[0]);
  a.sv_out = static_cast<T*>(outs[1]);
  a.dt = T(s[0]); a.dx = T(s[1]); a.dy = T(s[2]); a.eps = T(s[3]);
  return launch_momenta<ShapeE<H>, T, false>(a, ptrs, nx, ny, nz, nb, stream);
}

template <int H, typename T>
int launch_epilogue(const void* const* ptrs, void* const* outs, int nq, int nx, int ny, int nz,
                    int nb, const double* s, cudaStream_t stream) {
  MomentumArgs<T> a = {};
  const T** in[] = {&a.gamma, &a.s_ref, &a.su_ref, &a.sv_ref, &a.rmat, &a.su_tnd, &a.sv_tnd};
  for (int n = 0; n < 7; ++n) *in[n] = static_cast<const T*>(ptrs[10 + n]);
  for (int q = 0; q < nq; ++q) {
    a.sq[q] = static_cast<const T*>(ptrs[17 + q]);
    a.q_ref[q] = static_cast<const T*>(ptrs[17 + nq + q]);
    a.q_out[q] = static_cast<T*>(outs[3 + q]);
  }
  a.s_out = static_cast<T*>(outs[0]);
  a.su_out = static_cast<T*>(outs[1]);
  a.sv_out = static_cast<T*>(outs[2]);
  a.nq = nq;
  a.dt = T(s[0]); a.dtf = T(s[1]); a.dx = T(s[2]); a.dy = T(s[3]); a.eps = T(s[4]);
  return launch_momenta<ShapeE<H>, T, true>(a, ptrs, nx, ny, nz, nb, stream);
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
  if (nf < 1 || nf > kMaxFields || (q_mask & 1) || bad_geometry(nx, ny, nb, order) || nz < 1 ||
      !tt::fits_int32(nx, ny, nz)) {
    return int(cudaErrorInvalidValue);
  }
  const bool f32 = dtype == tt::kFloat32;
  if (order == 3) {
    return f32 ? launch_advection<2, float>(ptrs, outs, nf, q_mask, nx, ny, nz, nb, scalars, stream)
               : launch_advection<2, double>(ptrs, outs, nf, q_mask, nx, ny, nz, nb, scalars, stream);
  }
  return f32 ? launch_advection<3, float>(ptrs, outs, nf, q_mask, nx, ny, nz, nb, scalars, stream)
             : launch_advection<3, double>(ptrs, outs, nf, q_mask, nx, ny, nz, nb, scalars, stream);
}

// ptrs: u, v, su_now, sv_now, su_int, sv_int, s_now, mtg_now, s_new, mtg_new,
//       su_tnd, sv_tnd (both or neither null); outs: su, sv; order: 3 or 5;
// scalars: dt, dx, dy, eps
extern "C" int tt_momentum_step(int dtype, const void* const* ptrs, void* const* outs, int nx,
                                int ny, int nz, int nb, int order, const double* scalars,
                                cudaStream_t stream) {
  if (bad_geometry(nx, ny, nb, order) || nz < 1 || !tt::fits_int32(nx, ny, nz) ||
      (ptrs[10] == nullptr) != (ptrs[11] == nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  const bool f32 = dtype == tt::kFloat32;
  if (order == 3) {
    return f32 ? launch_momentum<2, float>(ptrs, outs, nx, ny, nz, nb, scalars, stream)
               : launch_momentum<2, double>(ptrs, outs, nx, ny, nz, nb, scalars, stream);
  }
  return f32 ? launch_momentum<3, float>(ptrs, outs, nx, ny, nz, nb, scalars, stream)
             : launch_momentum<3, double>(ptrs, outs, nx, ny, nz, nb, scalars, stream);
}

// ptrs: u, v, su_now, sv_now, su_int, sv_int, s_now, mtg_now, s_e, mtg,
//       gamma, s_ref, su_ref, sv_ref, rmat (or null: no damping), su_tnd,
//       sv_tnd (both or neither null), sq[nq], q_ref[nq];
// outs: s, su, sv, q[nq]; order: 3 or 5; scalars: dt, dtf, dx, dy, eps
extern "C" int tt_momentum_epilogue(int dtype, const void* const* ptrs, void* const* outs, int nq,
                                    int nx, int ny, int nz, int nb, int order, const double* scalars,
                                    cudaStream_t stream) {
  if (nq < 0 || nq > kMaxQ || bad_geometry(nx, ny, nb, order) || nz < 1 ||
      !tt::fits_int32(nx, ny, nz) || (ptrs[15] == nullptr) != (ptrs[16] == nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  const bool f32 = dtype == tt::kFloat32;
  if (order == 3) {
    return f32 ? launch_epilogue<2, float>(ptrs, outs, nq, nx, ny, nz, nb, scalars, stream)
               : launch_epilogue<2, double>(ptrs, outs, nq, nx, ny, nz, nb, scalars, stream);
  }
  return f32 ? launch_epilogue<3, float>(ptrs, outs, nq, nx, ny, nz, nb, scalars, stream)
             : launch_epilogue<3, double>(ptrs, outs, nq, nx, ny, nz, nb, scalars, stream);
}
