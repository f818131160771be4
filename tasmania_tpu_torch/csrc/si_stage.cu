// One whole semi-implicit (RK3WS-SI) stage of the isentropic core, every
// cell written.
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
//   The frame is the nb-wide ring outside [nb, nx-nb) x [nb, ny-nb).  div is
//   the divergence of third- or fifth-order upwind fluxes (the TPU kernel's
//   order, 3 or 5): the kernels are templates on the stencil's reach H (2 or
//   3), as advection.cu's are.
//
// The distributed mode (the TPU kernel's dist=True, si_stage.py:189-222,
// :393-401, :448-455, :835-849): the arrays are one shard's halo-extended
// block, whose cell (0, 0) lies at global (gx0, gy0) of a gnx x gny domain.
// A cell is stepped where it is inside the block's own frame (the stencils
// stay in the array) and at least nb from every GLOBAL edge: the keep-now
// frame test is gx0 + i < nb || gx0 + i >= gnx - nb on global coordinates,
// and the same in y.  The relaxed band needs no test of its own here: every
// cell is enforced by its own gamma, and the caller passes the shard's
// windows of gamma and of the references, so the global band (nr) comes in
// with them.  The block's ring outside the stencil's reach keeps its "now"
// values and is left to the post-stage halo exchange; the Montgomery
// gradient of the first owned column reads the advected density one cell
// into the ring, so the ring is at least nb + 1 deep on a decomposed axis.
// A single device is the instance gx0 = gy0 = 0, gnx = nx, gny = ny, whose
// global test is the local one: the same code and the same bits.
//
// Bound on the H100: bytes.  One 161x161x120 f32 field is 12.4 MB; a stage
// reads u, v, 6 "now", 6 "int", mtg_now and 6 references and writes 6
// fields, 336 MB, 0.100 ms at 3.35 TB/s; the scratch s_e and mtg add about
// 100 MB of round trips.  The arithmetic (five 5th-order divergences and one
// powf a cell) is well under the FP32 rate, but its instructions are not
// free: index arithmetic, bounds tests and divisions cost more issue slots
// than the fluxes.  Design: the TPU kernel's x-tiles, VMEM windows,
// edge-duplicate pads and MXU triangular scans are Mosaic artefacts and are
// not carried over.  Two launches on one stream, each tiled in (x, y) by
// blockIdx with 32-bit indices and no division of a flat index.  The
// stencil inputs are staged in shared memory with cp.async (tt::for_cross: a
// tile's cross of halo H, the level fastest; 16-byte copies where nz and the
// pointers allow).  Each thread has a fixed place in the tile (tt::Lane):
// its level, row and columns, and the faces whose fluxes it computes, each
// face once in the block (tt::flux5, or tt::flux3) into shared memory, where
// each divergence is taken in div5's order.  This tiling (common.cuh) also
// serves advection.cu's advection of the fields and momentum epilogue.
//   A  density + Montgomery: a block owns an 8 x 4 tile of columns over all
//      levels, one cell a thread in each run of 8 levels.  Three runs are in
//      flight: s_int's cross, u's and v's faces, s_now and s_ref of the next
//      two runs copy while this one computes s_e = enforce(s_now - dt div)
//      (enforce(s_now) on the frame) to device memory and to a column buffer
//      in shared memory (column stride nz rounded up to odd, so that the
//      scanning threads hit distinct banks).  Then one thread per column
//      runs the forward pressure scan, all threads the Exner powf of every
//      level, one thread per column the backward Montgomery scan, with the
//      roundings of the plain version (mul_rn/add_rn, no FMA: float32 noise
//      in mtg reaches the momenta through the pressure gradient); mtg leaves
//      coalesced along k.
//   B  momenta + water + epilogue: a block owns an 8 x 8 tile x 8 levels, two
//      cells a thread, the level run the fastest block index (blocks in
//      flight together read whole columns).  s_int's cross stays in shared
//      memory for the products, mtg's and mtg_now's crosses of halo 1 for
//      the pressure gradient, u's and v's faces (at the fifth order each
//      thread divides its own faces by 60 once, for all five fields:
//      tt::flux5_scaled; the third order keeps tt::flux3's own division by
//      12 at every flux, so that its roundings stay the plain version's); the
//      advected fields su_int, sv_int and clip(s_int q_int) (the product
//      formed once, after the copy) pass through two buffers, the next one's
//      copy in flight while the current one's fluxes and divergences are
//      computed.  Then the epilogue of the thread's cells, frame included
//      ("now" values there, as in the plain version): no frame composition
//      and no paste follow.
// Shared memory at the fifth order: A 44 KB a block in float32 at nz = 120
// (88 KB in float64), B 34 KB (67 KB); less at the third order (halo 2).
// Measured on the H100 (161x161x120 float32): deeper copy pipelines, more
// threads a block, longer level runs and staging the epilogue's inputs all
// cost occupancy and were slower; what paid was the level run as the
// fastest block index and fewer divisions.

#include "common.cuh"

namespace {

constexpr int kMaxQ = 3;
constexpr int kMaxAdv = 2 + kMaxQ;  // su, sv and the water densities
constexpr int kRunsInFlight = 3;    // A's level runs in flight: this one and the next two

// H: the stencil's reach, 2 (third order) or 3 (fifth)
template <int H>
using ShapeA = tt::Shape<8, 4, 8, 256, H>;  // 256 cells a level run: one a thread
template <int H>
using ShapeB = tt::Shape<8, 8, 8, 256, H>;  // 512 cells: two a thread

template <typename T>
struct Params {
  int nx, ny, nz, nb, nq, dd;
  int gx0, gy0, gnx, gny;  // the global offset of cell (0, 0) and the global extents
  T dt, dtf, dx, dy, eps, pt, gdz, dz, g, cp, rdcp, inv_pref;
};

// whether local cell (i, j) is stepped: inside the block's frame and at
// least nb cells from every global edge
template <typename T>
__device__ __forceinline__ bool stepped(const tt::Tile& t, const Params<T>& p, int i, int j) {
  const int gi = p.gx0 + i, gj = p.gy0 + j;
  return t.interior(i, j) && gi >= p.nb && gi < p.gnx - p.nb && gj >= p.nb && gj < p.gny - p.nb;
}

template <typename T>
struct Fields {
  const T *u, *v, *s_now, *s_int, *su_now, *sv_now, *su_int, *sv_int, *mtg_now;
  const T *hs, *theta, *gamma, *s_ref, *su_ref, *sv_ref, *rmat;
  const T *q_now[kMaxQ], *q_int[kMaxQ], *q_ref[kMaxQ];
  T *q_out[kMaxQ];
  T *s_e, *mtg, *s_out, *su_out, *sv_out;
};

// the tile's cells of a cell field, laid out [tx][ty][kk]
template <class S, int V, typename T>
__device__ __forceinline__ void copy_cells(T* dst, const T* __restrict__ src, const tt::Tile& t) {
  constexpr int KV = S::KL / V;
  tt::strided<S::kCells / V, S::Threads>([&](int e) {
    const int col = e / KV, k = t.k0 + e % KV * V;
    const int i = t.x0 + col / S::TY, j = t.y0 + col % S::TY;
    if (i < t.nx && j < t.ny && k < t.nz)
      tt::cp_async<V * sizeof(T)>(&dst[e * V], &src[(i * t.ny + j) * t.nz + k]);
  });
}

template <class S, typename T>
size_t smem_a(int nz) {
  return sizeof(T) * (size_t(kRunsInFlight) * (S::kRect + S::kFX + S::kFY + 2 * S::kCells) + S::kFX +
                      S::kFY + size_t(S::TX * S::TY) * (nz | 1));
}

// B's cross of mtg_now and mtg: the tile widened by 1 in x and y
template <class S>
constexpr int kRectB1 = (S::TX + 2) * (S::TY + 2) * S::KL;
// B's advected fields in flight: the one whose fluxes are computed and the
// next
constexpr int kAdvBufs = 2;

template <class S, typename T>
constexpr size_t smem_b() {
  return sizeof(T) * ((1 + kAdvBufs) * S::kRect + 2 * (S::kFX + S::kFY) + 2 * kRectB1<S>);
}

template <class S, typename T, int V>
__global__ void __launch_bounds__(S::Threads, 4) stage_density_montgomery(Fields<T> f, Params<T> p) {
  static_assert(tt::Lane<S>::P == 1, "one column a thread");
  constexpr int kBuf = S::kRect + S::kFX + S::kFY + 2 * S::kCells;  // s_int, u, v, s_now, s_ref
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);  // kRunsInFlight level runs' inputs
  T* const FX = ring + kRunsInFlight * kBuf;
  T* const FY = FX + S::kFX;
  T* const C = FY + S::kFY;  // the columns' s_e, then p, Exner, mtg: column stride nzp
  const int nzp = p.nz | 1;
  tt::Tile t{int(blockIdx.x) * S::TX, int(blockIdx.y) * S::TY, 0, p.nx, p.ny, p.nz, p.nb};
  const tt::Lane<S> L(t);
  const int i = t.x0 + L.tx(0), j = t.y0 + L.ty, col = L.tx(0) * S::TY + L.ty;
  const bool live = i < p.nx && j < p.ny, inner = stepped(t, p, i, j);
  const T gm = live ? f.gamma[i * p.ny + j] : T(0);
  const int sx = p.ny * p.nz;
  const int runs = (p.nz + S::KL - 1) / S::KL;

  auto copy_run = [&](int run) {
    T* b = ring + run % kRunsInFlight * kBuf;
    tt::Tile r = t;
    r.k0 = run * S::KL;
    tt::copy_cross<S, V>(b, f.s_int, r);
    tt::copy_faces<S, V>(b + S::kRect, b + S::kRect + S::kFX, f.u, f.v, r);
    copy_cells<S, V>(b + S::kRect + S::kFX + S::kFY, f.s_now, r);
    copy_cells<S, V>(b + S::kRect + S::kFX + S::kFY + S::kCells, f.s_ref, r);
  };
#pragma unroll
  for (int run = 0; run < kRunsInFlight - 1; ++run) {
    if (run < runs) copy_run(run);
    tt::cp_async_commit();
  }
  for (int run = 0; run < runs; ++run) {
    if (run + kRunsInFlight - 1 < runs) copy_run(run + kRunsInFlight - 1);
    tt::cp_async_commit();
    tt::cp_async_wait<kRunsInFlight - 1>();
    __syncthreads();
    const T* b = ring + run % kRunsInFlight * kBuf;
    t.k0 = run * S::KL;
    const int k = t.k0 + L.kk;
    tt::lane_fluxes<false>(L, k < p.nz, b, b + S::kRect, b + S::kRect + S::kFX, FX, FY);
    __syncthreads();
    if (live && k < p.nz) {
      const int cell = col * S::KL + L.kk;
      const T* sn = b + S::kRect + S::kFX + S::kFY;
      T res = sn[cell];
      if (inner) res = res - p.dt * tt::lane_div(L, 0, FX, FY, p.dx, p.dy);
      const T se = tt::enforce(res, gm, sn[S::kCells + cell]);
      f.s_e[i * sx + j * p.nz + k] = se;
      C[col * nzp + k] = se;
    }
    __syncthreads();  // the next run refills the oldest buffer and rewrites FX, FY
  }

  // forward: p[k+1] = p[k] + g dz s[k], kept in place of s[k]
  constexpr int ncol = S::TX * S::TY;
  const int sc = threadIdx.x, si = t.x0 + sc / S::TY, sj = t.y0 + sc % S::TY;
  const bool scans = sc < ncol && si < p.nx && sj < p.ny;
  if (scans) {
    T* m = C + sc * nzp;
    T pk = p.pt;
#pragma unroll 4
    for (int k = 0; k < p.nz; ++k) {
      pk = tt::add_rn(pk, tt::mul_rn(p.gdz, m[k]));
      m[k] = pk;
    }
  }
  __syncthreads();
  // exn[k+1] = cp (p[k+1] / pref)^(rd/cp) of every level, by all threads
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int w = warp; w < ncol; w += S::Threads / 32) {
    if (t.x0 + w / S::TY >= p.nx || t.y0 + w % S::TY >= p.ny) continue;
    T* m = C + w * nzp;
    for (int k = lane; k < p.nz; k += 32)
      m[k] = tt::mul_rn(p.cp, tt::tpow(tt::mul_rn(m[k], p.inv_pref), p.rdcp));
  }
  __syncthreads();
  // backward: mtg[nz-1] = theta_s exn[nz] + g hs + dz/2 exn[nz];
  // mtg[k] = mtg[nz-1] + dz sum_{l=k+1}^{nz-1} exn[l]
  if (scans) {
    T* m = C + sc * nzp;
    const T exn_s = m[p.nz - 1];
    const T base =
        tt::add_rn(tt::add_rn(tt::mul_rn(f.theta[p.nz], exn_s), tt::mul_rn(p.g, f.hs[si * p.ny + sj])),
                   tt::mul_rn(tt::mul_rn(T(0.5), p.dz), exn_s));
    m[p.nz - 1] = base;
    T r = T(0);
#pragma unroll 4
    for (int k = p.nz - 2; k >= 0; --k) {
      r = tt::add_rn(r, tt::mul_rn(p.dz, m[k]));
      m[k] = tt::add_rn(base, r);
    }
  }
  __syncthreads();
  for (int w = warp; w < ncol; w += S::Threads / 32) {
    const int wi = t.x0 + w / S::TY, wj = t.y0 + w % S::TY;
    if (wi >= p.nx || wj >= p.ny) continue;
    for (int k = lane; k < p.nz; k += 32) f.mtg[wi * sx + wj * p.nz + k] = C[w * nzp + k];
  }
}

template <class S, typename T, int V>
__global__ void __launch_bounds__(S::Threads) stage_momenta_epilogue(Fields<T> f, Params<T> p) {
  // the fifth order: u/60, v/60 once for all fields
  constexpr bool kScaled = S::H == 3;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const SI = reinterpret_cast<T*>(smem_raw);  // s_int's cross, kept
  T* const PHI = SI + S::kRect;                   // the advected fields' crosses, a ring
  T* const U = PHI + kAdvBufs * S::kRect;
  T* const Vf = U + S::kFX;
  T* const FX = Vf + S::kFY;
  T* const FY = FX + S::kFX;
  T* const MN = FY + S::kFY;  // mtg_now's and mtg's crosses of halo 1
  T* const MG = MN + kRectB1<S>;
  // the level run is the fastest block index: blocks that run together read
  // whole columns
  const tt::Tile t{int(blockIdx.y) * S::TX, int(blockIdx.z) * S::TY, int(blockIdx.x) * S::KL,
               p.nx, p.ny, p.nz, p.nb};
  const tt::Lane<S> L(t);
  const int k = t.k0 + L.kk;
  const int na = 2 + p.nq;
  auto source = [&](int a) { return a == 0 ? f.su_int : a == 1 ? f.sv_int : f.q_int[a - 2]; };

  tt::copy_cross<S, V>(SI, f.s_int, t);
  tt::copy_faces<S, V>(U, Vf, f.u, f.v, t);
  tt::for_cross<S::TX, S::TY, S::KL, 1, V, S::Threads>(
      t.x0, t.y0, t.k0, t.nx, t.ny, t.nz, [&](int m, int g) {
        tt::cp_async<V * sizeof(T)>(&MN[m], &f.mtg_now[g]);
        tt::cp_async<V * sizeof(T)>(&MG[m], &f.mtg[g]);
      });
#pragma unroll
  for (int a = 0; a < kAdvBufs; ++a) {  // a group each, the first with the inputs above
    if (a < na) tt::copy_cross<S, V>(PHI + a * S::kRect, source(a), t);
    tt::cp_async_commit();
  }
  T d[kMaxAdv][tt::Lane<S>::P];  // the divergences of su, sv and the water densities
#pragma unroll
  for (int a = 0; a < kMaxAdv; ++a) {
    if (a >= na) break;
    T* const phi = PHI + a % kAdvBufs * S::kRect;
    tt::cp_async_wait<kAdvBufs - 1>();
    __syncthreads();
    if constexpr (kScaled) {
      if (a == 0) tt::lane_scale_faces(L, k < p.nz, U, Vf);
    }
    if (a >= 2) {  // the water density clip(s_int q_int), formed once
      tt::for_cross<S::TX, S::TY, S::KL, S::H, V, S::Threads>(
          t.x0, t.y0, t.k0, t.nx, t.ny, t.nz, [&](int m, int) {
#pragma unroll
            for (int w = 0; w < V; ++w) phi[m + w] = tt::clip_pos(SI[m + w] * phi[m + w]);
          });
      __syncthreads();
    }
    tt::lane_fluxes<kScaled>(L, k < p.nz, phi, U, Vf, FX, FY);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < L.P; ++q)
      d[a][q] = t.interior(t.x0 + L.tx(q), t.y0 + L.ty) ? tt::lane_div(L, q, FX, FY, p.dx, p.dy) : T(0);
    // every thread's fluxes of phi are done (the barrier above): refill it
    if (a + kAdvBufs < na) tt::copy_cross<S, V>(phi, source(a + kAdvBufs), t);
    tt::cp_async_commit();
  }

  const int sx = p.ny * p.nz;
  const int j = t.y0 + L.ty;
  const bool damp = k < p.dd;
  const T rm = damp ? f.rmat[k] : T(0);
#pragma unroll
  for (int q = 0; q < L.P; ++q) {
    const int i = t.x0 + L.tx(q);
    if (i >= p.nx || j >= p.ny || k >= p.nz) continue;
    const int c = i * sx + j * p.nz + k;
    const bool inner = stepped(t, p, i, j);
    const T gm = f.gamma[i * p.ny + j];
    const T sn = f.s_now[c], se = f.s_e[c], s_ref = f.s_ref[c];

    // density: second enforcement, then damping
    T sf = tt::enforce(se, gm, s_ref);
    if (damp) sf = sf - p.dtf * rm * (sn - s_ref);
    f.s_out[c] = sf;

    // momenta with the semi-implicit pressure gradient
    const T sun = f.su_now[c], svn = f.sv_now[c], su_ref = f.su_ref[c], sv_ref = f.sv_ref[c];
    T sup = sun, svp = svn;
    if (inner) {
      constexpr int mx = (S::TY + 2) * S::KL, my = S::KL;
      const int m = ((L.tx(q) + 1) * (S::TY + 2) + L.ty + 1) * S::KL + L.kk;
      const T pgx = (T(1) - p.eps) * sn * (MN[m + mx] - MN[m - mx]) / (T(2) * p.dx) +
                    p.eps * se * (MG[m + mx] - MG[m - mx]) / (T(2) * p.dx);
      const T pgy = (T(1) - p.eps) * sn * (MN[m + my] - MN[m - my]) / (T(2) * p.dy) +
                    p.eps * se * (MG[m + my] - MG[m - my]) / (T(2) * p.dy);
      sup = sun - p.dt * (d[0][q] + pgx);
      svp = svn - p.dt * (d[1][q] + pgy);
    }
    T suf = tt::enforce(sup, gm, su_ref);
    T svf = tt::enforce(svp, gm, sv_ref);
    if (damp) {
      suf = suf - p.dtf * rm * (sun - su_ref);
      svf = svf - p.dtf * rm * (svn - sv_ref);
    }
    f.su_out[c] = suf;
    f.sv_out[c] = svf;

    // water species: advect the densities, back to clipped mass fractions
#pragma unroll
    for (int w = 0; w < kMaxQ; ++w) {
      if (w >= p.nq) break;
      const T sqn = tt::clip_pos(sn * f.q_now[w][c]);
      const T sqr = inner ? sqn - p.dt * d[2 + w][q] : sqn;
      f.q_out[w][c] = tt::enforce(tt::clip_pos(sqr / se), gm, f.q_ref[w][c]);
    }
  }
}

template <int H, typename T, int V>
int launch_kernels(const Fields<T>& f, const Params<T>& p, cudaStream_t stream) {
  using SA = ShapeA<H>;
  using SB = ShapeB<H>;
  // A's column buffer grows with nz: above the card's 227 KB a block the
  // attribute is refused and the error returned
  const int sa = int(smem_a<SA, T>(p.nz)), sb = int(smem_b<SB, T>());
  int err = int(cudaFuncSetAttribute(stage_density_montgomery<SA, T, V>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, sa));
  if (err) return err;
  err = int(cudaFuncSetAttribute(stage_momenta_epilogue<SB, T, V>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, sb));
  if (err) return err;
  const dim3 ga((p.nx + SA::TX - 1) / SA::TX, (p.ny + SA::TY - 1) / SA::TY);
  stage_density_montgomery<SA, T, V><<<ga, SA::Threads, sa, stream>>>(f, p);
  err = int(cudaGetLastError());
  if (err) return err;
  const dim3 gb((p.nz + SB::KL - 1) / SB::KL, (p.nx + SB::TX - 1) / SB::TX,
                (p.ny + SB::TY - 1) / SB::TY);
  stage_momenta_epilogue<SB, T, V><<<gb, SB::Threads, sb, stream>>>(f, p);
  return int(cudaGetLastError());
}

template <int H, typename T>
int launch(const void* const* ptrs, void* const* outs, int nq, int nx, int ny, int nz, int nb,
           int dd, const int* frame, const double* scalars, cudaStream_t stream) {
  Fields<T> f = {};
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
  p.gx0 = frame[0]; p.gy0 = frame[1]; p.gnx = frame[2]; p.gny = frame[3];
  p.dt = T(scalars[0]); p.dtf = T(scalars[1]); p.dx = T(scalars[2]); p.dy = T(scalars[3]);
  p.eps = T(scalars[4]); p.pt = T(scalars[5]); p.dz = T(scalars[6]); p.g = T(scalars[7]);
  p.cp = T(scalars[8]); p.rdcp = T(scalars[9] / scalars[8]); p.inv_pref = T(1.0 / scalars[10]);
  p.gdz = T(scalars[7] * scalars[6]);

  // 16-byte copies where every staged field's columns are whole 16-byte runs
  const bool vec = tt::runs_of_16<T>(nz, {f.u, f.v, f.s_now, f.s_int, f.s_ref, f.su_int, f.sv_int,
                                          f.mtg_now, f.mtg, f.q_int[0], f.q_int[1], f.q_int[2]});
  return vec ? launch_kernels<H, T, 16 / sizeof(T)>(f, p, stream) : launch_kernels<H, T, 1>(f, p, stream);
}

}  // namespace

// ptrs: u, v, s_now, s_int, su_now, sv_now, su_int, sv_int, mtg_now, hs,
//       theta, gamma, s_ref, su_ref, sv_ref, rmat, q_now[nq], q_int[nq], q_ref[nq]
// outs: s_e, mtg (scratch), s, su, sv, q[nq]
// scalars: dt, dtf, dx, dy, eps, pt, dz, g, cp, rd, pref
// dd: damp the levels k < dd (0: no damping); order: 3 or 5
// frame: gx0, gy0, gnx, gny (a single device: 0, 0, nx, ny)
extern "C" int tt_si_stage(int dtype, const void* const* ptrs, void* const* outs, int nq, int nx,
                           int ny, int nz, int nb, int dd, int order, const int* frame,
                           const double* scalars, cudaStream_t stream) {
  // the stencils of order 3 read 2 cells on each side of a face, those of order 5 three
  if (nq < 0 || nq > kMaxQ || (order != 3 && order != 5) || nb < (order == 3 ? 2 : 3) ||
      nx < 2 * nb + 1 || ny < 2 * nb + 1 || nz < 1 || !tt::fits_int32(nx, ny, nz) ||
      frame[2] < 2 * nb + 1 || frame[3] < 2 * nb + 1) {
    return int(cudaErrorInvalidValue);
  }
  const bool f32 = dtype == tt::kFloat32;
  if (order == 3) {
    return f32 ? launch<2, float>(ptrs, outs, nq, nx, ny, nz, nb, dd, frame, scalars, stream)
               : launch<2, double>(ptrs, outs, nq, nx, ny, nz, nb, dd, frame, scalars, stream);
  }
  return f32 ? launch<3, float>(ptrs, outs, nq, nx, ny, nz, nb, dd, frame, scalars, stream)
             : launch<3, double>(ptrs, outs, nq, nx, ny, nz, nb, dd, frame, scalars, stream);
}
