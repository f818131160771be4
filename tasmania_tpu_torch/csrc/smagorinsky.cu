// Both RK2 stages of the conservative Smagorinsky update of (su, sv) in one
// launch, and one stage alone.
//
// Replaces: tasmania_tpu/ops/smagorinsky_step.py:149 _smag_rk2_fused
// (pallas_call at :241; entry fused_smagorinsky_rk2 at :261), both stages in
// one launch as there, and :33 _smag_stage, one stage (the JAX entry's path
// for narrow grids).
//
// Per stage, with u = su_st/s and v = sv_st/s: the strain (s00, s01, s11)
// and the viscosity nu of every cell, the products nu s00, nu s01, nu s11,
// the tendency 2(dx(nu s00) + dy(nu s01)), 2(dx(nu s01) + dy(nu s11)), and
// out = base + (c s) tendency on [nb, nx-nb) x [nb, ny-nb), base on the
// frame.  RK2: stage 1 with c = dt/2 from (su, sv), stage 2 with c = dt from
// stage 1, both on the base (su, sv).  Operation order as in
// smagorinsky_stage_plain (ops/smagorinsky_step.py), whose divisions by the
// spacings PyTorch takes on the card as products with their reciprocals:
// so does the kernel.  Every output cell is written, frame included: no
// paste follows.
//
// Bound on the H100: bytes.  Both stages read s, su, sv and write su, sv:
// 5 x 12.44 MB = 62 MB at the flagship (161x161x120 float32), 19 us at
// 3.35 TB/s; about 200 flops a cell are far below the float32 rate.
// Design: a block owns a tile of 12 x 12 columns by two neighbouring
// 16-byte runs of levels (float32 4 levels a run, float64 2; the runs the
// fastest block index, so that blocks in flight together read whole
// columns), 512 threads, a thread a column's run at a time, moving it with
// one 16-byte load or store of shared memory; the two runs of a column lie
// side by side, so that two threads copy a column's 32 contiguous bytes.  It
// copies (s, su, sv) on the tile widened by 2 a stage (4 for RK2) into
// shared memory with cp.async (16-byte copies where tt::runs_of_16 allows),
// then forms each intermediate once, in shared memory: u and v on the
// widened tile; the products on the tile + 3; the stage-1 momenta, kept as
// velocities, on the tile + 2; the products again on the tile + 1; the
// output on the tile.  No intermediate reaches device memory, each input
// element leaves it once for its own block (its halo copies come from L2),
// and indices are 32-bit from blockIdx.  A halo cell's stage-1 value is
// formed by the expressions of an interior one, so it is the value its own
// block computes.  86 KB of shared memory a block, at most 64 registers a
// thread: two blocks an SM.  The time goes to instruction issue and the
// latency of each block's five dependent phases, not to bytes: on the H100
// tiles of 8 x 8 to 32 x 16 columns, one, three or four runs a block, 8- or
// 32-byte runs, a thread a level, and a block that takes several runs in
// turn with the next one's copies in flight were all slower.

#include "common.cuh"

namespace {

// a block's tile of TX x TY columns by Par neighbouring level runs, and the
// blocks an SM is to hold (registers a thread: at most 65536 / (kThreads
// Blocks))
struct Tile {
  static constexpr int TX = 12, TY = 12, Par = 2, Blocks = 2;
};

constexpr int kThreads = 256 * Tile::Par;

// a column's run of levels in a block: 16 bytes, which one vector load or
// store of shared memory moves (float32 4 levels, float64 2)
template <typename T>
struct alignas(16) Levels {
  static constexpr int n = 16 / int(sizeof(T));
  T v[n];
};

// the tile widened by H: (TX + 2H) x (TY + 2H) columns, column (x, y)
// counted from the tile's first; a buffer holds Par Levels a column, the
// level runs side by side
template <int H>
struct Window {
  static constexpr int halo = H, WY = Tile::TY + 2 * H, cols = (Tile::TX + 2 * H) * WY;
  static constexpr int sx = WY * Tile::Par, sy = Tile::Par;  // in Levels
  // the element of (x, y) and level run r
  __device__ static int at(int x, int y, int r) { return ((x + H) * WY + y + H) * Tile::Par + r; }
  __device__ static bool in(int x, int y) {
    return x >= -H && x < Tile::TX + H && y >= -H && y < Tile::TY + H;
  }
};

// shared memory in Levels: s, u, v on the tile + 2 Stages; the base
// momenta on the tile + 2 Stages - 2; the three products on the tile + 2
// Stages - 1
template <int Stages>
__host__ __device__ constexpr int smem_levels() {
  return Tile::Par * (3 * Window<2 * Stages>::cols + 2 * Window<2 * Stages - 2>::cols +
                      3 * Window<2 * Stages - 1>::cols);
}

// the products nu s00, nu s01, nu s11 of the strain at column c of the
// velocities (x and y strides sx, sy), level by level: tt::smag_strain's
// expressions in smagorinsky_tendency's order, with the divisions by 2 dx and
// 2 dy taken as products with their reciprocals rdx2, rdy2, as PyTorch
// divides a tensor by a scalar on the card
template <typename T>
__device__ __forceinline__ void strain_products(const Levels<T>* U, const Levels<T>* V, int c,
                                                int sx, int sy, T nuc, T rdx2, T rdy2,
                                                Levels<T>& p0, Levels<T>& p1, Levels<T>& p2) {
  const Levels<T> uxp = U[c + sx], uxm = U[c - sx], uyp = U[c + sy], uym = U[c - sy];
  const Levels<T> vxp = V[c + sx], vxm = V[c - sx], vyp = V[c + sy], vym = V[c - sy];
#pragma unroll
  for (int l = 0; l < Levels<T>::n; ++l) {
    const T s00 = (uxp.v[l] - uxm.v[l]) * rdx2;
    const T s01 = T(0.5) * ((uyp.v[l] - uym.v[l]) * rdy2 + (vxp.v[l] - vxm.v[l]) * rdx2);
    const T s11 = (vyp.v[l] - vym.v[l]) * rdy2;
    const T nu = nuc * sqrt(T(2) * (s00 * s00 + T(2) * (s01 * s01) + s11 * s11));
    p0.v[l] = nu * s00;
    p1.v[l] = nu * s01;
    p2.v[l] = nu * s11;
  }
}

// Stages = 2: the RK2 of (su, sv) = (su_st, sv_st) = (su_base, sv_base), c1 =
// dt/2 and c2 = dt; Stages = 1: one stage, base + c2 s T(su_st/s, sv_st/s).
// Run: the levels of one copy from device memory (KL, or 1 where a column's
// runs are not whole 16-byte runs)
template <typename T, int Stages, int Run>
__global__ void __launch_bounds__(kThreads, Tile::Blocks)
    smagorinsky_kernel(const T* __restrict__ s, const T* __restrict__ su_st,
                       const T* __restrict__ sv_st, const T* __restrict__ su_base,
                       const T* __restrict__ sv_base, T* __restrict__ su_out,
                       T* __restrict__ sv_out, int nx, int ny, int nz, int nb, T c1, T c2, T nuc,
                       T dx2, T dy2) {
  using C = Levels<T>;
  constexpr int TX = Tile::TX, TY = Tile::TY, KL = C::n, H = 2 * Stages;
  static_assert(KL % Run == 0, "whole runs of Run levels in a column's KL");
  using WS = Window<H>;      // s and the velocities
  using WB = Window<H - 2>;  // the base momenta
  using WP = Window<H - 1>;  // the products nu s00, nu s01, nu s11
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int Par = Tile::Par;
  C* S = reinterpret_cast<C*>(smem_raw);
  C* U = S + Par * WS::cols;
  C* V = U + Par * WS::cols;
  C* BU = V + Par * WS::cols;
  C* BV = BU + Par * WB::cols;
  C* P0 = BV + Par * WB::cols;
  C* P1 = P0 + Par * WP::cols;
  C* P2 = P1 + Par * WP::cols;

  const int x0 = blockIdx.y * TX, y0 = blockIdx.z * TY;
  const int gsx = ny * nz;
  const T rdx2 = T(1) / dx2, rdy2 = T(1) / dy2;
  auto in_grid = [&](int x, int y) {
    return unsigned(x0 + x) < unsigned(nx) && unsigned(y0 + y) < unsigned(ny);
  };
  // fn(e, x, y, r) for each element e of window W, column (x, y) and level
  // run r (from level k0(r)), the block's threads in turn
  auto each = [&](auto window, auto fn) {
    using W = decltype(window);
    tt::strided<W::cols * Par, kThreads>([&](int e) {
      const int c = e / Par;
      fn(e, c / W::WY - W::halo, c % W::WY - W::halo, e % Par);
    });
  };
  auto k0 = [&](int r) { return (int(blockIdx.x) * Par + r) * KL; };

  // 1. (s, su_st, sv_st) on the tile + H and, for one stage, the base
  //    momenta on the tile, in runs of Run levels (which lie wholly inside
  //    or outside the grid: Run > 1 only where Run divides nz); cells outside
  //    the grid get s = 1 and zero momenta (finite, and never read by a cell
  //    that is written)
  each(WS{}, [&](int c, int x, int y, int r) {
    const bool column = in_grid(x, y);
    const bool base = Stages == 1 && WB::in(x, y);
    const int b = WB::at(x, y, r);
    const int g = (x0 + x) * gsx + (y0 + y) * nz + k0(r);
#pragma unroll
    for (int kk = 0; kk < KL; kk += Run) {
      if (column && k0(r) + kk < nz) {
        tt::cp_async<Run * sizeof(T)>(&S[c].v[kk], &s[g + kk]);
        tt::cp_async<Run * sizeof(T)>(&U[c].v[kk], &su_st[g + kk]);
        tt::cp_async<Run * sizeof(T)>(&V[c].v[kk], &sv_st[g + kk]);
        if (base) {
          tt::cp_async<Run * sizeof(T)>(&BU[b].v[kk], &su_base[g + kk]);
          tt::cp_async<Run * sizeof(T)>(&BV[b].v[kk], &sv_base[g + kk]);
        }
      } else {
#pragma unroll
        for (int l = kk; l < kk + Run; ++l) {
          S[c].v[l] = T(1);
          U[c].v[l] = V[c].v[l] = T(0);
          if (base) BU[b].v[l] = BV[b].v[l] = T(0);
        }
      }
    }
  });
  tt::cp_async_commit();
  tt::cp_async_wait<0>();
  __syncthreads();

  // 2. the velocities su/s, sv/s in place (each thread reads and rewrites
  //    only its own columns); the RK2 first keeps su, sv on the tile + 2,
  //    the base of both stages
  each(WS{}, [&](int c, int x, int y, int r) {
    C u = U[c], v = V[c];
    const C sc = S[c];
    if (Stages == 2 && WB::in(x, y)) {
      BU[WB::at(x, y, r)] = u;
      BV[WB::at(x, y, r)] = v;
    }
#pragma unroll
    for (int l = 0; l < KL; ++l) {
      u.v[l] = u.v[l] / sc.v[l];
      v.v[l] = v.v[l] / sc.v[l];
    }
    U[c] = u;
    V[c] = v;
  });
  __syncthreads();

  // one stage with its output on the tile + h: the products on the tile + h
  // + 1 from the velocities on the tile + h + 2, then base + (c s) T inside
  // the frame and base on it, kept as velocities or, at the last stage,
  // written out
  auto stage = [&](auto window, T c) {
    using WO = decltype(window);
    constexpr int h = WO::halo;
    each(Window<h + 1>{}, [&](int, int x, int y, int r) {
      const int p = WP::at(x, y, r);
      strain_products(U, V, WS::at(x, y, r), WS::sx, WS::sy, nuc, rdx2, rdy2, P0[p], P1[p],
                      P2[p]);
    });
    __syncthreads();
    each(WO{}, [&](int, int x, int y, int r) {
      const int b = WB::at(x, y, r), m = WS::at(x, y, r), p = WP::at(x, y, r);
      C su = BU[b], sv = BV[b];
      if (unsigned(x0 + x - nb) < unsigned(nx - 2 * nb) && unsigned(y0 + y - nb) < unsigned(ny - 2 * nb)) {
        constexpr int px = WP::sx, py = WP::sy;
        const C a0 = P0[p + px], a1 = P0[p - px], b0 = P1[p + py], b1 = P1[p - py];
        const C d0 = P1[p + px], d1 = P1[p - px], e0 = P2[p + py], e1 = P2[p - py];
        const C sc = S[m];
#pragma unroll
        for (int l = 0; l < KL; ++l) {
          const T u_tnd = T(2) * ((a0.v[l] - a1.v[l]) * rdx2 + (b0.v[l] - b1.v[l]) * rdy2);
          const T v_tnd = T(2) * ((d0.v[l] - d1.v[l]) * rdx2 + (e0.v[l] - e1.v[l]) * rdy2);
          const T cs = c * sc.v[l];
          su.v[l] = su.v[l] + cs * u_tnd;
          sv.v[l] = sv.v[l] + cs * v_tnd;
        }
      }
      if constexpr (h == 0) {
        if (in_grid(x, y)) {
          const int g = (x0 + x) * gsx + (y0 + y) * nz + k0(r);
          if (Run == KL && k0(r) < nz) {  // a whole aligned run
            *reinterpret_cast<C*>(&su_out[g]) = su;
            *reinterpret_cast<C*>(&sv_out[g]) = sv;
          } else {
#pragma unroll
            for (int l = 0; l < KL; ++l) {
              if (k0(r) + l < nz) {
                su_out[g + l] = su.v[l];
                sv_out[g + l] = sv.v[l];
              }
            }
          }
        }
      } else {
        const C sc = S[m];
#pragma unroll
        for (int l = 0; l < KL; ++l) {
          su.v[l] = su.v[l] / sc.v[l];
          sv.v[l] = sv.v[l] / sc.v[l];
        }
        U[m] = su;
        V[m] = sv;
      }
    });
    if constexpr (h != 0) __syncthreads();
  };
  if constexpr (Stages == 2) stage(Window<2>{}, c1);
  stage(Window<0>{}, c2);
}

template <typename T, int Stages, int Run>
int launch_runs(const T* const* in, T* const* out, int nx, int ny, int nz, int nb, T c1, T c2,
                T nuc, T dx2, T dy2, cudaStream_t stream) {
  constexpr int KL = Levels<T>::n;
  auto kernel = smagorinsky_kernel<T, Stages, Run>;
  const int smem = int(sizeof(Levels<T>)) * smem_levels<Stages>();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const int runs = (nz + KL - 1) / KL;
  const dim3 grid((runs + Tile::Par - 1) / Tile::Par, (nx + Tile::TX - 1) / Tile::TX,
                  (ny + Tile::TY - 1) / Tile::TY);
  kernel<<<grid, kThreads, smem, stream>>>(in[0], in[1], in[2], in[3], in[4], out[0], out[1], nx,
                                           ny, nz, nb, c1, c2, nuc, dx2, dy2);
  return int(cudaGetLastError());
}

// in: s, su_st, sv_st, su_base, sv_base (the last two null for RK2)
template <typename T, int Stages>
int launch(const void* const* in_raw, void* const* out_raw, int nx, int ny, int nz, int nb,
           double c1, double c2, const double* sc, cudaStream_t stream) {
  const T* in[5];
  for (int f = 0; f < 5; ++f) in[f] = static_cast<const T*>(in_raw[f]);
  T* out[2] = {static_cast<T*>(out_raw[0]), static_cast<T*>(out_raw[1])};
  const T k[5] = {T(c1), T(c2), T(sc[0]), T(sc[1]), T(sc[2])};  // c1, c2, nu factor, 2 dx, 2 dy
  // 16-byte copies and stores where every field's columns are whole 16-byte runs
  if (tt::runs_of_16<T>(nz, {in[0], in[1], in[2], in[3], in[4], out[0], out[1]}))
    return launch_runs<T, Stages, Levels<T>::n>(in, out, nx, ny, nz, nb, k[0], k[1], k[2], k[3],
                                                 k[4], stream);
  return launch_runs<T, Stages, 1>(in, out, nx, ny, nz, nb, k[0], k[1], k[2], k[3], k[4], stream);
}

bool valid(int nx, int ny, int nz, int nb) {
  return nb >= 2 && nx >= 2 * nb + 1 && ny >= 2 * nb + 1 && nz >= 1 &&
         int64_t(nx) * ny * nz <= INT32_MAX;
}

}  // namespace

// in: s, su, sv; out: su, sv stepped (no aliasing); scalars: dt/2, dt,
// cs^2 dx dy, 2 dx, 2 dy
extern "C" int tt_smagorinsky_rk2(int dtype, const void* const* in, void* const* out, int nx,
                                  int ny, int nz, int nb, const double* scalars,
                                  cudaStream_t stream) {
  if (!valid(nx, ny, nz, nb)) return int(cudaErrorInvalidValue);
  const void* in5[5] = {in[0], in[1], in[2], nullptr, nullptr};
  if (dtype == tt::kFloat32)
    return launch<float, 2>(in5, out, nx, ny, nz, nb, scalars[0], scalars[1], scalars + 2, stream);
  return launch<double, 2>(in5, out, nx, ny, nz, nb, scalars[0], scalars[1], scalars + 2, stream);
}

// in: s, su_stage, sv_stage, su_base, sv_base; out: su, sv (no aliasing);
// scalars: c, cs^2 dx dy, 2 dx, 2 dy
extern "C" int tt_smagorinsky_stage(int dtype, const void* const* in, void* const* out, int nx,
                                    int ny, int nz, int nb, const double* scalars,
                                    cudaStream_t stream) {
  if (!valid(nx, ny, nz, nb)) return int(cudaErrorInvalidValue);
  if (dtype == tt::kFloat32)
    return launch<float, 1>(in, out, nx, ny, nz, nb, scalars[0], scalars[0], scalars + 1, stream);
  return launch<double, 1>(in, out, nx, ny, nz, nb, scalars[0], scalars[0], scalars + 1, stream);
}
