// The RK2 Smagorinsky update of a column tile in shared memory, shared by
// smagorinsky.cu (both stages, or one) and smooth_smag.cu (both stages after
// the smoothing): the tile (TX x TY columns by Par neighbouring 16-byte
// level runs, a thread a column's run at a time), its windows widened by a
// ring, the strain products, and the phases that follow the staging of s,
// su and sv: the velocities, then each stage's products and update.  The
// operation order is that of smagorinsky_stage_plain
// (ops/smagorinsky_step.py), whose divisions by the spacings PyTorch takes on
// the card as products with their reciprocals: so do these phases.
#pragma once

#include "common.cuh"

namespace tt {

// a column's run of levels in a block: 16 bytes, which one vector load or
// store of shared memory moves (float32 4 levels, float64 2)
template <typename T>
struct alignas(16) Levels {
  using value_type = T;
  static constexpr int n = 16 / int(sizeof(T));
  T v[n];
};

// a block's tile of TX x TY columns by Par neighbouring level runs, 256 Par
// threads, and the blocks an SM is to hold (registers a thread: at most
// 65536 / (Threads Blocks)); Rolled: a phase's rounds over a window in a
// loop the compiler keeps rolled (fewer registers live at once)
template <int TX_, int TY_, int Par_, int Blocks_, bool Rolled_ = false>
struct SmagTile {
  static constexpr int TX = TX_, TY = TY_, Par = Par_, Blocks = Blocks_;
  static constexpr int Threads = 256 * Par_;
  static constexpr bool Rolled = Rolled_;
};

// the tile widened by H: (TX + 2H) x (TY + 2H) columns, column (x, y)
// counted from the tile's first; a buffer holds Par Levels a column, the
// level runs side by side
template <class Tl, int H>
struct Window {
  static constexpr int halo = H, WY = Tl::TY + 2 * H, cols = (Tl::TX + 2 * H) * WY;
  static constexpr int sx = WY * Tl::Par, sy = Tl::Par;  // in Levels
  // the element of (x, y) and level run r
  __device__ static int at(int x, int y, int r) { return ((x + H) * WY + y + H) * Tl::Par + r; }
  __device__ static bool in(int x, int y) {
    return x >= -H && x < Tl::TX + H && y >= -H && y < Tl::TY + H;
  }
};

// the products nu s00, nu s01, nu s11 of the strain at column c of the
// velocities (x and y strides sx, sy), level by level: the strain and
// viscosity of smagorinsky_tendency in its order, with the divisions by 2 dx
// and 2 dy taken as products with their reciprocals rdx2, rdy2, as PyTorch
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

// The block's Smagorinsky buffers and phases.  Stages = 2: the RK2 of (su,
// sv) = (su_st, sv_st) = (su_base, sv_base), c1 = dt/2 and c2 = dt; Stages =
// 1: one stage, base + c2 s T(su_st/s, sv_st/s).  Run: the levels of one
// copy from device memory (KL, or 1 where a column's runs are not whole
// 16-byte runs).  Shared memory from the block's first Levels: s, u, v on
// the tile + 2 Stages (WS); the base momenta on the tile + 2 Stages - 2
// (WB); the three products on the tile + 2 Stages - 1 (WP).  The caller
// stages s, su_st, sv_st into S, U, V on WS (cells outside the grid s = 1
// and zero momenta: finite, and never read by a cell that is written) and,
// for one stage, the base momenta into BU, BV, then calls velocities() and
// the stages after a barrier.
template <class Tl, typename T, int Stages, int Run>
struct SmagBlock {
  using C = Levels<T>;
  static constexpr int TX = Tl::TX, TY = Tl::TY, Par = Tl::Par, KL = C::n, H = 2 * Stages;
  static_assert(KL % Run == 0, "whole runs of Run levels in a column's KL");
  using WS = Window<Tl, H>;      // s and the velocities
  using WB = Window<Tl, H - 2>;  // the base momenta
  using WP = Window<Tl, H - 1>;  // the products nu s00, nu s01, nu s11
  // the Levels of s, u, v, and of the base momenta and the products after them
  static constexpr int kSUV = 3 * Par * WS::cols;
  static constexpr int kBaseProducts = Par * (2 * WB::cols + 3 * WP::cols);

  C *S, *U, *V, *BU, *BV, *P0, *P1, *P2;
  int x0, y0, nx, ny, nz, nb, gsx;
  T nuc, rdx2, rdy2;

  __device__ SmagBlock(C* smem, int nx_, int ny_, int nz_, int nb_, T nuc_, T dx2, T dy2)
      : S(smem), U(S + Par * WS::cols), V(U + Par * WS::cols), BU(V + Par * WS::cols),
        BV(BU + Par * WB::cols), P0(BV + Par * WB::cols), P1(P0 + Par * WP::cols),
        P2(P1 + Par * WP::cols), x0(blockIdx.y * TX), y0(blockIdx.z * TY), nx(nx_), ny(ny_),
        nz(nz_), nb(nb_), gsx(ny_ * nz_), nuc(nuc_), rdx2(T(1) / dx2), rdy2(T(1) / dy2) {}

  __device__ bool in_grid(int x, int y) const {
    return unsigned(x0 + x) < unsigned(nx) && unsigned(y0 + y) < unsigned(ny);
  }
  __device__ bool interior(int x, int y) const {
    return unsigned(x0 + x - nb) < unsigned(nx - 2 * nb) && unsigned(y0 + y - nb) < unsigned(ny - 2 * nb);
  }
  // the first level of run r
  __device__ static int k0(int r) { return (int(blockIdx.x) * Par + r) * KL; }
  // the field index of column (x, y), run r's first level
  __device__ int cell(int x, int y, int r) const { return (x0 + x) * gsx + (y0 + y) * nz + k0(r); }

  // fn(e, x, y, r) for each element e of window W, column (x, y) and level
  // run r (from level k0(r)), the block's threads in turn
  template <class W, typename F>
  __device__ static void each(F fn) {
    auto at = [&](int e) {
      const int c = e / Par;
      fn(e, c / W::WY - W::halo, c % W::WY - W::halo, e % Par);
    };
    if constexpr (Tl::Rolled) {
#pragma unroll 1
      for (int e = threadIdx.x; e < W::cols * Par; e += Tl::Threads) at(e);
    } else {
      strided<W::cols * Par, Tl::Threads>(at);
    }
  }

  // a run of levels written to device memory at field index g: one 16-byte
  // store where the run is whole and aligned
  __device__ void store(T* __restrict__ out, int g, int r, const C& val) const {
    if (Run == KL && k0(r) < nz) {
      *reinterpret_cast<C*>(&out[g]) = val;
    } else {
#pragma unroll
      for (int l = 0; l < KL; ++l)
        if (k0(r) + l < nz) out[g + l] = val.v[l];
    }
  }

  // the velocities su/s, sv/s in place (each thread reads and rewrites only
  // its own columns); the RK2 first keeps su, sv on the tile + 2, the base of
  // both stages; a barrier follows
  __device__ void velocities() {
    each<WS>([&](int c, int x, int y, int r) {
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
  }

  // one stage with its output on the tile + h: the products on the tile + h
  // + 1 from the velocities on the tile + h + 2, then base + (c s) T inside
  // the frame and base on it, kept as velocities or, at the last stage (h =
  // 0), written to su_out, sv_out
  template <int h>
  __device__ void stage(T c, T* __restrict__ su_out, T* __restrict__ sv_out) {
    using WO = Window<Tl, h>;
    each<Window<Tl, h + 1>>([&](int, int x, int y, int r) {
      const int p = WP::at(x, y, r);
      strain_products(U, V, WS::at(x, y, r), WS::sx, WS::sy, nuc, rdx2, rdy2, P0[p], P1[p], P2[p]);
    });
    __syncthreads();
    each<WO>([&](int, int x, int y, int r) {
      const int b = WB::at(x, y, r), m = WS::at(x, y, r), p = WP::at(x, y, r);
      C su = BU[b], sv = BV[b];
      if (interior(x, y)) {
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
          const int g = cell(x, y, r);
          store(su_out, g, r, su);
          store(sv_out, g, r, sv);
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
  }

  // both stages (RK2) or the one stage
  __device__ void stages(T c1, T c2, T* __restrict__ su_out, T* __restrict__ sv_out) {
    if constexpr (Stages == 2) stage<2>(c1, su_out, sv_out);
    stage<0>(c2, su_out, sv_out);
  }
};

}  // namespace tt
