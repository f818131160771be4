// Isentropic diagnostics by column scans: pressure, Exner function,
// Montgomery potential, height of the isentropes (and density, temperature).
//
// Replaces: tasmania_tpu/ops/diagnostics_step.py:103
// fused_isentropic_diagnostics (pallas_call at :167), its recurrences
// (:16-21, _diag_compute :62-93), per (i, j) column with theta on the nz+1
// interfaces, theta_s = theta[nz]:
//   p[0] = pt;  p[k+1] = pt + sum_{l<=k} g dz s[l]
//   exn = cp (p / pref)^(rd / cp)
//   mtg[nz-1] = theta_s exn[nz] + g hs + dz/2 exn[nz];
//   mtg[k] = mtg[nz-1] + sum_{l=k}^{nz-2} dz exn[l+1]
//   dh[k] = rd (theta[k] exn[k] + theta[k+1] exn[k+1]) (p[k] - p[k+1])
//           / (cp g (p[k] + p[k+1]))
//   h[nz] = hs;  h[k] = hs - sum_{l=k}^{nz-1} dh[l]
//   rho[k] = s[k] (theta[k] - theta[k+1]) / (h[k] - h[k+1])
//   t[k] = (theta[k] exn[k] + theta[k+1] exn[k+1]) / (2 cp)
// Modes: 0 "mtg" (the Montgomery potential alone), 1 "dry" (p, exn, mtg, h),
// 2 "moist" (and rho, t).  Every sum runs level by level in the order of the
// plain version's cumulative sums on the CPU (ops/diagnostics_step.py), each
// product and sum rounded apart (mul_rn/add_rn): a float32 Montgomery
// potential near 3.7e5 has a last digit of about 0.03, and the pressure
// gradient carries differences of that size into the momenta.
//
// Bound on the H100: bytes.  At the flagship (161x161x120 float32) the moist
// mode reads s (12.4 MB) and writes three interface fields and three cell
// fields (87.5 MB in all, 26 us at 3.35 TB/s); one power a level is far below
// the float32 rate.  Design: the TPU kernel's triangular MXU contractions are
// its way of scanning on a matrix unit and are not carried over.  One warp
// owns 32 neighbouring columns, one lane a column, and walks them level by
// level: forward for p and exn, backward for mtg, h, rho and t.  A column is
// contiguous in k, so a lane reading its own column would touch addresses nz
// apart from its neighbours' (no coalescing; that first version took 0.69 ms
// for the moist mode at the flagship on an H100, twice the plain version's
// time).  Instead the levels go through shared memory in chunks (31 levels
// in float32): the warp copies a chunk of its 32 columns with lanes on
// consecutive levels (each row a contiguous, coalesced access; the 32 rows'
// loads issued together, so the warp waits one latency a chunk, not 32),
// each lane then scans its own row of the tile, and the results go back to
// device memory the same way.  The backward pass reads p and exn (in mode
// "mtg": exn[k+1], kept in the output mtg[k]) back from device memory, chunk
// by chunk from the top.

#include "common.cuh"

namespace {

// levels a tile holds per pass: 31 in float32 (a tile row of 32 interface
// values, 33 apart: no bank conflicts), 15 in float64 (six tiles stay under
// 48 KB of shared memory)
template <typename T>
struct Chunk {
  static constexpr int n = sizeof(T) == 4 ? 31 : 15;
  static constexpr int ld = n + 2;
};

template <typename T>
struct DiagArgs {
  const T *s, *hs, *theta;
  T *p, *exn, *mtg, *h, *rho, *t;  // p, exn, h, rho, t: null in the modes without them
  int64_t ncol;
  int nz;
  T pt, gdz, dz, half_dz, g, cp, rdcp, inv_pref, rd, cpg, half_over_cp;
};

template <typename T>
__device__ __forceinline__ T exner(const DiagArgs<T>& a, T p) {
  return tt::mul_rn(a.cp, tt::tpow(tt::mul_rn(p, a.inv_pref), a.rdcp));
}

// levels [k0, k0 + n), n <= 32, of the warp's nc columns (rows `stride`
// apart, from column c0) into a tile and back: lane l moves level k0 + l of
// every column, the 32 columns' loads issued together
template <typename T, int LD>
__device__ __forceinline__ void load(T (*tile)[LD], const T* __restrict__ g, int64_t c0, int nc,
                                     int stride, int k0, int n) {
  const int l = threadIdx.x;
  if (l >= n) return;
  T v[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) v[j] = j < nc ? g[(c0 + j) * stride + k0 + l] : T(0);
#pragma unroll
  for (int j = 0; j < 32; ++j) tile[j][l] = v[j];
}

template <typename T, int LD>
__device__ __forceinline__ void store(T (*tile)[LD], T* __restrict__ g, int64_t c0, int nc, int stride,
                                      int k0, int n) {
  const int l = threadIdx.x;
  if (l >= n) return;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (j < nc) g[(c0 + j) * stride + k0 + l] = tile[j][l];
  }
}

template <typename T>
__global__ void __launch_bounds__(32) diagnostics_kernel(DiagArgs<T> a, int mode) {
  using tt::add_rn;
  using tt::mul_rn;
  constexpr int kChunk = Chunk<T>::n;
  constexpr int kLd = Chunk<T>::ld;
  // tiles of s (then rho), p, exn, mtg, h and T
  __shared__ T ts[32][kLd], tp[32][kLd], te[32][kLd], tm[32][kLd], th_[32][kLd], tt_[32][kLd];
  const int lane = threadIdx.x;
  const int nz = a.nz;
  const int si = nz + 1;  // row of an interface field
  const T* th = a.theta;
  for (int64_t c0 = int64_t(blockIdx.x) * 32; c0 < a.ncol; c0 += int64_t(gridDim.x) * 32) {
    const int nc = int(a.ncol - c0 < 32 ? a.ncol - c0 : 32);
    const bool active = lane < nc;
    const int64_t col = c0 + lane;
    const T hs = active ? a.hs[col] : T(0);

    // forward: p and exn on the levels 1..nz (mode mtg: exn[k+1] into mtg[k])
    T acc = T(0), exn_s = T(0);
    for (int k0 = 0; k0 < nz; k0 += kChunk) {
      const int n = nz - k0 < kChunk ? nz - k0 : kChunk;
      load(ts, a.s, c0, nc, nz, k0, n);
      __syncwarp();
      if (active) {
        for (int l = 0; l < n; ++l) {
          acc = add_rn(acc, mul_rn(a.gdz, ts[lane][l]));
          const T pk = add_rn(acc, a.pt);
          exn_s = exner(a, pk);
          tp[lane][l] = pk;
          te[lane][l] = exn_s;
        }
      }
      __syncwarp();
      if (mode == 0) {
        store(te, a.mtg, c0, nc, nz, k0, n);
      } else {
        store(tp, a.p, c0, nc, si, k0 + 1, n);
        store(te, a.exn, c0, nc, si, k0 + 1, n);
      }
      __syncwarp();
    }
    if (mode != 0 && active) {
      a.p[col * si] = a.pt;
      a.exn[col * si] = exner(a, a.pt);
      a.h[col * si + nz] = hs;
    }
    __syncwarp();  // the backward pass reads what the other lanes wrote

    // backward, from the top chunk down
    const T base = add_rn(add_rn(mul_rn(th[nz], exn_s), mul_rn(a.g, hs)), mul_rn(a.half_dz, exn_s));
    T r = T(0), rh = T(0), h_up = hs;  // h_up: h[k+1]
    for (int k0 = ((nz - 1) / kChunk) * kChunk; k0 >= 0; k0 -= kChunk) {
      const int n = nz - k0 < kChunk ? nz - k0 : kChunk;
      if (mode == 0) {
        load(te, a.mtg, c0, nc, nz, k0, n);  // te[l] = exn[k0 + l + 1]
      } else {
        load(tp, a.p, c0, nc, si, k0, n + 1);  // levels k0 .. k0 + n
        load(te, a.exn, c0, nc, si, k0, n + 1);
        if (mode == 2) load(ts, a.s, c0, nc, nz, k0, n);
      }
      __syncwarp();
      if (active) {
        for (int l = n - 1; l >= 0; --l) {
          const int k = k0 + l;
          if (k < nz - 1) r = add_rn(r, mul_rn(a.dz, mode == 0 ? te[lane][l] : te[lane][l + 1]));
          tm[lane][l] = k < nz - 1 ? add_rn(base, r) : base;
          if (mode != 0) {
            const T tex = add_rn(mul_rn(th[k], te[lane][l]), mul_rn(th[k + 1], te[lane][l + 1]));
            const T pk = tp[lane][l], pk1 = tp[lane][l + 1];
            const T dh = mul_rn(mul_rn(a.rd, tex), pk - pk1) / mul_rn(a.cpg, add_rn(pk, pk1));
            rh = add_rn(rh, dh);
            const T hk = hs - rh;
            th_[lane][l] = hk;
            if (mode == 2) {
              ts[lane][l] = mul_rn(ts[lane][l], th[k] - th[k + 1]) / (hk - h_up);
              tt_[lane][l] = mul_rn(a.half_over_cp, tex);
            }
            h_up = hk;
          }
        }
      }
      __syncwarp();
      store(tm, a.mtg, c0, nc, nz, k0, n);
      if (mode != 0) store(th_, a.h, c0, nc, si, k0, n);
      if (mode == 2) {
        store(ts, a.rho, c0, nc, nz, k0, n);
        store(tt_, a.t, c0, nc, nz, k0, n);
      }
      __syncwarp();
    }
  }
}

template <typename T>
int launch(const void* const* ptrs, void* const* outs, int64_t ncol, int nz, int mode,
           const double* sc, cudaStream_t stream) {
  DiagArgs<T> a;
  a.s = static_cast<const T*>(ptrs[0]);
  a.hs = static_cast<const T*>(ptrs[1]);
  a.theta = static_cast<const T*>(ptrs[2]);
  a.p = a.exn = a.h = a.rho = a.t = nullptr;
  if (mode == 0) {
    a.mtg = static_cast<T*>(outs[0]);
  } else {
    T** out[] = {&a.p, &a.exn, &a.mtg, &a.h, &a.rho, &a.t};
    for (int n = 0; n < (mode == 2 ? 6 : 4); ++n) *out[n] = static_cast<T*>(outs[n]);
  }
  a.ncol = ncol;
  a.nz = nz;
  // scalars: pt, dz, g, cp, rd, pref; the products of constants are formed
  // in double and rounded once, as the plain version's Python floats are
  const double pt = sc[0], dz = sc[1], g = sc[2], cp = sc[3], rd = sc[4], pref = sc[5];
  a.pt = T(pt); a.gdz = T(g * dz); a.dz = T(dz); a.half_dz = T(0.5 * dz); a.g = T(g);
  a.cp = T(cp); a.rdcp = T(rd / cp); a.inv_pref = T(1.0 / pref); a.rd = T(rd);
  a.cpg = T(cp * g); a.half_over_cp = T(0.5 / cp);
  const int64_t warps = (ncol + 31) / 32;
  diagnostics_kernel<T><<<unsigned(warps > 65535 ? 65535 : warps), 32, 0, stream>>>(a, mode);
  return int(cudaGetLastError());
}

}  // namespace

// ptrs: s (ncol x nz), hs (ncol), theta (nz + 1); outs by mode: 0 mtg; 1 p,
// exn, mtg, h; 2 p, exn, mtg, h, rho, t (p, exn, h: ncol x (nz + 1); the
// others ncol x nz); scalars: pt, dz, g, cp, rd, pref
extern "C" int tt_isentropic_diagnostics(int dtype, const void* const* ptrs, void* const* outs,
                                         int ncol, int nz, int mode, const double* scalars,
                                         cudaStream_t stream) {
  if (ncol < 1 || nz < 2 || mode < 0 || mode > 2) return int(cudaErrorInvalidValue);
  if (dtype == tt::kFloat32) return launch<float>(ptrs, outs, ncol, nz, mode, scalars, stream);
  return launch<double>(ptrs, outs, ncol, nz, mode, scalars, stream);
}
