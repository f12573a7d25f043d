// Pair sums of batched crates for Hopper (sm_90a): the dense all-pairs
// passes (D1) and the chunked window passes (D2), one launch a pass for
// every crate of a batch.
//
// Neither replaces a pl.pallas_call.  D1 (dense_pass_kernel) is the
// counterpart of the XLA fusion of sand_crate_tpu/cellwise.py:334-392
// (neighbor_forces_dense); D2 (window_pass_kernel) of the XLA loop of
// sand_crate_tpu/ops/chunked.py:50 (_pass_scan, its fori_loop at l.156).
// The port's torch versions ran each pass as a few dozen unfused
// elementwise ops over (B, P, P) planes (D1; one f32 plane is 1.68 GB at
// 1024 crates of 640 slots) or over (cs, cs + 2H) planes, one self chunk
// at a time in a Python loop (D2).  Here a block takes a tile of TS selves
// of one crate, stages the candidates (every slot of the crate for D1, the
// chunk's fixed window for D2) through shared memory kTile at a time, and
// each thread walks its share of them with the pair's terms in registers:
// nothing of size P^2 reaches device memory.  The wrappers and their plain
// torch versions are sand_crate_tpu_torch/ops/pair_batch.py.
//
// Bound: the function tests every candidate pair (~6 f32 operations: rx,
// ry, d2 and the compare; D2 first tests the row) and computes the rest of
// a pair's terms (~22 in pass A, ~34 in pass B) only for the pairs it
// counts, ~8 a self (ops/pair_batch.py counts them), against a few dozen
// bytes a slot: the bound is operations.  This form computes every term of
// every candidate pair (no culling beyond the diameter: see NaN below), so
// it runs far from that bound; pair culling is later work.
//
// Block layout: kThreads = TS selves x NS = kThreads / TS splits of the
// candidates, TS = 32, or 16 where the crate has more than 2048 rows, so
// that one crate of 4096 still gives 256 blocks for the 132 SMs.  Thread
// (split s, self t) sums candidates s, s + NS, s + 2 NS, ... of each staged
// tile in order; the NS partial sums of a self are then added in the order
// s = 0, 1, ..., NS - 1.  The order depends on the crate's shape (P; p_pad,
// cs and H for D2) alone, never on B or on the data: a vmapped batch
// equals each crate alone bit for bit, and a captured replay its eager
// run.  No atomics.
//
// Pair terms: every value is the plain version's f32 operation in its
// order.  Built with -fmad=false, d2 = rx*rx + ry*ry rounds each product,
// so the pair set, and the neighbour count, are the plain version's
// exactly.  D1 takes the distance and direction with IEEE sqrt and
// division (cellwise.neighbor_forces_dense), D2 with rsqrt
// (ops/chunked.py, torch.rsqrt).  The float sums differ from torch's in
// their order only.
//
// NaN: the plain versions follow the JAX package's compiled step: each
// pair's weight and coefficients are selected by the mask (XLA compiles a
// product with a converted mask as a select), then multiplied by the
// direction, so a masked coefficient still makes 0 * NaN with a NaN
// direction; D1's neighbour velocities are multiplied by the 0/1 mask (the
// compiled dense step keeps that product), D2's selected.  A dead slot at a
// NaN position (as cull_particles leaves one behind) makes NaN the sums of
// every self that reads its direction, dead or alive, and a NaN velocity
// every D1 visc_vsum.  Every pair is computed here in that order, so the
// NaN places are the plain version's.

#include <cstdint>

#include <cuda_runtime.h>

// The operands: outside the unnamed namespace, so the C entry points that
// take them keep external linkage.  Mirrored by ops/pair_batch.py's
// _DenseArgs and _WindowArgs (ctypes); keep them in step.
struct DenseArgs {
  const float* pos;    // (B, P, 2)
  const float* vel;    // (B, P, 2)
  const bool* alive;   // (B, P)
  const float* noise;  // (B, P, 2) collider jitter, added to the candidate's position
  const float *diameter, *surface_smoothing, *target_pressure, *ignored_pressure,
      *spring_overlap_balance;  // (B,)
  float *p_i, *cnt;             // (B, P): pass A writes, pass B reads p_i
  float* s;                     // (B, P, 2): pass A writes, pass B reads
  float *dv_tension, *pressure_real, *spring_real, *visc_vsum;  // (B, P, 2): pass B writes
  int B, P;
};

struct WindowArgs {
  const float* feat;  // (B, p_pad, F) cell-sorted feature slab (ops/chunked.py)
  const float *diameter, *surface_smoothing, *target_pressure,
      *spring_overlap_balance;  // (B,)
  float* out;                   // (B, p_pad, n_out)
  int B, p_pad, F, halo, cs, n_chunks;
};

namespace {

constexpr float kEps = 1e-12f;   // cellwise.py / ops/pmajor.py EPS
constexpr float kEps2 = 1e-24f;  // EPS * EPS, ops/chunked.py's floor of nd2
constexpr int kThreads = 256;
constexpr int kTile = 256;  // candidates staged at a time
// Staged candidate columns: D1 pass B (pos, noisy pos, alive, vel, p, s)
// and D2 mode b (the slab's 11 features).
constexpr int kStaged = 11;

// torch.clamp keeps a NaN; fmaxf / fminf would drop it.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp01(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

// The sums a self keeps: pass A (w, s, cnt), pass B (tension, pressure,
// the spring where enabled, the neighbour velocities).
template <int MODE, bool SPRING>
struct Sums {
  static constexpr int N = MODE == 0 ? 4 : (SPRING ? 8 : 6);
};

// The NS partial sums of each self in shared memory, then added in split
// order by the split-0 thread: tot[f] = part[0][f] + part[1][f] + ...
template <int N>
__device__ __forceinline__ bool combine(float (&acc)[N], float* red, int ts, int ns, int split,
                                        int sl) {
  __syncthreads();  // the staged tiles are no longer read
#pragma unroll
  for (int f = 0; f < N; ++f) red[(f * ns + split) * ts + sl] = acc[f];
  __syncthreads();
  if (split != 0) return false;
#pragma unroll
  for (int f = 0; f < N; ++f) {
    float v = red[f * ns * ts + sl];
    for (int q = 1; q < ns; ++q) v += red[(f * ns + q) * ts + sl];
    acc[f] = v;
  }
  return true;
}

// D1: pass A (MODE 0) -> cnt, p_i, s; pass B (MODE 1) -> dv_tension,
// pressure_real, spring_real (zeros without SPRING, as the plain version
// gives), visc_vsum.  Grid (ceil(P / ts), B).
template <int MODE, bool SPRING>
__global__ void __launch_bounds__(kThreads) dense_pass_kernel(const DenseArgs a, int ts) {
  constexpr int N = Sums<MODE, SPRING>::N;
  __shared__ float sh[kStaged * kTile];
  float* c_px = sh;
  float* c_py = sh + kTile;
  float* c_qx = sh + 2 * kTile;  // the candidate's position plus its noise
  float* c_qy = sh + 3 * kTile;
  float* c_al = sh + 4 * kTile;
  float* c_vx = sh + 5 * kTile;
  float* c_vy = sh + 6 * kTile;
  float* c_p = sh + 7 * kTile;
  float* c_sx = sh + 8 * kTile;
  float* c_sy = sh + 9 * kTile;

  const int b = blockIdx.y;
  const int P = a.P;
  const int ns = kThreads / ts;
  const int sl = threadIdx.x % ts, split = threadIdx.x / ts;
  const int i = blockIdx.x * ts + sl;
  const bool self_in = i < P;
  const int64_t row0 = static_cast<int64_t>(b) * P;

  // diam = clamp(diameter, min=EPS); the 0-d products as torch takes them
  const float diam = clamp_min(a.diameter[b], kEps);
  const float diam2 = diam * diam;
  float smooth = 0.0f, tp2 = 0.0f, bal = 0.0f;
  if constexpr (MODE == 1) {
    smooth = a.surface_smoothing[b];
    tp2 = 2.0f * a.target_pressure[b];
    bal = a.spring_overlap_balance[b];
  }

  float px = 0.0f, py = 0.0f, pi = 0.0f, sxi = 0.0f, syi = 0.0f;
  bool ai = false;
  if (self_in) {
    const int64_t r = row0 + i;
    px = a.pos[2 * r];
    py = a.pos[2 * r + 1];
    ai = a.alive[r];
    if constexpr (MODE == 1) {
      pi = a.p_i[r];
      sxi = a.s[2 * r];
      syi = a.s[2 * r + 1];
    }
  }
  float acc[N];
#pragma unroll
  for (int f = 0; f < N; ++f) acc[f] = 0.0f;

  for (int j0 = 0; j0 < P; j0 += kTile) {
    const int n = min(kTile, P - j0);
    __syncthreads();
    if (threadIdx.x < n) {
      const int t = threadIdx.x;
      const int64_t r = row0 + j0 + t;
      const float x = a.pos[2 * r], y = a.pos[2 * r + 1];
      c_px[t] = x;
      c_py[t] = y;
      c_qx[t] = x + a.noise[2 * r];  // qx = px + noise[:, 0]
      c_qy[t] = y + a.noise[2 * r + 1];
      c_al[t] = a.alive[r] ? 1.0f : 0.0f;
      if constexpr (MODE == 1) {
        c_vx[t] = a.vel[2 * r];
        c_vy[t] = a.vel[2 * r + 1];
        c_p[t] = a.p_i[r];
        c_sx[t] = a.s[2 * r];
        c_sy[t] = a.s[2 * r + 1];
      }
    }
    __syncthreads();
    if (!self_in) continue;
    for (int k = split; k < n; k += ns) {
      const float rx = px - c_px[k];
      const float ry = py - c_py[k];
      const float d2 = rx * rx + ry * ry;
      const float m = (d2 <= diam2 && ai && c_al[k] != 0.0f && j0 + k != i) ? 1.0f : 0.0f;
      float nx = px - c_qx[k];
      float ny = py - c_qy[k];
      const float dist = sqrtf(clamp_min(nx * nx + ny * ny, 0.0f));
      const float den = clamp_min(dist, kEps);
      nx = nx / den;
      ny = ny / den;
      const float w = m != 0.0f ? 1.0f - clamp01(dist / diam) : 0.0f;
      if constexpr (MODE == 0) {
        acc[0] += m;
        acc[1] += w;
        const float coeff = (1.0f - w) * w;
        acc[2] += coeff * nx;
        acc[3] += coeff * ny;
      } else {
        const float align = ((sxi - c_sx[k]) * nx + (syi - c_sy[k]) * ny) * smooth;
        const float t = m != 0.0f ? align + ((c_p[k] + pi) - tp2) : 0.0f;
        acc[0] += t * nx;
        acc[1] += t * ny;
        const float tpr = m != 0.0f ? pi + c_p[k] : 0.0f;
        acc[2] += tpr * nx;
        acc[3] += tpr * ny;
        if constexpr (SPRING) {
          const float tsp = m != 0.0f ? bal - w : 0.0f;
          acc[4] += tsp * nx;
          acc[5] += tsp * ny;
        }
        acc[N - 2] += m * c_vx[k];  // a product, as the plain version
        acc[N - 1] += m * c_vy[k];
      }
    }
  }

  if (!combine(acc, sh, ts, ns, split, sl) || !self_in) return;
  const int64_t r = row0 + i;
  if constexpr (MODE == 0) {
    // p_i = where(cnt > 0, clamp(w_sum - ignored_pressure, min=0), 0)
    a.cnt[r] = acc[0];
    a.p_i[r] = acc[0] > 0.0f ? clamp_min(acc[1] - a.ignored_pressure[b], 0.0f) : 0.0f;
    a.s[2 * r] = acc[2];
    a.s[2 * r + 1] = acc[3];
  } else {
    a.dv_tension[2 * r] = acc[0];
    a.dv_tension[2 * r + 1] = acc[1];
    a.pressure_real[2 * r] = acc[2];
    a.pressure_real[2 * r + 1] = acc[3];
    a.spring_real[2 * r] = SPRING ? acc[4] : 0.0f;
    a.spring_real[2 * r + 1] = SPRING ? acc[5] : 0.0f;
    a.visc_vsum[2 * r] = acc[N - 2];
    a.visc_vsum[2 * r + 1] = acc[N - 1];
  }
}

// The slab's feature columns (ops/chunked.py's feat_a / feat_b).
enum : int { kPx = 0, kPy, kNpx, kNpy, kRow, kAlive, kVx, kVy, kCp, kSx, kSy };

// D2: the cs-wide self chunks c < n_chunks of the slab, each against its
// window rows [c cs - H, c cs + cs + H) (rows outside [0, p_pad) are the
// plain version's zero padding); rows of later chunks get exact zeros.
// MODE 0 writes (w, s_x, s_y, cnt), MODE 1 the tension, pressure, spring
// (with SPRING) and neighbour-velocity sums.  Grid ((p_pad / cs) *
// ceil(cs / ts), B).
template <int MODE, bool SPRING>
__global__ void __launch_bounds__(kThreads) window_pass_kernel(const WindowArgs a, int ts) {
  constexpr int N = Sums<MODE, SPRING>::N;
  constexpr int NF = MODE == 0 ? 6 : 11;  // feature columns read
  __shared__ float sh[kStaged * kTile];

  const int b = blockIdx.y;
  const int ns = kThreads / ts;
  const int sl = threadIdx.x % ts, split = threadIdx.x / ts;
  const int tiles = (a.cs + ts - 1) / ts;
  const int c = blockIdx.x / tiles;
  const int in_chunk = (blockIdx.x - c * tiles) * ts + sl;
  const bool self_in = in_chunk < a.cs;
  const int i = c * a.cs + in_chunk;
  float* out = a.out + static_cast<int64_t>(b) * a.p_pad * N;
  if (c >= a.n_chunks) {  // past the swept chunks: the plain version's zeros
    if (split == 0 && self_in) {
#pragma unroll
      for (int f = 0; f < N; ++f) out[static_cast<int64_t>(i) * N + f] = 0.0f;
    }
    return;
  }
  const float* feat = a.feat + static_cast<int64_t>(b) * a.p_pad * a.F;

  // diam * diam with the diameter as given; 1 / clamp(diam, min=EPS)
  const float diam = a.diameter[b];
  const float diam2 = diam * diam;
  const float inv_diam = 1.0f / clamp_min(diam, kEps);
  float smooth = 0.0f, tp2 = 0.0f, bal = 0.0f;
  if constexpr (MODE == 1) {
    smooth = a.surface_smoothing[b];
    tp2 = 2.0f * a.target_pressure[b];
    bal = a.spring_overlap_balance[b];
  }

  float self[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) self[f] = self_in ? feat[static_cast<int64_t>(i) * a.F + f] : 0.0f;
  float acc[N];
#pragma unroll
  for (int f = 0; f < N; ++f) acc[f] = 0.0f;

  const int wt = a.cs + 2 * a.halo;
  const int w0 = c * a.cs - a.halo;  // the window's first slab row
  for (int k0 = 0; k0 < wt; k0 += kTile) {
    const int n = min(kTile, wt - k0);
    __syncthreads();
    if (threadIdx.x < n) {
      const int r = w0 + k0 + threadIdx.x;
      const bool in = r >= 0 && r < a.p_pad;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        sh[f * kTile + threadIdx.x] = in ? feat[static_cast<int64_t>(r) * a.F + f] : 0.0f;
      }
    }
    __syncthreads();
    if (!self_in) continue;
    for (int k = split; k < n; k += ns) {
      const float rx = self[kPx] - sh[kPx * kTile + k];
      const float ry = self[kPy] - sh[kPy * kTile + k];
      const float d2 = rx * rx + ry * ry;
      const float dr = sh[kRow * kTile + k] - self[kRow];
      const bool mb = d2 <= diam2 && self[kAlive] > 0.0f && sh[kAlive * kTile + k] > 0.0f &&
                      dr >= -1.0f && dr <= 1.0f && i != w0 + k0 + k;
      const float nrx = self[kPx] - sh[kNpx * kTile + k];
      const float nry = self[kPy] - sh[kNpy * kTile + k];
      const float nd2 = clamp_min(nrx * nrx + nry * nry, kEps2);
      const float inv = rsqrtf(nd2);
      const float nhx = nrx * inv;
      const float nhy = nry * inv;
      const float dist = nd2 * inv;
      const float wgt = mb ? 1.0f - clamp01(dist * inv_diam) : 0.0f;
      if constexpr (MODE == 0) {
        const float coeff = (1.0f - wgt) * wgt;
        acc[0] += wgt;
        acc[1] += coeff * nhx;
        acc[2] += coeff * nhy;
        acc[3] += mb ? 1.0f : 0.0f;
      } else {
        const float c_cp = sh[kCp * kTile + k];
        const float align = ((self[kSx] - sh[kSx * kTile + k]) * nhx +
                             (self[kSy] - sh[kSy * kTile + k]) * nhy) * smooth;
        const float t = mb ? align + ((c_cp + self[kCp]) - tp2) : 0.0f;
        const float p = mb ? self[kCp] + c_cp : 0.0f;
        acc[0] += t * nhx;
        acc[1] += t * nhy;
        acc[2] += p * nhx;
        acc[3] += p * nhy;
        if constexpr (SPRING) {
          const float sp = mb ? bal - wgt : 0.0f;
          acc[4] += sp * nhx;
          acc[5] += sp * nhy;
        }
        acc[N - 2] += mb ? sh[kVx * kTile + k] : 0.0f;  // a where, as the plain version
        acc[N - 1] += mb ? sh[kVy * kTile + k] : 0.0f;
      }
    }
  }

  if (!combine(acc, sh, ts, ns, split, sl) || !self_in) return;
#pragma unroll
  for (int f = 0; f < N; ++f) out[static_cast<int64_t>(i) * N + f] = acc[f];
}

// Selves a block: 32, or 16 past 2048 rows (a crate of 4096 gives 256
// blocks).  A function of the crate's rows alone, so the reduction order
// is the same for a crate alone and in any batch.
int self_tile(int rows) { return rows > 2048 ? 16 : 32; }

template <int MODE, bool SPRING>
int launch_dense(const DenseArgs& a, cudaStream_t stream) {
  const int ts = self_tile(a.P);
  const dim3 grid((a.P + ts - 1) / ts, a.B);
  dense_pass_kernel<MODE, SPRING><<<grid, kThreads, 0, stream>>>(a, ts);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, bool SPRING>
int launch_window(const WindowArgs& a, cudaStream_t stream) {
  const int ts = self_tile(a.p_pad);
  const dim3 grid((a.p_pad / a.cs) * ((a.cs + ts - 1) / ts), a.B);
  window_pass_kernel<MODE, SPRING><<<grid, kThreads, 0, stream>>>(a, ts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One dense pass (mode 0: A, 1: B; spring: pass B's spring sums) over B
// crates of P slots.  Launches on `stream` and does not synchronise;
// returns cudaGetLastError().
extern "C" int sc_dense_pass(const DenseArgs* args, int mode, int spring, void* stream) {
  const DenseArgs& a = *args;
  if (a.B <= 0 || a.P <= 0) return 0;
  if (a.B > 65535 || mode < 0 || mode > 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) return launch_dense<0, false>(a, s);
  return spring ? launch_dense<1, true>(a, s) : launch_dense<1, false>(a, s);
}

// One window pass (mode 0: A, 1: B) over B crates' (p_pad, F) slabs, the
// first n_chunks chunks of cs selves swept.  Launches on `stream` and does
// not synchronise; returns cudaGetLastError().
extern "C" int sc_window_pass(const WindowArgs* args, int mode, int spring, void* stream) {
  const WindowArgs& a = *args;
  if (a.B <= 0 || a.p_pad <= 0) return 0;
  if (a.B > 65535 || mode < 0 || mode > 1 || a.cs <= 0 || a.p_pad % a.cs != 0 || a.halo < 0 ||
      a.n_chunks < 0 || a.n_chunks > a.p_pad / a.cs || a.F < (mode == 0 ? 6 : 11)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) return launch_window<0, false>(a, s);
  return spring ? launch_window<1, true>(a, s) : launch_window<1, false>(a, s);
}
