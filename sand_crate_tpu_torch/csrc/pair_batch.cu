// Pair sums of batched crates for Hopper (sm_90a): the dense all-pairs
// passes (D1, after one prologue that orders each crate) and the chunked
// window passes (D2), one launch a pass for every crate of a batch.
//
// Neither replaces a pl.pallas_call.  D1 (dense_pass_kernel) is the
// counterpart of the XLA fusion of sand_crate_tpu/cellwise.py:334-392
// (neighbor_forces_dense); D2 (window_pass_kernel) of the XLA loop of
// sand_crate_tpu/ops/chunked.py:50 (_pass_scan, its fori_loop at l.156).
// The wrappers, the plain torch versions and a torch mirror of the
// prologue and of the skip rule are sand_crate_tpu_torch/ops/pair_batch.py.
//
// Bound.  Of the P^2 candidate pairs of a dense crate (cs (cs + 2H) of a
// window chunk) only a few a self lie within one diameter: at 1024 crates
// of 640 slots 2.3e6 of 4.2e8.  Any implementation must read each slot's
// fields once, write its sums once, and compute the terms of the pairs
// that count (~22 f32 operations in pass A, ~34 in pass B, 39 with the
// spring: ops/pair_batch.py's COUNTED_PAIR_OPS) at the card's 67 TFLOP/s;
// the larger of the two times is the bound.  What this design adds is the
// pair test (rx, ry, d2, the compare) of the candidates its tiles cannot
// rule out, a few tiles of 32 a self, and D1's prologue.
//
// Design.  A warp holds TS selves (32; 16 in a crate of more than 2048
// rows, each self's candidates then split between two lanes, so that one
// crate of 4096 slots still gives D1 256 warps, and as many blocks, for
// the 132 SMs) and walks the candidates in tiles of kTile = 32 slots:
//  * D1's prologue (dense_order_kernel, a block a crate) sorts the crate's
//    slots by a cell key: the row-major cell of side one diameter, clamped
//    to kCellMax cells an axis; a dead slot or a NaN position takes the
//    dead key and sorts last.  The key sets the order only; no result
//    depends on it.  It sorts (key, slot) in shared memory: a bin a grid
//    row (the dead slots after them, 32 a bin, in slot order), filled by
//    counting, and a slot's place in its bin the count of smaller
//    composites there, so ties keep slot order (a stable sort by key;
//    crates past kSortMax slots stay in slot order; integer atomics only
//    count and place, and no result depends on their order).  The work is
//    the sum of the bins' squared sizes, a row's particles a slot: far
//    below a sorting network's at 640 slots.  It writes the slot of each
//    sorted index, the sorted positions, noisy positions (position + noise)
//    and velocities, and a Tile record per 32 sorted slots.  Both passes
//    read one prologue and write their sums to slot order; pass B reads
//    pass A's p_i and s there, through the order.
//  * D2's slab is cell-sorted already (ops/chunked.py).  A block of up to
//    kWindowWarps warps (selves of one chunk) builds the Tile records of the
//    chunk's window, tiles counted from its first row, in shared memory,
//    32 tiles at a time; a record also holds its alive slots' grid rows.
//  * A Tile holds the box of its alive bounded slots, their alive bits, and
//    whether every slot of it is bounded (|v| <= kBig: position and noisy
//    position; for D1's pass B the velocity too).
//  * A warp reduces its selves' box (D2: and rows), then tests 32 candidate
//    tiles at once, one a lane, and ballots those to visit.  Where the
//    selves and the tile are all bounded, it skips a tile with no alive
//    slot, or whose box lies more than one diameter from the selves' box
//    (squared gap > diam^2), or (D2) whose rows lie more than one row from
//    theirs: the skip is uniform across the warp.
//  * A visited tile's positions (D2: and rows) are staged in the warp's own
//    shared memory.  Each lane tests its self against the tile's candidates
//    (rx, ry, d2 <= diam^2 as the plain version takes them, alive, not
//    itself; D2 the row delta) and appends its counted pairs to a list of
//    its own (kCap entries in shared memory).  Only then does it compute a
//    pair's noisy offset, length, direction, weight and terms, reading the
//    candidate by its index, in candidate order: when a tile would overflow
//    a lane's list, before a tile computed pair by pair, and at the end.
//    So a warp diverges over its lanes' counted pairs a few times in all,
//    not once a tile.  Where the selves or the tile hold a slot that is not
//    bounded, it computes every pair of the tile, masked ones included, as
//    the plain version does (the NaN rule below).
//
// Why the skips change no bit.  (1) The plain versions select a masked
// pair's weight and coefficients to 0 and multiply them by the direction
// (D1's pass B also multiplies the mask by the neighbour's velocity).  With
// every value in play bounded, the offset is at most 2^101, so the
// direction is finite (the offset over its own length, or over an infinite
// one: 0) and each masked addend is +0 or -0.  A sum that starts at +0 is
// never -0 under round to nearest, so adding +-0 leaves it as it was:
// leaving a masked pair out changes no bit.  (2) The box test keeps every
// counted pair: per axis the gap is max(fl(cmin - smax), fl(smin - cmax),
// 0) and gap2 = gx gx + gy gy, in the order of the pair's d2 (-fmad=false
// holds for the whole file).  Round to nearest is monotone, so for every
// pair of the two tiles |rx| >= gx, |ry| >= gy and fl(d2) >= gap2: a tile
// pair with gap2 > diam^2 holds no pair with d2 <= diam^2, and no margin is
// needed.  Grid rows are small integers, exact in f32.  The order of a
// self's sums is its candidates' order (D1: the sorted one), a function of
// the crate alone, and two lanes of a self are added lane 0 + lane 1: a
// vmapped crate equals the crate alone, and a replay its eager run, bit for
// bit.  No atomics on floats (the prologue's integer ones count and place).
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
// pair's weight and coefficients are selected by the mask, then multiplied
// by the direction, so a masked coefficient still makes 0 * NaN with a NaN
// direction; D1's neighbour velocities are multiplied by the 0/1 mask, D2's
// selected.  A dead slot at a NaN position (as cull_particles leaves one
// behind) makes NaN the sums of every self that reads its direction, dead
// or alive, and a non-finite velocity every D1 visc_vsum.  Such a slot
// clears its tile's bounded flag, so every tile pair that holds it is
// visited and computed pair by pair in the plain version's form: the NaN
// places are the plain version's.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

// A tile's record (32 bytes): the prologue writes D1's to device memory, D2
// builds its window's in shared memory.  Mirrored by ops/pair_batch.py's
// TILE_FIELDS; keep them in step.
struct Tile {
  float x0, x1, y0, y1;  // box of the alive bounded slots (+inf, -inf: none)
  float r0, r1;          // D2: their grid rows (D1: 0)
  unsigned alive;        // bit k: slot k of the tile alive
  unsigned flags;        // kPosOk, kVelOk
};

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
  float *p_i, *cnt;             // (B, P) slot order: pass A writes, pass B reads p_i
  float* s;                     // (B, P, 2) slot order: pass A writes, pass B reads
  float *dv_tension, *pressure_real, *spring_real, *visc_vsum;  // (B, P, 2): pass B writes
  int* order;                   // (B, P): the slot of each sorted index (the prologue writes)
  float* pq;                    // (B, P, 4): sorted px, py, qx, qy (q = position + noise)
  float* sv;                    // (B, P, 2): sorted velocity
  Tile* tiles;                  // (B, ceil(P / kTile)): the sorted tiles' records
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
constexpr float kBig = 0x1p100f;  // a bounded value: |v| <= 2^100
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kPosOk = 1u;  // every slot's position and noisy position bounded
constexpr unsigned kVelOk = 2u;  // ... and its velocity too
constexpr int kTile = 32;        // candidates a tile (a warp's lanes)
constexpr int kCap = 32;         // counted pairs a lane holds before it takes their terms
constexpr int kSortMax = 4096;   // crates the prologue sorts (12 bits of slot)
constexpr int kSlotBits = 12;
constexpr int kCellMax = 1022;   // cells an axis 0..kCellMax (10 bits a key half)
constexpr unsigned kKeyDead = 0xfffffu;
// The sort's bins: one a grid row (rows past kRows - 1 share the last, so a
// bin's keys rise with its index), then the dead slots, 32 a bin.
constexpr int kRows = 128;
constexpr int kBins = kRows + kSortMax / 32;
constexpr int kOrderThreads = 1024;           // at most; 4 slots a thread at most
constexpr int kOrderPer = kSortMax / kOrderThreads;
constexpr int kPassWarps = 4;    // D1: warps a block at most
constexpr int kWindowWarps = 8;  // D2: warps a block at most

// torch.clamp keeps a NaN; fmaxf / fminf would drop it.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp01(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ bool bounded(float v) { return fabsf(v) <= kBig; }

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The warp's box (and row range) over the lanes with `in`; +inf / -inf for none.
__device__ __forceinline__ Tile warp_box(bool in, float x, float y, float r) {
  Tile t;
  t.x0 = warp_min(in ? x : INFINITY);
  t.x1 = warp_max(in ? x : -INFINITY);
  t.y0 = warp_min(in ? y : INFINITY);
  t.y1 = warp_max(in ? y : -INFINITY);
  t.r0 = warp_min(in ? r : INFINITY);
  t.r1 = warp_max(in ? r : -INFINITY);
  return t;
}

// Two bounded non-empty boxes more than one diameter apart: no pair of them
// has d2 <= diam2 (the note's (2)).
__device__ __forceinline__ bool far_apart(const Tile& s, const Tile& c, float diam2) {
  const float gx = fmaxf(fmaxf(c.x0 - s.x1, s.x0 - c.x1), 0.0f);
  const float gy = fmaxf(fmaxf(c.y0 - s.y1, s.y0 - c.y1), 0.0f);
  const float gap2 = gx * gx + gy * gy;
  return gap2 > diam2;
}

// The bits of a tile's candidates k = q L + h that lane h of a self tests,
// as bits q (L = 2: every other bit, from bit h).
__device__ __forceinline__ unsigned lane_bits(unsigned bits, int L, int h) {
  if (L == 1) return bits;
  unsigned x = (bits >> h) & 0x55555555u;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0f0f0f0fu;
  x = (x | (x >> 4)) & 0x00ff00ffu;
  return (x | (x >> 8)) & 0x0000ffffu;
}

// Bits 0..n-1.
__device__ __forceinline__ unsigned low_bits(int n) { return n >= 32 ? kFull : (1u << n) - 1u; }

// The sums a self keeps: pass A (w, s, cnt), pass B (tension, pressure,
// the spring where enabled, the neighbour velocities).
template <int MODE, bool SPRING>
struct Sums {
  static constexpr int N = MODE == 0 ? 4 : (SPRING ? 8 : 6);
};

// Lane h = 1 of a self's two lanes into lane h = 0: acc = part 0 + part 1.
template <int N>
__device__ __forceinline__ void combine_halves(float (&acc)[N], int ts) {
  if (ts == kTile) return;
#pragma unroll
  for (int f = 0; f < N; ++f) acc[f] += __shfl_down_sync(kFull, acc[f], ts);
}

// D1's sort key: the row-major cell of side diam, clamped; dead or NaN last.
__device__ __forceinline__ unsigned cell_key(float x, float y, bool alive, float diam) {
  float fx = floorf(x / diam) + 1.0f;
  float fy = floorf(y / diam) + 1.0f;
  if (!alive || isnan(fx) || isnan(fy)) return kKeyDead;
  fx = fminf(fmaxf(fx, 0.0f), static_cast<float>(kCellMax));
  fy = fminf(fmaxf(fy, 0.0f), static_cast<float>(kCellMax));
  return static_cast<unsigned>(fy) * 1024u + static_cast<unsigned>(fx);
}

// Exclusive prefix sums of in[0, n) into out[0, n), block-wide.
__device__ void block_scan(const int* in, int* out, int n, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(static_cast<int>(threadIdx.x) * per, n), hi = min(lo + per, n);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += in[i];
  int x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int base = (warp > 0 ? warp_sums[warp - 1] : 0) + x - sum;
  for (int i = lo; i < hi; ++i) {
    out[i] = base;
    base += in[i];
  }
}

// D1's prologue: a block a crate.  Sorts the crate's slots (P <= kSortMax)
// by (key, slot): a bin a grid row (the bins rise with the key; the dead
// slots after them, 32 a bin in slot order) filled by counting, then each
// slot's place in its bin by counting the smaller composites there.  Then a
// warp a tile of sorted slots writes them (order, pq, sv) and the tile's
// record.
__global__ void __launch_bounds__(kOrderThreads) dense_order_kernel(const DenseArgs a) {
  __shared__ unsigned comp[kSortMax];  // (key << kSlotBits | slot): binned, then sorted
  __shared__ int bin_end[kBins], bin_start[kBins];
  __shared__ int warp_sums[32];
  const int b = blockIdx.x;
  const int P = a.P;
  const int64_t row0 = static_cast<int64_t>(b) * P;
  const float2* pos = reinterpret_cast<const float2*>(a.pos) + row0;
  const float2* noise = reinterpret_cast<const float2*>(a.noise) + row0;
  const float2* vel = reinterpret_cast<const float2*>(a.vel) + row0;
  const bool* alive = a.alive + row0;
  const bool sort = P <= kSortMax;
  if (sort) {
    const float diam = clamp_min(a.diameter[b], kEps);
    const int nb = kRows + (P + 31) / 32;
    for (int i = threadIdx.x; i < nb; i += blockDim.x) bin_end[i] = 0;
    __syncthreads();
    unsigned mine[kOrderPer];
    int bin[kOrderPer];
#pragma unroll
    for (int k = 0; k < kOrderPer; ++k) {
      const int e = threadIdx.x + k * blockDim.x;
      bin[k] = -1;
      mine[k] = 0u;
      if (e < P) {
        const float2 p = pos[e];
        const unsigned key = cell_key(p.x, p.y, alive[e], diam);
        mine[k] = (key << kSlotBits) | static_cast<unsigned>(e);
        bin[k] = key == kKeyDead ? kRows + (e >> 5)
                                 : min(static_cast<int>(key >> 10), kRows - 1);
        atomicAdd(&bin_end[bin[k]], 1);  // a count: no order depends on the atomics
      }
    }
    __syncthreads();
    block_scan(bin_end, bin_start, nb, warp_sums);
    __syncthreads();
    for (int i = threadIdx.x; i < nb; i += blockDim.x) bin_end[i] = bin_start[i];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kOrderPer; ++k) {
      if (bin[k] >= 0) comp[atomicAdd(&bin_end[bin[k]], 1)] = mine[k];
    }
    __syncthreads();
    int at[kOrderPer];
#pragma unroll
    for (int k = 0; k < kOrderPer; ++k) {
      at[k] = -1;
      if (bin[k] >= 0) {
        const int lo = bin_start[bin[k]], hi = bin_end[bin[k]];
        at[k] = lo;
        for (int g = lo; g < hi; ++g) at[k] += comp[g] < mine[k] ? 1 : 0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kOrderPer; ++k) {
      if (at[k] >= 0) comp[at[k]] = mine[k];
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int T = (P + kTile - 1) / kTile;
  Tile* tiles = a.tiles + static_cast<int64_t>(b) * T;
  for (int t = warp; t < T; t += nw) {
    const int e = t * kTile + lane;
    const bool in = e < P;
    float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float2 u = make_float2(0.0f, 0.0f);
    bool al = false;
    if (in) {
      const int slot = sort ? static_cast<int>(comp[e] & ((1u << kSlotBits) - 1u)) : e;
      const float2 p = pos[slot], n = noise[slot];
      c = make_float4(p.x, p.y, p.x + n.x, p.y + n.y);  // q = p + noise
      u = vel[slot];
      al = alive[slot];
      a.order[row0 + e] = slot;
      reinterpret_cast<float4*>(a.pq)[row0 + e] = c;
      reinterpret_cast<float2*>(a.sv)[row0 + e] = u;
    }
    const bool pos_ok = !in || (bounded(c.x) && bounded(c.y) && bounded(c.z) && bounded(c.w));
    const bool vel_ok = !in || (bounded(u.x) && bounded(u.y));
    Tile rec = warp_box(al && bounded(c.x) && bounded(c.y), c.x, c.y, 0.0f);
    rec.r0 = rec.r1 = 0.0f;
    rec.alive = __ballot_sync(kFull, al);
    rec.flags = (__all_sync(kFull, pos_ok) ? kPosOk : 0u) |
                (__all_sync(kFull, pos_ok && vel_ok) ? kVelOk : 0u);
    if (lane == 0) tiles[t] = rec;
  }
}

// One self of D1: its fields, its sums, and the terms of its pairs.
template <int MODE, bool SPRING>
struct DenseSelf {
  static constexpr int N = Sums<MODE, SPRING>::N;
  // What a pair's terms read of its candidate: the noisy position (pass B:
  // and the velocity, p_i and s).
  struct Cand {
    float qx, qy, vx, vy, p, sx, sy;
  };
  const float4* pq;    // the crate's sorted positions and noisy positions
  const float2* sv;    // sorted velocities
  const int* order;    // the slot of each sorted index
  const float* p_i;    // (P,) slot order (pass B)
  const float* s;      // (P, 2) slot order (pass B)
  float px, py, pi, sxi, syi, diam, smooth, tp2, bal;
  float acc[N];

  __device__ __forceinline__ Cand fetch(int j) const {
    Cand c;
    const float4 v = pq[j];
    c.qx = v.z;
    c.qy = v.w;
    c.vx = c.vy = c.p = c.sx = c.sy = 0.0f;
    if constexpr (MODE == 1) {
      const float2 u = sv[j];
      const int r = order[j];
      c.vx = u.x;
      c.vy = u.y;
      c.p = p_i[r];
      c.sx = s[2 * r];
      c.sy = s[2 * r + 1];
    }
    return c;
  }

  // The terms of the pair (self, c), m its mask, in the plain version's
  // form (every value selected by the mask).
  __device__ __forceinline__ void add(const Cand& c, bool m) {
    float nx = px - c.qx;
    float ny = py - c.qy;
    const float dist = sqrtf(clamp_min(nx * nx + ny * ny, 0.0f));
    const float den = clamp_min(dist, kEps);
    nx = nx / den;
    ny = ny / den;
    const float w = m ? 1.0f - clamp01(dist / diam) : 0.0f;
    if constexpr (MODE == 0) {
      acc[0] += m ? 1.0f : 0.0f;
      acc[1] += w;
      const float coeff = (1.0f - w) * w;
      acc[2] += coeff * nx;
      acc[3] += coeff * ny;
    } else {
      const float align = ((sxi - c.sx) * nx + (syi - c.sy) * ny) * smooth;
      const float tt = m ? align + ((c.p + pi) - tp2) : 0.0f;
      acc[0] += tt * nx;
      acc[1] += tt * ny;
      const float tpr = m ? pi + c.p : 0.0f;
      acc[2] += tpr * nx;
      acc[3] += tpr * ny;
      if constexpr (SPRING) {
        const float tsp = m ? bal - w : 0.0f;
        acc[4] += tsp * nx;
        acc[5] += tsp * ny;
      }
      const float mf = m ? 1.0f : 0.0f;
      acc[N - 2] += mf * c.vx;  // a product, as the plain version
      acc[N - 1] += mf * c.vy;
    }
  }
};

// The terms of a lane's held counted pairs (list[r * kTile], r < held), in
// their order, each candidate fetched while the one before is summed; the
// warp's lanes diverge over their own counts once.
template <class Self>
__device__ __forceinline__ void flush(Self& me, const unsigned* list, int& held) {
  if (held > 0) {
    typename Self::Cand next = me.fetch(static_cast<int>(list[0]));
    for (int r = 0; r < held; ++r) {
      const typename Self::Cand c = next;
      if (r + 1 < held) next = me.fetch(static_cast<int>(list[(r + 1) * kTile]));
      me.add(c, true);
    }
  }
  held = 0;
}

// The pair test over a staged tile: bit q for candidate k = q L + h where
// near(k), q < nq; unrolled for a whole tile (nq = kTile / L).
template <class Near>
__device__ __forceinline__ unsigned test_tile(const Near& near, int nq, int L, int h) {
  unsigned bits = 0u;
  if (nq == kTile && L == 1) {
#pragma unroll
    for (int q = 0; q < kTile; ++q) bits |= near(q) ? 1u << q : 0u;
  } else if (nq == kTile / 2 && L == 2) {
#pragma unroll
    for (int q = 0; q < kTile / 2; ++q) bits |= near(2 * q + h) ? 1u << q : 0u;
  } else {
    for (int q = 0; q < nq; ++q) bits |= near(q * L + h) ? 1u << q : 0u;
  }
  return bits;
}

// D1: pass A (MODE 0) -> cnt, p_i, s; pass B (MODE 1) -> dv_tension,
// pressure_real, spring_real (zeros without SPRING, as the plain version
// gives), visc_vsum; each in slot order.  A warp a self tile of ts sorted
// selves; grid (ceil(ceil(P / ts) / warps a block), B).
template <int MODE, bool SPRING>
__global__ void __launch_bounds__(32 * kPassWarps) dense_pass_kernel(const DenseArgs a, int ts) {
  constexpr int N = Sums<MODE, SPRING>::N;
  __shared__ float2 stage[kPassWarps][kTile];  // the tile's positions, for the pair test
  __shared__ unsigned pending[kPassWarps][kCap][kTile];  // a lane's counted pairs, in order

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int P = a.P;
  const int st = blockIdx.x * (blockDim.x >> 5) + warp;
  if (st >= (P + ts - 1) / ts) return;  // the whole warp
  const int t = lane % ts, h = lane / ts, L = kTile / ts;
  const int i = st * ts + t;
  const bool self_in = i < P;
  const int64_t row0 = static_cast<int64_t>(b) * P;
  const int T = (P + kTile - 1) / kTile;
  const Tile* tiles = a.tiles + static_cast<int64_t>(b) * T;

  DenseSelf<MODE, SPRING> me;
  me.pq = reinterpret_cast<const float4*>(a.pq) + row0;
  me.sv = reinterpret_cast<const float2*>(a.sv) + row0;
  me.order = a.order + row0;
  me.p_i = a.p_i + row0;
  me.s = a.s + 2 * row0;
  // diam = clamp(diameter, min=EPS); the 0-d products as torch takes them
  me.diam = clamp_min(a.diameter[b], kEps);
  const float diam2 = me.diam * me.diam;
  me.smooth = me.tp2 = me.bal = 0.0f;
  if constexpr (MODE == 1) {
    me.smooth = a.surface_smoothing[b];
    me.tp2 = 2.0f * a.target_pressure[b];
    me.bal = a.spring_overlap_balance[b];
  }
  me.px = me.py = me.pi = me.sxi = me.syi = 0.0f;
  bool ai = false;
  int slot = 0;
  if (self_in) {
    const float4 v = me.pq[i];
    me.px = v.x;
    me.py = v.y;
    ai = (tiles[i / kTile].alive >> (i % kTile)) & 1u;
    slot = me.order[i];
    if constexpr (MODE == 1) {
      me.pi = me.p_i[slot];
      me.sxi = me.s[2 * slot];
      me.syi = me.s[2 * slot + 1];
    }
  }
  const float px = me.px, py = me.py;
  const Tile sb = warp_box(self_in && ai && bounded(px) && bounded(py), px, py, 0.0f);
  const bool self_ok = __all_sync(kFull, !self_in || (bounded(px) && bounded(py)));
  const bool any_alive = __any_sync(kFull, self_in && ai);
  const unsigned need = MODE == 0 ? kPosOk : kVelOk;
#pragma unroll
  for (int f = 0; f < N; ++f) me.acc[f] = 0.0f;
  const unsigned* list = &pending[warp][0][lane];
  int held = 0;

  for (int tb = 0; tb < T; tb += kTile) {
    bool visit = false, full = false;
    if (tb + lane < T) {
      const Tile c = tiles[tb + lane];
      full = !self_ok || (c.flags & need) == 0u;
      visit = full || (any_alive && c.alive != 0u && !far_apart(sb, c, diam2));
    }
    unsigned todo_tiles = __ballot_sync(kFull, visit);
    const unsigned full_tiles = __ballot_sync(kFull, full);
    while (todo_tiles != 0u) {
      const int l = __ffs(todo_tiles) - 1;
      todo_tiles &= todo_tiles - 1u;
      const bool whole = (full_tiles >> l) & 1u;  // every pair, masked ones too
      const int c0 = (tb + l) * kTile;
      const int n = min(kTile, P - c0);
      __syncwarp();  // the previous tile is no longer read
      if (lane < n) {
        const float4 v = me.pq[c0 + lane];
        stage[warp][lane] = make_float2(v.x, v.y);
      }
      const unsigned amask = tiles[tb + l].alive;
      __syncwarp();
      // the pair test of candidates k = q L + h: rx, ry, d2 <= diam^2, both
      // alive, not the self
      unsigned hits = 0u, valid = 0u;
      if (self_in) {
        const int nq = (n - h + L - 1) / L;
        valid = low_bits(nq);
        unsigned own = amask & low_bits(n);
        if (i >= c0 && i < c0 + kTile) own &= ~(1u << (i - c0));
        const unsigned eligible = ai ? lane_bits(own, L, h) & valid : 0u;
        if (eligible != 0u || whole) {
          const float2* cand = stage[warp];
          hits = eligible & test_tile([&](int k) {
            const float2 c = cand[k];
            const float rx = px - c.x;
            const float ry = py - c.y;
            return rx * rx + ry * ry <= diam2;
          }, nq, L, h);
        }
      }
      if (whole) {
        flush(me, list, held);
        for (unsigned work = valid; work != 0u; work &= work - 1u) {
          const int q = __ffs(work) - 1;
          me.add(me.fetch(c0 + q * L + h), (hits >> q) & 1u);
        }
      } else {
        if (__any_sync(kFull, held + __popc(hits) > kCap)) flush(me, list, held);
        for (unsigned work = hits; work != 0u; work &= work - 1u) {
          pending[warp][held++][lane] = static_cast<unsigned>(c0 + (__ffs(work) - 1) * L + h);
        }
      }
    }
  }
  flush(me, list, held);

  combine_halves(me.acc, ts);
  if (!self_in || h != 0) return;
  const int64_t ri = row0 + slot;
  if constexpr (MODE == 0) {
    // p_i = where(cnt > 0, clamp(w_sum - ignored_pressure, min=0), 0)
    a.cnt[ri] = me.acc[0];
    a.p_i[ri] = me.acc[0] > 0.0f ? clamp_min(me.acc[1] - a.ignored_pressure[b], 0.0f) : 0.0f;
    a.s[2 * ri] = me.acc[2];
    a.s[2 * ri + 1] = me.acc[3];
  } else {
    a.dv_tension[2 * ri] = me.acc[0];
    a.dv_tension[2 * ri + 1] = me.acc[1];
    a.pressure_real[2 * ri] = me.acc[2];
    a.pressure_real[2 * ri + 1] = me.acc[3];
    a.spring_real[2 * ri] = SPRING ? me.acc[4] : 0.0f;
    a.spring_real[2 * ri + 1] = SPRING ? me.acc[5] : 0.0f;
    a.visc_vsum[2 * ri] = me.acc[N - 2];
    a.visc_vsum[2 * ri + 1] = me.acc[N - 1];
  }
}

// The slab's feature columns (ops/chunked.py's feat_a / feat_b).
enum : int { kPx = 0, kPy, kNpx, kNpy, kRow, kAlive, kVx, kVy, kCp, kSx, kSy };

// One self of D2: its features, its sums, and the terms of its pairs.
template <int MODE, bool SPRING>
struct WindowSelf {
  static constexpr int N = Sums<MODE, SPRING>::N;
  static constexpr int NF = MODE == 0 ? 6 : 11;  // feature columns a self reads
  const float* feat;  // the crate's (p_pad, F) slab
  int p_pad, F;
  float self[NF];
  float inv_diam, smooth, tp2, bal;
  float acc[N];

  // What a pair's terms read of its candidate, slab row r (rows outside
  // the slab: the plain version's zero padding).
  struct Cand {
    float nx, ny, cp, sx, sy, vx, vy;
  };

  __device__ __forceinline__ Cand fetch(int r) const {
    Cand c;
    c.nx = c.ny = c.cp = c.sx = c.sy = c.vx = c.vy = 0.0f;
    if (r >= 0 && r < p_pad) {
      const float* f = feat + static_cast<int64_t>(r) * F;
      c.nx = f[kNpx];
      c.ny = f[kNpy];
      if constexpr (MODE == 1) {
        c.cp = f[kCp];
        c.sx = f[kSx];
        c.sy = f[kSy];
        c.vx = f[kVx];
        c.vy = f[kVy];
      }
    }
    return c;
  }

  // The terms of the pair (self, c), mb its mask, as the plain version
  // takes them.
  __device__ __forceinline__ void add(const Cand& c, bool mb) {
    const float nrx = self[kPx] - c.nx;
    const float nry = self[kPy] - c.ny;
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
      const float align = ((self[kSx] - c.sx) * nhx + (self[kSy] - c.sy) * nhy) * smooth;
      const float tt = mb ? align + ((c.cp + self[kCp]) - tp2) : 0.0f;
      const float p = mb ? self[kCp] + c.cp : 0.0f;
      acc[0] += tt * nhx;
      acc[1] += tt * nhy;
      acc[2] += p * nhx;
      acc[3] += p * nhy;
      if constexpr (SPRING) {
        const float sp = mb ? bal - wgt : 0.0f;
        acc[4] += sp * nhx;
        acc[5] += sp * nhy;
      }
      acc[N - 2] += mb ? c.vx : 0.0f;  // a where, as the plain version
      acc[N - 1] += mb ? c.vy : 0.0f;
    }
  }
};

// D2: the cs-wide self chunks c < n_chunks of the slab, each against its
// window rows [c cs - H, c cs + cs + H) (rows outside [0, p_pad) are the
// plain version's zero padding); rows of later chunks get exact zeros.
// MODE 0 writes (w, s_x, s_y, cnt), MODE 1 the tension, pressure, spring
// (with SPRING) and neighbour-velocity sums.  A warp a self tile of ts
// rows of a chunk, a block nw of them; grid ((p_pad / cs) * blocks a
// chunk, B).
template <int MODE, bool SPRING>
__global__ void __launch_bounds__(32 * kWindowWarps) window_pass_kernel(const WindowArgs a,
                                                                         int ts) {
  constexpr int N = Sums<MODE, SPRING>::N;
  constexpr int NF = WindowSelf<MODE, SPRING>::NF;
  __shared__ Tile seg[kTile];
  __shared__ float4 stage[kWindowWarps][kTile];  // x, y, row of the tile, for the pair test
  __shared__ unsigned pending[kWindowWarps][kCap][kTile];  // a lane's counted pairs, in order

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int b = blockIdx.y;
  const int t = lane % ts, h = lane / ts, L = kTile / ts;
  const int tiles_c = (a.cs + ts - 1) / ts;
  const int blocks_c = (tiles_c + nw - 1) / nw;
  const int c = blockIdx.x / blocks_c;
  const int st = (blockIdx.x - c * blocks_c) * nw + warp;
  const bool warp_in = st < tiles_c;
  const int in_chunk = st * ts + t;
  const bool self_in = warp_in && in_chunk < a.cs;
  const int i = c * a.cs + in_chunk;
  float* out = a.out + static_cast<int64_t>(b) * a.p_pad * N;
  if (c >= a.n_chunks) {  // past the swept chunks: the plain version's zeros
    if (self_in && h == 0) {
#pragma unroll
      for (int f = 0; f < N; ++f) out[static_cast<int64_t>(i) * N + f] = 0.0f;
    }
    return;  // the whole block
  }

  WindowSelf<MODE, SPRING> me;
  me.feat = a.feat + static_cast<int64_t>(b) * a.p_pad * a.F;
  me.p_pad = a.p_pad;
  me.F = a.F;
  // diam * diam with the diameter as given; 1 / clamp(diam, min=EPS)
  const float diam = a.diameter[b];
  const float diam2 = diam * diam;
  me.inv_diam = 1.0f / clamp_min(diam, kEps);
  me.smooth = me.tp2 = me.bal = 0.0f;
  if constexpr (MODE == 1) {
    me.smooth = a.surface_smoothing[b];
    me.tp2 = 2.0f * a.target_pressure[b];
    me.bal = a.spring_overlap_balance[b];
  }
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    me.self[f] = self_in ? me.feat[static_cast<int64_t>(i) * a.F + f] : 0.0f;
  }
  const float px = me.self[kPx], py = me.self[kPy], prow = me.self[kRow];
  const bool s_alive = self_in && me.self[kAlive] > 0.0f;
  const bool s_bounded = bounded(px) && bounded(py);
  const Tile sb = warp_box(s_alive && s_bounded, px, py, prow);
  const bool self_ok = __all_sync(kFull, !self_in || s_bounded);
  const bool any_alive = __any_sync(kFull, s_alive);
#pragma unroll
  for (int f = 0; f < N; ++f) me.acc[f] = 0.0f;
  const unsigned* list = &pending[warp][0][lane];
  int held = 0;

  const int wt = a.cs + 2 * a.halo;
  const int w0 = c * a.cs - a.halo;  // the window's first slab row
  const int n_tiles = (wt + kTile - 1) / kTile;
  for (int s0 = 0; s0 < n_tiles; s0 += kTile) {
    const int ns = min(kTile, n_tiles - s0);
    __syncthreads();  // the previous records are no longer read
    for (int tt = warp; tt < ns; tt += nw) {  // the records of window tiles s0 + tt
      const int k = (s0 + tt) * kTile + lane;
      const int r = w0 + k;
      const bool in = k < wt;
      float x = 0.0f, y = 0.0f, nx = 0.0f, ny = 0.0f, row = 0.0f;
      bool al = false;
      if (in && r >= 0 && r < a.p_pad) {
        const float* f = me.feat + static_cast<int64_t>(r) * a.F;
        x = f[kPx];
        y = f[kPy];
        nx = f[kNpx];
        ny = f[kNpy];
        row = f[kRow];
        al = f[kAlive] > 0.0f;
      }
      const bool ok = !in || (bounded(x) && bounded(y) && bounded(nx) && bounded(ny));
      Tile rec = warp_box(al && bounded(x) && bounded(y), x, y, row);
      rec.alive = __ballot_sync(kFull, al);
      rec.flags = __all_sync(kFull, ok) ? kPosOk : 0u;
      if (lane == 0) seg[tt] = rec;
    }
    __syncthreads();
    if (!warp_in) continue;
    bool visit = false, full = false;
    if (lane < ns) {
      const Tile rec = seg[lane];
      full = !self_ok || (rec.flags & kPosOk) == 0u;
      visit = full || (any_alive && rec.alive != 0u && !far_apart(sb, rec, diam2) &&
                       !(rec.r0 - sb.r1 > 1.0f) && !(sb.r0 - rec.r1 > 1.0f));
    }
    unsigned todo_tiles = __ballot_sync(kFull, visit);
    const unsigned full_tiles = __ballot_sync(kFull, full);
    while (todo_tiles != 0u) {
      const int l = __ffs(todo_tiles) - 1;
      todo_tiles &= todo_tiles - 1u;
      const bool whole = (full_tiles >> l) & 1u;  // every pair, masked ones too
      const int k0 = (s0 + l) * kTile;
      const int r0 = w0 + k0;  // the tile's first slab row
      const int n = min(kTile, wt - k0);
      __syncwarp();  // the previous tile is no longer read
      if (lane < n) {
        const int r = r0 + lane;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (r >= 0 && r < a.p_pad) {
          const float* f = me.feat + static_cast<int64_t>(r) * a.F;
          v = make_float4(f[kPx], f[kPy], f[kRow], 0.0f);
        }
        stage[warp][lane] = v;
      }
      const unsigned amask = seg[l].alive;
      __syncwarp();
      // the pair test of candidates k = q L + h: rx, ry, d2 <= diam^2, the
      // row delta within one, both alive, not the self
      unsigned hits = 0u, valid = 0u;
      if (self_in) {
        const int nq = (n - h + L - 1) / L;
        valid = low_bits(nq);
        unsigned own = amask & low_bits(n);
        if (i >= r0 && i < r0 + kTile) own &= ~(1u << (i - r0));
        const unsigned eligible = s_alive ? lane_bits(own, L, h) & valid : 0u;
        if (eligible != 0u || whole) {
          const float4* cand = stage[warp];
          hits = eligible & test_tile([&](int k) {
            const float4 c = cand[k];
            const float rx = px - c.x;
            const float ry = py - c.y;
            const float dr = c.z - prow;
            return rx * rx + ry * ry <= diam2 && dr >= -1.0f && dr <= 1.0f;
          }, nq, L, h);
        }
      }
      if (whole) {
        flush(me, list, held);
        for (unsigned work = valid; work != 0u; work &= work - 1u) {
          const int q = __ffs(work) - 1;
          me.add(me.fetch(r0 + q * L + h), (hits >> q) & 1u);
        }
      } else {
        if (__any_sync(kFull, held + __popc(hits) > kCap)) flush(me, list, held);
        for (unsigned work = hits; work != 0u; work &= work - 1u) {
          pending[warp][held++][lane] = static_cast<unsigned>(r0 + (__ffs(work) - 1) * L + h);
        }
      }
    }
  }
  flush(me, list, held);

  combine_halves(me.acc, ts);
  if (!self_in || h != 0) return;
#pragma unroll
  for (int f = 0; f < N; ++f) out[static_cast<int64_t>(i) * N + f] = me.acc[f];
}

// Selves a warp: 32, or 16 past 2048 rows (a crate of 4096 gives 256
// warps).  A function of the crate's rows alone, so the reduction order is
// the same for a crate alone and in any batch.
int self_tile(int rows) { return rows > 2048 ? 16 : 32; }

template <int MODE, bool SPRING>
int launch_dense(const DenseArgs& a, cudaStream_t stream) {
  const int ts = self_tile(a.P);
  const int64_t warps = (a.P + ts - 1) / ts;
  // Blocks of one warp where the batch is small, so that one crate of 4096
  // still spreads over the SMs; the warps are independent, so the block
  // size changes no result.
  const int nw = static_cast<int64_t>(a.B) * warps >= 8 * 132 ? kPassWarps : 1;
  const dim3 grid(static_cast<unsigned>((warps + nw - 1) / nw), a.B);
  dense_pass_kernel<MODE, SPRING><<<grid, 32 * nw, 0, stream>>>(a, ts);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, bool SPRING>
int launch_window(const WindowArgs& a, cudaStream_t stream) {
  const int ts = self_tile(a.p_pad);
  const int tiles_c = (a.cs + ts - 1) / ts;
  const int nw = min(tiles_c, kWindowWarps);  // each block builds its window's records
  const int blocks_c = (tiles_c + nw - 1) / nw;
  const dim3 grid((a.p_pad / a.cs) * blocks_c, a.B);
  window_pass_kernel<MODE, SPRING><<<grid, 32 * nw, 0, stream>>>(a, ts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// D1's prologue over B crates of P slots: order, pq, sv and tiles.
// Launches on `stream` and does not synchronise; returns cudaGetLastError().
extern "C" int sc_dense_order(const DenseArgs* args, void* stream) {
  const DenseArgs& a = *args;
  if (a.B <= 0 || a.P <= 0) return 0;
  // 256 threads up to 1024 slots, 1024 past: at most kOrderPer slots a thread
  const int threads = a.P <= 1024 ? 256 : kOrderThreads;
  dense_order_kernel<<<a.B, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// One dense pass (mode 0: A, 1: B; spring: pass B's spring sums) over B
// crates of P slots, from the prologue's order.  Launches on `stream` and
// does not synchronise; returns cudaGetLastError().
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
