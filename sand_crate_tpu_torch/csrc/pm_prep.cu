// The p-major pair glue for Hopper (sm_90a): the slab and exact candidate
// ranges that K1/K2 (csrc/pmajor.cu) read in pass A, and the slab they read
// in pass B.
//
// Not a pl.pallas_call: the counterparts of the XLA fusions of
// sand_crate_tpu/ops/pmajor.py `feature_rows` (l.129), `_windows` (l.1006)
// and `finalize_cp` (l.175) around the pair passes.  The port's torch
// versions (sand_crate_tpu_torch/ops/pmajor.py: pass_a_slab,
// candidate_ranges, finalize_cp, pass_b_slab) run them as ~70 launches a
// tick, each streaming the whole crate, with two P-sized searchsorteds of
// 3P queries each and two strided stacks of 8 columns.  Here:
//
// pm_cell_start_kernel + pm_prep_kernel (slab A and the ranges): the range
//   bounds are torch.searchsorted(sorted_cid, t) of clamped targets t in
//   [0, NC] (NC = nx * ny; dead slots sort last with cell id NC), i.e. the
//   first slot whose cell id reaches t.  The first kernel, a thread per slot
//   boundary i in [0, P], writes that position into a per-crate table
//   start[0 .. NC]: i for every cell of (cid[i-1], cid[i]] (cid[-1] = -1,
//   cid[P] = NC + 1), so an empty cell gets the next occupied cell's first
//   slot and cells past the last id get P: every cell is written once.  A
//   run longer than a warp is written by the whole warp, 32 consecutive
//   cells a store.  The second kernel, a thread per slot, then
//   reads its six bounds from the table and writes the slot's 32-byte slab
//   row: the ALIVE_OFFSET encoding, the collider jitter (the pair_kernel
//   hash on the sorted index and tick, in uint32 arithmetic: the low 32
//   bits of the plain version's int64-masked products), the velocity, the
//   row cid / nx (ny for dead slots) and a zero.  Without RANGES (K10
//   finds its own ranges from chunk_windows) the table pass is not
//   launched and the prep kernel writes the slab alone.
// pm_slab_b_kernel (slab B): a thread per slot reads slab A's positions and
//   row and pass A's w_sum, s_x, s_y and count, and writes the slot's pass-B
//   row (positions, cell pressure, the surface_smoothing-prescaled normal
//   sums, row) and the cell pressure p_i itself: finalize_cp, times
//   (1 + pressure_amplifier) in the slab under FOLD.
//
// Both take a crate axis: B crates of P slots each (a solo crate is B = 1),
// a crate a row of the grid (blockIdx.y), operands at per-crate strides.
//
// Bitwise reproducibility: built with -fmad=false, every float operation
// is one IEEE-rounded f32 operation in the order of the torch ops; the
// clamp of finalize_cp tests for NaN first, as torch's clamp propagates
// it; the ranges are integers.  So both give their plain versions' bits.
//
// What bounds them, at the settled 1M dam break: bytes.  The prep moves
// ~21 B a slot in (pos, vel, alive, cid), 32 + 24 B out, plus the table
// (4 B a cell, read back from L2 mostly); slab B 32 + 16 B in and
// 32 + 4 B out.

#include <cstdint>

#include <cuda_runtime.h>


namespace {

constexpr int kMaxCrates = 65535;  // gridDim.y
constexpr int kThreads = 256;
constexpr float kAliveOffset = 2.0f;          // ops/pmajor.py ALIVE_OFFSET
constexpr float kRsqrt2 = 0.7071067811865476f;  // the symm amplitude scale

// p + off, a crate's operand, opaque to the optimiser (csrc/pmajor.cu's
// crate_base: a visible offset costs 64-bit index arithmetic on each load).
template <class T>
__device__ __forceinline__ T* crate_base(T* p, size_t off) {
  p += off;
  asm("" : "+l"(p));
  __builtin_assume(__isGlobal(p));
  return p;
}

// ops/pmajor.py::_u01: the pair_kernel noise mix -> [0, 1).  The plain
// version multiplies in int64 and masks to 32 bits; the low 32 bits of a
// product are the uint32 product's.
__device__ __forceinline__ float u01(uint32_t seed, uint32_t tick) {
  uint32_t h = seed * 2654435769u;  // -1640531527 mod 2^32
  h ^= tick * 3266489909u;          // -1028477387 mod 2^32
  h ^= h >> 15;
  h *= 2246822507u;                 // -2048144789 mod 2^32
  h ^= h >> 13;
  return static_cast<float>(h >> 8) * 5.9604644775390625e-8f;  // 2^-24
}

// Writes v into start[a .. e] (inclusive): runs of up to a warp by their
// own thread, longer ones by the whole warp in turn.  Every lane of the
// warp calls it.
__device__ __forceinline__ void fill(int* start, int a, int e, int v) {
  const bool wide = e - a >= 32;
  if (!wide)
    for (int c = a; c <= e; ++c) start[c] = v;
  unsigned todo = __ballot_sync(0xffffffffu, wide);
  const int lane = threadIdx.x & 31;
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const int sa = __shfl_sync(0xffffffffu, a, src);
    const int se = __shfl_sync(0xffffffffu, e, src);
    const int sv = __shfl_sync(0xffffffffu, v, src);
    for (int c = sa + lane; c <= se; c += 32) start[c] = sv;
  }
}

// start[t] = the first slot whose cell id is >= t, for every t in [0, NC];
// a thread per boundary i in [0, P].  Blocks are whole warps and no thread
// leaves early (fill's ballot).
__global__ void __launch_bounds__(kThreads)
pm_cell_start_kernel(const int* __restrict__ cid, int* __restrict__ start, int P, int nc) {
  const size_t b = blockIdx.y;
  cid = crate_base(cid, b * P);
  start = crate_base(start, b * (static_cast<size_t>(nc) + 1));
  const int i = blockIdx.x * kThreads + threadIdx.x;
  int a = 0, e = -1;  // the cells (prev, cur] keeps: [a, e]
  if (i <= P) {
    const int prev = i == 0 ? -1 : cid[i - 1];
    const int cur = i == P ? nc + 1 : cid[i];
    a = max(prev + 1, 0);  // (ids below 0 would write nothing outside the table)
    e = min(cur, nc);
  }
  fill(start, a, e, i);
}

// Slab A (P, 8) f32 and, with RANGES, the (6, P) i32 candidate ranges of
// one crate's sorted slots; a thread per slot.
template <bool SYMM, bool RANGES>
__global__ void __launch_bounds__(kThreads)
pm_prep_kernel(const float2* __restrict__ pos, const float2* __restrict__ vel,
               const bool* __restrict__ alive, const int* __restrict__ cid,
               const float* __restrict__ noise_amp, const int* __restrict__ tick,
               const int* __restrict__ start, float4* __restrict__ slab,
               int* __restrict__ ranges, int P, int nx, int ny) {
  const size_t b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= P) return;
  pos = crate_base(pos, b * P);
  vel = crate_base(vel, b * P);
  alive = crate_base(alive, b * P);
  cid = crate_base(cid, b * P);
  slab = crate_base(slab, b * 2 * P);
  const float2 p = pos[i];
  const float2 v = vel[i];
  const bool al = alive[i];
  const int c = cid[i];
  float amp = noise_amp[b];
  if (SYMM) amp = amp * kRsqrt2;  // as pass_a_slab scales the amplitude
  const uint32_t tk = static_cast<uint32_t>(tick[b]);
  const float off = al ? kAliveOffset : 0.0f;  // ALIVE_OFFSET * alive, exact
  const float pxo = p.x + off;
  const float pyo = p.y + off;
  const uint32_t seed = 2u * static_cast<uint32_t>(i);
  const float npx = pxo + (u01(seed, tk) - 0.5f) * amp;
  const float npy = pyo + (u01(seed + 1u, tk) - 0.5f) * amp;
  const float row = static_cast<float>(al ? c / nx : ny);
  slab[2 * i] = make_float4(pxo, pyo, npx, npy);
  slab[2 * i + 1] = make_float4(v.x, v.y, row, 0.0f);
  if constexpr (RANGES) {
    const int nc = nx * ny;
    start = crate_base(start, b * (static_cast<size_t>(nc) + 1));
    ranges = crate_base(ranges, b * 6 * P);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int base = c + (q - 1) * nx;
      const int ws = start[min(max(base - 1, 0), nc)];
      const int we = al ? start[min(max(base + 2, 0), nc)] : ws;
      ranges[q * P + i] = ws;
      ranges[(3 + q) * P + i] = we;
    }
  }
}

// Slab B (P, 8) f32 and the cell pressure cp (P,) of one crate's sorted
// slots from slab A and pass A's sums (6, P); a thread per slot.
template <bool FOLD>
__global__ void __launch_bounds__(kThreads)
pm_slab_b_kernel(const float4* __restrict__ slab_a, const float* __restrict__ out_a,
                 const float* __restrict__ ignored, const float* __restrict__ smoothing,
                 const float* __restrict__ amplifier, float4* __restrict__ slab_b,
                 float* __restrict__ cp_out, int P) {
  const size_t b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= P) return;
  slab_a = crate_base(slab_a, b * 2 * P);
  out_a = crate_base(out_a, b * 6 * P);
  slab_b = crate_base(slab_b, b * 2 * P);
  cp_out = crate_base(cp_out, b * P);
  const float4 a0 = slab_a[2 * i];
  const float4 a1 = slab_a[2 * i + 1];
  const float w_sum = out_a[i];
  const float s_x = out_a[P + i];
  const float s_y = out_a[2 * P + i];
  const float cnt = out_a[3 * P + i];
  const float x = w_sum - ignored[b];
  const float cl = isnan(x) ? x : fmaxf(x, 0.0f);  // torch.clamp(min=0) keeps NaN
  const float cp = cnt > 0.0f ? cl : 0.0f;
  const float cps = FOLD ? cp * (1.0f + amplifier[b]) : cp;
  const float sm = smoothing[b];
  slab_b[2 * i] = a0;
  slab_b[2 * i + 1] = make_float4(cps, sm * s_x, sm * s_y, a1.z);
  cp_out[i] = cp;
}

template <bool SYMM, bool RANGES>
void launch_prep(const void* pos, const void* vel, const void* alive, const void* cid,
                 const void* amp, const void* tick, const void* start, void* slab,
                 void* ranges, int P, int B, int nx, int ny, cudaStream_t s) {
  const dim3 blocks((P + kThreads - 1) / kThreads, B);
  pm_prep_kernel<SYMM, RANGES><<<blocks, kThreads, 0, s>>>(
      static_cast<const float2*>(pos), static_cast<const float2*>(vel),
      static_cast<const bool*>(alive), static_cast<const int*>(cid),
      static_cast<const float*>(amp), static_cast<const int*>(tick),
      static_cast<const int*>(start), static_cast<float4*>(slab), static_cast<int*>(ranges),
      P, nx, ny);
}

}  // namespace

// Slab A and the candidate ranges of B crates of P sorted slots each: pos,
// vel (B, P, 2) f32, alive (B, P) bool, cid (B, P) i32 sorted ascending in
// [0, nx * ny], noise_amp (B,) f32, tick (B,) i32 -> slab (B, P, 8) f32 and,
// where with_ranges, ranges (B, 6, P) i32 through the scratch table start
// (B, nx * ny + 1) i32 (neither read where with_ranges is 0).  symm scales
// the jitter by 1/sqrt(2).  Launches on `stream` (two kernels with the
// ranges, one without) and does not synchronise; returns cudaGetLastError().
extern "C" int sc_pm_prep(const void* pos, const void* vel, const void* alive, const void* cid,
                          const void* noise_amp, const void* tick, void* start, void* slab,
                          void* ranges, int P, int B, int nx, int ny, int symm, int with_ranges,
                          void* stream) {
  if (B < 0 || B > kMaxCrates || nx <= 0 || ny <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (P <= 0 || B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (with_ranges) {
    const dim3 blocks(P / kThreads + 1, B);  // P + 1 boundaries
    pm_cell_start_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const int*>(cid),
                                                     static_cast<int*>(start), P, nx * ny);
    if (symm)
      launch_prep<true, true>(pos, vel, alive, cid, noise_amp, tick, start, slab, ranges, P, B,
                              nx, ny, s);
    else
      launch_prep<false, true>(pos, vel, alive, cid, noise_amp, tick, start, slab, ranges, P, B,
                               nx, ny, s);
  } else if (symm) {
    launch_prep<true, false>(pos, vel, alive, cid, noise_amp, tick, start, slab, ranges, P, B,
                             nx, ny, s);
  } else {
    launch_prep<false, false>(pos, vel, alive, cid, noise_amp, tick, start, slab, ranges, P, B,
                              nx, ny, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// Slab B and the cell pressure of B crates of P sorted slots each: slab_a
// (B, P, 8) f32, out_a (B, 6, P) f32 (pass A's sums), ignored_pressure and
// surface_smoothing (B,) f32, pressure_amplifier (B,) f32 read where fold
// -> slab_b (B, P, 8) f32, cp (B, P) f32.  Launches on `stream` and does not
// synchronise; returns cudaGetLastError().
extern "C" int sc_pm_slab_b(const void* slab_a, const void* out_a, const void* ignored,
                            const void* smoothing, const void* amplifier, void* slab_b,
                            void* cp, int P, int B, int fold, void* stream) {
  if (B < 0 || B > kMaxCrates) return static_cast<int>(cudaErrorInvalidValue);
  if (P <= 0 || B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 blocks((P + kThreads - 1) / kThreads, B);
  const auto* a = static_cast<const float4*>(slab_a);
  const auto* o = static_cast<const float*>(out_a);
  const auto* ig = static_cast<const float*>(ignored);
  const auto* sm = static_cast<const float*>(smoothing);
  const auto* pa = static_cast<const float*>(amplifier);
  if (fold)
    pm_slab_b_kernel<true><<<blocks, kThreads, 0, s>>>(a, o, ig, sm, pa,
                                                       static_cast<float4*>(slab_b),
                                                       static_cast<float*>(cp), P);
  else
    pm_slab_b_kernel<false><<<blocks, kThreads, 0, s>>>(a, o, ig, sm, pa,
                                                        static_cast<float4*>(slab_b),
                                                        static_cast<float*>(cp), P);
  return static_cast<int>(cudaGetLastError());
}
