// The tick's velocity update for Hopper (sm_90a): every kick, the wall
// bounce, the continuous-collision clamp and the integrate in one pass.
//
// The counterpart of the XLA fusions of sand_crate_tpu/physics.py's
// apply_tension ... apply_continuous_collision and finish_tick
// (l.680-790); no pl.pallas_call.  The port's torch chain ran each kick as
// a where, a multiply and an add over (P, 2) and a mean |dv| of five more
// passes: a particle's velocity crossed device memory about forty times a
// tick in about forty launches.  Here a thread per particle slot reads its
// velocity, position, pair sums and ghost sums once, applies the stages in
// registers, and writes the new velocity, position and pressure once.  The
// work is ~110 bytes and a few hundred f32 operations a slot, so the bound
// is bytes; what runs slower than that is the clamp's loop over the 2S
// padded walls (a few dozen instructions a slot and wall), so the loop tests
// each wall's approach and the move's straddle of its line first and only a
// crossing goes on to the rest.  The slots are walked in a grid-stride loop
// of one wave of resident blocks, each staging the walls once, with the next
// slot's loads in flight.  The wrapper and its plain torch version are
// sand_crate_tpu_torch/ops/kick.py (velocity_update / velocity_update_plain).
//
// Stages (bits of `stages`, ops/kick.py): tension, gravity, pressure,
// spring (set only where the scene enables it; a template flag),
// viscosity, wall bounce, the CCD clamp, the integrate; NORMS (write each
// kick's masked |dv| as a row of the (B, K, P) norm plane, K the kicks in
// `stages`).  physics.step and the band step run every stage in one
// launch; the instrumented tick runs one stage a launch (an f32 round trip
// through memory is exact, so staged equals fused bit for bit).
//
// The per-particle operands are read through their strides (element units,
// crate, slot, component): the p-major backend hands its sums over as
// transposed views of (rows, P) planes, and no transpose copy is made.  A
// stride of 0 (an expanded zero plane) reads one element for every slot.
//
// With INTEGRATE the kernel also reduces, per crate, the alive count, the
// largest alive speed^2 and the alive slots with a non-finite position or
// velocity: integer atomics on a zeroed (B, 5) scratch, exact in any order
// (the speed^2 as the bits of a non-negative float; a NaN has a flag of its
// own, as torch.max propagates it), and the block that finishes last writes
// max_speed = sqrt(max), non_finite and cnt = max(count, 1).
//
// Bitwise reproducibility: built with -fmad=false and IEEE division and
// sqrt, every value is one rounded f32 operation in the order the torch
// chain performs it (0-d coefficient products such as dt * pa first, as
// torch evaluates them); masked kicks add +0 as torch.where(alive, dv, 0)
// does (so a dead slot's -0 becomes +0); clamps and minimums test NaN first
// as torch's do; the orientation sign is geometry.sign.  The CCD's minimum
// over the 2S padded walls follows torch's amin over dim 0 of a (2S, P)
// plane: four accumulators, wall w into accumulator w % 4, combined
// 0, 1, 2, 3.  A wall whose crossing is false (the slot dead, the wall
// invalid, the move not approaching it or not reaching across its line)
// adds +inf to its accumulator, which changes nothing, so the rest of its
// signs and its division are skipped; a NaN position still reaches them
// (a NaN sign differs from every sign).

#include <cstdint>

#include <cuda_runtime.h>

// The operands' layout: outside the unnamed namespace, so the C entry point
// that takes it keeps external linkage.
struct F2 {  // a (B, P, 2) f32 operand and its element strides
  const float* p;
  long long sb, sp, sc;
};

struct F1 {  // a (B, P) f32 operand
  const float* p;
  long long sb, sp;
};

// Mirrored by ops/kick.py's _Args (ctypes); keep the two in step.
struct KickArgs {
  F2 vel, pos, dv_tension, pressure_real, spring_real, visc_vsum, gsum, gvel_sum;
  F1 p_i, nbr_cnt, g_cnt;
  const bool* alive;
  long long alive_sb, alive_sp;
  const float* segments;  // (B, S, 2, 2) contiguous
  const bool* seg_valid;  // (S,)
  const float *dt, *gravity, *pressure_amplifier, *spring_amplifier, *spring_overlap_balance,
      *viscosity, *wall_collision_decay, *radius;  // (B,), gravity (B, 2)
  float *vel_out, *pos_out, *pressure_out, *norms;  // (B, P, 2), (B, P, 2), (B, P), (B, K, P)
  float *max_speed, *cnt;                            // (B,)
  int* non_finite;                                   // (B,)
  unsigned* scratch;                                 // (B, kScratch), zeroed
  int B, P, S, stages, K;
};

namespace {

constexpr float kEps = 1e-12f;  // geometry.py / physics.py EPS
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 4;          // accumulators of torch's dim-0 reduction

enum : int {  // ops/kick.py's stage bits
  kTension = 1 << 0,
  kGravity = 1 << 1,
  kPressure = 1 << 2,
  kSpring = 1 << 3,
  kViscosity = 1 << 4,
  kWall = 1 << 5,
  kCCD = 1 << 6,
  kIntegrate = 1 << 7,
  kNorms = 1 << 8,
};

// The diagnostics scratch per crate: speed^2 bits, NaN flag, non-finite
// count, alive count, finished blocks.
enum : int { kMax = 0, kNan = 1, kNonFinite = 2, kCount = 3, kDone = 4, kScratch = 5 };

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

// geometry.sign(a) == geometry.sign(b): a NaN sign equals no sign.
__device__ __forceinline__ bool same_sign(float a, float b) {
  return (a > 0.0f) == (b > 0.0f) && (a < 0.0f) == (b < 0.0f) && !isnan(a) && !isnan(b);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}

__device__ __forceinline__ float2 ld2(const F2& f, int b, int p) {
  const float* q = f.p + b * f.sb + p * f.sp;
  if (f.sc == 1 && (reinterpret_cast<uintptr_t>(q) & 7) == 0) {
    return __ldg(reinterpret_cast<const float2*>(q));
  }
  return make_float2(__ldg(q), __ldg(q + f.sc));
}

__device__ __forceinline__ float ld1(const F1& f, int b, int p) {
  return __ldg(f.p + b * f.sb + p * f.sp);
}

// |dv| masked to the alive slots: where(alive, sqrt(max(dvx^2 + dvy^2, 0)), 0)
__device__ __forceinline__ float masked_norm(float dvx, float dvy, bool al) {
  return al ? sqrtf(clamp_min(dvx * dvx + dvy * dvy, 0.0f)) : 0.0f;
}

// A padded wall: start c and direction d - c; an invalid segment's walls
// get a NaN direction, so no move approaches them (its crossing is false).
struct alignas(16) Wall {
  float cx, cy, wx, wy;
};

struct In {  // one slot's operands
  float2 v, x, t, pr, sr, vs, gs, gv;
  float pi, nc, gc;
  bool al;
};

template <bool SPRING>
__device__ __forceinline__ In load(const KickArgs& a, int b, int p) {
  const int st = a.stages;
  In in{};
  in.al = a.alive[b * a.alive_sb + p * a.alive_sp];
  in.v = ld2(a.vel, b, p);
  if (st & (kCCD | kIntegrate)) in.x = ld2(a.pos, b, p);
  if (st & kTension) in.t = ld2(a.dv_tension, b, p);
  if (st & (kPressure | kIntegrate)) in.pi = ld1(a.p_i, b, p);
  if (st & kPressure) in.pr = ld2(a.pressure_real, b, p);
  if (st & (kPressure | kWall) || SPRING) in.gs = ld2(a.gsum, b, p);
  if (SPRING) in.sr = ld2(a.spring_real, b, p);
  if (st & kViscosity || SPRING) in.nc = ld1(a.nbr_cnt, b, p);
  if (st & kWall || SPRING) in.gc = ld1(a.g_cnt, b, p);
  if (st & kViscosity) in.vs = ld2(a.visc_vsum, b, p);
  if (st & kWall) in.gv = ld2(a.gvel_sum, b, p);
  return in;
}

struct Coef {  // one crate's coefficients and their 0-d products, as torch forms them
  float dt, gx, gy, dtpa, dtsa, sob, dtvisc, one_decay, r;
};

template <bool SPRING>
__global__ void __launch_bounds__(kThreads) kick_kernel(const KickArgs a) {
  extern __shared__ Wall wall[];
  __shared__ unsigned red[4][kWarps];
  const int b = blockIdx.y;
  const int st = a.stages;
  const int P = a.P, S = a.S;
  const int stride = gridDim.x * blockDim.x;
  int p = blockIdx.x * blockDim.x + threadIdx.x;

  // the first slot's loads go out before the walls are staged
  In cur{};
  if (p < P) cur = load<SPRING>(a, b, p);

  Coef c;
  c.dt = a.dt[b];
  c.r = (st & kCCD) ? a.radius[b] : 0.0f;
  c.gx = (st & kGravity) ? c.dt * a.gravity[b * 2] : 0.0f;
  c.gy = (st & kGravity) ? c.dt * a.gravity[b * 2 + 1] : 0.0f;
  c.dtpa = (st & kPressure) ? c.dt * a.pressure_amplifier[b] : 0.0f;
  c.dtsa = SPRING ? c.dt * a.spring_amplifier[b] : 0.0f;
  c.sob = SPRING ? a.spring_overlap_balance[b] : 0.0f;
  c.dtvisc = (st & kViscosity) ? c.dt * a.viscosity[b] : 0.0f;
  c.one_decay = (st & kWall) ? 1.0f + a.wall_collision_decay[b] : 0.0f;

  if (st & kCCD) {
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      // pad_segments: offset along the clockwise normal of b - a; the near
      // copy keeps a -> b, the far copy (row S + s) is reversed
      const float* sg = a.segments + (static_cast<int64_t>(b) * S + s) * 4;
      const float ax = sg[0], ay = sg[1], bx = sg[2], by = sg[3];
      const float n0 = by - ay;
      const float n1 = -(bx - ax);
      const float norm = sqrtf(clamp_min(n0 * n0 + n1 * n1, kEps));
      const float o0 = n0 * c.r / norm;
      const float o1 = n1 * c.r / norm;
      const float nc_x = ax + o0, nc_y = ay + o1, nd_x = bx + o0, nd_y = by + o1;
      const float fc_x = bx - o0, fc_y = by - o1, fd_x = ax - o0, fd_y = ay - o1;
      const bool valid = a.seg_valid[s];
      wall[s] = Wall{nc_x, nc_y, valid ? nd_x - nc_x : NAN, valid ? nd_y - nc_y : NAN};
      wall[S + s] = Wall{fc_x, fc_y, valid ? fd_x - fc_x : NAN, valid ? fd_y - fc_y : NAN};
    }
  }
  __syncthreads();

  unsigned max_bits = 0, nan_seen = 0, non_finite = 0, count = 0;
  while (p < P) {
    const int pn = p + stride;
    In nxt{};
    if (pn < P) nxt = load<SPRING>(a, b, pn);  // the next slot's loads in flight

    const bool al = cur.al;
    float vx = cur.v.x, vy = cur.v.y;
    float* norm_out = a.norms + (static_cast<int64_t>(b) * a.K) * P + p;
    const bool norms = st & kNorms;
    auto kick = [&](float dvx, float dvy) {
      if (norms) {
        __stcs(norm_out, masked_norm(dvx, dvy, al));
        norm_out += P;
      }
      vx = vx + dvx;
      vy = vy + dvy;
    };

    if (st & kTension) {  // where(alive, dt * dv_tension, 0)
      kick(al ? c.dt * cur.t.x : 0.0f, al ? c.dt * cur.t.y : 0.0f);
    }
    if (st & kGravity) {  // where(alive, dt * g, 0)
      kick(al ? c.gx : 0.0f, al ? c.gy : 0.0f);
    }
    if (st & kPressure) {  // dt * pa * (pressure_real + p_i * gsum)
      const float dvx = c.dtpa * (cur.pr.x + cur.pi * cur.gs.x);
      const float dvy = c.dtpa * (cur.pr.y + cur.pi * cur.gs.y);
      kick(al ? dvx : 0.0f, al ? dvy : 0.0f);
    }
    if (SPRING) {  // dt * sa * (spring_real + sob * gsum) / max(total, 1)
      const float total = cur.nc + cur.gc;
      const float den = clamp_min(total, 1.0f);
      const float dvx = c.dtsa * (cur.sr.x + c.sob * cur.gs.x) / den;
      const float dvy = c.dtsa * (cur.sr.y + c.sob * cur.gs.y) / den;
      const bool on = al && total > 0.0f;
      kick(on ? dvx : 0.0f, on ? dvy : 0.0f);
    }
    if (st & kViscosity) {  // dt * visc * (visc_vsum - nbr_cnt * vel), the fresh vel
      const float dvx = c.dtvisc * (cur.vs.x - cur.nc * vx);
      const float dvy = c.dtvisc * (cur.vs.y - cur.nc * vy);
      kick(al ? dvx : 0.0f, al ? dvy : 0.0f);
    }
    if (st & kWall) {  // the bounce against the mean ghost normal and contact velocity
      const float denom = clamp_min(cur.gc, 1.0f);
      const float nx = cur.gs.x / denom, ny = cur.gs.y / denom;
      const float cvx = cur.gv.x / denom, cvy = cur.gv.y / denom;
      const float n = sqrtf(clamp_min(nx * nx + ny * ny, 0.0f));  // safe_normalize
      const float nn = clamp_min(n, kEps);
      const float ux = nx / nn, uy = ny / nn;
      const float approach = (vx - cvx) * ux + (vy - cvy) * uy;
      const bool hit = al && cur.gc > 0.0f && approach < 0.0f;
      const float bx = -approach * ux * c.one_decay;
      const float by = -approach * uy * c.one_decay;
      kick(hit ? bx : 0.0f, hit ? by : 0.0f);
    }
    if (st & kCCD) {  // cut the move vel * dt at its first padded-wall crossing
      const float px = cur.x.x, py = cur.x.y;
      const float mvx = vx * c.dt;
      const float mvy = vy * c.dt;
      const float ex = px + mvx;  // the move's end
      const float ey = py + mvy;
      float acc[kAcc];
      for (int k = 0; k < kAcc; ++k) acc[k] = INFINITY;
      if (al) {
        for (int w0 = 0; w0 < 2 * S; w0 += kAcc) {
#pragma unroll
          for (int k = 0; k < kAcc; ++k) {
            if (w0 + k >= 2 * S) break;
            const Wall q = wall[w0 + k];
            // segment_crossings_soa: the approach-side filter and whether the
            // move's ends lie on two sides of the wall's line (s3, s4); that
            // is rare, so a warp seldom goes on to the wall's own ends (s1,
            // s2) and the division
            const bool approaching = (q.wy * mvx - q.wx * mvy) < 0.0f;
            if (!approaching ||
                same_sign(q.wx * ((py - q.cy) - q.wy) - q.wy * ((px - q.cx) - q.wx),
                          q.wx * ((ey - q.cy) - q.wy) - q.wy * ((ex - q.cx) - q.wx))) {
              continue;
            }
            if (same_sign(mvx * (q.cy - ey) - mvy * (q.cx - ex),
                          mvx * ((q.cy + q.wy) - ey) - mvy * ((q.cx + q.wx) - ex))) {
              continue;
            }
            // t = cross(start - c, d - c) / cross(d - c, move), |den| >= EPS
            const float num = (px - q.cx) * q.wy - (py - q.cy) * q.wx;
            const float den = q.wx * mvy - q.wy * mvx;
            const float sign_eps = den >= 0.0f ? kEps : -kEps;
            const float safe = fabsf(den) > kEps ? den : sign_eps;
            acc[k] = min_nan(acc[k], num / safe);
          }
        }
      }
      const float factor = min_nan(min_nan(min_nan(acc[0], acc[1]), acc[2]), acc[3]);
      const float fix = clamp_max(factor, 1.0f);
      const float nvx = vx * fix;
      const float nvy = vy * fix;
      if (norms) {  // the clamp's dv is new_vel - vel
        __stcs(norm_out, masked_norm(nvx - vx, nvy - vy, al));
        norm_out += P;
      }
      vx = nvx;
      vy = nvy;
    }

    const int64_t i = static_cast<int64_t>(b) * P + p;
    reinterpret_cast<float2*>(a.vel_out)[i] = make_float2(vx, vy);
    if (st & kIntegrate) {  // where(alive, pos + dt * vel, pos); where(alive, p_i, 0)
      const float px = al ? cur.x.x + c.dt * vx : cur.x.x;
      const float py = al ? cur.x.y + c.dt * vy : cur.x.y;
      reinterpret_cast<float2*>(a.pos_out)[i] = make_float2(px, py);
      a.pressure_out[i] = al ? cur.pi : 0.0f;
      if (al) {
        const float speed2 = vx * vx + vy * vy;
        if (isnan(speed2)) {
          nan_seen = 1;
        } else {
          max_bits = max(max_bits, __float_as_uint(speed2));  // speed2 >= +0
        }
        count += 1;
        const bool finite = isfinite(px) && isfinite(py) && isfinite(vx) && isfinite(vy);
        non_finite += finite ? 0 : 1;
      }
    }
    p = pn;
    cur = nxt;
  }

  if (!(st & kIntegrate)) return;
  // the block's sums: warps, then thread 0 adds them to the crate's scratch
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  max_bits = __reduce_max_sync(0xffffffffu, max_bits);
  nan_seen = __reduce_or_sync(0xffffffffu, nan_seen);
  non_finite = __reduce_add_sync(0xffffffffu, non_finite);
  count = __reduce_add_sync(0xffffffffu, count);
  if (lane == 0) {
    red[kMax][warp] = max_bits;
    red[kNan][warp] = nan_seen;
    red[kNonFinite][warp] = non_finite;
    red[kCount][warp] = count;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kWarps; ++w) {
    max_bits = max(max_bits, red[kMax][w]);
    nan_seen |= red[kNan][w];
    non_finite += red[kNonFinite][w];
    count += red[kCount][w];
  }
  unsigned* sc = a.scratch + b * kScratch;
  if (max_bits) atomicMax(sc + kMax, max_bits);
  if (nan_seen) atomicOr(sc + kNan, 1u);
  if (non_finite) atomicAdd(sc + kNonFinite, non_finite);
  if (count) atomicAdd(sc + kCount, count);
  __threadfence();
  if (atomicAdd(sc + kDone, 1u) != gridDim.x - 1) return;
  // the crate's last block: every other block's atomics are visible
  __threadfence();
  const unsigned m = atomicOr(sc + kMax, 0u);
  const bool any_nan = atomicOr(sc + kNan, 0u) != 0;
  a.max_speed[b] = sqrtf(any_nan ? __uint_as_float(0x7fffffffu) : __uint_as_float(m));
  a.non_finite[b] = static_cast<int>(atomicOr(sc + kNonFinite, 0u));
  a.cnt[b] = fmaxf(static_cast<float>(atomicOr(sc + kCount, 0u)), 1.0f);
}

// The grid-stride loop's blocks a crate: one wave of resident blocks (as
// many as the SMs hold at once), or fewer where the slots need fewer.
template <typename Kernel>
int grid_blocks(Kernel kernel, int P, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  const int wave = sms * (per_sm > 0 ? per_sm : 1);
  const int need = (P + kThreads - 1) / kThreads;
  return need < wave ? need : wave;
}

template <bool SPRING>
int launch(const KickArgs& a, cudaStream_t stream) {
  const size_t smem = (a.stages & kCCD) ? sizeof(Wall) * 2 * a.S : 0;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kick_kernel<SPRING>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const int blocks = grid_blocks(kick_kernel<SPRING>, a.P, smem);
  kick_kernel<SPRING><<<dim3(blocks, a.B), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The velocity update of B crates of P slots (S segments, 2S padded walls)
// over the stages in args->stages.  Launches on `stream` and does not
// synchronise; returns cudaGetLastError().
extern "C" int sc_velocity_update(const KickArgs* args, void* stream) {
  const KickArgs& a = *args;
  if (a.B <= 0 || a.P <= 0) return 0;
  if (a.B > 65535 || ((a.stages & kCCD) && a.S <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (a.stages & kSpring) ? launch<true>(a, s) : launch<false>(a, s);
}

// Stage marks of the tick (ops/stage_mark.py): an empty kernel a stage end,
// launched on the tick's stream, so a device trace splits a replayed tick
// (which has no host frames) into its stages by the marks' names.  Each
// stage is a type, so the trace names it: stage_mark_kernel<stage::sort>.
namespace stage {
struct lifecycle;
struct sort;
struct pairs;
struct tick;
}  // namespace stage

template <class S>
__global__ void stage_mark_kernel() {}

// Launch stage `which` (0 lifecycle, 1 sort, 2 pairs, 3 tick) on `stream`;
// returns cudaGetLastError().
extern "C" int sc_stage_mark(int which, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: stage_mark_kernel<stage::lifecycle><<<1, 1, 0, s>>>(); break;
    case 1: stage_mark_kernel<stage::sort><<<1, 1, 0, s>>>(); break;
    case 2: stage_mark_kernel<stage::pairs><<<1, 1, 0, s>>>(); break;
    case 3: stage_mark_kernel<stage::tick><<<1, 1, 0, s>>>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
