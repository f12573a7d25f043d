// The boundary chain of the tick for Hopper (sm_90a): the ghost pass with
// its hard-wall fix, and the continuous-collision clamp.
//
// ghost_kernel is the counterpart of the XLA fusion of
// sand_crate_tpu/physics.py::_ghost_core (l.331-363, with _ghost_geom and
// _ghost_vel); ccd_kernel of the fusion of apply_continuous_collision
// (l.738-749, with geometry.py's pad_segments and segment_crossings_soa).
// Neither is a pl.pallas_call in the JAX package: XLA fuses both into loops
// over the particles.  The port's torch versions run them as dozens of
// plane-wide ops over (S, P) and (2S, P) planes; these kernels take a
// thread per particle and keep no plane in memory.  The wrappers and their
// plain torch versions are sand_crate_tpu_torch/ops/boundary.py
// (ghost_pass / ghost_pass_plain, continuous_collision /
// continuous_collision_plain).
//
// Inputs (B crates of P particle slots, S segments, NB bodies; a solo crate
// is B = 1, a vmapped batch B crates):
//   prepos   (B, P, 2) f32   positions before the hard-wall fix
//   pos, vel (B, P, 2) f32   CCD: the fixed positions and the velocities
//   alive    (B, P) bool
//   segments (B, S, 2, 2) f32  the crate's current segments
//   lin, ang (B, NB, 2), (B, NB) f32  body velocities (ghost pass)
//   radius, dt (B,) f32      read on the device, so a graph captures them
//   seg_valid (S,) bool, seg_body (S,) i64, body_center (NB, 2) f32: the
//            scene's, shared by the crates
// Outputs: ghost pass pos, g_cnt, gsum, gvel_sum ((B, P, 2), (B, P),
// (B, P, 2), (B, P, 2)); CCD the clamped velocity (B, P, 2).
//
// Each block stages its crate's S segments once in shared memory (the ghost
// pass: the segment's start, direction, squared length, validity and the
// owning body's linear and angular velocity and center; the CCD: the 2S
// padded walls in pad_segments' order, near sides first), then each thread
// loops over them for its particle.
//
// Bitwise reproducibility: built with -fmad=false and IEEE division and
// sqrt (nvcc's defaults; no fast math), every operation is one rounded f32
// operation in the order the torch ops perform it, and every term is
// computed for every segment, masked by multiplying (0 * inf is NaN there
// too).  torch's clamp, where and amin propagate NaN, so clamp and min here
// test for NaN first; the orientation sign is geometry.sign, torch.sign
// ((0 < a) - (a < 0) on the card, +0 for -0) with NaN kept, as jnp.sign
// keeps it.  The sums and the minimum over the segment axis follow
// torch's reduction over dim 0 of an (S, P) plane with a thread per output:
// four accumulators, segment s into accumulator s % 4 in ascending order,
// each started at the identity (0, +inf), then combined 0 + 1, + 2, + 3.
// The minimum keeps torch's rule (a is kept if it is NaN or a < b, else b).
// No atomics: the outputs do not depend on the launch.

#include <cstdint>

#include <cuda_runtime.h>


namespace {

constexpr float kEps = 1e-12f;  // geometry.py / physics.py EPS
constexpr int kThreads = 256;
constexpr int kAcc = 4;  // accumulators of torch's dim-0 reduction

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

__device__ __forceinline__ float clamp01(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ float sign_of(float a) {  // geometry.sign: NaN stays NaN
  return isnan(a) ? a
                  : static_cast<float>(static_cast<int>(0.0f < a) - static_cast<int>(a < 0.0f));
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}

__device__ __forceinline__ float sum4(const float* acc) {
  return ((acc[0] + acc[1]) + acc[2]) + acc[3];
}

struct GhostSeg {
  float ax, ay, abx, aby, denom;  // start, direction, clamped squared length
  float blx, bly, bang, bcx, bcy;  // owning body: velocity and center
  float valid;                     // 1 or 0
};

__global__ void ghost_kernel(const float* __restrict__ prepos,
                             const bool* __restrict__ alive,
                             const float* __restrict__ segments,
                             const float* __restrict__ lin,
                             const float* __restrict__ ang,
                             const float* __restrict__ radius,
                             const bool* __restrict__ seg_valid,
                             const int64_t* __restrict__ seg_body,
                             const float* __restrict__ body_center,
                             float* __restrict__ pos_out, float* __restrict__ g_cnt,
                             float* __restrict__ gsum, float* __restrict__ gvel_sum,
                             int P, int S, int NB) {
  extern __shared__ GhostSeg seg[];
  const int b = blockIdx.y;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const float* sg = segments + (static_cast<int64_t>(b) * S + s) * 4;
    GhostSeg g;
    g.ax = sg[0];
    g.ay = sg[1];
    g.abx = sg[2] - sg[0];
    g.aby = sg[3] - sg[1];
    g.denom = clamp_min(g.abx * g.abx + g.aby * g.aby, kEps);
    const int64_t body = seg_body[s];
    const int64_t bb = static_cast<int64_t>(b) * NB + body;
    g.blx = lin[bb * 2];
    g.bly = lin[bb * 2 + 1];
    g.bang = ang[bb];
    g.bcx = body_center[body * 2];
    g.bcy = body_center[body * 2 + 1];
    g.valid = seg_valid[s] ? 1.0f : 0.0f;
    seg[s] = g;
  }
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int64_t i = static_cast<int64_t>(b) * P + p;
  const float px = prepos[i * 2];
  const float py = prepos[i * 2 + 1];
  const bool al = alive[i];
  const float r = radius[b];
  const float thr = r * 1.2f;
  float cor_x[kAcc], cor_y[kAcc], cnt[kAcc], gs_x[kAcc], gs_y[kAcc], gv_x[kAcc], gv_y[kAcc];
  for (int k = 0; k < kAcc; ++k) {
    cor_x[k] = cor_y[k] = cnt[k] = gs_x[k] = gs_y[k] = gv_x[k] = gv_y[k] = 0.0f;
  }
  // segment s into accumulator s % 4, in ascending s; k is a constant of
  // the unrolled loop, so the accumulators stay in registers
  for (int s0 = 0; s0 < S; s0 += kAcc) {
#pragma unroll
    for (int k = 0; k < kAcc; ++k) {
      if (s0 + k >= S) break;
      const GhostSeg g = seg[s0 + k];
      // points_to_segments_soa: the clamped projection and its distance
      const float t = clamp01(((px - g.ax) * g.abx + (py - g.ay) * g.aby) / g.denom);
      const float nx = g.ax + g.abx * t;
      const float ny = g.ay + g.aby * t;
      const float dx = nx - px;
      const float dy = ny - py;
      const float dist = sqrtf(clamp_min(dx * dx + dy * dy, 0.0f));
      const float gm = (dist <= thr && g.valid != 0.0f && al) ? 1.0f : 0.0f;
      // mirror ghost offset, contact velocity, hard-wall ratio
      const float gvx = 2.0f * (px - nx);
      const float gvy = 2.0f * (py - ny);
      const float gvelx = g.blx + g.bang * (ny - g.bcy);
      const float gvely = g.bly - g.bang * (nx - g.bcx);
      const float gnorm = sqrtf(clamp_min(gvx * gvx + gvy * gvy, 0.0f));
      const float vrd = clamp_min(r / clamp_min(gnorm, kEps), 0.5f) - 0.5f;
      cor_x[k] = cor_x[k] + gm * gvx * vrd;
      cor_y[k] = cor_y[k] + gm * gvy * vrd;
      cnt[k] = cnt[k] + gm;
      gs_x[k] = gs_x[k] + gm * gvx;
      gs_y[k] = gs_y[k] + gm * gvy;
      gv_x[k] = gv_x[k] + gm * gvelx;
      gv_y[k] = gv_y[k] + gm * gvely;
    }
  }
  pos_out[i * 2] = al ? px + sum4(cor_x) : px;
  pos_out[i * 2 + 1] = al ? py + sum4(cor_y) : py;
  g_cnt[i] = sum4(cnt);
  gsum[i * 2] = sum4(gs_x);
  gsum[i * 2 + 1] = sum4(gs_y);
  gvel_sum[i * 2] = sum4(gv_x);
  gvel_sum[i * 2 + 1] = sum4(gv_y);
}

struct Wall {
  float cx, cy, wx, wy;  // start c and direction d - c
  float valid;
};

__global__ void ccd_kernel(const float* __restrict__ pos, const float* __restrict__ vel,
                           const bool* __restrict__ alive,
                           const float* __restrict__ segments,
                           const float* __restrict__ radius, const float* __restrict__ dt,
                           const bool* __restrict__ seg_valid,
                           float* __restrict__ vel_out, int P, int S) {
  extern __shared__ Wall wall[];
  const int b = blockIdx.y;
  const float r = radius[b];
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    // pad_segments: offset along the clockwise normal of b - a; the near
    // copy keeps a -> b, the far copy (row S + s) is reversed
    const float* sg = segments + (static_cast<int64_t>(b) * S + s) * 4;
    const float ax = sg[0], ay = sg[1], bx = sg[2], by = sg[3];
    const float n0 = by - ay;
    const float n1 = -(bx - ax);
    const float norm = sqrtf(clamp_min(n0 * n0 + n1 * n1, kEps));
    const float o0 = n0 * r / norm;
    const float o1 = n1 * r / norm;
    const float valid = seg_valid[s] ? 1.0f : 0.0f;
    const float nc_x = ax + o0, nc_y = ay + o1, nd_x = bx + o0, nd_y = by + o1;
    const float fc_x = bx - o0, fc_y = by - o1, fd_x = ax - o0, fd_y = ay - o1;
    wall[s] = Wall{nc_x, nc_y, nd_x - nc_x, nd_y - nc_y, valid};
    wall[S + s] = Wall{fc_x, fc_y, fd_x - fc_x, fd_y - fc_y, valid};
  }
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int64_t i = static_cast<int64_t>(b) * P + p;
  const float px = pos[i * 2];
  const float py = pos[i * 2 + 1];
  const float vx = vel[i * 2];
  const float vy = vel[i * 2 + 1];
  const bool al = alive[i];
  const float step = dt[b];
  const float mvx = vx * step;
  const float mvy = vy * step;
  const float bx = px + mvx;  // the move's end
  const float by = py + mvy;
  float acc[kAcc];
  for (int k = 0; k < kAcc; ++k) acc[k] = INFINITY;
  for (int w0 = 0; w0 < 2 * S; w0 += kAcc) {
#pragma unroll
    for (int k = 0; k < kAcc; ++k) {
      if (w0 + k >= 2 * S) break;
      const Wall q = wall[w0 + k];
      // segment_crossings_soa: the approach-side filter, the four
      // orientation signs, and t = cross(start - c, d - c) / cross(d - c, move)
      const bool approaching = (q.wy * mvx - q.wx * mvy) < 0.0f;
      const float s1 = sign_of(mvx * (q.cy - by) - mvy * (q.cx - bx));
      const float s2 = sign_of(mvx * ((q.cy + q.wy) - by) - mvy * ((q.cx + q.wx) - bx));
      const float s3 = sign_of(q.wx * ((py - q.cy) - q.wy) - q.wy * ((px - q.cx) - q.wx));
      const float s4 = sign_of(q.wx * ((by - q.cy) - q.wy) - q.wy * ((bx - q.cx) - q.wx));
      const bool crossing =
          approaching && (s1 != s2) && (s3 != s4) && q.valid != 0.0f && al;
      const float num = (px - q.cx) * q.wy - (py - q.cy) * q.wx;
      const float den = q.wx * mvy - q.wy * mvx;
      const float sign_eps = den >= 0.0f ? kEps : -kEps;
      const float safe = fabsf(den) > kEps ? den : sign_eps;
      const float t_hit = num / safe;
      acc[k] = min_nan(acc[k], crossing ? t_hit : INFINITY);
    }
  }
  const float factor = min_nan(min_nan(min_nan(acc[0], acc[1]), acc[2]), acc[3]);
  const float fix = clamp_max(factor, 1.0f);
  vel_out[i * 2] = vx * fix;
  vel_out[i * 2 + 1] = vy * fix;
}

}  // namespace

// The ghost pass over B crates of P slots and S segments (NB bodies).
// Launches on `stream` and does not synchronise; returns cudaGetLastError().
extern "C" int sc_ghost_pass(const void* prepos, const void* alive, const void* segments,
                             const void* lin, const void* ang, const void* radius,
                             const void* seg_valid, const void* seg_body,
                             const void* body_center, void* pos, void* g_cnt, void* gsum,
                             void* gvel_sum, int B, int P, int S, int NB, void* stream) {
  if (B <= 0 || P <= 0) return 0;
  if (S <= 0 || NB <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((P + kThreads - 1) / kThreads, B);
  const size_t smem = sizeof(GhostSeg) * S;
  ghost_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(prepos), static_cast<const bool*>(alive),
      static_cast<const float*>(segments), static_cast<const float*>(lin),
      static_cast<const float*>(ang), static_cast<const float*>(radius),
      static_cast<const bool*>(seg_valid), static_cast<const int64_t*>(seg_body),
      static_cast<const float*>(body_center), static_cast<float*>(pos),
      static_cast<float*>(g_cnt), static_cast<float*>(gsum), static_cast<float*>(gvel_sum),
      P, S, NB);
  return static_cast<int>(cudaGetLastError());
}

// The continuous-collision clamp over B crates of P slots and S segments
// (2S padded walls).  Launches on `stream` and does not synchronise; returns
// cudaGetLastError().
extern "C" int sc_ccd(const void* pos, const void* vel, const void* alive, const void* segments,
                      const void* radius, const void* dt, const void* seg_valid, void* vel_out,
                      int B, int P, int S, void* stream) {
  if (B <= 0 || P <= 0) return 0;
  if (S <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((P + kThreads - 1) / kThreads, B);
  const size_t smem = sizeof(Wall) * 2 * S;
  ccd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float*>(vel),
      static_cast<const bool*>(alive), static_cast<const float*>(segments),
      static_cast<const float*>(radius), static_cast<const float*>(dt),
      static_cast<const bool*>(seg_valid), static_cast<float*>(vel_out), P, S);
  return static_cast<int>(cudaGetLastError());
}
