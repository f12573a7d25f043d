// The ghost pass of the tick for Hopper (sm_90a): the virtual colliders
// (boundary ghosts) with the hard-wall fix, in two instantiations: the full
// pass (fixed position, ghost count, ghost sum, ghost velocity sum) and the
// positions-only pass (the fixed position alone, which the sorted backends'
// cell sort reads before the full pass runs again on the sorted order).
//
// The counterpart of the XLA fusion of sand_crate_tpu/physics.py::
// _ghost_core (l.331-363, with _ghost_geom and _ghost_vel); not a
// pl.pallas_call: XLA fuses it into a loop over the particles.  The port's
// torch version runs it as dozens of plane-wide ops over (S, P) planes;
// this kernel takes a thread per particle slot and keeps no plane in
// memory.  The wrappers and their plain torch versions are
// sand_crate_tpu_torch/ops/boundary.py (ghost_pass / ghost_pass_plain,
// ghost_pos / ghost_pos_plain).  The continuous-collision clamp that this
// file also held is a stage of the velocity update (csrc/kick.cu).
//
// Inputs (B crates of P particle slots, S segments, NB bodies; a solo crate
// is B = 1, a vmapped batch B crates):
//   prepos   (B, P, 2) f32   positions before the hard-wall fix
//   alive    (B, P) bool
//   segments (B, S, 2, 2) f32  the crate's current segments
//   lin, ang (B, NB, 2), (B, NB) f32  body velocities (full pass)
//   radius   (B,) f32        read on the device, so a graph captures it
//   seg_valid (S,) bool, seg_body (S,) i64, body_center (NB, 2) f32: the
//            scene's, shared by the crates
// Outputs: pos, g_cnt, gsum, gvel_sum ((B, P, 2), (B, P), (B, P, 2),
// (B, P, 2)); the positions-only pass writes pos alone.
//
// The pass moves 37 bytes a slot (positions-only: 17) and does a few dozen
// f32 operations a slot and segment, so it is bound by bytes.  The design
// against that: each block issues its first slot's loads (the position as
// one float2, alive) before it stages the crate's S segments in shared
// memory (start, direction, squared length, validity, the owning body's
// velocity and center, the bounding box), then walks the slots in a
// grid-stride loop (one wave of the blocks the SMs hold at once, so a block
// stages once for many slots) with the next slot's loads in flight, and stores
// positions and sums as float2.  Most slot-segment pairs are far apart and
// contribute nothing: where the distance from the slot to the segment's
// bounding box exceeds 1.2 r by a margin that covers every rounding of the
// exact path, and every value in play is finite and bounded, the exact
// path's mask would be 0 and every term it adds +-0; where the exact path
// finds the mask 0 and the mirror offsets, contact velocities and ratio
// finite, likewise.  Adding +-0 to an accumulator that started at +0 leaves
// its bits unchanged (it can never be -0), so both skip the segment; a NaN
// or an overflow (0 * inf) runs the full path.  In cell-sorted order whole
// warps take the same branch.
//
// Bitwise reproducibility: built with -fmad=false and IEEE division and
// sqrt (nvcc's defaults; no fast math), every operation is one rounded f32
// operation in the order the torch ops perform it.  torch's clamp and
// where propagate NaN, so clamps here test for NaN first.  The sums over
// the segment axis follow torch's reduction over dim 0 of an (S, P) plane
// with a thread per output: four accumulators, segment s into accumulator
// s % 4 in ascending order, each started at +0, then combined 0 + 1, + 2,
// + 3.  No atomics: the outputs do not depend on the launch.

#include <cstdint>

#include <cuda_runtime.h>


namespace {

constexpr float kEps = 1e-12f;  // geometry.py / physics.py EPS
constexpr int kThreads = 256;
constexpr int kAcc = 4;          // accumulators of torch's dim-0 reduction
// Values at most kBig in magnitude keep every product of the exact path
// finite (squares of sums of two stay under 1e31, r / EPS under 1e27).
constexpr float kBig = 1e15f;
// The skip's margin, relative to 1 + the largest coordinate in play: the
// exact path's distance is within ~25 roundings (2^-24 each) of the true
// distance to the segment, and 1e-5 is ~170 of them.
constexpr float kMargin = 1e-5f;

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp01(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ float sum4(const float* acc) {
  return ((acc[0] + acc[1]) + acc[2]) + acc[3];
}

__device__ __forceinline__ bool bounded(float v) {  // false for NaN and inf
  return fabsf(v) <= kBig;
}

struct GhostSeg {
  float ax, ay, abx, aby, denom;   // start, direction, clamped squared length
  float blx, bly, bang, bcx, bcy;  // owning body: velocity and center
  float xlo, xhi, ylo, yhi;        // bounding box
  float reach;                     // the skip's margin for this segment
  bool valid;
  bool ok;  // every value above finite and bounded: the skip may apply
};

template <bool FULL>
__global__ void __launch_bounds__(kThreads) ghost_kernel(
    const float* __restrict__ prepos, const bool* __restrict__ alive,
    const float* __restrict__ segments, const float* __restrict__ lin,
    const float* __restrict__ ang, const float* __restrict__ radius,
    const bool* __restrict__ seg_valid, const int64_t* __restrict__ seg_body,
    const float* __restrict__ body_center, float* __restrict__ pos_out,
    float* __restrict__ g_cnt, float* __restrict__ gsum, float* __restrict__ gvel_sum, int P,
    int S, int NB) {
  extern __shared__ GhostSeg seg[];
  const int b = blockIdx.y;
  const int stride = gridDim.x * blockDim.x;
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t base = static_cast<int64_t>(b) * P;
  const float2* pre = reinterpret_cast<const float2*>(prepos) + base;

  // the first slot's loads go out before the segments are staged
  float2 cur = make_float2(0.0f, 0.0f);
  bool cur_al = false;
  if (p < P) {
    cur = __ldg(pre + p);
    cur_al = alive[base + p];
  }
  const float r = radius[b];

  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const float* sg = segments + (static_cast<int64_t>(b) * S + s) * 4;
    GhostSeg g;
    g.ax = sg[0];
    g.ay = sg[1];
    g.abx = sg[2] - sg[0];
    g.aby = sg[3] - sg[1];
    g.denom = clamp_min(g.abx * g.abx + g.aby * g.aby, kEps);
    g.xlo = fminf(sg[0], sg[2]);
    g.xhi = fmaxf(sg[0], sg[2]);
    g.ylo = fminf(sg[1], sg[3]);
    g.yhi = fmaxf(sg[1], sg[3]);
    g.ok = bounded(sg[0]) && bounded(sg[1]) && bounded(sg[2]) && bounded(sg[3]);
    if (FULL) {
      const int64_t body = seg_body[s];
      const int64_t bb = static_cast<int64_t>(b) * NB + body;
      g.blx = lin[bb * 2];
      g.bly = lin[bb * 2 + 1];
      g.bang = ang[bb];
      g.bcx = body_center[body * 2];
      g.bcy = body_center[body * 2 + 1];
      g.ok = g.ok && bounded(g.blx) && bounded(g.bly) && bounded(g.bang) && bounded(g.bcx) &&
             bounded(g.bcy);
    }
    const float mag = fmaxf(fmaxf(fabsf(sg[0]), fabsf(sg[1])), fmaxf(fabsf(sg[2]), fabsf(sg[3])));
    g.reach = r * 1.2f + kMargin * (1.0f + mag);
    g.valid = seg_valid[s];
    seg[s] = g;
  }
  __syncthreads();

  const float thr = r * 1.2f;
  const bool r_ok = bounded(r);
  while (p < P) {
    const int pn = p + stride;
    float2 nxt = make_float2(0.0f, 0.0f);
    bool nxt_al = false;
    if (pn < P) {  // the next slot's loads in flight
      nxt = __ldg(pre + pn);
      nxt_al = alive[base + pn];
    }
    const float px = cur.x, py = cur.y;
    const bool al = cur_al;
    const bool slot_ok = r_ok && bounded(px) && bounded(py);
    const float slot_reach = kMargin * (fabsf(px) + fabsf(py));
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
        const GhostSeg& g = seg[s0 + k];
        if (slot_ok && g.ok) {  // far from the segment's box: the mask is 0
          const float ex = fmaxf(fmaxf(g.xlo - px, px - g.xhi), 0.0f);
          const float ey = fmaxf(fmaxf(g.ylo - py, py - g.yhi), 0.0f);
          if (fmaxf(ex, ey) > g.reach + slot_reach) continue;
        }
        // points_to_segments_soa: the clamped projection and its distance
        const float t = clamp01(((px - g.ax) * g.abx + (py - g.ay) * g.aby) / g.denom);
        const float nx = g.ax + g.abx * t;
        const float ny = g.ay + g.aby * t;
        const float dx = nx - px;
        const float dy = ny - py;
        const float dist = sqrtf(clamp_min(dx * dx + dy * dy, 0.0f));
        const bool gm = dist <= thr && g.valid && al;
        // mirror ghost offset, contact velocity
        const float gvx = 2.0f * (px - nx);
        const float gvy = 2.0f * (py - ny);
        const float gvelx = FULL ? g.blx + g.bang * (ny - g.bcy) : 0.0f;
        const float gvely = FULL ? g.bly - g.bang * (nx - g.bcx) : 0.0f;
        if (!gm && r_ok && isfinite(gvx) && isfinite(gvy) && isfinite(gvelx) &&
            isfinite(gvely)) {
          continue;  // every term below is +-0
        }
        const float m = gm ? 1.0f : 0.0f;
        // the hard-wall ratio
        const float gnorm = sqrtf(clamp_min(gvx * gvx + gvy * gvy, 0.0f));
        const float vrd = clamp_min(r / clamp_min(gnorm, kEps), 0.5f) - 0.5f;
        cor_x[k] = cor_x[k] + m * gvx * vrd;
        cor_y[k] = cor_y[k] + m * gvy * vrd;
        if (FULL) {
          cnt[k] = cnt[k] + m;
          gs_x[k] = gs_x[k] + m * gvx;
          gs_y[k] = gs_y[k] + m * gvy;
          gv_x[k] = gv_x[k] + m * gvelx;
          gv_y[k] = gv_y[k] + m * gvely;
        }
      }
    }
    const int64_t i = base + p;
    reinterpret_cast<float2*>(pos_out)[i] =
        al ? make_float2(px + sum4(cor_x), py + sum4(cor_y)) : cur;
    if (FULL) {
      g_cnt[i] = sum4(cnt);
      reinterpret_cast<float2*>(gsum)[i] = make_float2(sum4(gs_x), sum4(gs_y));
      reinterpret_cast<float2*>(gvel_sum)[i] = make_float2(sum4(gv_x), sum4(gv_y));
    }
    p = pn;
    cur = nxt;
    cur_al = nxt_al;
  }
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

template <bool FULL>
int launch(const void* prepos, const void* alive, const void* segments, const void* lin,
           const void* ang, const void* radius, const void* seg_valid, const void* seg_body,
           const void* body_center, void* pos, void* g_cnt, void* gsum, void* gvel_sum, int B,
           int P, int S, int NB, void* stream) {
  const size_t smem = sizeof(GhostSeg) * S;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(ghost_kernel<FULL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const dim3 grid(grid_blocks(ghost_kernel<FULL>, P, smem), B);
  ghost_kernel<FULL><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(prepos), static_cast<const bool*>(alive),
      static_cast<const float*>(segments), static_cast<const float*>(lin),
      static_cast<const float*>(ang), static_cast<const float*>(radius),
      static_cast<const bool*>(seg_valid), static_cast<const int64_t*>(seg_body),
      static_cast<const float*>(body_center), static_cast<float*>(pos),
      static_cast<float*>(g_cnt), static_cast<float*>(gsum), static_cast<float*>(gvel_sum), P,
      S, NB);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The full ghost pass over B crates of P slots and S segments (NB bodies).
// Launches on `stream` and does not synchronise; returns cudaGetLastError().
extern "C" int sc_ghost_pass(const void* prepos, const void* alive, const void* segments,
                             const void* lin, const void* ang, const void* radius,
                             const void* seg_valid, const void* seg_body,
                             const void* body_center, void* pos, void* g_cnt, void* gsum,
                             void* gvel_sum, int B, int P, int S, int NB, void* stream) {
  if (B <= 0 || P <= 0) return 0;
  if (S <= 0 || NB <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(prepos, alive, segments, lin, ang, radius, seg_valid, seg_body,
                      body_center, pos, g_cnt, gsum, gvel_sum, B, P, S, NB, stream);
}

// The positions-only ghost pass: the hard-wall-fixed positions alone.
extern "C" int sc_ghost_pos(const void* prepos, const void* alive, const void* segments,
                            const void* radius, const void* seg_valid, void* pos, int B, int P,
                            int S, void* stream) {
  if (B <= 0 || P <= 0) return 0;
  if (S <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(prepos, alive, segments, nullptr, nullptr, radius, seg_valid, nullptr,
                       nullptr, pos, nullptr, nullptr, nullptr, B, P, S, 0, stream);
}
