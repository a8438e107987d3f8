// Boids steering kernel for Hopper (sm_90a): the clamped flocking
// acceleration of every agent of one boids step.
//
// Replaces goworld_tpu/ops/boids.py::_boids_kernel, the Pallas TPU kernel
// built by _compiled_accel.
//
// What it computes. The input is the dense cell layout f32[gz+2, gx+2, 8, 128]
// with a wrapped halo ring: per cell, feature rows x, z, vx, vz, valid (then 3
// spare rows) by 128 lanes. An empty lane carries another agent's x, z, vx and
// vz (or anything finite) and a valid row of 0, so only the valid row decides
// who takes part. For a query lane q of cell (i, j), over the 1152 candidates
// c of the cell's 3x3 halo block (c = (3*di + dj) * 128 + lane), a candidate
// is a neighbor when
//     valid_q > 0 && valid_c > 0 && d2 <= r2 && c != 4 * 128 + q
// with the minimal-image torus displacement
//     dx = (x_c - x_q) - wx * rint((x_c - x_q) / wx), dz likewise,
//     d2 = dx*dx + dz*dz.
// Per query it sums, over the neighbors: their count, their vx and vz, their
// dx and dz, and for the close ones (d2 < sep_r2) dx / (d2 + 1e-6) and
// dz / (d2 + 1e-6). Then
//     sep = -(the close sums), align = (mean neighbor velocity - own) or 0,
//     coh = mean (dx, dz) or 0,
//     a = w_sep * sep + w_align * align + w_coh * coh,
//     a *= min(1, max_accel * rsqrt(|a|^2 + 1e-12)),
// written to out f32[gz, gx, 2, 128] (ax in row 0, az in row 1). An empty
// lane's acceleration is 0.
//
// Arithmetic. Each operation is rounded on its own (the __f*_rn intrinsics,
// and the build passes --fmad=false), as the plain PyTorch version rounds
// them. rint rounds half to even, as jnp.round does. The division by the
// world size is an IEEE division, as in the float64 oracle: a reciprocal
// multiply would move the image one float above |dx| = wx/2 (XLA makes the
// Pallas body's division one; tests/test_torch_boids_skips.py). The image
// needs no division where |dx| <= wx/2: |dx / wx| then rounds to at most
// 0.5, which rint takes to 0, so the image is dx itself (a -0 becomes +0
// there, which no sum starting at +0 can tell).
// The rsqrt is 1 / sqrt(x) with both steps correctly rounded (__fsqrt_rn,
// __fdiv_rn), not the approximate rsqrtf. Never build this with
// --use_fast_math. A query walked by one thread sums its neighbors in
// candidate order; one split over several threads sums each thread's share
// in candidate order and the shares in a fixed tree. The plain version and
// the TPU sum in other orders, so the outputs differ by rounding (a few 1e-6
// at the test sizes).
//
// What bounds it on an H100. Per pair of an occupied query and another
// occupied candidate it needs 6 FP32 operations, 4 more on each axis along
// which the pair lies past half the world (the image, counting an IEEE
// division as one), 6 more for each pair in range and 6 more for each close
// pair, and 33 per occupied query after the loop; it must read each cell's
// valid row and 16 B of each occupied lane, and write 1 KB a cell
// (chip_smoke.py's boids_work counts both from the run's cells). At 51,200
// agents the bytes bound it on 64x64 cells (12.5 agents a cell), the
// operations on 40x40 to 20x20 (up to 128). The time goes elsewhere: where
// cells are sparse, to each CTA's fixed work (two round trips to L2, two
// barriers, the prefix, the sums' reduction) over 4,096 CTAs; where they are
// dense, to issuing the pair loop, about 14 instructions a pair, on the 3-4
// CTAs an SM gets of 400.
//
// Measured by chip_smoke.py on one NVIDIA H100 80GB HBM3 at 700.00 W, at
// the start cells of bench.py's supercell sweep (51,200 agents): 0.0339 ms
// on 64x64 cells, 0.0359 on 40x40, 0.0422 on 32x32 and 0.0732 on 20x20,
// against 0.2422 / 0.1727 / 0.1249 / 0.1993 for the kernel before this
// design in the same call (one CTA per cell, a thread per lane walking all
// 1152 candidates, the image division on every pair).
//
// The design (PERF.md, section 6, has its measurements):
//  * Only occupied candidates are walked. One CTA of 128 threads handles one
//    cell; thread t reads lane t's valid row of each of the nine cells, each
//    warp ballots its 32 lanes, and x, z, vx and vz are loaded only for the
//    lanes that hold an agent. A prefix over the 36 ballots' popcounts
//    places each occupied candidate in a compacted list in shared memory
//    (18 KB), in candidate order, as one float4 (x, z, vx, vz). The queries are the run
//    of the centre cell, so the self test compares list positions. Nothing
//    assumes that lanes fill from 0.
//  * Threads go to occupied queries, not to lanes. With n queries, each gets
//    s lanes, the largest power of two up to 32 with n * s <= 128; lane r of
//    a query walks list entries r, r + s, ..., and the s lanes add their
//    seven sums (count, vx, vz, dx, dz, close dx, close dz) with
//    __shfl_xor_sync. A dense cell keeps one thread a query (s = 1), which
//    walks the list in candidate order and sums as the kernel before did,
//    bit for bit. A warp without a query does no pair work.
//  * The image division only across the seam, and mostly not at all. A CTA
//    whose occupied x and z span at most half the world (every cell off the
//    grid's edge) takes no image: d is its own. Otherwise each halo cell's
//    extent against the queries' shows whether all its pairs need d, d - w
//    or d + w (two divisions a halo cell tell), and the loop subtracts that
//    shift, exactly what the formula gives them. Only where a halo cell
//    mixes them is each pair tested, the division running for |d| > w/2.
//  * In flight: 64 registers (launch bounds of 8 CTAs an SM) and 19 KB of
//    shared memory a CTA; ptxas reports no spill and no stack frame
//    (chip_smoke.py fails the run otherwise).
//
// The CTA shape, register bound and unroll depth are the fastest, on the
// main path's mix of grids, of the variants that tools/time_boids_variants.py
// times against this source in turns (PERF.md has its readings): 256
// threads a CTA (faster on dense cells, slower on the sparse grid the main
// path launches most), 6 or 10 CTAs an SM (10 spills), unrolling by 1 or 2,
// and every CTA taking the per-halo-cell shifts (no block-wide extent) all
// read slower. A second query a thread and (x, z) and (vx, vz) kept apart in
// the list were tried and dropped too.

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>

namespace {

constexpr int kLanes = 128;                  // query lanes per cell
constexpr int kFeat = 8;                     // feature rows per cell
constexpr int kCell = kFeat * kLanes;        // floats per cell
constexpr int kCands = 9 * kLanes;           // candidates in a 3x3 halo block
constexpr int kSubs = kLanes / 32;           // 32-lane chunks of a cell
constexpr int kChunks = 9 * kSubs;           // 32-lane chunks of the block
constexpr int kCentre = 4 * kSubs;           // first chunk of the centre cell
constexpr int kValidRow = 4;
constexpr int kThreads = 128;                // a multiple of kLanes
constexpr int kMinBlocks = 8;                // CTAs an SM must hold (registers)
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                   // candidates a pair-loop step
constexpr int kCopies = kThreads / kLanes;   // threads that stage one lane
constexpr int kPer = (9 + kCopies - 1) / kCopies;  // halo cells a thread stages
static_assert(kChunks <= 64, "the prefix holds two chunks a lane");
static_assert(kThreads % kLanes == 0, "a thread stages one lane of a cell");

struct Consts {
  float wx, wz;          // world size, for the minimal image
  float hwx, hwz;        // half of it, up to which the image is the difference
                         // (-1 for a world that is not positive and finite)
  float r2, sep_r2;      // squared interaction and separation radii
  float w_sep, w_align, w_coh, max_accel;
};

struct Sums {
  float count, vx, vz, dx, dz, sep_x, sep_z;
};

// How the pair loop takes the minimal image (one choice for the whole CTA).
enum Image {
  kNone,     // no pair of the block crosses the seam: the image is d itself
  kShifted,  // per halo cell, every pair's image is d, d - w or d + w
  kTested,   // otherwise: each pair is tested
};

// The minimal image d - w * rint(d / w), taken where |d| > w / 2 only.
__device__ __forceinline__ float image(float d, float w, float hw) {
  return fabsf(d) > hw ? __fsub_rn(d, __fmul_rn(w, rintf(__fdiv_rn(d, w)))) : d;
}

struct Offset {
  float dx, dz, d2;
};

// The image offset of candidate o from query q. `shift` is the halo cell's
// (x, z) shift under kShifted: d - 0 is d, so an unshifted cell loses
// nothing.
template <Image kImage>
__device__ __forceinline__ Offset offset(float4 o, float4 q, float2 shift, const Consts& k) {
  float dx = __fsub_rn(o.x, q.x);
  float dz = __fsub_rn(o.y, q.y);
  if (kImage == kShifted) {
    dx = __fsub_rn(dx, shift.x);
    dz = __fsub_rn(dz, shift.y);
  } else if (kImage == kTested) {
    dx = image(dx, k.wx, k.hwx);
    dz = image(dz, k.wz, k.hwz);
  }
  return {dx, dz, __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dz, dz))};
}

// Adds candidate o at offset p to the sums if it is a neighbor.
__device__ __forceinline__ void add(float4 o, Offset p, bool other, const Consts& k, Sums& s) {
  if (!(p.d2 <= k.r2) || !other) return;
  s.count = __fadd_rn(s.count, 1.0f);
  s.vx = __fadd_rn(s.vx, o.z);
  s.vz = __fadd_rn(s.vz, o.w);
  s.dx = __fadd_rn(s.dx, p.dx);
  s.dz = __fadd_rn(s.dz, p.dz);
  if (p.d2 < k.sep_r2) {
    const float inv = __fdiv_rn(1.0f, __fadd_rn(p.d2, 1e-6f));
    s.sep_x = __fadd_rn(s.sep_x, __fmul_rn(p.dx, inv));
    s.sep_z = __fadd_rn(s.sep_z, __fmul_rn(p.dz, inv));
  }
}

// Adds the neighbors among list entries lo, lo + step, ... < hi of the
// query q (list position self when kSelf) to s, in that order; kUnroll
// candidates' offsets at a time.
template <Image kImage, bool kSelf>
__device__ __forceinline__ void walk(const float4* list, int lo, int hi, int step, int self,
                                     float4 q, float2 shift, const Consts& k, Sums& s) {
  int c = lo;
  for (; c + (kUnroll - 1) * step < hi; c += kUnroll * step) {
    float4 o[kUnroll];
    Offset p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      o[u] = list[c + u * step];
      p[u] = offset<kImage>(o[u], q, shift, k);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add(o[u], p[u], !kSelf || c + u * step != self, k, s);
  }
  for (; c < hi; c += step) {
    const float4 o = list[c];
    add(o, offset<kImage>(o, q, shift, k), !kSelf || c != self, k, s);
  }
}

__device__ __forceinline__ float add_across(float v, int s) {
  for (int m = s >> 1; m > 0; m >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

// The clamped acceleration of query q from its sums.
__device__ __forceinline__ float2 steer(const Sums& s, float4 q, const Consts& k) {
  const bool has_n = s.count > 0.0f;
  const float inv_count = has_n ? __fdiv_rn(1.0f, fmaxf(s.count, 1.0f)) : 0.0f;
  const float gate = has_n ? 1.0f : 0.0f;
  const float align_x = __fmul_rn(__fsub_rn(__fmul_rn(s.vx, inv_count), q.z), gate);
  const float align_z = __fmul_rn(__fsub_rn(__fmul_rn(s.vz, inv_count), q.w), gate);
  const float coh_x = __fmul_rn(s.dx, inv_count);
  const float coh_z = __fmul_rn(s.dz, inv_count);
  const float ax = __fadd_rn(__fadd_rn(__fmul_rn(k.w_sep, -s.sep_x), __fmul_rn(k.w_align, align_x)),
                             __fmul_rn(k.w_coh, coh_x));
  const float az = __fadd_rn(__fadd_rn(__fmul_rn(k.w_sep, -s.sep_z), __fmul_rn(k.w_align, align_z)),
                             __fmul_rn(k.w_coh, coh_z));
  const float a2 = __fadd_rn(__fmul_rn(ax, ax), __fmul_rn(az, az));
  const float rs = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(a2, 1e-12f)));
  const float scale = fminf(1.0f, __fmul_rn(k.max_accel, rs));
  return make_float2(__fmul_rn(ax, scale), __fmul_rn(az, scale));
}

// Where the list's runs start: cell[b] for halo cell b (cell[9] is the
// list's length); the queries are the run of cell 4.
struct Layout {
  int cell[10];
};

// Steers the cell's queries over the whole list and writes their
// accelerations to dst. Under kShifted the list is walked halo cell by halo
// cell, each with its shift; otherwise in one run.
template <Image kImage>
__device__ __forceinline__ void steer_queries(const float4* list, const Layout& at,
                                              const float2* shift, const unsigned char* qlane,
                                              float* dst, const Consts& k) {
  const int t = threadIdx.x;
  const int q0 = at.cell[4];
  const int nq = at.cell[5] - q0;
  int log_s = 5;  // s = 1 << log_s lanes a query
  while (log_s > 0 && (nq << log_s) > kThreads) --log_s;
  const int s = 1 << log_s;
  const int r = t & (s - 1);
  for (int base = 0; base < nq; base += kThreads >> log_s) {
    if (base + ((t & ~31) >> log_s) >= nq) break;  // uniform: the warp has no query
    const int qi = base + (t >> log_s);
    Sums acc{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (qi < nq) {
      const int self = q0 + qi;
      q = list[self];
      if (kImage == kShifted) {
#pragma unroll
        for (int b = 0; b < 9; ++b) {
          if (b == 4) {
            walk<kImage, true>(list, at.cell[b] + r, at.cell[b + 1], s, self, q, shift[b], k, acc);
          } else {
            walk<kImage, false>(list, at.cell[b] + r, at.cell[b + 1], s, self, q, shift[b], k, acc);
          }
        }
      } else {
        walk<kImage, true>(list, at.cell[0] + r, at.cell[9], s, self, q, make_float2(0.0f, 0.0f),
                           k, acc);
      }
    }
    if (s > 1) {  // uniform: every lane of the warp takes part
      acc.count = add_across(acc.count, s);
      acc.vx = add_across(acc.vx, s);
      acc.vz = add_across(acc.vz, s);
      acc.dx = add_across(acc.dx, s);
      acc.dz = add_across(acc.dz, s);
      acc.sep_x = add_across(acc.sep_x, s);
      acc.sep_z = add_across(acc.sep_z, s);
    }
    if (qi < nq && r == 0) {
      const float2 a = steer(acc, q, k);
      const int lane = qlane[qi];
      dst[lane] = a.x;
      dst[kLanes + lane] = a.y;
    }
  }
}

// An int that orders as the float does (for any float but NaN), and back.
__device__ __forceinline__ int order_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ INT_MAX;
}
__device__ __forceinline__ float from_key(int i) {
  return __int_as_float(i >= 0 ? i : i ^ INT_MAX);
}

// The shift that takes every pair of candidates in [c_lo, c_hi] and queries
// in [q_lo, q_hi] to its minimal image along one axis, if there is one: 0
// where every difference lies within w/2; w where every difference's
// quotient by w rounds into (0.5, 1.5), so rint gives 1; -w where it gives
// -1. Differences and quotients are rounded as any pair's are, and rounding
// keeps order, so the bounds hold for each pair. Returns false if the pairs
// need the test (or a bound is NaN).
__device__ __forceinline__ bool axis_shift(float c_lo, float c_hi, float q_lo, float q_hi,
                                           float w, float hw, float& shift) {
  const float lo = __fsub_rn(c_lo, q_hi);
  const float hi = __fsub_rn(c_hi, q_lo);
  shift = 0.0f;
  if (lo >= -hw && hi <= hw) return true;
  if (!(hw > 0.0f)) return false;
  const float q_min = __fdiv_rn(lo, w);
  const float q_max = __fdiv_rn(hi, w);
  shift = w;
  if (q_min > 0.5f && q_max < 1.5f) return true;
  shift = -w;
  return q_max < -0.5f && q_min > -1.5f;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
boids_accel_kernel(const float* __restrict__ cells, float* __restrict__ out,
                   int gx, Consts k) {
  __shared__ float4 list[kCands];          // occupied candidates, in order
  __shared__ unsigned ballot[kChunks];     // occupied lanes of each chunk
  __shared__ unsigned char qlane[kLanes];  // lane of each query
  __shared__ int extent[10][4];            // keys of max -x, x, -z, z: per halo
                                           // cell, then of the whole block
  __shared__ float2 shifts[kWarps][9];     // each warp's copy of the cells' shifts
  __shared__ Layout runs;

  const int j = blockIdx.x;
  const int i = blockIdx.y;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;

  // Thread t stages lane l = t % 128, in chunk sub = l / 32, of the halo
  // cells b = part, part + kCopies, ... (b = 3 * di + dj; with 128 threads,
  // of all nine): the valid rows, then x, z, vx and vz of the occupied lanes
  // alone, all in flight at once and across the first barrier.
  const int part = kCopies == 1 ? 0 : t / kLanes;
  const int l = kCopies == 1 ? t : t % kLanes;
  const int sub = l >> 5;
  const float* mine = cells + (static_cast<long long>(i) * (gx + 2) + j) * kCell + l;
  auto cell = [&](int b) { return mine + ((b / 3) * (gx + 2) + b % 3) * kCell; };
  if (t < 40) extent[t >> 2][t & 3] = INT_MIN;
  float v[kPer];
#pragma unroll
  for (int n = 0; n < kPer; ++n) {
    const int b = part + kCopies * n;
    v[n] = b < 9 ? cell(b)[kValidRow * kLanes] : 0.0f;
  }
  float4 kin[kPer];
#pragma unroll
  for (int n = 0; n < kPer; ++n) {
    const int b = part + kCopies * n;
    if (b >= 9) break;  // uniform
    const unsigned bal = __ballot_sync(0xffffffffu, v[n] > 0.0f);
    if (lane == 0) ballot[kSubs * b + sub] = bal;
    if (bal >> lane & 1u) {
      const float* src = cell(b);
      kin[n] = make_float4(src[0], src[kLanes], src[2 * kLanes], src[3 * kLanes]);
    }
  }
  __syncthreads();

  // Every warp takes the exclusive prefix over the chunks' popcounts (two
  // chunks a lane); the list position of chunk ch is start(ch).
  const int c0 = 2 * lane < kChunks ? __popc(ballot[2 * lane]) : 0;
  const int c1 = 2 * lane + 1 < kChunks ? __popc(ballot[2 * lane + 1]) : 0;
  int incl = c0 + c1;
  for (int m = 1; m < 32; m <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, m);
    if (lane >= m) incl += up;
  }
  const int even = incl - c0 - c1;  // list position of chunk 2 * lane
  const int odd = even + c0;         // and of chunk 2 * lane + 1
  auto start = [&](int ch) {  // uniform across the warp
    return __shfl_sync(0xffffffffu, (ch & 1) ? odd : even, ch >> 1);
  };
  Layout at;
#pragma unroll
  for (int b = 0; b < 9; ++b) at.cell[b] = start(b * kSubs);
  at.cell[9] = __shfl_sync(0xffffffffu, incl, 31);
  if (t == 0) runs = at;

  // Scatter the occupied candidates into the list, note each query's lane,
  // take the block's extent of x and z, and write the empty lanes' zeros.
  int key[4] = {INT_MIN, INT_MIN, INT_MIN, INT_MIN};
#pragma unroll
  for (int n = 0; n < kPer; ++n) {
    const int b = part + kCopies * n;
    if (b >= 9) break;  // uniform
    const unsigned occ = ballot[kSubs * b + sub];  // this warp's ballot
    if (occ == 0u) continue;  // uniform
    const int pos = start(kSubs * b + sub) + __popc(occ & ((1u << lane) - 1u));
    if (occ >> lane & 1u) {
      list[pos] = kin[n];
      if (b == 4) qlane[pos - at.cell[4]] = static_cast<unsigned char>(l);
      key[0] = max(key[0], order_key(-kin[n].x));
      key[1] = max(key[1], order_key(kin[n].x));
      key[2] = max(key[2], order_key(-kin[n].y));
      key[3] = max(key[3], order_key(kin[n].y));
    }
  }
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int top = __reduce_max_sync(0xffffffffu, key[f]);
    if (lane == 0) atomicMax(&extent[9][f], top);
  }
  float* dst = out + (static_cast<long long>(i) * gx + j) * 2 * kLanes;
  if (part == 0 && !(ballot[kCentre + sub] >> lane & 1u)) {
    dst[l] = 0.0f;
    dst[kLanes + l] = 0.0f;
  }
  __syncthreads();
  if (at.cell[5] == at.cell[4]) return;  // uniform: no queries

  // The image. Where the block's occupied x and z span at most half the
  // world, no pair crosses the seam (max - min rounds to at least any
  // difference of two of them). Otherwise each halo cell's extent against
  // the queries' gives its shift, or calls for the test.
  if (!(__fadd_rn(from_key(extent[9][1]), from_key(extent[9][0])) <= k.hwx &&
        __fadd_rn(from_key(extent[9][3]), from_key(extent[9][2])) <= k.hwz)) {
    for (int b = warp; b < 9; b += kWarps) {  // uniform
      int e[4] = {INT_MIN, INT_MIN, INT_MIN, INT_MIN};
      const int end = b == 8 ? at.cell[9] : start(4 * b + 4);
      for (int c = start(4 * b) + lane; c < end; c += 32) {
        const float4 o = list[c];
        e[0] = max(e[0], order_key(-o.x));
        e[1] = max(e[1], order_key(o.x));
        e[2] = max(e[2], order_key(-o.y));
        e[3] = max(e[3], order_key(o.y));
      }
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int top = __reduce_max_sync(0xffffffffu, e[f]);
        if (lane == 0) extent[b][f] = top;
      }
    }
    __syncthreads();  // uniform: every thread read the same extent
    bool tested = false, shifted = false;
    if (lane < 9) {
      float2 sh = make_float2(0.0f, 0.0f);
      if (extent[lane][1] != INT_MIN) {  // the cell holds agents
        const int* c = extent[lane];
        const int* q = extent[4];
        tested = !axis_shift(-from_key(c[0]), from_key(c[1]), -from_key(q[0]), from_key(q[1]),
                             k.wx, k.hwx, sh.x) ||
                 !axis_shift(-from_key(c[2]), from_key(c[3]), -from_key(q[2]), from_key(q[3]),
                             k.wz, k.hwz, sh.y);
      }
      shifted = sh.x != 0.0f || sh.y != 0.0f;
      shifts[warp][lane] = sh;
    }
    __syncwarp();
    if (__any_sync(0xffffffffu, tested)) {
      steer_queries<kTested>(list, runs, shifts[warp], qlane, dst, k);
      return;
    }
    if (__any_sync(0xffffffffu, shifted)) {
      steer_queries<kShifted>(list, runs, shifts[warp], qlane, dst, k);
      return;
    }
  }
  steer_queries<kNone>(list, runs, shifts[warp], qlane, dst, k);
}

// Half of a world side; -1 where the side is not positive and finite (the
// image is then taken for every pair, as the formula gives it).
float half_world(float w) { return w > 0.0f && w <= FLT_MAX ? 0.5f * w : -1.0f; }

}  // namespace

// Launches the kernel on `stream` over the grid (gx, gz). cells: f32[gz+2,
// gx+2, 8, 128]; out: f32[gz, gx, 2, 128]. The floats are the step's
// constants, already rounded to f32 by the caller. Returns the cudaError_t of
// the launch.
extern "C" int gw_boids_accel(const float* cells, float* out, int gz, int gx,
                              float wx, float wz, float r2, float sep_r2,
                              float w_sep, float w_align, float w_coh,
                              float max_accel, void* stream) {
  if (gz <= 0 || gx <= 0 || gz > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Consts k{wx, wz, half_world(wx), half_world(wz),
                 r2, sep_r2, w_sep, w_align, w_coh, max_accel};
  const dim3 grid(gx, gz);
  boids_accel_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(cells, out, gx, k);
  return static_cast<int>(cudaGetLastError());
}
