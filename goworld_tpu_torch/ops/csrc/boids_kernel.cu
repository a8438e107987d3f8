// Boids steering kernel for Hopper (sm_90a): the clamped flocking
// acceleration of every agent of one boids step.
//
// Replaces goworld_tpu/ops/boids.py::_boids_kernel, the Pallas TPU kernel
// built by _compiled_accel.
//
// What it computes. The input is the dense cell layout f32[gz+2, gx+2, 8, 128]
// with a wrapped halo ring: per cell, feature rows x, z, vx, vz, valid (then 3
// spare rows) by 128 lanes. An empty lane carries another agent's x, z, vx and
// vz and a valid row of 0, so only the valid row decides who takes part. One
// CTA handles one cell (i, j) and one thread one query lane q of it. Over the
// 1152 candidates c of the cell's 3x3 halo block (c = (3*di + dj) * 128 +
// lane), a candidate is a neighbor when
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
// written to out f32[gz, gx, 2, 128] (ax in row 0, az in row 1).
//
// Arithmetic. Each operation is rounded on its own (the __f*_rn intrinsics,
// and the build passes --fmad=false), as the plain PyTorch version and the
// Pallas body round them. rint rounds half to even, as jnp.round does. The
// division by the world size is an IEEE division: a reciprocal multiply would
// move the image at |dx| = wx/2. The rsqrt is 1 / sqrt(x) with both steps
// correctly rounded (__fsqrt_rn, __fdiv_rn), not the approximate rsqrtf.
// Never build this with --use_fast_math. The sums run in candidate order, the
// plain version's and the TPU's in another order, so the outputs differ by
// rounding (a few 1e-6 at the test sizes).
//
// What bounds it on an H100. It reads the cells once (each cell from 9 CTAs,
// mostly out of L2) and writes 1 KB a cell. It does 14 FP32 operations for
// each pair of an occupied query and another occupied candidate (counting an
// IEEE division as one, though it issues as a short sequence), 6 more for each
// pair in range, 6 more for each close pair, and 33 per occupied query after
// the loop. Which of the bytes and the operations bounds it depends on how
// many agents a cell holds; chip_smoke.py computes both from the run's cells
// (OPS_PER_* there). The design: the halo's five used rows are staged once in 23,040 B
// of shared memory as one float4 (x, z, vx, vz) and one valid flag per
// candidate, so all threads of a warp read the same candidate in one
// broadcast; an empty candidate is skipped by a branch that is uniform across
// the warp; a thread of an empty query lane does no pair work, so a warp whose
// 32 lanes are all empty finishes at once.
//
// Left for later: the 128 threads of a cell still walk every candidate when a
// few lanes hold agents; packing several sparse cells into one CTA, or cells
// of fewer lanes, is the next step.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;         // query lanes per cell
constexpr int kFeat = 8;            // feature rows per cell
constexpr int kCands = 9 * kLanes;  // candidates in a 3x3 halo block
constexpr int kCell = kFeat * kLanes;
constexpr int kValidRow = 4;

struct Consts {
  float wx, wz;        // world size, for the minimal image
  float r2, sep_r2;    // squared interaction and separation radii
  float w_sep, w_align, w_coh, max_accel;
};

__device__ __forceinline__ float min_image(float d, float w) {
  return __fsub_rn(d, __fmul_rn(w, rintf(__fdiv_rn(d, w))));
}

__global__ void __launch_bounds__(kLanes)
boids_accel_kernel(const float* __restrict__ cells, float* __restrict__ out,
                   int gx, Consts k) {
  __shared__ float4 kin[kCands];   // (x, z, vx, vz) of each candidate
  __shared__ float valid[kCands];

  const int j = blockIdx.x;
  const int i = blockIdx.y;
  const int t = threadIdx.x;

  // Stage the 3x3 block: halo row di is three consecutive cells in memory.
  for (int di = 0; di < 3; ++di) {
    const float* row = cells + (static_cast<long long>(i + di) * (gx + 2) + j) * kCell;
    for (int dj = 0; dj < 3; ++dj) {
      const float* cell = row + dj * kCell;
      const int c = (3 * di + dj) * kLanes + t;
      kin[c] = make_float4(cell[t], cell[kLanes + t], cell[2 * kLanes + t],
                           cell[3 * kLanes + t]);
      valid[c] = cell[kValidRow * kLanes + t];
    }
  }
  __syncthreads();

  const int self_c = 4 * kLanes + t;  // the centre cell is block 4
  const float4 q = kin[self_c];
  float count = 0.0f;
  float sep_x = 0.0f, sep_z = 0.0f;
  float sum_vx = 0.0f, sum_vz = 0.0f;
  float sum_dx = 0.0f, sum_dz = 0.0f;
  if (valid[self_c] > 0.0f) {
    for (int c = 0; c < kCands; ++c) {
      if (!(valid[c] > 0.0f) || c == self_c) continue;
      const float4 o = kin[c];
      const float dx = min_image(__fsub_rn(o.x, q.x), k.wx);
      const float dz = min_image(__fsub_rn(o.y, q.y), k.wz);
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dz, dz));
      if (!(d2 <= k.r2)) continue;
      count = __fadd_rn(count, 1.0f);
      sum_vx = __fadd_rn(sum_vx, o.z);
      sum_vz = __fadd_rn(sum_vz, o.w);
      sum_dx = __fadd_rn(sum_dx, dx);
      sum_dz = __fadd_rn(sum_dz, dz);
      if (d2 < k.sep_r2) {
        const float inv = __fdiv_rn(1.0f, __fadd_rn(d2, 1e-6f));
        sep_x = __fadd_rn(sep_x, __fmul_rn(dx, inv));
        sep_z = __fadd_rn(sep_z, __fmul_rn(dz, inv));
      }
    }
  }

  const bool has_n = count > 0.0f;
  const float inv_count = has_n ? __fdiv_rn(1.0f, fmaxf(count, 1.0f)) : 0.0f;
  const float gate = has_n ? 1.0f : 0.0f;
  const float align_x = __fmul_rn(__fsub_rn(__fmul_rn(sum_vx, inv_count), q.z), gate);
  const float align_z = __fmul_rn(__fsub_rn(__fmul_rn(sum_vz, inv_count), q.w), gate);
  const float coh_x = __fmul_rn(sum_dx, inv_count);
  const float coh_z = __fmul_rn(sum_dz, inv_count);
  const float ax = __fadd_rn(__fadd_rn(__fmul_rn(k.w_sep, -sep_x), __fmul_rn(k.w_align, align_x)),
                             __fmul_rn(k.w_coh, coh_x));
  const float az = __fadd_rn(__fadd_rn(__fmul_rn(k.w_sep, -sep_z), __fmul_rn(k.w_align, align_z)),
                             __fmul_rn(k.w_coh, coh_z));
  const float a2 = __fadd_rn(__fmul_rn(ax, ax), __fmul_rn(az, az));
  const float rs = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(a2, 1e-12f)));
  const float scale = fminf(1.0f, __fmul_rn(k.max_accel, rs));

  float* dst = out + (static_cast<long long>(i) * gx + j) * 2 * kLanes;
  dst[t] = __fmul_rn(ax, scale);
  dst[kLanes + t] = __fmul_rn(az, scale);
}

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
  const Consts k{wx, wz, r2, sep_r2, w_sep, w_align, w_coh, max_accel};
  const dim3 grid(gx, gz);
  boids_accel_kernel<<<grid, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(cells, out, gx, k);
  return static_cast<int>(cudaGetLastError());
}
