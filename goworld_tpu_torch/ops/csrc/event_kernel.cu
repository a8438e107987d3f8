// AOI event kernel for Hopper (sm_90a): the packed enter/leave masks of one
// neighbor-engine tick.
//
// Replaces goworld_tpu/ops/neighbor.py::_event_kernel, the Pallas TPU kernel,
// in its two forms without the in-kernel drain: single (dual=False) and dual
// (dual=True). The row and column extents are launch arguments, so a slab of
// the grid (the sharded engines' geometries) runs the same code.
//
// What it computes. The input is the dense cell layout
// f32[S, rows+2, cols+2, 8, 128] with a halo ring: per cell, 8 feature rows
// (x, z, space, radius of epoch A, then of epoch B) by 128 lanes, NaN x in an
// empty lane. One CTA handles one cell (s, i, j) and one thread one query lane
// of it. For each of the 1152 candidates c of the cell's 3x3 halo block
// (c = (3*di + dj) * 128 + lane) and each epoch E:
//     valid_E = space_q == space_c && dx*dx + dz*dz <= r_q*r_q && c != self
// with dx = x_c - x_q, dz = z_c - z_q. Output word w of a query row holds the
// 16 bits of candidates [16w, 16w+16): words [0, 72) are valid_A && !valid_B,
// and in the dual form words [72, 144) are valid_B && !valid_A. An empty lane's
// NaN x makes d2 NaN, and NaN <= r2 is false, so it never takes part.
//
// Exactness. The products and sums are rounded one by one (__fsub_rn,
// __fmul_rn, __fadd_rn, and the build passes --fmad=false), never contracted
// into an FMA: the plain PyTorch version rounds the same way, so the two agree
// bit for bit at d2 == r2. Never build this with --use_fast_math.
//
// What bounds it on an H100. Per cell it reads 36,864 B of halo (each cell is
// read by 9 CTAs, mostly from L2; device memory sees the input once) and
// writes 36,864 B (dual) or 18,432 B (single), and it evaluates
// 128 x 1152 pairs x 2 epochs x 7 FP32 operations. At the 44x44-cell grid
// that is ~151 MB (45 us at 3.35 TB/s) against ~4.0 G FP32 instructions
// (120 us at 33.5 T/s, the 67 TFLOP/s peak with an FMA counted as two
// operations; this kernel issues no FMA): the arithmetic bounds it.
// The design keeps the pair arithmetic lean: the halo is staged once in
// shared memory as [candidate][8 features], so a candidate is two broadcast
// 16-byte loads shared by the whole warp; the query's features stay in
// registers; the self pair is cleared once per word instead of tested per
// pair; 16 candidate bits accumulate in a register word and four words leave
// as one 16-byte store.
//
// Left for later: the output rows are 288 or 576 B apart, so a warp's stores
// are strided; staging them through shared memory, TMA for the halo, and
// persistent CTAs are the next steps.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;           // query lanes per cell
constexpr int kFeat = 8;              // feature rows per cell
constexpr int kCands = 9 * kLanes;    // candidates in a 3x3 halo block
constexpr int kPack = 16;             // candidate bits per output word
constexpr int kWords = kCands / kPack;  // 72 words per mask

__device__ __forceinline__ bool pair_valid(float4 q, float r2, float4 c) {
  // q and c are (x, z, space, radius) of one epoch.
  const float dx = __fsub_rn(c.x, q.x);
  const float dz = __fsub_rn(c.y, q.y);
  const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dz, dz));
  return (q.z == c.z) & (d2 <= r2);
}

template <bool kDual>
__global__ void __launch_bounds__(kLanes)
event_mask_kernel(const float* __restrict__ cells, int* __restrict__ out,
                  const unsigned char* __restrict__ skip, int rows, int cols) {
  if (skip != nullptr && *skip) return;
  // [candidate][0] = epoch A (x, z, space, radius), [candidate][1] = epoch B.
  __shared__ float4 halo[kCands][2];

  const int j = blockIdx.x;
  const int i = blockIdx.y;
  const int s = blockIdx.z;
  const int t = threadIdx.x;

  // Stage the 3x3 block: halo row di is three consecutive cells in memory.
  constexpr int kCell = kFeat * kLanes;
  for (int di = 0; di < 3; ++di) {
    const float* src =
        cells + ((static_cast<long long>(s) * (rows + 2) + i + di) * (cols + 2) + j) * kCell;
    for (int e = t; e < 3 * kCell; e += kLanes) {
      const int dj = e / kCell;
      const int f = (e / kLanes) % kFeat;
      const int lane = e % kLanes;
      const int c = (3 * di + dj) * kLanes + lane;
      reinterpret_cast<float*>(&halo[c][0])[f] = src[e];
    }
  }
  __syncthreads();

  const int self_c = 4 * kLanes + t;  // the centre cell is block 4
  const float4 qa = halo[self_c][0];
  const float4 qb = halo[self_c][1];
  const float r2a = __fmul_rn(qa.w, qa.w);
  const float r2b = __fmul_rn(qb.w, qb.w);

  constexpr int kRow = kDual ? 2 * kWords : kWords;
  int* dst = out + ((static_cast<long long>(s) * rows + i) * cols + j) * kLanes * kRow +
             static_cast<long long>(t) * kRow;

  for (int w0 = 0; w0 < kWords; w0 += 4) {
    int enter[4];
    int leave[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int e = 0;
      int l = 0;
      const int c0 = (w0 + k) * kPack;
#pragma unroll
      for (int b = 0; b < kPack; ++b) {
        const float4 ca = halo[c0 + b][0];
        const float4 cb = halo[c0 + b][1];
        const bool va = pair_valid(qa, r2a, ca);
        const bool vb = pair_valid(qb, r2b, cb);
        e |= static_cast<int>(va & !vb) << b;
        if (kDual) l |= static_cast<int>(vb & !va) << b;
      }
      // A query is never its own candidate: clear the self bit.
      if (self_c >= c0 && self_c < c0 + kPack) {
        const int keep = ~(1 << (self_c - c0));
        e &= keep;
        l &= keep;
      }
      enter[k] = e;
      leave[k] = l;
    }
    *reinterpret_cast<int4*>(dst + w0) = make_int4(enter[0], enter[1], enter[2], enter[3]);
    if (kDual) {
      *reinterpret_cast<int4*>(dst + kWords + w0) =
          make_int4(leave[0], leave[1], leave[2], leave[3]);
    }
  }
}

}  // namespace

// Launches the kernel on `stream` over the grid (cols, rows, slots).
// cells: f32[slots, rows+2, cols+2, 8, 128]; out: i32[slots, rows, cols, 128,
// 72 or 144]; skip: one byte on the device, or null; when it holds a nonzero
// byte every CTA returns at once and `out` is left unwritten. Returns the
// cudaError_t of the launch.
extern "C" int gw_event_mask(const float* cells, int* out, const unsigned char* skip,
                             int slots, int rows, int cols, int dual, void* stream) {
  if (slots <= 0 || rows <= 0 || cols <= 0 || slots > 65535 || rows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(cols, rows, slots);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dual) {
    event_mask_kernel<true><<<grid, kLanes, 0, st>>>(cells, out, skip, rows, cols);
  } else {
    event_mask_kernel<false><<<grid, kLanes, 0, st>>>(cells, out, skip, rows, cols);
  }
  return static_cast<int>(cudaGetLastError());
}
