// AOI event kernel for Hopper (sm_90a): the packed enter/leave masks of one
// neighbor-engine tick.
//
// Replaces goworld_tpu/ops/neighbor.py::_event_kernel, the Pallas TPU kernel,
// in all its forms: single (dual=False) and dual (dual=True), each without
// (gw_event_mask) and with (gw_event_drain) the in-kernel drain. The row and
// column extents are launch arguments, so a slab of the grid (the strip
// tier's geometry, parallel/spatial.py) runs the same code.
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
// 128 x 1152 pairs x 2 epochs x 7 FP32 operations, of which only the
// occupied query lanes' are needed (an empty lane's words are zero). At
// the 44x44-cell grid of 102,400 entities that is ~151 MB (45 us at
// 3.35 TB/s) against ~1.65 G needed FP32 instructions (49 us at 33.5 T/s,
// the 67 TFLOP/s peak with an FMA counted as two operations; this kernel
// issues no FMA): the arithmetic bounds it, narrowly.
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
//
// The drain form (gw_event_drain, _event_kernel with drain_inline = D > 0).
// A second input, the slot/own plane i32[S, rows+2, cols+2, 2, 128], holds
// each tabled lane's slot id (plane 0, sentinel `capacity` in empty lanes)
// and own flag (plane 1). The kernel appends the (query slot, other slot)
// pair of every event of an OWN query lane to pairs i32[2, cap+1] (row 0
// query, row 1 other, prefilled with `capacity`): enters fill columns
// [0, D), and in the dual form leaves fill [D, 2D). The order is the TPU
// kernel's: cell-major over (s, i, j), then query lane, then candidate c
// ascending. The TPU grid runs cells in sequence and keeps the two cursors
// as SMEM scalars; a Hopper grid runs in parallel, so the cursors become
// count -> exclusive scan -> write, with no global atomics (which would
// give a nondeterministic order):
//   pass 1, count: the mask kernel, which also writes each cell's own-lane
//     enter and leave counts (a block reduction of per-lane popcounts) and
//     prefills the pairs with the sentinel;
//   pass 2, scan: one CTA scans the per-cell counts into 64-bit exclusive
//     offsets, 1024 cells a step;
//   pass 3, write: one CTA per cell reads its words back, block-scans its
//     128 own lanes' popcounts, and each lane writes its pairs at
//     offset + rank while that is below D; a cell whose offset is past D in
//     every region returns at once.
// An event past its region's end is not written. The TPU kernel sends it to
// the trailing trash column instead; that column is never read (the caller
// slices the regions), and here it keeps the sentinel. The drain adds
// ~6 B per cell of scratch traffic and the words' second read (mostly from
// L2) to the mask kernel's work. On a strip slab, whose static width leaves
// many columns empty, the dual form's bytes bound it and the single form's
// needed arithmetic, narrowly, bounds that one.

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

// What the count pass adds to the mask kernel (null in the mask forms).
struct DrainCount {
  const int* plane;  // i32[S, rows+2, cols+2, 2, 128] slot/own plane
  int* counts;       // i32[cells, 2]: own-lane enter and leave events
  int* pairs;        // i32[2 * pairs_cols], prefilled with `sentinel`
  int pairs_cols;    // cap + 1
  int sentinel;      // the capacity
};

__device__ __forceinline__ long long plane_offset(int s, int r, int c, int rows,
                                                  int cols) {
  // Start of cell (r, c) of slot s in the plane, padded geometry.
  return ((static_cast<long long>(s) * (rows + 2) + r) * (cols + 2) + c) * 2 * kLanes;
}

template <bool kDual, bool kCount>
__global__ void __launch_bounds__(kLanes)
event_mask_kernel(const float* __restrict__ cells, int* __restrict__ out,
                  const unsigned char* __restrict__ skip, int rows, int cols,
                  DrainCount drain) {
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

  int n_enter = 0;  // this lane's events, for the count pass
  int n_leave = 0;
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
      if (kCount) {
        n_enter += __popc(e);
        n_leave += __popc(l);
      }
    }
    *reinterpret_cast<int4*>(dst + w0) = make_int4(enter[0], enter[1], enter[2], enter[3]);
    if (kDual) {
      *reinterpret_cast<int4*>(dst + kWords + w0) =
          make_int4(leave[0], leave[1], leave[2], leave[3]);
    }
  }
  if (!kCount) return;

  // Count pass: the cell's own-lane events, summed over the block.
  const int lin = (s * rows + i) * cols + j;
  const bool own = drain.plane[plane_offset(s, i + 1, j + 1, rows, cols) + kLanes + t] > 0;
  if (!own) n_enter = n_leave = 0;
  for (int o = 16; o > 0; o >>= 1) {
    n_enter += __shfl_down_sync(0xffffffffu, n_enter, o);
    n_leave += __shfl_down_sync(0xffffffffu, n_leave, o);
  }
  __shared__ int warp_sum[kLanes / 32][2];
  if ((t & 31) == 0) {
    warp_sum[t >> 5][0] = n_enter;
    warp_sum[t >> 5][1] = n_leave;
  }
  __syncthreads();
  if (t == 0) {
    int e = 0;
    int l = 0;
    for (int w = 0; w < kLanes / 32; ++w) {
      e += warp_sum[w][0];
      l += warp_sum[w][1];
    }
    drain.counts[2 * lin] = e;
    drain.counts[2 * lin + 1] = l;
  }
  // The sentinel prefill of the pairs, spread over the grid.
  const long long n_threads =
      static_cast<long long>(gridDim.x) * gridDim.y * gridDim.z * kLanes;
  for (long long k = static_cast<long long>(lin) * kLanes + t; k < 2LL * drain.pairs_cols;
       k += n_threads) {
    drain.pairs[k] = drain.sentinel;
  }
}

constexpr int kScanThreads = 1024;

// Pass 2: exclusive scan of the per-cell counts (both regions) in one CTA,
// kScanThreads cells a step: a warp scan, a scan of the warp totals, and a
// carry across steps.
__global__ void __launch_bounds__(kScanThreads)
drain_scan_kernel(const int* __restrict__ counts, long long* __restrict__ offsets,
                  const unsigned char* __restrict__ skip, int n_cells) {
  if (skip != nullptr && *skip) return;
  __shared__ long long warp_tot[kScanThreads / 32][2];
  __shared__ long long carry[2];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) carry[0] = carry[1] = 0;
  __syncthreads();
  for (int base = 0; base < n_cells; base += kScanThreads) {
    const int c = base + t;
    const long long v0 = c < n_cells ? counts[2 * c] : 0;
    const long long v1 = c < n_cells ? counts[2 * c + 1] : 0;
    long long s0 = v0;
    long long s1 = v1;
    for (int o = 1; o < 32; o <<= 1) {
      const long long y0 = __shfl_up_sync(0xffffffffu, s0, o);
      const long long y1 = __shfl_up_sync(0xffffffffu, s1, o);
      if (lane >= o) {
        s0 += y0;
        s1 += y1;
      }
    }
    if (lane == 31) {
      warp_tot[warp][0] = s0;
      warp_tot[warp][1] = s1;
    }
    __syncthreads();
    if (warp == 0) {
      long long w0 = warp_tot[lane][0];
      long long w1 = warp_tot[lane][1];
      for (int o = 1; o < 32; o <<= 1) {
        const long long y0 = __shfl_up_sync(0xffffffffu, w0, o);
        const long long y1 = __shfl_up_sync(0xffffffffu, w1, o);
        if (lane >= o) {
          w0 += y0;
          w1 += y1;
        }
      }
      warp_tot[lane][0] = w0;  // inclusive over warps
      warp_tot[lane][1] = w1;
    }
    __syncthreads();
    const long long before0 = warp > 0 ? warp_tot[warp - 1][0] : 0;
    const long long before1 = warp > 0 ? warp_tot[warp - 1][1] : 0;
    if (c < n_cells) {
      offsets[2 * c] = carry[0] + before0 + s0 - v0;
      offsets[2 * c + 1] = carry[1] + before1 + s1 - v1;
    }
    __syncthreads();
    if (t == 0) {
      carry[0] += warp_tot[kScanThreads / 32 - 1][0];
      carry[1] += warp_tot[kScanThreads / 32 - 1][1];
    }
    __syncthreads();
  }
}

// Exclusive scan of one int per thread over the 128-thread block.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_tot) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[t >> 5] = x;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < (t >> 5); ++w) before += warp_tot[w];
  __syncthreads();  // warp_tot is reused by the next call
  return before + x - v;
}

// Pass 3: one CTA per cell, one thread per query lane. Lane t's events of
// one region are the set bits of its words, word ascending and bit
// ascending, which is candidate order; they land at the cell's offset plus
// the own events of lanes < t.
template <bool kDual>
__global__ void __launch_bounds__(kLanes)
drain_write_kernel(const int* __restrict__ words, const int* __restrict__ plane,
                   const long long* __restrict__ offsets,
                   const unsigned char* __restrict__ skip, int* __restrict__ pairs,
                   int rows, int cols, int drain, int pairs_cols) {
  if (skip != nullptr && *skip) return;
  const int j = blockIdx.x;
  const int i = blockIdx.y;
  const int s = blockIdx.z;
  const int t = threadIdx.x;
  const int lin = (s * rows + i) * cols + j;
  constexpr int kRegions = kDual ? 2 : 1;
  long long cell_off[kRegions];
  bool any = false;
  for (int r = 0; r < kRegions; ++r) {
    cell_off[r] = offsets[2 * lin + r];
    any |= cell_off[r] < drain;
  }
  if (!any) return;  // every event of this cell lies past its region

  // The candidates' slot ids: halo block (di, dj) lane l sits at
  // c = (3*di + dj)*128 + l, the candidate index itself.
  __shared__ int slot9[kCands];
  __shared__ int warp_tot[kLanes / 32];
  for (int di = 0; di < 3; ++di) {
    for (int dj = 0; dj < 3; ++dj) {
      slot9[(3 * di + dj) * kLanes + t] = plane[plane_offset(s, i + di, j + dj, rows, cols) + t];
    }
  }
  const bool own = plane[plane_offset(s, i + 1, j + 1, rows, cols) + kLanes + t] > 0;
  __syncthreads();
  const int q_slot = slot9[4 * kLanes + t];
  constexpr int kRow = kDual ? 2 * kWords : kWords;
  const int* row = words + (static_cast<long long>(lin) * kLanes + t) * kRow;

  for (int r = 0; r < kRegions; ++r) {
    if (cell_off[r] >= drain) continue;  // uniform over the block
    const int* rw = row + r * kWords;
    int n = 0;
    if (own) {
      for (int w = 0; w < kWords; ++w) n += __popc(rw[w]);
    }
    long long pos = cell_off[r] + block_exclusive_scan(n, warp_tot);
    if (n == 0 || pos >= drain) continue;
    int* q_out = pairs + static_cast<long long>(r) * drain;
    int* o_out = q_out + pairs_cols;
    for (int w = 0; w < kWords && pos < drain; ++w) {
      unsigned bits = static_cast<unsigned>(rw[w]);
      while (bits != 0u && pos < drain) {
        const int c = w * kPack + __ffs(bits) - 1;
        bits &= bits - 1u;
        q_out[pos] = q_slot;
        o_out[pos] = slot9[c];
        ++pos;
      }
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
  const DrainCount none = {nullptr, nullptr, nullptr, 0, 0};
  if (dual) {
    event_mask_kernel<true, false><<<grid, kLanes, 0, st>>>(cells, out, skip, rows, cols, none);
  } else {
    event_mask_kernel<false, false><<<grid, kLanes, 0, st>>>(cells, out, skip, rows, cols, none);
  }
  return static_cast<int>(cudaGetLastError());
}

// The drain form: the three passes on `stream`, each checked at launch.
// cells, out, skip and the grid as in gw_event_mask; plane: i32[slots,
// rows+2, cols+2, 2, 128]; pairs: i32[2, drain*(1+dual) + 1]; counts:
// i32[cells, 2] and offsets: i64[cells, 2] scratch, cells = slots*rows*cols.
// `capacity` is the slot sentinel. Returns the first failed launch's
// cudaError_t, or 0.
extern "C" int gw_event_drain(const float* cells, const int* plane, int* out, int* pairs,
                              int* counts, long long* offsets, const unsigned char* skip,
                              int slots, int rows, int cols, int dual, int drain,
                              int capacity, void* stream) {
  if (slots <= 0 || rows <= 0 || cols <= 0 || slots > 65535 || rows > 65535 ||
      drain <= 0 || drain > (1 << 29)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(cols, rows, slots);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pairs_cols = drain * (dual ? 2 : 1) + 1;
  const DrainCount count = {plane, counts, pairs, pairs_cols, capacity};
  if (dual) {
    event_mask_kernel<true, true><<<grid, kLanes, 0, st>>>(cells, out, skip, rows, cols, count);
  } else {
    event_mask_kernel<false, true><<<grid, kLanes, 0, st>>>(cells, out, skip, rows, cols, count);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_cells = slots * rows * cols;
  drain_scan_kernel<<<1, kScanThreads, 0, st>>>(counts, offsets, skip, n_cells);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dual) {
    drain_write_kernel<true><<<grid, kLanes, 0, st>>>(out, plane, offsets, skip, pairs, rows,
                                                      cols, drain, pairs_cols);
  } else {
    drain_write_kernel<false><<<grid, kLanes, 0, st>>>(out, plane, offsets, skip, pairs, rows,
                                                       cols, drain, pairs_cols);
  }
  return static_cast<int>(cudaGetLastError());
}
