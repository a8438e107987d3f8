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
// empty lane. For each query lane q of cell (s, i, j), each of the 1152
// candidates c of the cell's 3x3 halo block (c = (3*di + dj) * 128 + lane)
// and each epoch E:
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
// What bounds it on an H100. Per cell it writes 36,864 B (single) or
// 73,728 B (dual) of words, every row whether its lane is empty or not, and
// reads the 3x3 block (each cell is read by 9 CTAs, mostly from L2; device
// memory sees the input once). The pairs it must evaluate are those whose
// query and candidate both have x set, epoch by epoch. At the headline
// (44x44 cells, 102,400 entities, ~53 a cell filled from lane 0) the bytes
// bound it (45 us dual, 24 us single at 3.35 TB/s, against 20 us of needed
// FP32 operations), but the time goes to issuing the pair loop: per
// occupied query and occupied 32-candidate chunk (~1.9 M of them a launch)
// a warp issues 10 FP32 operations, 2 compares and 1 ballot per region,
// plus its share of the query's loads and store. At 32 spaces (~3 entities
// a cell) the stores set the pace, within 20% of their bound; a strip slab
// lies between.
//
// The design, for the H100 rather than carried over from the TPU's block:
//  * Candidates across the lanes of a warp. A chunk is 32 consecutive
//    candidates (36 a cell); a lane holds its candidate's x, z and space of
//    both epochs in registers, loaded straight from global memory (a
//    feature row's lanes are contiguous, so the loads are coalesced), for
//    two chunks at once. For each query one __ballot_sync a chunk yields its
//    32 bits: bits 0-15 are word 2m, bits 16-31 word 2m+1, the reference's
//    packing; the dual form takes a second ballot. A query's features are
//    one broadcast read from shared memory.
//  * No work on empty lanes. The CTA lists its occupied query lanes (x set
//    in epoch A or B) and its occupied chunks (one of the 32 candidates' x
//    set in A or B) with ballots and walks only (two chunks, up to 32
//    queries) items of those lists, round-robin over its 8 warps. Neither
//    list assumes that lanes fill from 0.
//  * No test that cannot fail. The self test runs only on items holding a
//    chunk of the centre block; the space test only where the item's lanes,
//    in the epochs whose x is set, hold more than one space id (a pair with
//    a NaN x is invalid whatever its space).
//  * Whole-cell stores. The cell's ballots are built in a zeroed block of
//    shared memory (128 rows x 36 or 72 u32, 18 / 36 KB), so an empty row or
//    skipped chunk costs nothing, then written out as the cell's one
//    contiguous block of words: each thread expands two ballots into four
//    words and stores them as one 16-byte store, a warp 512 contiguous
//    bytes. Every row is written.
//  * In flight: one CTA per cell, 48 registers and 23 / 42 KB of shared
//    memory, so 5 CTAs (40 warps) fit on an SM and one CTA's stores overlap
//    the others' pair loops; ptxas reports no spill (PERF.md, section 6,
//    records its lines and the measured choice of shape).
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
//   pass 1, count: the mask kernel, whose write-out also sums the popcounts
//     of the own rows' ballots into the cell's enter and leave counts, and
//     which prefills the pairs with the sentinel;
//   pass 2, scan: one CTA scans the per-cell counts into 64-bit exclusive
//     offsets, each thread a run of consecutive cells;
//   pass 3, write: one CTA per cell; a cell with own events below a
//     region's end loads its own rows' words of that region once,
//     coalesced, packed two to a u32 in shared memory, block-scans the 128
//     lanes' popcounts, and each lane writes its pairs from there at
//     offset + rank while that is below D.
// An event past its region's end is not written. The TPU kernel sends it to
// the trailing trash column instead; that column is never read (the caller
// slices the regions), and here it keeps the sentinel. Every pass honours
// `skip`.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;             // query lanes per cell
constexpr int kFeat = 8;                // feature rows per cell
constexpr int kCell = kFeat * kLanes;   // floats per cell
constexpr int kCands = 9 * kLanes;      // candidates in a 3x3 halo block
constexpr int kPack = 16;               // candidate bits per output word
constexpr int kWords = kCands / kPack;  // 72 words per mask
constexpr int kChunks = kCands / 32;    // 36 ballots per mask
// The mask CTA's shape, chosen by measurement on the H100 (PERF.md,
// section 6): warps per CTA, chunks a warp holds per work item, and queries
// per work item at most.
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPerItem = 2;
constexpr int kSlice = 32;

__device__ __forceinline__ bool is_empty(float x) { return x != x; }  // NaN

// q is the query's (x, z, space, radius^2) of one epoch; c the candidate's.
// Without kSpace the space test is left out: the caller has shown that it
// holds for every pair whose x is set on both sides.
template <bool kSpace>
__device__ __forceinline__ bool pair_valid(float4 q, float cx, float cz, float cs) {
  const float dx = __fsub_rn(cx, q.x);
  const float dz = __fsub_rn(cz, q.y);
  const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dz, dz));
  return kSpace ? (q.z == cs) & (d2 <= q.w) : d2 <= q.w;
}

// Whether one epoch of a lane is empty or in space `s`.
__device__ __forceinline__ bool in_space(float x, float space, float s) {
  return is_empty(x) | (space == s);
}

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

__device__ __forceinline__ long long cell_offset(int s, int r, int c, int rows, int cols) {
  // Index of cell (r, c) of slot s in the padded geometry.
  return (static_cast<long long>(s) * (rows + 2) + r) * (cols + 2) + c;
}

// A lane's candidate of each of kN chunks: x, z and space of both epochs.
template <int kN>
struct Candidates {
  float xa[kN], za[kN], sa[kN], xb[kN], zb[kN], sb[kN];
  int self_q[kN];  // the query lane this candidate is, or -1 outside the centre block
};

// The occupied queries q_list[k0, k1) against a lane's candidates: per
// query, each chunk gives one ballot a region; the lanes with `stores` put
// theirs at bal[q * kRowU + row_off]. kSpace and kSelf keep the space and
// self tests, which the caller leaves out where they cannot fail.
template <bool kDual, int kN, bool kSpace, bool kSelf>
__device__ __forceinline__ void scan_queries(const Candidates<kN>& c, int k0, int k1,
                                             const int* q_list, const float4 (*qf)[2],
                                             unsigned* bal, int row_off, bool stores) {
  constexpr int kRowU = (kDual ? 2 : 1) * kChunks;
  const int lane = threadIdx.x & 31;
#pragma unroll 2
  for (int k = k0; k < k1; ++k) {
    const int q = q_list[k];
    const float4 qa = qf[k][0];
    const float4 qb = qf[k][1];
    unsigned v = 0u;
#pragma unroll
    for (int u = 0; u < kN; ++u) {
      const bool va = pair_valid<kSpace>(qa, c.xa[u], c.za[u], c.sa[u]);
      const bool vb = pair_valid<kSpace>(qb, c.xb[u], c.zb[u], c.sb[u]);
      const bool other = !kSelf || c.self_q[u] != q;
      const unsigned enter = __ballot_sync(0xffffffffu, va & !vb & other);
      if (lane == u) v = enter;
      if (kDual) {
        const unsigned leave = __ballot_sync(0xffffffffu, vb & !va & other);
        if (lane == kN + u) v = leave;
      }
    }
    if (stores) bal[q * kRowU + row_off] = v;
  }
}

// One work item of a warp: the occupied queries q_list[k0, k1) (at most 32)
// against kN occupied chunks chunk[0, kN) of the cell (s, i, j)'s 3x3
// block. Each lane holds its candidate of every chunk in registers; lane u
// (u < kN) stores chunk u's enter ballot, lane kN + u its leave ballot, in
// the query's row of `bal`. The self test runs only where a chunk lies in
// the centre block; the space test only where the item's lanes, in the
// epochs where their x is set, hold more than one space.
template <bool kDual, int kN>
__device__ __forceinline__ void evaluate_item(const float* __restrict__ cells, int s, int i,
                                              int j, int rows, int cols, const int* chunk,
                                              int k0, int k1, const int* q_list,
                                              const float4 (*qf)[2], unsigned* bal) {
  const int lane = threadIdx.x & 31;
  Candidates<kN> c;
  bool centre = false;
#pragma unroll
  for (int u = 0; u < kN; ++u) {
    const int m = chunk[u];
    const int b = m >> 2;                // block (di, dj) = (b / 3, b % 3)
    const int cl = (m & 3) * 32 + lane;  // the candidate's lane in block b
    const float* src = cells + cell_offset(s, i + b / 3, j + b % 3, rows, cols) * kCell + cl;
    c.xa[u] = src[0 * kLanes];
    c.za[u] = src[1 * kLanes];
    c.sa[u] = src[2 * kLanes];
    c.xb[u] = src[4 * kLanes];
    c.zb[u] = src[5 * kLanes];
    c.sb[u] = src[6 * kLanes];
    c.self_q[u] = b == 4 ? cl : -1;
    centre |= b == 4;
  }
  // One space: that of the first query's first epoch with x set.
  const float4 qa0 = qf[k0][0];
  const float space = is_empty(qa0.x) ? qf[k0][1].z : qa0.z;
  bool agree = true;
  if (lane < k1 - k0) {
    const float4 qa = qf[k0 + lane][0];
    const float4 qb = qf[k0 + lane][1];
    agree = in_space(qa.x, qa.z, space) & in_space(qb.x, qb.z, space);
  }
#pragma unroll
  for (int u = 0; u < kN; ++u) {
    agree &= in_space(c.xa[u], c.sa[u], space) & in_space(c.xb[u], c.sb[u], space);
  }
  const bool one_space = __all_sync(0xffffffffu, agree);
  const bool stores = lane < (kDual ? 2 : 1) * kN;
  const int row_off = stores ? (lane / kN) * kChunks + chunk[lane % kN] : 0;
  if (one_space) {
    if (centre) {
      scan_queries<kDual, kN, false, true>(c, k0, k1, q_list, qf, bal, row_off, stores);
    } else {
      scan_queries<kDual, kN, false, false>(c, k0, k1, q_list, qf, bal, row_off, stores);
    }
  } else if (centre) {
    scan_queries<kDual, kN, true, true>(c, k0, k1, q_list, qf, bal, row_off, stores);
  } else {
    scan_queries<kDual, kN, true, false>(c, k0, k1, q_list, qf, bal, row_off, stores);
  }
}

// What the count pass adds to the mask kernel (null in the mask forms).
struct DrainCount {
  const int* plane;  // i32[S, rows+2, cols+2, 2, 128] slot/own plane
  int* counts;       // i32[cells, 2]: own-lane enter and leave events
  int* pairs;        // i32[2 * pairs_cols], prefilled with `sentinel`
  int pairs_cols;    // cap + 1
  int sentinel;      // the capacity
};

template <bool kDual, bool kCount>
__global__ void __launch_bounds__(kThreads)
event_mask_kernel(const float* __restrict__ cells, int* __restrict__ out,
                  const unsigned char* __restrict__ skip, int rows, int cols,
                  DrainCount drain) {
  if (skip != nullptr && *skip) return;
  constexpr int kRegions = kDual ? 2 : 1;
  constexpr int kRowU = kRegions * kChunks;  // ballots per query row
  // The cell's ballots, row q holding region r's chunk m at r*36 + m: the
  // output block with each pair of 16-bit words packed into one u32.
  __shared__ __align__(16) unsigned bal[kLanes * kRowU];
  // The k-th occupied query's (x, z, space, radius^2) in epochs A and B,
  // and its lane q_list[k].
  __shared__ float4 qf[kLanes][2];
  __shared__ int q_list[kLanes];
  __shared__ int chunk_list[kChunks];
  __shared__ unsigned q_bits[kLanes / 32];
  __shared__ unsigned own_bits[kLanes / 32];
  __shared__ int chunk_occ[kChunks];
  __shared__ int n_list[2];  // occupied queries, occupied chunks
  __shared__ int warp_sum[kWarps][2];

  const int j = blockIdx.x;
  const int i = blockIdx.y;
  const int s = blockIdx.z;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int lin = (s * rows + i) * cols + j;

  for (int k = t; k < kLanes * kRowU / 4; k += kThreads) {
    reinterpret_cast<uint4*>(bal)[k] = make_uint4(0u, 0u, 0u, 0u);
  }
  // Warps 0-3: the centre cell's query lanes, kept in registers until
  // their place in the list is known.
  float4 mine[2];
  bool occupied = false;
  if (t < kLanes) {
    const float* c = cells + cell_offset(s, i + 1, j + 1, rows, cols) * kCell + t;
    mine[0] = make_float4(c[0 * kLanes], c[1 * kLanes], c[2 * kLanes],
                          __fmul_rn(c[3 * kLanes], c[3 * kLanes]));
    mine[1] = make_float4(c[4 * kLanes], c[5 * kLanes], c[6 * kLanes],
                          __fmul_rn(c[7 * kLanes], c[7 * kLanes]));
    occupied = !(is_empty(mine[0].x) & is_empty(mine[1].x));
    const unsigned occ = __ballot_sync(0xffffffffu, occupied);
    if (lane == 0) q_bits[warp] = occ;
    if (kCount) {
      const int* own = drain.plane + cell_offset(s, i + 1, j + 1, rows, cols) * 2 * kLanes;
      const unsigned o = __ballot_sync(0xffffffffu, own[kLanes + t] > 0);
      if (lane == 0) own_bits[warp] = o;
    }
  }
  // Chunk m = warp + r * kWarps: all of a warp's loads first, then its ballots.
  constexpr int kRounds = (kChunks + kWarps - 1) / kWarps;
  bool has[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int m = warp + r * kWarps;
    has[r] = false;
    if (m < kChunks) {
      const int b = m >> 2;  // block (di, dj) = (b / 3, b % 3)
      const float* c = cells + cell_offset(s, i + b / 3, j + b % 3, rows, cols) * kCell +
                       (m & 3) * 32 + lane;
      has[r] = !(is_empty(c[0]) & is_empty(c[4 * kLanes]));
    }
  }
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int m = warp + r * kWarps;
    if (m < kChunks) {
      const unsigned occ = __ballot_sync(0xffffffffu, has[r]);
      if (lane == 0) chunk_occ[m] = occ != 0u;
    }
  }
  __syncthreads();
  // The two lists, in ascending order: each occupied query lane puts its
  // lane and features at its rank; warp 0 lists the occupied chunks.
  if (t < kLanes) {
    int before = 0;
    for (int w = 0; w < warp; ++w) before += __popc(q_bits[w]);
    if (occupied) {
      const int k = before + __popc(q_bits[warp] & lanes_below());
      q_list[k] = t;
      qf[k][0] = mine[0];
      qf[k][1] = mine[1];
    }
  }
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < kChunks; base += 32) {
      const bool occ = base + lane < kChunks && chunk_occ[base + lane];
      const unsigned bits = __ballot_sync(0xffffffffu, occ);
      if (occ) chunk_list[n + __popc(bits & lanes_below())] = base + lane;
      n += __popc(bits);
    }
    if (lane == 0) {
      int nq = 0;
      for (int w = 0; w < kLanes / 32; ++w) nq += __popc(q_bits[w]);
      n_list[0] = nq;
      n_list[1] = n;
    }
  }
  __syncthreads();

  // Work items: (kPerItem occupied chunks, slice of the occupied queries),
  // round-robin over the warps; a last group of fewer chunks runs them
  // one at a time.
  const int nq = n_list[0];
  const int n_chunks = n_list[1];
  const int n_slices = (nq + kSlice - 1) / kSlice;
  const int n_items = (n_chunks + kPerItem - 1) / kPerItem * n_slices;
  for (int item = warp; item < n_items; item += kWarps) {
    const int g = item / n_slices;
    const int h = item - g * n_slices;
    const int k0 = nq * h / n_slices;
    const int k1 = nq * (h + 1) / n_slices;
    const int* chunk = chunk_list + g * kPerItem;
    const int left = n_chunks - g * kPerItem;
    if (left >= kPerItem) {
      evaluate_item<kDual, kPerItem>(cells, s, i, j, rows, cols, chunk, k0, k1, q_list, qf,
                                     bal);
    } else {
      for (int u = 0; u < left; ++u) {
        evaluate_item<kDual, 1>(cells, s, i, j, rows, cols, chunk + u, k0, k1, q_list, qf,
                                bal);
      }
    }
  }
  __syncthreads();

  // The whole cell's words, contiguous: two ballots become four words in one
  // 16-byte store. The count pass also sums the own rows' events here.
  constexpr int kRowPairs = kRowU / 2;  // u32 pairs per row
  int4* dst = reinterpret_cast<int4*>(out + static_cast<long long>(lin) * kLanes * 2 * kRowU);
  const uint2* src = reinterpret_cast<const uint2*>(bal);
  int n_enter = 0;
  int n_leave = 0;
  for (int k = t; k < kLanes * kRowPairs; k += kThreads) {
    const uint2 v = src[k];
    dst[k] = make_int4(static_cast<int>(v.x & 0xffffu), static_cast<int>(v.x >> 16),
                       static_cast<int>(v.y & 0xffffu), static_cast<int>(v.y >> 16));
    if (kCount) {
      const int q = k / kRowPairs;
      if ((own_bits[q >> 5] >> (q & 31)) & 1u) {
        const int n = __popc(v.x) + __popc(v.y);
        if (kDual && k - q * kRowPairs >= kChunks / 2) {
          n_leave += n;
        } else {
          n_enter += n;
        }
      }
    }
  }
  if (!kCount) return;

  for (int o = 16; o > 0; o >>= 1) {
    n_enter += __shfl_down_sync(0xffffffffu, n_enter, o);
    n_leave += __shfl_down_sync(0xffffffffu, n_leave, o);
  }
  if (lane == 0) {
    warp_sum[warp][0] = n_enter;
    warp_sum[warp][1] = n_leave;
  }
  __syncthreads();
  if (t == 0) {
    int e = 0;
    int l = 0;
    for (int w = 0; w < kWarps; ++w) {
      e += warp_sum[w][0];
      l += warp_sum[w][1];
    }
    drain.counts[2 * lin] = e;
    drain.counts[2 * lin + 1] = l;
  }
  // The sentinel prefill of the pairs, spread over the grid.
  const long long n_threads =
      static_cast<long long>(gridDim.x) * gridDim.y * gridDim.z * kThreads;
  for (long long k = static_cast<long long>(lin) * kThreads + t; k < 2LL * drain.pairs_cols;
       k += n_threads) {
    drain.pairs[k] = drain.sentinel;
  }
}

constexpr int kScanThreads = 1024;

// Pass 2: exclusive scan of the per-cell counts (both regions) in one CTA:
// each thread sums a run of consecutive cells, the block scans the runs'
// totals (a warp scan, then a scan of the warp totals), and each thread
// writes its run's offsets.
__global__ void __launch_bounds__(kScanThreads)
drain_scan_kernel(const int* __restrict__ counts, long long* __restrict__ offsets,
                  const unsigned char* __restrict__ skip, int n_cells) {
  if (skip != nullptr && *skip) return;
  __shared__ long long warp_tot[kScanThreads / 32][2];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int per = (n_cells + kScanThreads - 1) / kScanThreads;
  const int c0 = min(t * per, n_cells);
  const int c1 = min(c0 + per, n_cells);
  long long v0 = 0;
  long long v1 = 0;
  for (int c = c0; c < c1; ++c) {
    v0 += counts[2 * c];
    v1 += counts[2 * c + 1];
  }
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
  long long o0 = (warp > 0 ? warp_tot[warp - 1][0] : 0) + s0 - v0;
  long long o1 = (warp > 0 ? warp_tot[warp - 1][1] : 0) + s1 - v1;
  for (int c = c0; c < c1; ++c) {
    offsets[2 * c] = o0;
    offsets[2 * c + 1] = o1;
    o0 += counts[2 * c];
    o1 += counts[2 * c + 1];
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

constexpr int kBalStride = kChunks + 1;  // padded: lane q reads row q conflict-free

// Pass 3: one CTA per cell, one thread per query lane. A cell with no own
// event, or none below the region's end, costs two loads. Lane t's events
// of one region are the set bits of its ballots, ballot ascending and bit
// ascending, which is candidate order; they land at the cell's offset plus
// the own events of lanes < t.
template <bool kDual>
__global__ void __launch_bounds__(kLanes)
drain_write_kernel(const int* __restrict__ words, const int* __restrict__ plane,
                   const int* __restrict__ counts, const long long* __restrict__ offsets,
                   const unsigned char* __restrict__ skip, int* __restrict__ pairs,
                   int rows, int cols, int drain, int pairs_cols) {
  if (skip != nullptr && *skip) return;
  constexpr int kRegions = kDual ? 2 : 1;
  constexpr int kRow = kRegions * kWords;
  constexpr int kRowVecs = kWords / 4;  // 16-byte loads per row and region
  // The candidates' slot ids: halo block (di, dj) lane l sits at
  // c = (3*di + dj)*128 + l, the candidate index itself.
  __shared__ int slot9[kCands];
  __shared__ unsigned bal[kLanes * kBalStride];
  __shared__ unsigned own_bits[kLanes / 32];
  __shared__ int warp_tot[kLanes / 32];
  const int t = threadIdx.x;
  const int lin = blockIdx.x;
  long long cell_off[kRegions];
  bool emits[kRegions];  // own events, not all past the region's end
  bool any = false;
#pragma unroll
  for (int r = 0; r < kRegions; ++r) {
    cell_off[r] = offsets[2 * lin + r];
    emits[r] = counts[2 * lin + r] > 0 && cell_off[r] < drain;
    any |= emits[r];
  }
  if (!any) return;  // uniform over the block
  const int j = lin % cols;
  const int i = lin / cols % rows;
  const int s = lin / (cols * rows);
  for (int b = 0; b < 9; ++b) {
    slot9[b * kLanes + t] =
        plane[cell_offset(s, i + b / 3, j + b % 3, rows, cols) * 2 * kLanes + t];
  }
  const bool own =
      plane[cell_offset(s, i + 1, j + 1, rows, cols) * 2 * kLanes + kLanes + t] > 0;
  const unsigned own_warp = __ballot_sync(0xffffffffu, own);
  if ((t & 31) == 0) own_bits[t >> 5] = own_warp;
  __syncthreads();
  const int q_slot = slot9[4 * kLanes + t];
  const int4* cell_words =
      reinterpret_cast<const int4*>(words + static_cast<long long>(lin) * kLanes * kRow);

#pragma unroll
  for (int r = 0; r < kRegions; ++r) {
    if (!emits[r]) continue;  // uniform over the block
    // The own rows' words of region r, coalesced, two words to a u32.
    for (int k = t; k < kLanes * kRowVecs; k += kLanes) {
      const int q = k / kRowVecs;
      const int v = k - q * kRowVecs;
      if ((own_bits[q >> 5] >> (q & 31)) & 1u) {
        const int4 w = cell_words[(q * kRow + r * kWords) / 4 + v];
        bal[q * kBalStride + 2 * v] =
            static_cast<unsigned>(w.x) | (static_cast<unsigned>(w.y) << 16);
        bal[q * kBalStride + 2 * v + 1] =
            static_cast<unsigned>(w.z) | (static_cast<unsigned>(w.w) << 16);
      }
    }
    __syncthreads();
    const unsigned* mine = bal + t * kBalStride;
    int n = 0;
    if (own) {
      for (int m = 0; m < kChunks; ++m) n += __popc(mine[m]);
    }
    long long pos = cell_off[r] + block_exclusive_scan(n, warp_tot);
    if (n > 0 && pos < drain) {
      int* q_out = pairs + static_cast<long long>(r) * drain;
      int* o_out = q_out + pairs_cols;
      for (int m = 0; m < kChunks && pos < drain; ++m) {
        unsigned bits = mine[m];
        while (bits != 0u && pos < drain) {
          const int c = 32 * m + __ffs(bits) - 1;
          bits &= bits - 1u;
          q_out[pos] = q_slot;
          o_out[pos] = slot9[c];
          ++pos;
        }
      }
    }
    __syncthreads();  // bal is refilled for the next region
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
    event_mask_kernel<true, false><<<grid, kThreads, 0, st>>>(cells, out, skip, rows, cols, none);
  } else {
    event_mask_kernel<false, false><<<grid, kThreads, 0, st>>>(cells, out, skip, rows, cols, none);
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
    event_mask_kernel<true, true><<<grid, kThreads, 0, st>>>(cells, out, skip, rows, cols, count);
  } else {
    event_mask_kernel<false, true><<<grid, kThreads, 0, st>>>(cells, out, skip, rows, cols, count);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_cells = slots * rows * cols;
  drain_scan_kernel<<<1, kScanThreads, 0, st>>>(counts, offsets, skip, n_cells);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto write = dual ? drain_write_kernel<true> : drain_write_kernel<false>;
  write<<<n_cells, kLanes, 0, st>>>(out, plane, counts, offsets, skip, pairs, rows, cols, drain,
                                    pairs_cols);
  return static_cast<int>(cudaGetLastError());
}
