// CSR sorted segment-sum for Hopper (sm_90a), of one stream or two.
//
//   out[n, :] = sum_{r in [splits[n], splits[n+1])} x[r, :]     (f32)
//
// Kernel 1 (one stream) replaces the TPU kernels sorted_segment_sum_pallas
// (graph_hypernetwork_forge_tpu/ops/pallas/segment_sum.py:198) and its d=64
// pair-packed form sorted_segment_sum_packed64 (same file, :415). Those fold
// rows into node tiles with one-hot MXU matmuls over a 3-term bf16 split and
// pack even/odd rows into 128 lanes; all of that exists only for the TPU's
// matrix unit and lane width, and none of it is carried over here.
//
// Kernel 7 (two streams, each with its own rows and splits, in one pass)
// replaces dual_sorted_segment_sum_pallas (same file, :463, pallas_call in
// _dual_impl :396), which concatenates the streams into [E, 2 * dh] so that
// each fills one half of the TPU's 128 lanes. Here the streams stay apart:
// the grid covers stream A's row blocks and then stream B's, each with its
// own scratch and counters.
//
// What bounds it on the H100: bytes. Each input row is read once and each
// output row written once (R*d*4 + N*d*4 bytes per stream, ~0.28 GB at
// R=1.03M, N=50k, d=64), against d adds per row: far below one operation
// per byte.
//
// What the design does about it. The work is split by ROWS, not by
// segments, because segment lengths are skewed: in the group-padded layout
// every masked pad row points at node 0, whose segment holds ~31k of the
// 1.03M rows. One launch does everything:
//
// 1. A block owns kBlockRows consecutive rows; a row is read by a group of
//    L lanes (16 bytes each: L = 8 for bf16 rows at d=64, 16 for f32), so a
//    warp holds G = 32 / L groups and the block 8 G. Each group walks its
//    own span of kBlockRows / (8 G) consecutive rows as a segmented sum: it
//    loads a batch of 4 rows at a time (batch_rows), whatever segments they
//    belong to, adds them in row order and flushes at each segment end (a
//    row whose index + 1 is the next split). The loads never wait on the
//    segment logic, so every group keeps a batch of 16-byte loads a lane in
//    flight, and the groups of a warp sum their segments at the same time.
//    A group finds the segment of its first row once (a 32-way search of
//    splits by the whole warp, then one ballot a group) and after that
//    reads one split ahead per segment end. Where a segment ends on the
//    span's last row the group stops; where empty segments follow it,
//    it finds the segment of its next row with a search of its own
//    (skip_empty: steps of 1, 2, 4, ..., then a bisection), so a run of m
//    empty segments costs it about 2 log2(m) dependent loads, not m.
// 2. A segment that starts and ends inside a span is written by its group.
//    A span's first segment, if it began earlier (its head), and its last,
//    if it runs on (its tail), go to shared memory. After a __syncthreads
//    the block chains them: a tail plus the heads of the spans that follow,
//    in span order, is a whole segment (written to out) or, where it leaves
//    the block, the block's piece of it.
// 3. A block has at most two pieces of segments that cross its bounds: its
//    first segment's if it began in an earlier block (slot 0), its last's
//    if it runs on (slot 1). Each goes to f32 scratch, and the block takes
//    a ticket of the segment (int32 atomicAdd on the counter of the block
//    where the segment starts). The block that draws the last ticket sums
//    the pieces in block order and writes the segment; it resets the
//    counter, so every launch leaves the counters at zero (run_reduce.cuh,
//    the same ordered last-arriver as kernels 3 and 6).
// 4. Empty segments have no row, so no span writes them. The grid ends in
//    zero blocks, ceil(N / kZeroSegs) a stream after the row blocks of
//    both streams, each owning kZeroSegs = 2048 consecutive segments: a
//    warp reads the splits of its 256 with coalesced loads (one ballot of
//    32 empty-or-not at a time) and its lane groups write the zero rows of
//    the empty ones in the block's column window. Leading, interior and
//    trailing runs, and a call where no segment has a row, are all the
//    same case. No block and no group steps through empty segments one at
//    a time: a launch costs its rows, one coalesced read of splits (N + 1
//    int32) and the zero rows, in the one launch.
//
// There are no float atomics, and every sum is taken in an order fixed by
// the splits and the shape alone (rows in order inside a span, spans in
// order inside a block, blocks in order), so the result is bitwise
// identical from run to run. Every output row is written once: a segment
// with rows by its group, its block's chain or its last ticket, an empty
// one by its zero block. Only the zero blocks are sized by the number of
// segments, and they run beside the row blocks.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py and
// scripts/time_segment_sums.py, the kernel alone by torch.profiler), xl at
// d=64 / 128: f32 rows 0.100-0.104 / 0.195-0.213 ms, bf16 rows 0.058-0.063
// / 0.107-0.108, against bounds of 0.083 / 0.165 and 0.043 / 0.087; the
// zero blocks left these times as they were. On the composed step's shard
// at k = 4 (295,424 rows at d=64; the dst cotangent over 62,292 segments,
// 49,792 of them empty after the last row): 0.032-0.047 ms against a bound
// of 0.027, where the group that ended a segment zeroing the empty ones
// after it one at a time took 4.68-4.69 ms. An earlier design (one warp
// per 256-row chunk walking its segments one after another, then a second
// launch of one warp per segment) took 0.123 / 0.220 and 0.098 / 0.147 a
// call at xl.
//
// Kernel 1's bf16 form (the speed mode's rows: the TPU kernel's bf16
// branch, one pass with f32 sums, segment_sum.py:69, :117-118) is the same
// kernel over rows of bf16: each lane loads 8 bf16 (16 bytes) at a time,
// converts them to f32 exactly, and everything after the load (the sums,
// the scratch, the output) is f32. It moves half the input bytes of the f32
// form (~0.145 GB at R=1.03M, N=50k, d=64). Kernel 7 takes bf16 rows the
// same way, over both streams (the TPU kernel's bf16 branch,
// segment_sum.py:270-271, :327-329).
//
// mode="fast" of kernels 1 and 7 (the TPU kernels' fast branch,
// segment_sum.py:119-120, :330-333: f32 rows rounded to bf16 before the f32
// fold) is a third loader: f32 rows rounded to nearest even bf16 as they are
// loaded and widened back, then the same f32 sums. On bf16 rows the mode
// changes nothing, as on the TPU (:117-118). It reads the bytes of the f32
// form, so on this card it is the f32 form's time at best: the rounding is
// the TPU's one-pass fold, which a CUDA-core sum has no use for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "run_reduce.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kBlockRows = 2048;  // rows of a block: 256 a warp
constexpr int kZeroSegs = 2048;   // segments of a zero block: 256 a warp
constexpr unsigned kFull = 0xffffffffu;

// Rows a group loads before it adds them: 4 where a lane loads 16 bytes (8
// spilled at the 64 registers of 4 blocks an SM; 8 at 3 blocks an SM ran
// 14% slower on bf16 rows), 8 where it loads one element
// (scripts/tune_edge_kernels.py, H100).
template <int VEC>
__host__ __device__ constexpr int batch_rows() { return VEC == 1 ? 8 : 4; }
constexpr int kMinBlocks = 4;  // resident blocks an SM: 64 registers

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static void add(T& a, const T& b) { a += b; }
  __device__ static T ldcg(const T* p) { return __ldcg(p); }
};
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void add(T& a, const T& b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  __device__ static T ldcg(const T* p) { return __ldcg(p); }
};
struct Float8 {
  float4 lo, hi;
};
template <>
struct Vec<8> {
  using T = Float8;
  __device__ static T zero() { return T{Vec<4>::zero(), Vec<4>::zero()}; }
  __device__ static void add(T& a, const T& b) {
    Vec<4>::add(a.lo, b.lo);
    Vec<4>::add(a.hi, b.hi);
  }
  __device__ static T ldcg(const T* p) {
    const float4* q = reinterpret_cast<const float4*>(p);
    return T{__ldcg(q), __ldcg(q + 1)};
  }
};

// Rows of `In` read VEC elements at a time: fetch() loads the raw bits
// (Raw), widen() makes VEC floats of them.
template <int VEC, typename In>
struct Rows;
template <>
struct Rows<1, float> {
  using Raw = float;
  __device__ static Raw fetch(const Raw* p) { return __ldg(p); }
  __device__ static float widen(Raw v) { return v; }
};
template <>
struct Rows<4, float> {
  using Raw = float4;
  __device__ static Raw fetch(const Raw* p) { return __ldg(p); }
  __device__ static float4 widen(Raw v) { return v; }
};
// A bf16 is the high half of the f32 with the same value.
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
template <>
struct Rows<1, __nv_bfloat16> {
  using Raw = unsigned short;
  __device__ static Raw fetch(const Raw* p) { return __ldg(p); }
  __device__ static float widen(Raw v) { return bf16_lo(v); }
};
template <>
struct Rows<8, __nv_bfloat16> {
  using Raw = uint4;  // 8 bf16
  __device__ static Raw fetch(const Raw* p) { return __ldg(p); }
  __device__ static Float8 widen(Raw v) {
    return Float8{
        make_float4(bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y), bf16_hi(v.y)),
        make_float4(bf16_lo(v.z), bf16_hi(v.z), bf16_lo(v.w), bf16_hi(v.w))};
  }
};

// mode="fast": f32 rows, each value rounded to nearest even bf16 as loaded.
struct Fast {};
__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <>
struct Rows<1, Fast> {
  using Raw = float;
  __device__ static Raw fetch(const Raw* p) { return __ldg(p); }
  __device__ static float widen(Raw v) { return to_bf16(v); }
};
template <>
struct Rows<4, Fast> {
  using Raw = float4;
  __device__ static Raw fetch(const Raw* p) { return __ldg(p); }
  __device__ static float4 widen(Raw v) {
    return make_float4(to_bf16(v.x), to_bf16(v.y), to_bf16(v.z), to_bf16(v.w));
  }
};

// Largest s in [lo, n] with splits[s] <= r, given splits[lo] <= r: a 32-way
// search by the whole warp (about four dependent loads for n = 50k).
__device__ int segment_of(const int32_t* __restrict__ splits, int lo, int n,
                          int64_t r, int lane) {
  int hi = n + 1;  // the answer lies in [lo, hi)
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) >> 5;
    const int idx = lo + lane * step;
    const bool le = idx < hi && __ldg(splits + idx) <= r;
    const unsigned m = __ballot_sync(kFull, le);  // a prefix of the lanes
    lo += (31 - __clz(m)) * step;
    hi = min(hi, lo + step);
  }
  return lo;
}

// From s with splits[s] <= r, the largest s' >= s with splits[s'] <= r, by
// the whole warp: one ballot over the next 32 splits, and where all of them
// are <= r (a run of empty segments), a search of the rest.
__device__ int advance(const int32_t* __restrict__ splits, int n, int s,
                       int64_t r, int lane) {
  const int idx = s + 1 + lane;
  const unsigned m = __ballot_sync(kFull, idx <= n && __ldg(splits + idx) <= r);
  return m != kFull ? s + __popc(m) : segment_of(splits, s + 32, n, r, lane);
}

// Largest s >= lo with splits[s] <= r, given splits[lo] <= r < splits[n], by
// one lane: steps of 1, 2, 4, ... from lo, then a bisection of the last
// step, so a run of m empty segments costs about 2 log2(m) dependent loads.
__device__ __forceinline__ int skip_empty(const int32_t* __restrict__ splits,
                                          int lo, int n, int64_t r) {
  int hi = n;
  for (int step = 1; step < n - lo; step <<= 1) {
    if (__ldg(splits + lo + step) > r) {
      hi = lo + step;
      break;
    }
    lo += step;
  }
  while (hi - lo > 1) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(splits + mid) <= r) lo = mid;
    else hi = mid;
  }
  return lo;
}

// A zero block's work: the zero rows, in the block's column window, of the
// empty segments among s0 .. s0 + kZeroSegs - 1. Each warp takes 256
// consecutive segments: 8 ballots of 32 (coalesced loads of splits), then
// its G groups write the empty ones' rows, G segments at a time.
template <int VEC>
__device__ void zero_empty_segments(const int32_t* __restrict__ splits,
                                    typename Vec<VEC>::T* __restrict__ out,
                                    int n, int s0, int chunks, int L) {
  constexpr int kBallots = kZeroSegs / kThreads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int base = s0 + warp * kBallots * 32;
  unsigned empty[kBallots];
#pragma unroll
  for (int j = 0; j < kBallots; ++j) {
    const int s = base + j * 32 + lane;
    empty[j] = __ballot_sync(
        kFull, s < n && __ldg(splits + s) == __ldg(splits + s + 1));
  }
  const int col = blockIdx.y * L + lane % L;
  if (col >= chunks) return;
#pragma unroll
  for (int j = 0; j < kBallots; ++j) {
    if (!empty[j]) continue;
    for (int p = lane / L; p < 32; p += 32 / L)
      if (empty[j] >> p & 1)
        out[(int64_t)(base + j * 32 + p) * chunks + col] = Vec<VEC>::zero();
  }
}

// One stream: x is [num_rows, chunks] of VEC-element vectors of In sorted
// by segment, splits its CSR bounds, out [N, chunks] and partial [B, 2,
// chunks] of VEC-float vectors for its B = num_blocks row blocks, counters
// B * gridDim.y int32 tickets (zero before and after the launch).
template <int VEC, typename In>
struct Stream {
  const typename Rows<VEC, In>::Raw* x;
  const int32_t* splits;
  typename Vec<VEC>::T* out;
  typename Vec<VEC>::T* partial;
  int* counters;
  int64_t num_rows;
  int num_blocks;
};

// Block b of the grid sums the row block b of stream a, or, past a's
// blocks, of stream b; past the row blocks of both come the zero blocks of
// stream a, ceil(num_segments / kZeroSegs) of them, then those of stream b.
// Lanes form 32 / lanes_per_row groups of lanes_per_row lanes (a power of
// two); blockIdx.y picks the window of lanes_per_row vector columns.
template <int VEC, typename In>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
csr_segment_sum_kernel(Stream<VEC, In> a, Stream<VEC, In> b, int num_segments,
                       int chunks, int lanes_per_row) {
  const int zero = (int)blockIdx.x - a.num_blocks - b.num_blocks;
  if (zero >= 0) {
    const int per_stream = (num_segments + kZeroSegs - 1) / kZeroSegs;
    const Stream<VEC, In>& st = zero < per_stream ? a : b;
    zero_empty_segments<VEC>(st.splits, st.out, num_segments,
                             zero % per_stream * kZeroSegs, chunks,
                             lanes_per_row);
    return;
  }
  using V = Vec<VEC>;
  using T = typename V::T;
  using R = Rows<VEC, In>;
  using Raw = typename R::Raw;
  constexpr int kBatch = batch_rows<VEC>();
  // The heads and tails of the block's 8 G spans: [span][lanes_per_row].
  __shared__ __align__(16) unsigned char piece_bytes[2 * kThreads * sizeof(T)];
  __shared__ int head_seg[kThreads], tail_seg[kThreads];
  __shared__ int block_seg[2];  // the segments of the block's slots, or -1
  T* const heads = reinterpret_cast<T*>(piece_bytes);
  T* const tails = heads + kThreads;

  const int n = num_segments;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int blk = blockIdx.x;
  const bool second = blk >= a.num_blocks;
  if (second) blk -= a.num_blocks;
  const Stream<VEC, In> st = second ? b : a;
  const Raw* __restrict__ x = st.x;
  const int32_t* __restrict__ splits = st.splits;
  T* __restrict__ out = st.out;

  const int L = lanes_per_row;
  const int G = 32 / L;                               // groups a warp
  const int K = kWarpsPerBlock * G;                   // spans a block
  const int S = kBlockRows / K;                       // rows a span
  const int sub = lane % L;
  const int k = warp * G + lane / L;                  // this group's span
  const int col = blockIdx.y * L + sub;
  const bool col_ok = col < chunks;
  const int64_t brow0 = (int64_t)blk * kBlockRows;
  const int64_t span0 = brow0 + (int64_t)k * S;
  const int64_t span1 = span0 + S;
  const int64_t row_begin = __ldg(splits), row_end = __ldg(splits + n);
  const int64_t r0 = max(span0, row_begin), r1 = min(span1, row_end);
  const int64_t rl = min(span1, st.num_rows);  // rows that may be loaded
  if (sub == 0) head_seg[k] = tail_seg[k] = -1;
  if (threadIdx.x < 2) block_seg[threadIdx.x] = -1;

  // The first batch is in flight while the segment is searched.
  Raw raw[kBatch];
  auto fetch = [&](int64_t base) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int64_t row = base + u;
      raw[u] = row < rl && col_ok ? R::fetch(x + row * chunks + col) : Raw{};
    }
  };
  fetch(span0);

  // s: the segment of row r0 (warp-uniform search, one ballot a group).
  int s = 0;
  {
    const int64_t w0 = max(brow0 + (int64_t)warp * G * S, row_begin);
    const int64_t w1 = min(brow0 + (int64_t)(warp + 1) * G * S, row_end);
    if (w0 < w1) {
      const int sw = segment_of(splits, 0, n, w0, lane);
      for (int g = 0; g < G; ++g) {
        const int64_t g0 = max(brow0 + (int64_t)(warp * G + g) * S, row_begin);
        const int sg = advance(splits, n, sw, max(g0, w0), lane);
        if (g == lane / L) s = sg;
      }
    }
  }
  const bool has_rows = r0 < r1;

  // The segmented sum of the span: seg_start, nb, nn: splits[s], s + 1,
  // s + 2 (INT64_MAX past splits[n]); head: segment s began before span0.
  constexpr int64_t kNone = INT64_MAX;
  auto split_at = [&](int i) -> int64_t {
    return i <= n ? (int64_t)__ldg(splits + i) : kNone;
  };
  int64_t seg_start = 0, nb = kNone, nn = kNone;
  if (has_rows) {
    seg_start = __ldg(splits + s);
    nb = split_at(s + 1);
    nn = split_at(s + 2);
  }
  bool head = seg_start < span0;
  T acc = V::zero();
  for (int64_t base = span0;;) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int64_t row = base + u;
      if (row < r0 || row >= r1) continue;
      V::add(acc, R::widen(raw[u]));
      if (row + 1 != nb) continue;
      // Segment s ends here: a head goes to shared memory, a whole segment
      // to out. If the span has a next row, its segment is s + 1, or, past
      // a run of empty segments (the zero blocks write those), the one
      // skip_empty finds.
      T* dst = head ? heads + k * L + sub : out + (int64_t)s * chunks + col;
      if (col_ok) *dst = acc;
      if (head && sub == 0) head_seg[k] = s;
      acc = V::zero();
      head = false;
      seg_start = nb;
      if (nb >= r1) continue;  // no row of the span is left
      if (nn > nb) {
        ++s;
        nb = nn;
      } else {
        s = skip_empty(splits, s + 2, n, nb);
        nb = split_at(s + 1);
      }
      nn = split_at(s + 2);
    }
    base += kBatch;
    if (base >= r1) break;
    fetch(base);
  }
  // Segment s runs on past the span: the span's head, or its tail.
  if (has_rows && max(seg_start, r0) < r1) {
    (head ? heads : tails)[k * L + sub] = acc;
    if (sub == 0) (head ? head_seg : tail_seg)[k] = s;
  }
  __syncthreads();

  // Chains: the block's first head and every tail, each with the heads of
  // the same segment in the spans after it, in span order.
  for (int idx = threadIdx.x; idx < (K + 1) * L; idx += kThreads) {
    const int c = idx / L, i = idx % L, ccol = blockIdx.y * L + i;
    const bool before = c == 0;  // the segment began before the block
    const int j0 = before ? 0 : c - 1;
    const int seg = before ? head_seg[0] : tail_seg[j0];
    if (seg < 0) continue;
    T sum = (before ? heads : tails)[j0 * L + i];
    for (int j = j0 + 1; j < K && head_seg[j] == seg; ++j) V::add(sum, heads[j * L + i]);
    const bool past = __ldg(splits + seg + 1) > brow0 + kBlockRows;
    if (!before && !past) {
      if (ccol < chunks) out[(int64_t)seg * chunks + ccol] = sum;
    } else {
      const int slot = before ? 0 : 1;
      if (ccol < chunks) st.partial[((int64_t)blk * 2 + slot) * chunks + ccol] = sum;
      if (i == 0) block_seg[slot] = seg;
    }
  }

  // The block's pieces of segments that cross blocks: the last of a
  // segment's blocks to arrive sums them in block order.
  __syncthreads();
  for (int slot = 0; slot < 2; ++slot) {
    const int seg = block_seg[slot];  // block-uniform
    if (seg < 0) continue;
    const int64_t b0 = __ldg(splits + seg) / kBlockRows;
    const int64_t b1 = (__ldg(splits + seg + 1) - 1) / kBlockRows;
    int* counter = st.counters + b0 * gridDim.y + blockIdx.y;
    if (!runred::last_arriver(counter, (int)(b1 - b0 + 1))) continue;
    for (int i = threadIdx.x; i < L; i += kThreads) {
      const int ccol = blockIdx.y * L + i;
      if (ccol >= chunks) continue;
      const T* p = st.partial + ccol;
      T sum = V::ldcg(p + (b0 * 2 + 1) * chunks);
#pragma unroll 8
      for (int64_t q = b0 + 1; q <= b1; ++q) V::add(sum, V::ldcg(p + q * 2 * chunks));
      out[(int64_t)seg * chunks + ccol] = sum;
    }
  }
}

int lanes_for(int chunks) {
  int lanes = 1;
  while (lanes < chunks && lanes < 32) lanes <<= 1;
  return lanes;
}

int blocks_for(int64_t num_rows) {
  const int64_t blocks = (num_rows + kBlockRows - 1) / kBlockRows;
  return blocks > 0 ? (int)blocks : 1;
}

template <int VEC, typename In = float>
Stream<VEC, In> stream_of(const void* x, const void* splits, void* out,
                          void* partial, int* counters, int64_t num_rows) {
  using T = typename Vec<VEC>::T;
  return Stream<VEC, In>{
      static_cast<const typename Rows<VEC, In>::Raw*>(x),
      static_cast<const int32_t*>(splits), static_cast<T*>(out),
      static_cast<T*>(partial), counters, num_rows, blocks_for(num_rows)};
}

// One launch over one stream (num_streams 1, b unused) or two.
template <int VEC, typename In>
void launch(Stream<VEC, In> a, Stream<VEC, In> b, int num_streams,
            int num_segments, int d, cudaStream_t s) {
  const int chunks = d / VEC;
  const int lanes = lanes_for(chunks);
  const int windows = (chunks + lanes - 1) / lanes;
  b.num_blocks = num_streams == 2 ? b.num_blocks : 0;
  b.counters = a.counters + (int64_t)a.num_blocks * windows;
  const int zero_blocks =
      num_streams * ((num_segments + kZeroSegs - 1) / kZeroSegs);
  const dim3 grid((unsigned)(a.num_blocks + b.num_blocks + zero_blocks),
                  windows);
  csr_segment_sum_kernel<VEC, In><<<grid, kThreads, 0, s>>>(
      a, b, num_segments, chunks, lanes);
}

// One stream (num_streams 1: b is a's pointers again, unused) or two, over
// rows of In read VEC at a time (vec == VEC) or one at a time (vec == 1).
template <typename In, int VEC>
int segment_sums(const void* x_a, const void* splits_a, void* out_a,
                 void* partial_a, int64_t num_rows_a, const void* x_b,
                 const void* splits_b, void* out_b, void* partial_b,
                 int64_t num_rows_b, void* counters, int num_streams,
                 int num_segments, int d, int vec, void* stream) {
  if (num_segments <= 0 || d <= 0) return (int)cudaSuccess;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int* c = static_cast<int*>(counters);
  if (vec == VEC) {
    launch(stream_of<VEC, In>(x_a, splits_a, out_a, partial_a, c, num_rows_a),
           stream_of<VEC, In>(x_b, splits_b, out_b, partial_b, c, num_rows_b),
           num_streams, num_segments, d, s);
  } else if (vec == 1) {
    launch(stream_of<1, In>(x_a, splits_a, out_a, partial_a, c, num_rows_a),
           stream_of<1, In>(x_b, splits_b, out_b, partial_b, c, num_rows_b),
           num_streams, num_segments, d, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Rows of a block; the wrapper sizes the scratch and the counters with it:
// per stream, B = max(1, ceil(num_rows / rows_per_block)) blocks.
extern "C" int ghf_csr_rows_per_block() { return kBlockRows; }

// x: [num_rows, d] f32 rows sorted by segment; splits: int32, at least
// num_segments + 1 entries, non-decreasing, splits[num_segments] <=
// num_rows; out: [num_segments, d] f32; partial: f32 scratch of 2 * B * d
// floats; counters: B * W int32, all zero (W = ceil(d / vec / 32) column
// windows), left at zero. vec is 4 when d % 4 == 0 and x, out and partial
// are 16-byte aligned, else 1. One launch on `stream`; returns
// cudaGetLastError().
extern "C" int ghf_csr_segment_sum(const void* x, const void* splits,
                                   void* out, void* partial, void* counters,
                                   int64_t num_rows, int num_segments, int d,
                                   int vec, void* stream) {
  return segment_sums<float, 4>(x, splits, out, partial, num_rows, x, splits,
                                out, partial, num_rows, counters, 1,
                                num_segments, d, vec, stream);
}

// Kernel 1's bf16 form: x is [num_rows, d] bf16, everything else as
// ghf_csr_segment_sum (out and partial f32). vec is 8 when d % 8 == 0 and
// x, out and partial are 16-byte aligned, else 1.
extern "C" int ghf_csr_segment_sum_bf16(const void* x, const void* splits,
                                        void* out, void* partial,
                                        void* counters, int64_t num_rows,
                                        int num_segments, int d, int vec,
                                        void* stream) {
  return segment_sums<__nv_bfloat16, 8>(x, splits, out, partial, num_rows, x,
                                        splits, out, partial, num_rows,
                                        counters, 1, num_segments, d, vec,
                                        stream);
}

// Kernel 1, mode="fast": as ghf_csr_segment_sum, each f32 value rounded to
// bf16 as it is read.
extern "C" int ghf_csr_segment_sum_fast(const void* x, const void* splits,
                                        void* out, void* partial,
                                        void* counters, int64_t num_rows,
                                        int num_segments, int d, int vec,
                                        void* stream) {
  return segment_sums<Fast, 4>(x, splits, out, partial, num_rows, x, splits,
                               out, partial, num_rows, counters, 1,
                               num_segments, d, vec, stream);
}

// Kernel 7: two independent segment-sums, each stream as ghf_csr_segment_sum
// takes one (x_*, splits_*, out_*, partial_*, num_rows_*), over the same
// num_segments and d, in one launch; counters: (B_a + B_b) * W int32, all
// zero. vec is 4 when d % 4 == 0 and every x, out and partial is 16-byte
// aligned, else 1. Returns cudaGetLastError().
extern "C" int ghf_dual_csr_segment_sum(
    const void* x_a, const void* splits_a, void* out_a, void* partial_a,
    int64_t num_rows_a, const void* x_b, const void* splits_b, void* out_b,
    void* partial_b, int64_t num_rows_b, void* counters, int num_segments,
    int d, int vec, void* stream) {
  return segment_sums<float, 4>(x_a, splits_a, out_a, partial_a, num_rows_a,
                                x_b, splits_b, out_b, partial_b, num_rows_b,
                                counters, 2, num_segments, d, vec, stream);
}

// Kernel 7's bf16 form: both x_* bf16, the rest as ghf_dual_csr_segment_sum;
// vec is 8 when d % 8 == 0 and every pointer is 16-byte aligned, else 1.
extern "C" int ghf_dual_csr_segment_sum_bf16(
    const void* x_a, const void* splits_a, void* out_a, void* partial_a,
    int64_t num_rows_a, const void* x_b, const void* splits_b, void* out_b,
    void* partial_b, int64_t num_rows_b, void* counters, int num_segments,
    int d, int vec, void* stream) {
  return segment_sums<__nv_bfloat16, 8>(
      x_a, splits_a, out_a, partial_a, num_rows_a, x_b, splits_b, out_b,
      partial_b, num_rows_b, counters, 2, num_segments, d, vec, stream);
}

// Kernel 7, mode="fast": as ghf_dual_csr_segment_sum, each f32 value
// rounded to bf16 as it is read.
extern "C" int ghf_dual_csr_segment_sum_fast(
    const void* x_a, const void* splits_a, void* out_a, void* partial_a,
    int64_t num_rows_a, const void* x_b, const void* splits_b, void* out_b,
    void* partial_b, int64_t num_rows_b, void* counters, int num_segments,
    int d, int vec, void* stream) {
  return segment_sums<Fast, 4>(x_a, splits_a, out_a, partial_a, num_rows_a,
                               x_b, splits_b, out_b, partial_b, num_rows_b,
                               counters, 2, num_segments, d, vec, stream);
}
