// CSR sorted segment-sum for Hopper (sm_90a).
//
//   out[n, :] = sum_{r in [splits[n], splits[n+1])} x[r, :]     (f32)
//
// Replaces the TPU kernels sorted_segment_sum_pallas
// (graph_hypernetwork_forge_tpu/ops/pallas/segment_sum.py:198) and its d=64
// pair-packed form sorted_segment_sum_packed64 (same file, :415). Those fold
// rows into node tiles with one-hot MXU matmuls over a 3-term bf16 split and
// pack even/odd rows into 128 lanes; all of that exists only for the TPU's
// matrix unit and lane width, and none of it is carried over here.
//
// What bounds it on the H100: bytes. Each input row is read once and each
// output row written once (R*d*4 + N*d*4 bytes, ~0.28 GB at R=1.03M,
// N=50k, d=64), against d adds per row: far below one operation per byte.
//
// What the design does about it: the work is split by ROWS, not by
// segments, because segment lengths are skewed. In the group-padded layout
// every masked pad row points at node 0, so node 0's segment holds ~31k of
// the 1.03M rows; one warp per segment left that warp alone on 7.7 MB while
// the card idled (3.3 ms against an 83 us bound on the H100). Here each
// warp owns one chunk of kRowsPerChunk consecutive rows and walks the
// segments that overlap it, reading each row exactly once in 16-byte vector
// loads. A segment that lies inside its chunk is written directly; the
// pieces of a segment that crosses chunk boundaries go to a small scratch
// buffer (at most two pieces per chunk: the chunk's first segment if it
// began earlier, its last if it runs on), and a second kernel adds each
// crossing segment's pieces in chunk order and writes the empty segments'
// zeros. There are no atomics, and every sum is taken in an order fixed by
// the splits alone, so the result is bitwise identical from run to run.
//
// Within a chunk, lanes split a row's columns; when a row is narrower than
// 32 lanes of vectors (d=64: 16 lanes of float4), the warp reads several
// consecutive rows per step, so a step's loads are one contiguous span. The
// lanes' partial sums are combined by a fixed butterfly of shuffles. Four
// steps are issued before they are added, to keep loads in flight.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kRowsPerChunk = 256;
constexpr unsigned kFull = 0xffffffffu;

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static void add(T& a, const T& b) { a += b; }
  __device__ static T shfl_xor(const T& a, int m) {
    return __shfl_xor_sync(kFull, a, m);
  }
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
  __device__ static T shfl_xor(const T& a, int m) {
    return make_float4(__shfl_xor_sync(kFull, a.x, m),
                       __shfl_xor_sync(kFull, a.y, m),
                       __shfl_xor_sync(kFull, a.z, m),
                       __shfl_xor_sync(kFull, a.w, m));
  }
};

// Largest s in [0, n] with splits[s] <= r, given splits[0] <= r: a 32-way
// search by the whole warp (about four dependent loads for n = 50k).
__device__ int segment_of(const int32_t* __restrict__ splits, int n,
                          int64_t r, int lane) {
  int lo = 0, hi = n + 1;  // splits[lo] <= r; the answer lies in [lo, hi)
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

// From s with splits[s] <= r, the largest s' >= s with splits[s'] <= r
// (skips empty segments 31 at a time).
__device__ int advance(const int32_t* __restrict__ splits, int n, int s,
                       int64_t r, int lane) {
  for (;; s += 32) {
    const int idx = s + 1 + lane;
    const unsigned m = __ballot_sync(kFull, idx <= n && __ldg(splits + idx) <= r);
    if (m != kFull) return s + __popc(m);
  }
}

// Pass 1: warp w of the grid sums chunk w's rows segment by segment. x is
// [R, chunks] of VEC-float vectors, out [N, chunks], partial [C, 2, chunks].
// Lanes form 32 / lanes_per_row groups of lanes_per_row lanes (a power of
// two); blockIdx.y picks the window of lanes_per_row vector columns.
template <int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_chunk_kernel(const typename Vec<VEC>::T* __restrict__ x,
                 const int32_t* __restrict__ splits,
                 typename Vec<VEC>::T* __restrict__ out,
                 typename Vec<VEC>::T* __restrict__ partial, int64_t num_rows,
                 int num_chunks, int num_segments, int chunks,
                 int lanes_per_row) {
  using V = Vec<VEC>;
  using T = typename V::T;
  const int lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (chunk >= num_chunks) return;  // whole warp leaves together

  const int rows_per_step = 32 / lanes_per_row;
  const int group = lane / lanes_per_row;
  const int col = blockIdx.y * lanes_per_row + (lane % lanes_per_row);
  const bool col_ok = col < chunks;

  const int64_t cstart = (int64_t)chunk * kRowsPerChunk;
  const int64_t cend = min(cstart + kRowsPerChunk, num_rows);
  int64_t r = max(cstart, (int64_t)__ldg(splits));
  if (r >= cend || r >= __ldg(splits + num_segments)) return;
  int s = segment_of(splits, num_segments, r, lane);

  while (s < num_segments) {
    const int64_t seg_start = __ldg(splits + s);
    const int64_t seg_end = __ldg(splits + s + 1);  // > r
    const int64_t stop = min(seg_end, cend);
    T acc = V::zero();
    if (col_ok) {
      const int64_t step = rows_per_step;
      int64_t i = r + group;
      for (; i + 3 * step < stop; i += 4 * step) {
        const T a0 = __ldg(x + i * chunks + col);
        const T a1 = __ldg(x + (i + step) * chunks + col);
        const T a2 = __ldg(x + (i + 2 * step) * chunks + col);
        const T a3 = __ldg(x + (i + 3 * step) * chunks + col);
        V::add(acc, a0);
        V::add(acc, a1);
        V::add(acc, a2);
        V::add(acc, a3);
      }
      for (; i < stop; i += step) V::add(acc, __ldg(x + i * chunks + col));
    }
    // Fixed butterfly over the row groups (lanes lanes_per_row apart).
    for (int m = lanes_per_row; m < 32; m <<= 1) {
      const T other = V::shfl_xor(acc, m);
      V::add(acc, other);
    }
    if (group == 0 && col_ok) {
      if (seg_start >= cstart && seg_end <= cend) {
        out[(int64_t)s * chunks + col] = acc;
      } else {
        const int slot = seg_start < cstart ? 0 : 1;
        partial[((int64_t)chunk * 2 + slot) * chunks + col] = acc;
      }
    }
    r = stop;
    if (r >= cend) break;
    s = advance(splits, num_segments, s, r, lane);
  }
}

// Pass 2: one warp per segment. A segment that crosses chunks adds its
// first chunk's slot 1 and the following chunks' slot 0, in chunk order;
// an empty segment writes zeros; the rest were written by pass 1.
template <int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_fixup_kernel(const int32_t* __restrict__ splits,
                 const typename Vec<VEC>::T* __restrict__ partial,
                 typename Vec<VEC>::T* __restrict__ out, int num_segments,
                 int chunks) {
  using V = Vec<VEC>;
  using T = typename V::T;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (s >= num_segments) return;
  const int64_t start = __ldg(splits + s);
  const int64_t end = __ldg(splits + s + 1);
  const int64_t c0 = start / kRowsPerChunk;
  const int64_t c1 = (end - 1) / kRowsPerChunk;
  if (end > start && c0 == c1) return;
  for (int col = lane; col < chunks; col += 32) {
    T acc = V::zero();
    if (end > start) {
      acc = partial[(c0 * 2 + 1) * chunks + col];
#pragma unroll 8
      for (int64_t c = c0 + 1; c <= c1; ++c) {
        V::add(acc, partial[(c * 2) * chunks + col]);
      }
    }
    out[(int64_t)s * chunks + col] = acc;
  }
}

int lanes_for(int chunks) {
  int lanes = 1;
  while (lanes < chunks && lanes < 32) lanes <<= 1;
  return lanes;
}

template <int VEC>
void launch(const void* x, const void* splits, void* out, void* partial,
            int64_t num_rows, int num_segments, int d, cudaStream_t s) {
  using T = typename Vec<VEC>::T;
  const int chunks = d / VEC;
  const int lanes = lanes_for(chunks);
  const int64_t num_chunks = (num_rows + kRowsPerChunk - 1) / kRowsPerChunk;
  const dim3 block(kWarpsPerBlock * 32);
  if (num_chunks > 0) {
    const dim3 grid((unsigned)((num_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock),
                    (chunks + lanes - 1) / lanes);
    csr_chunk_kernel<VEC><<<grid, block, 0, s>>>(
        static_cast<const T*>(x), static_cast<const int32_t*>(splits),
        static_cast<T*>(out), static_cast<T*>(partial), num_rows,
        (int)num_chunks, num_segments, chunks, lanes);
  }
  const dim3 grid2((num_segments + kWarpsPerBlock - 1) / kWarpsPerBlock);
  csr_fixup_kernel<VEC><<<grid2, block, 0, s>>>(
      static_cast<const int32_t*>(splits), static_cast<const T*>(partial),
      static_cast<T*>(out), num_segments, chunks);
}

}  // namespace

// Rows per chunk of pass 1; the wrapper sizes the scratch buffer with it.
extern "C" int ghf_csr_rows_per_chunk() { return kRowsPerChunk; }

// x: [num_rows, d] f32 rows sorted by segment; splits: int32, at least
// num_segments + 1 entries, non-decreasing, splits[num_segments] <=
// num_rows; out: [num_segments, d] f32; partial: f32 scratch of
// 2 * ceil(num_rows / rows_per_chunk) * d floats. vec is 4 when d % 4 == 0
// and x, out and partial are 16-byte aligned, else 1. Launches both passes
// on `stream`; returns cudaGetLastError().
extern "C" int ghf_csr_segment_sum(const void* x, const void* splits,
                                   void* out, void* partial, int64_t num_rows,
                                   int num_segments, int d, int vec,
                                   void* stream) {
  if (num_segments <= 0 || d <= 0) return (int)cudaSuccess;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (vec == 4) {
    launch<4>(x, splits, out, partial, num_rows, num_segments, d, s);
  } else if (vec == 1) {
    launch<1>(x, splits, out, partial, num_rows, num_segments, d, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
