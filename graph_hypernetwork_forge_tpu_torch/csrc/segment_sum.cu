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
// pass 1's grid covers stream A's row chunks and then stream B's, and pass
// 2 covers A's segments and then B's, each with its own scratch.
//
// What bounds it on the H100: bytes. Each input row is read once and each
// output row written once (R*d*4 + N*d*4 bytes per stream, ~0.28 GB at
// R=1.03M, N=50k, d=64), against d adds per row: far below one operation
// per byte.
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
//
// Kernel 1's bf16 form (the speed mode's rows: the TPU kernel's bf16
// branch, one pass with f32 sums, segment_sum.py:69, :117-118) is the same
// two passes over rows of bf16: each lane loads 8 bf16 (16 bytes) at a
// time, converts them to f32 exactly, and everything after the load (the
// sums, the scratch, the output) is f32. The order of the sums is that of
// the f32 form, so it is bitwise deterministic too. It moves half the
// input bytes of the f32 form (~0.15 GB at R=1.03M, N=50k, d=64): 0.094 /
// 0.150 ms at d=64 / 128 on an H100 80GB HBM3 at 700 W, against 0.127 /
// 0.220 for the f32 form. Kernel 7 takes bf16 rows the same way, over both
// streams (the TPU kernel's bf16 branch, segment_sum.py:270-271, :327-329).
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
  __device__ static T shfl_xor(const T& a, int m) {
    return T{Vec<4>::shfl_xor(a.lo, m), Vec<4>::shfl_xor(a.hi, m)};
  }
};

// Rows of `In` read VEC elements at a time (Raw) as VEC floats.
template <int VEC, typename In>
struct Rows;
template <>
struct Rows<1, float> {
  using Raw = float;
  __device__ static float load(const Raw* p) { return __ldg(p); }
};
template <>
struct Rows<4, float> {
  using Raw = float4;
  __device__ static float4 load(const Raw* p) { return __ldg(p); }
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
  __device__ static float load(const Raw* p) { return bf16_lo(__ldg(p)); }
};
template <>
struct Rows<8, __nv_bfloat16> {
  using Raw = uint4;  // 8 bf16
  __device__ static Float8 load(const Raw* p) {
    const uint4 v = __ldg(p);
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
  __device__ static float load(const Raw* p) { return to_bf16(__ldg(p)); }
};
template <>
struct Rows<4, Fast> {
  using Raw = float4;
  __device__ static float4 load(const Raw* p) {
    const float4 v = __ldg(p);
    return make_float4(to_bf16(v.x), to_bf16(v.y), to_bf16(v.z), to_bf16(v.w));
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

// One stream: x is [num_rows, chunks] of VEC-element vectors of In sorted
// by segment, splits its CSR bounds, out [N, chunks] and partial [C, 2,
// chunks] of VEC-float vectors for its C = num_chunks row chunks.
template <int VEC, typename In>
struct Stream {
  const typename Rows<VEC, In>::Raw* x;
  const int32_t* splits;
  typename Vec<VEC>::T* out;
  typename Vec<VEC>::T* partial;
  int64_t num_rows;
  int num_chunks;
};

// Pass 1: warp w of the grid sums row chunk w segment by segment; chunks
// past stream a's belong to stream b. Lanes form 32 / lanes_per_row groups
// of lanes_per_row lanes (a power of two); blockIdx.y picks the window of
// lanes_per_row vector columns.
template <int VEC, typename In>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_chunk_kernel(Stream<VEC, In> a, Stream<VEC, In> b, int num_segments,
                 int chunks, int lanes_per_row) {
  using V = Vec<VEC>;
  using T = typename V::T;
  using R = Rows<VEC, In>;
  const int lane = threadIdx.x & 31;
  int chunk = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const bool second = chunk >= a.num_chunks;
  if (second) chunk -= a.num_chunks;
  if (chunk >= (second ? b.num_chunks : a.num_chunks)) return;  // whole warp
  const typename R::Raw* __restrict__ x = second ? b.x : a.x;
  const int32_t* __restrict__ splits = second ? b.splits : a.splits;
  T* __restrict__ out = second ? b.out : a.out;
  T* __restrict__ partial = second ? b.partial : a.partial;
  const int64_t num_rows = second ? b.num_rows : a.num_rows;

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
        const T a0 = R::load(x + i * chunks + col);
        const T a1 = R::load(x + (i + step) * chunks + col);
        const T a2 = R::load(x + (i + 2 * step) * chunks + col);
        const T a3 = R::load(x + (i + 3 * step) * chunks + col);
        V::add(acc, a0);
        V::add(acc, a1);
        V::add(acc, a2);
        V::add(acc, a3);
      }
      for (; i < stop; i += step) V::add(acc, R::load(x + i * chunks + col));
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

// Pass 2: one warp per segment of each stream (stream a's, then b's). A
// segment that crosses chunks adds its first chunk's slot 1 and the
// following chunks' slot 0, in chunk order; an empty segment writes zeros;
// the rest were written by pass 1.
template <int VEC, typename In>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_fixup_kernel(Stream<VEC, In> a, Stream<VEC, In> b, int num_streams,
                 int num_segments, int chunks) {
  using V = Vec<VEC>;
  using T = typename V::T;
  const int lane = threadIdx.x & 31;
  int s = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (s >= num_streams * num_segments) return;
  const bool second = s >= num_segments;
  if (second) s -= num_segments;
  const int32_t* __restrict__ splits = second ? b.splits : a.splits;
  const T* __restrict__ partial = second ? b.partial : a.partial;
  T* __restrict__ out = second ? b.out : a.out;
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

template <int VEC, typename In = float>
Stream<VEC, In> stream_of(const void* x, const void* splits, void* out,
                          void* partial, int64_t num_rows) {
  using T = typename Vec<VEC>::T;
  return Stream<VEC, In>{
      static_cast<const typename Rows<VEC, In>::Raw*>(x),
      static_cast<const int32_t*>(splits), static_cast<T*>(out),
      static_cast<T*>(partial), num_rows,
      (int)((num_rows + kRowsPerChunk - 1) / kRowsPerChunk)};
}

// Both passes over one stream (num_streams 1, b unused) or two.
template <int VEC, typename In>
void launch(Stream<VEC, In> a, Stream<VEC, In> b, int num_streams,
            int num_segments, int d, cudaStream_t s) {
  const int chunks = d / VEC;
  const int lanes = lanes_for(chunks);
  if (num_streams == 1) b.num_chunks = 0;
  const int64_t num_chunks = (int64_t)a.num_chunks + b.num_chunks;
  const dim3 block(kWarpsPerBlock * 32);
  if (num_chunks > 0) {
    const dim3 grid((unsigned)((num_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock),
                    (chunks + lanes - 1) / lanes);
    csr_chunk_kernel<VEC, In><<<grid, block, 0, s>>>(a, b, num_segments,
                                                     chunks, lanes);
  }
  const int64_t warps = (int64_t)num_streams * num_segments;
  const dim3 grid2((unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  csr_fixup_kernel<VEC, In><<<grid2, block, 0, s>>>(a, b, num_streams,
                                                    num_segments, chunks);
}

// Both passes over one stream (num_streams 1: b is a's pointers again,
// unused) or two, over rows of In read VEC at a time (vec == VEC) or one at
// a time (vec == 1).
template <typename In, int VEC>
int segment_sums(const void* x_a, const void* splits_a, void* out_a,
                 void* partial_a, int64_t num_rows_a, const void* x_b,
                 const void* splits_b, void* out_b, void* partial_b,
                 int64_t num_rows_b, int num_streams, int num_segments, int d,
                 int vec, void* stream) {
  if (num_segments <= 0 || d <= 0) return (int)cudaSuccess;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (vec == VEC) {
    launch(stream_of<VEC, In>(x_a, splits_a, out_a, partial_a, num_rows_a),
           stream_of<VEC, In>(x_b, splits_b, out_b, partial_b, num_rows_b),
           num_streams, num_segments, d, s);
  } else if (vec == 1) {
    launch(stream_of<1, In>(x_a, splits_a, out_a, partial_a, num_rows_a),
           stream_of<1, In>(x_b, splits_b, out_b, partial_b, num_rows_b),
           num_streams, num_segments, d, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
  return segment_sums<float, 4>(x, splits, out, partial, num_rows, x, splits,
                                out, partial, num_rows, 1, num_segments, d,
                                vec, stream);
}

// Kernel 1's bf16 form: x is [num_rows, d] bf16, everything else as
// ghf_csr_segment_sum (out and partial f32). vec is 8 when d % 8 == 0 and
// x, out and partial are 16-byte aligned, else 1.
extern "C" int ghf_csr_segment_sum_bf16(const void* x, const void* splits,
                                        void* out, void* partial,
                                        int64_t num_rows, int num_segments,
                                        int d, int vec, void* stream) {
  return segment_sums<__nv_bfloat16, 8>(x, splits, out, partial, num_rows, x,
                                        splits, out, partial, num_rows, 1,
                                        num_segments, d, vec, stream);
}

// Kernel 1, mode="fast": as ghf_csr_segment_sum, each f32 value rounded to
// bf16 as it is read.
extern "C" int ghf_csr_segment_sum_fast(const void* x, const void* splits,
                                        void* out, void* partial,
                                        int64_t num_rows, int num_segments,
                                        int d, int vec, void* stream) {
  return segment_sums<Fast, 4>(x, splits, out, partial, num_rows, x, splits,
                               out, partial, num_rows, 1, num_segments, d, vec,
                               stream);
}

// Kernel 7: two independent segment-sums, each stream as ghf_csr_segment_sum
// takes one (x_*, splits_*, out_*, partial_*, num_rows_*), over the same
// num_segments and d, in one pass. vec is 4 when d % 4 == 0 and every x,
// out and partial is 16-byte aligned, else 1. Launches both passes on
// `stream`; returns cudaGetLastError().
extern "C" int ghf_dual_csr_segment_sum(
    const void* x_a, const void* splits_a, void* out_a, void* partial_a,
    int64_t num_rows_a, const void* x_b, const void* splits_b, void* out_b,
    void* partial_b, int64_t num_rows_b, int num_segments, int d, int vec,
    void* stream) {
  return segment_sums<float, 4>(x_a, splits_a, out_a, partial_a, num_rows_a,
                                x_b, splits_b, out_b, partial_b, num_rows_b, 2,
                                num_segments, d, vec, stream);
}

// Kernel 7's bf16 form: both x_* bf16, the rest as ghf_dual_csr_segment_sum;
// vec is 8 when d % 8 == 0 and every pointer is 16-byte aligned, else 1.
extern "C" int ghf_dual_csr_segment_sum_bf16(
    const void* x_a, const void* splits_a, void* out_a, void* partial_a,
    int64_t num_rows_a, const void* x_b, const void* splits_b, void* out_b,
    void* partial_b, int64_t num_rows_b, int num_segments, int d, int vec,
    void* stream) {
  return segment_sums<__nv_bfloat16, 8>(
      x_a, splits_a, out_a, partial_a, num_rows_a, x_b, splits_b, out_b,
      partial_b, num_rows_b, 2, num_segments, d, vec, stream);
}

// Kernel 7, mode="fast": as ghf_dual_csr_segment_sum, each f32 value
// rounded to bf16 as it is read.
extern "C" int ghf_dual_csr_segment_sum_fast(
    const void* x_a, const void* splits_a, void* out_a, void* partial_a,
    int64_t num_rows_a, const void* x_b, const void* splits_b, void* out_b,
    void* partial_b, int64_t num_rows_b, int num_segments, int d, int vec,
    void* stream) {
  return segment_sums<Fast, 4>(x_a, splits_a, out_a, partial_a, num_rows_a,
                               x_b, splits_b, out_b, partial_b, num_rows_b, 2,
                               num_segments, d, vec, stream);
}
