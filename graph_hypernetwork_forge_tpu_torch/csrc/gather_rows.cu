// Row gather for Hopper (sm_90a), of up to three index streams over one table.
//
//   out_s[i, :] = table[idx_s[i], :]        (any element type, bit for bit)
//
// It replaces no TPU kernel: on the TPU these gathers are XLA's (jnp.take
// in the JAX package's ops/segment.py and training/objectives.py), and in
// the port before this kernel they were PyTorch's index_select. That one,
// vectorized_gather_kernel, runs one block of one warp per index: for a
// 256-byte row 16 of the warp's lanes carry 16 bytes each, one load and one
// store in flight, and a million such blocks a gather. Its time tracks the
// rows and not the bytes (about 0.6 ns a row on the H100 whether the table
// sits in L2 or in HBM), so the step's gathers ran at a fifth of HBM's bound.
//
// What bounds it on the H100: bytes. Each output row is written once, each
// index read once and each table row read at least once; there is no
// arithmetic. The random table rows are what the design is about.
//
// What the design does about it.
// 1. Many rows per warp. A row of W words of V bytes (V the widest of 16,
//    8, 4, 2, 1 that divides the row and every base address; the wrapper
//    picks it) goes to a group of L lanes, L the power of two at or above W,
//    at most 32: a warp moves 32 / L rows at once (two f32 rows at d = 64,
//    four bf16 rows, 32 four-byte rows). A row wider than 32 words is walked
//    by its 32 lanes in passes.
// 2. Enough in flight. A warp owns a chunk of kDepth rows a lane group:
//    it loads the chunk's indices (a group's lanes share one address, the
//    groups' addresses are consecutive), then issues every row load of the
//    chunk (read-only loads, kDepth of V bytes a lane) before any store, so
//    a lane has kDepth random rows outstanding instead of one.
// 3. A grid the size of the card's resident blocks, whose warps walk the
//    chunks with a grid stride: one launch covers every stream's chunks in
//    turn (a chunk is of one stream), so the h[src] / h[dst] pair or the
//    uniform loss's three gathers are one launch.
// 4. Offsets are 64-bit: a table or an output over 2^31 bytes is safe.
// Indices are int32 or int64, per stream, as given; they are not checked
// (the callers' come in range by construction, as index_select requires).
// The kernel allocates nothing and never synchronises, so a CUDA graph can
// capture it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// Rows each lane group has in flight, and stores that L2 evicts first
// (st.global.cs): chosen on the H100 at the train cells' shapes
// (scripts/time_gather_rows.py --variants). 2, 4 and 8 rows in flight lie
// within 1-5% of each other on every gather, 16 are 10-25% slower; against
// default stores, the evict-first ones keep a node table in L2 while its
// rows are read (node-table gathers 10-18% faster) and leave the permutes
// as they were.
constexpr int kDepth = 4;
constexpr bool kStreamingStores = true;
constexpr int kMaxStreams = 3;

template <int V> struct Word;
template <> struct Word<16> { using T = uint4; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<4> { using T = unsigned int; };
template <> struct Word<2> { using T = unsigned short; };
template <> struct Word<1> { using T = unsigned char; };

struct Streams {
  const void* idx[kMaxStreams];
  char* out[kMaxStreams];
  int64_t rows[kMaxStreams];
  // Chunks of streams 0..k together; a stream past the last one given
  // repeats the total, so that no chunk maps to it.
  int64_t first_chunk_end[kMaxStreams];
  int idx64[kMaxStreams];  // 1: int64 indices, 0: int32
};

template <typename T>
__device__ __forceinline__ void store(T* p, T v) {
  if constexpr (kStreamingStores) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

__device__ __forceinline__ int64_t load_index(const void* idx, int idx64, int64_t r) {
  return idx64 ? (int64_t)__ldg(static_cast<const long long*>(idx) + r)
               : (int64_t)__ldg(static_cast<const int*>(idx) + r);
}

// a[k] of a kernel parameter's array, by selects: a dynamic index into a
// parameter would copy the whole struct to local memory.
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[kMaxStreams], int k) {
  return k == 0 ? a[0] : (k == 1 ? a[1] : a[2]);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const char* __restrict__ table, const Streams s, const int64_t words,
                   const int log_lanes) {
  using T = typename Word<V>::T;
  const int lane = threadIdx.x & 31;
  const int group = lane >> log_lanes;
  const int64_t sub = lane & ((1 << log_lanes) - 1);
  const int groups = 32 >> log_lanes;
  const int64_t lanes = int64_t{1} << log_lanes;
  const int64_t chunk_rows = (int64_t)groups * kDepth;
  const int64_t row_bytes = words * V;
  const int64_t chunks = s.first_chunk_end[kMaxStreams - 1];
  const int64_t warps = (int64_t)gridDim.x * (kThreads / 32);
  for (int64_t c = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32; c < chunks;
       c += warps) {
    const int k = (c >= s.first_chunk_end[0]) + (c >= s.first_chunk_end[1]);
    const int64_t first = k == 0 ? 0 : pick(s.first_chunk_end, k - 1);
    const int64_t base = (c - first) * chunk_rows + group;
    const int64_t n = pick(s.rows, k);
    const void* const idx = pick(s.idx, k);
    const int idx64 = pick(s.idx64, k);
    char* const out = pick(s.out, k);
    int64_t src[kDepth];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int64_t r = base + (int64_t)d * groups;
      src[d] = r < n ? load_index(idx, idx64, r) * row_bytes : 0;
    }
    // Every row load of the chunk, then every store. The loop's bound is
    // the same for the warp's lanes.
    for (int64_t w = sub; w - sub < words; w += lanes) {
      const bool in_row = w < words;
      T v[kDepth];
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        if (in_row && base + (int64_t)d * groups < n) {
          v[d] = __ldg(reinterpret_cast<const T*>(table + src[d]) + w);
        }
      }
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        const int64_t r = base + (int64_t)d * groups;
        if (in_row && r < n) store(reinterpret_cast<T*>(out + r * row_bytes) + w, v[d]);
      }
    }
  }
}

// Blocks of one instance that the card holds at once: its SMs times the
// blocks an SM takes, read once per device.
template <int V>
cudaError_t resident_blocks(int* blocks) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_rows_kernel<V>,
                                                          kThreads, 0);
    }
    if (err != cudaSuccess) return err;
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *blocks = cached[dev];
  return cudaSuccess;
}

template <int V>
int launch(const void* table, const Streams& s, int64_t words, int log_lanes,
           cudaStream_t stream) {
  int resident = 0;
  const cudaError_t err = resident_blocks<V>(&resident);
  if (err != cudaSuccess) return (int)err;
  const int64_t warps = s.first_chunk_end[kMaxStreams - 1];
  const int64_t wanted = (warps + kThreads / 32 - 1) / (kThreads / 32);
  const int blocks = (int)(wanted < resident ? wanted : resident);
  gather_rows_kernel<V><<<blocks, kThreads, 0, stream>>>(static_cast<const char*>(table), s,
                                                          words, log_lanes);
  return (int)cudaGetLastError();
}

}  // namespace

// out_k = table[idx_k] for the `count` streams k (1 to 3; a stream with no
// rows is left out by the caller). row_bytes: bytes of one table row, a
// multiple of vec (16, 8, 4, 2 or 1), which also divides the addresses of
// the table and of every output. idx64_k: 1 for int64 indices, 0 for
// int32. Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int ghf_gather_rows(const void* table, int64_t row_bytes, int vec, int count,
                               const void* idx0, int idx64_0, void* out0, int64_t rows0,
                               const void* idx1, int idx64_1, void* out1, int64_t rows1,
                               const void* idx2, int idx64_2, void* out2, int64_t rows2,
                               void* stream) {
  if (count < 1 || count > kMaxStreams || row_bytes <= 0 || vec <= 0 || row_bytes % vec != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t words = row_bytes / vec;
  int log_lanes = 0;
  while ((int64_t{1} << log_lanes) < words && log_lanes < 5) ++log_lanes;
  const int64_t chunk_rows = (int64_t)(32 >> log_lanes) * kDepth;
  const void* idx[kMaxStreams] = {idx0, idx1, idx2};
  void* out[kMaxStreams] = {out0, out1, out2};
  const int64_t rows[kMaxStreams] = {rows0, rows1, rows2};
  const int idx64[kMaxStreams] = {idx64_0, idx64_1, idx64_2};
  Streams s{};
  int64_t total = 0;
  for (int k = 0; k < kMaxStreams; ++k) {
    if (k < count) {
      s.idx[k] = idx[k];
      s.out[k] = static_cast<char*>(out[k]);
      s.rows[k] = rows[k];
      s.idx64[k] = idx64[k];
      total += (rows[k] + chunk_rows - 1) / chunk_rows;
    }
    s.first_chunk_end[k] = total;
  }
  if (total == 0) return (int)cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 16: return launch<16>(table, s, words, log_lanes, st);
    case 8: return launch<8>(table, s, words, log_lanes, st);
    case 4: return launch<4>(table, s, words, log_lanes, st);
    case 2: return launch<2>(table, s, words, log_lanes, st);
    case 1: return launch<1>(table, s, words, log_lanes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
