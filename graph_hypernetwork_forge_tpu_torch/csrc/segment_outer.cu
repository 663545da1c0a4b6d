// Segment outer product, the weight gradient of the two-output transform
// (sm_90a).
//
//   partial[q] = x[run q]^T g[run q]                ([d_in, d_out], f32)
//   dW[u]      = sum of partial[q] over the runs q of relation u
//   r(e) = rel_sorted[(e / 256) * 256]
//
// The edge rows come relation-sorted and group-padded, so every 256-row
// tile holds one relation (a ragged last tile too, its missing rows counting
// as zero) and a relation's tiles are consecutive. A run is up to
// `run_tiles` consecutive tiles of one relation: relation u's tiles
// [tile_splits[u], tile_splits[u + 1]) in groups of run_tiles from the
// first, the last group ragged, and its runs are run_splits[u] ..
// run_splits[u + 1] - 1 (ops/cuda/edge_transform_bwd.py, run_bounds). The
// wrapper sums each relation's run partials with the CSR segment-sum kernel
// (segment_sum.cu) over run_splits, so a relation that no tile visits comes
// out exactly zero, the result is bitwise the same from run to run, and
// there are no float atomics.
//
// Replaces the TPU kernel _segment_outer_impl
// (graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:473, kernel
// body :447-470), the dW half of edge_transform_sorted's backward. On the
// TPU a relation's dW block stays in VMEM while the sequential grid walks
// the relation's consecutive tiles. Here one block walks one run and keeps
// its dW in registers; Hopper's blocks run in no order, so each run writes
// its own partial and the second pass adds them. This is kernel 3's dW
// half (edge_transform_bwd.cu) for one bank.
//
// The products run on the tensor cores in 3xTF32 (tf32x3.cuh), f32-class at
// three TF32 passes. What bounds it on the H100, at E=1.03M: the bytes of x
// and g (2 E d * 4, 0.53 GB at d=64: 0.16 ms at 3.35 TB/s; 1.06 GB at
// d=128: 0.32 ms) against 2 E d_in d_out f32-class operations, three
// passes of which at 495 TFLOP/s take 0.05 / 0.21 ms; at the ~154 TFLOP/s
// that kernel 3's products reach on mma.sync, 0.16 / 0.66 ms. The run
// partials add 2,131 x d_in x d_out x 4 bytes (runs of 2 tiles: 35 MB at
// d=64, 140 MB at d=128) written here and read by the reduction.
//
// What the design does about it: a block owns one run, one slab of 64 d_in
// columns and one slab of up to 128 d_out columns (d=128: two blocks per
// run, next to each other in launch order so that the second reads the
// run's g from L2). It walks the run in chunks of BM rows through a
// cp.async ring (16-byte copies; 4-byte ones when a width or pointer is
// not 16-byte aligned; zero fill past each edge) and keeps its [64, d_out]
// dW in registers over the whole run: 2 x 2 warps of 2 m-tiles (32 d_in
// rows) and DOUT / 16 n-tiles each, every operand split into TF32 halves
// as its fragment is read. Fragment k = tig and tig + 4 come from chunk
// rows 2 tig and 2 tig + 1, and rows are padded to = 4 (mod 32) floats, so
// both fragment loads are free of bank conflicts.
// Measured on the H100 (scripts/tune_edge_kernels.py, xl): this kernel
// alone takes 0.23-0.24 ms at d=64 and 0.74-0.75 ms at d=128, as long as
// cuBLAS's bmm of the per-tile products; the reduction of the partials by
// kernel 1 adds 0.07 / 0.14 ms. 64-row chunks, 2 stages, two blocks of 4
// warps an SM: 153 registers at d_out <= 64, 254 at d_out <= 128, no
// spills. No faster, within the 3% spread between calls: 3 stages, 32-row
// chunks with 3 stages, 128-row chunks, one or three blocks an SM, 8 warps
// (2 x 4), 128 d_in columns a block, dW in groups of 2 n-tiles, the k loop
// not unrolled or unrolled by 4. Runs of 2 tiles (ops/cuda/segment_outer.py,
// RUN_TILES).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int kTileRows = 256;  // relation tile of the group-padded layout
constexpr int CS = 64;          // d_in columns per block
constexpr int kXS = CS + 4;     // x rows in shared memory, floats
constexpr int BM = 64;          // rows per chunk
constexpr int kStages = 2;      // ring stages
constexpr int kWarpsM = 2;      // warps over the 64 d_in rows, 32 each
constexpr int kWarpsN = 2;      // warps over the DOUT columns
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kMinBlocks = 2;   // blocks an SM (__launch_bounds__)

static_assert(kWarpsM * 32 == CS, "the warps cover the d_in slab");

// d_out slab (64 or 128): n-tiles a warp, shared-memory layout.
template <int DOUT>
struct Shape {
  static constexpr int NW = DOUT / (8 * kWarpsN);  // n-tiles a warp
  static constexpr int NG = NW < 4 ? NW : 4;       // n-tiles per fragment group
  static constexpr int kGS = DOUT + 4;             // g rows, floats
  static constexpr int kStage = BM * (kXS + kGS);  // floats
  static constexpr int kSmem = kStages * kStage * 4;
};

template <int DOUT, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
segment_outer_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     const int32_t* __restrict__ tile_splits,
                     const int32_t* __restrict__ run_splits,
                     float* __restrict__ partial, int num_edges, int d_in,
                     int d_out, int num_rel, int run_tiles) {
  using S = Shape<DOUT>;
  constexpr int NW = S::NW, NG = S::NG, kGS = S::kGS, kStage = S::kStage;
  extern __shared__ __align__(16) float smem[];  // [stage][X BM x kXS | G BM x kGS]

  const int cslabs = (d_in + CS - 1) / CS;
  const int run = blockIdx.x / cslabs;
  const int c0 = (blockIdx.x % cslabs) * CS;
  const int n0 = blockIdx.y * DOUT;
  if (run >= run_splits[num_rel]) return;  // the grid is an upper bound
  int u = 0;  // the relation: run_splits[u] <= run < run_splits[u + 1]
  for (int hi = num_rel; hi - u > 1;) {
    const int mid = (u + hi) / 2;
    if (run_splits[mid] <= run) u = mid; else hi = mid;
  }
  const int t0 = tile_splits[u] + (run - run_splits[u]) * run_tiles;
  const int t1 = min(t0 + run_tiles, tile_splits[u + 1]);
  const int64_t row_begin = (int64_t)t0 * kTileRows;
  const int64_t row_end = min((int64_t)t1 * kTileRows, (int64_t)num_edges);
  const int chunks = (int)((row_end - row_begin + BM - 1) / BM);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;

  // Chunk ch's x columns c0.. and g columns n0.. into ring stage s.
  auto load = [&](int ch, int s) {
    float* X = smem + s * kStage;
    float* G = X + BM * kXS;
    const int64_t r0 = row_begin + (int64_t)ch * BM;
    if (kVec) {
#pragma unroll
      for (int v = tid; v < BM * CS / 4; v += kThreads) {
        const int r = v / (CS / 4), c = (v % (CS / 4)) * 4;
        const int64_t row = r0 + r;
        const bool ok = row < row_end && c0 + c < d_in;
        tf32x3::cp_async16(X + r * kXS + c, ok ? x + row * d_in + c0 + c : x, ok);
      }
#pragma unroll
      for (int v = tid; v < BM * DOUT / 4; v += kThreads) {
        const int r = v / (DOUT / 4), n = (v % (DOUT / 4)) * 4;
        const int64_t row = r0 + r;
        const bool ok = row < row_end && n0 + n < d_out;
        tf32x3::cp_async16(G + r * kGS + n, ok ? g + row * d_out + n0 + n : g, ok);
      }
    } else {
#pragma unroll 4
      for (int v = tid; v < BM * CS; v += kThreads) {
        const int r = v / CS, c = v % CS;
        const int64_t row = r0 + r;
        const bool ok = row < row_end && c0 + c < d_in;
        tf32x3::cp_async4(X + r * kXS + c, ok ? x + row * d_in + c0 + c : x, ok);
      }
#pragma unroll 4
      for (int v = tid; v < BM * DOUT; v += kThreads) {
        const int r = v / DOUT, n = v % DOUT;
        const int64_t row = r0 + r;
        const bool ok = row < row_end && n0 + n < d_out;
        tf32x3::cp_async4(G + r * kGS + n, ok ? g + row * d_out + n0 + n : g, ok);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) load(s, s);
    tf32x3::cp_async_commit();
  }

  float dw[NW / NG][2][NG][4];
#pragma unroll
  for (int q = 0; q < NW / NG; ++q)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NG; ++j)
#pragma unroll
        for (int l = 0; l < 4; ++l) dw[q][i][j][l] = 0.f;

  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int cb = wm * 32, nb = wn * NW * 8;
  for (int ch = 0; ch < chunks; ++ch) {
    tf32x3::cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk ch landed; chunk ch - 1's stage is free
    if (ch + kStages - 1 < chunks)
      load(ch + kStages - 1, (ch + kStages - 1) % kStages);
    tf32x3::cp_async_commit();

    const float* X = smem + (ch % kStages) * kStage;
    const float* G = X + BM * kXS;
    // dW += X^T g, K = the chunk's rows.
#pragma unroll 2
    for (int kb = 0; kb < BM; kb += 8) {
      // Fragment k = tig, tig + 4 <-> chunk rows kb + 2 tig, kb + 2 tig + 1.
      const float* x0 = X + (kb + 2 * tig) * kXS + cb + gid;
      const float* g0 = G + (kb + 2 * tig) * kGS + nb + gid;
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        tf32x3::split(x0[i * 16], ahi[i][0], alo[i][0]);
        tf32x3::split(x0[i * 16 + 8], ahi[i][1], alo[i][1]);
        tf32x3::split(x0[kXS + i * 16], ahi[i][2], alo[i][2]);
        tf32x3::split(x0[kXS + i * 16 + 8], ahi[i][3], alo[i][3]);
      }
#pragma unroll
      for (int q = 0; q < NW / NG; ++q) {
        uint32_t bhi[NG][2], blo[NG][2];
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          const int n = (q * NG + j) * 8;
          tf32x3::split(g0[n], bhi[j][0], blo[j][0]);
          tf32x3::split(g0[kGS + n], bhi[j][1], blo[j][1]);
        }
        tf32x3::mma3_tile<2, NG>(dw[q], ahi, alo, bhi, blo);
      }
    }
  }

  // This run's dW rows c0 + cb.., columns n0 + nb..
  float* __restrict__ p = partial + (int64_t)run * d_in * d_out;
#pragma unroll
  for (int q = 0; q < NW / NG; ++q)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const int n = n0 + nb + (q * NG + j) * 8 + 2 * tig;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + cb + i * 16 + gid + 8 * h;
          if (c >= d_in) continue;
          float* dst = p + (int64_t)c * d_out + n;
          const float v0 = dw[q][i][j][2 * h], v1 = dw[q][i][j][2 * h + 1];
          if (kVec) {  // d_out % 4 == 0: n and n + 1 both in or both out
            if (n < d_out) *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            if (n < d_out) dst[0] = v0;
            if (n + 1 < d_out) dst[1] = v1;
          }
        }
      }
}

template <int DOUT, bool kVec>
cudaError_t launch(const float* x, const float* g, const int32_t* tile_splits,
                   const int32_t* run_splits, float* partial, int num_edges,
                   int d_in, int d_out, int num_rel, int run_tiles,
                   int max_runs, cudaStream_t stream) {
  auto kernel = segment_outer_kernel<DOUT, kVec>;
  constexpr int smem = Shape<DOUT>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int cslabs = (d_in + CS - 1) / CS;
  dim3 grid((unsigned)max_runs * cslabs, (d_out + DOUT - 1) / DOUT);
  kernel<<<grid, kThreads, smem, stream>>>(x, g, tile_splits, run_splits,
                                           partial, num_edges, d_in, d_out,
                                           num_rel, run_tiles);
  return cudaGetLastError();
}

}  // namespace

// x: [E, d_in] f32; g: [E, d_out] f32; tile_splits, run_splits: [num_rel +
// 1] int32 (relation u's tiles and runs, as above); partial: [max_runs,
// d_in, d_out] f32, rows 0 .. run_splits[num_rel] - 1 written, max_runs >=
// run_splits[num_rel]. All contiguous. vec != 0: d_in and d_out are
// multiples of 4 and every pointer is 16-byte aligned (16-byte copies).
// Launches on `stream`; returns the CUDA error of the launch.
extern "C" int ghf_segment_outer(const void* x, const void* g,
                                 const void* tile_splits,
                                 const void* run_splits, void* partial,
                                 int num_edges, int d_in, int d_out,
                                 int num_rel, int run_tiles, int max_runs,
                                 int vec, void* stream) {
  if (num_edges <= 0 || d_in <= 0 || d_out <= 0 || max_runs <= 0)
    return (int)cudaSuccess;
  const auto xp = static_cast<const float*>(x);
  const auto gp = static_cast<const float*>(g);
  const auto ts = static_cast<const int32_t*>(tile_splits);
  const auto rs = static_cast<const int32_t*>(run_splits);
  const auto part = static_cast<float*>(partial);
  const auto s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d_out <= 64) {
    err = vec ? launch<64, true>(xp, gp, ts, rs, part, num_edges, d_in, d_out,
                                 num_rel, run_tiles, max_runs, s)
              : launch<64, false>(xp, gp, ts, rs, part, num_edges, d_in, d_out,
                                  num_rel, run_tiles, max_runs, s);
  } else {
    err = vec ? launch<128, true>(xp, gp, ts, rs, part, num_edges, d_in, d_out,
                                  num_rel, run_tiles, max_runs, s)
              : launch<128, false>(xp, gp, ts, rs, part, num_edges, d_in,
                                   d_out, num_rel, run_tiles, max_runs, s);
  }
  return (int)err;
}
