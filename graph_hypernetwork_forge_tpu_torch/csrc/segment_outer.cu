// Segment outer product, the weight gradient of the two-output transform
// (sm_90a).
//
//   dW[u] = sum over e with r(e) = u of x[e]^T g[e]        ([d_in, d_out], f32)
//   r(e) = rel_sorted[(e / 256) * 256]
//
// The edge rows come relation-sorted and group-padded, so every 256-row
// tile holds one relation (a ragged last tile too, its missing rows counting
// as zero) and a relation's tiles are consecutive. A run is up to
// `run_tiles` consecutive tiles of one relation: relation u's tiles
// [tile_splits[u], tile_splits[u + 1]) in groups of run_tiles from the
// first, the last group ragged, and its runs are run_splits[u] ..
// run_splits[u + 1] - 1 (the run table of kernel 3, edge_transform_bwd.cu,
// with its own run length). A relation's runs add their dW inside this
// kernel: each run writes an f32 partial x[run]^T g[run] and the block that
// finishes the relation's last run sums its partials in run order
// (run_reduce.cuh): bitwise the same from launch to launch, no float
// atomics, no second launch; a relation with one run writes dW directly,
// and one that no tile visits comes out exactly zero.
//
// Replaces the TPU kernel _segment_outer_impl
// (graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:473, kernel
// body :447-470), the dW half of edge_transform_sorted's backward. On the
// TPU a relation's dW block stays in VMEM while the sequential grid walks
// the relation's consecutive tiles. Here one block walks one run and keeps
// its dW in registers; Hopper's blocks run in no order, so the last of a
// relation's runs to finish adds the partials, in run order. This is kernel
// 3's dW half (edge_transform_bwd.cu) for one bank.
//
// The products run on the tensor cores in 3xTF32 (tf32x3.cuh), f32-class at
// three TF32 passes. What bounds it on the H100, at E=1.03M: the bytes of x
// and g (2 E d * 4, 0.53 GB at d=64: 0.16 ms at 3.35 TB/s; 1.06 GB at
// d=128: 0.32 ms) against 2 E d_in d_out f32-class operations, three
// passes of which at 495 TFLOP/s take 0.05 / 0.21 ms; at the ~154 TFLOP/s
// that kernel 3's products reach on mma.sync, 0.16 / 0.66 ms. The run
// partials add 2,131 x d_in x d_out x 4 bytes (runs of 2 tiles: 35 MB at
// d=64, 140 MB at d=128) written and read back, mostly through L2.
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
// Measured on the H100 (scripts/tune_edge_kernels.py, xl), before the
// reduction moved inside: the kernel took 0.23-0.24 ms at d=64 and
// 0.74-0.75 ms at d=128, as long as cuBLAS's bmm of the per-tile
// products, and kernel 1's reduction of the partials 0.07 / 0.14 ms. With
// the reduction inside, the wrapper takes 0.242 / 0.778 ms (runs of 2
// tiles) and 0.249 / 0.765 (runs of 4); one TF32 pass 0.220 / 0.536 and
// 0.217 / 0.490; bf16 0.131 / 0.325 and 0.120 / 0.281. 64-row chunks, 2
// stages, two blocks of 4 warps an SM. No faster, within the 3% spread
// between calls: 3 stages, 32-row chunks with 3 stages, 128-row chunks,
// one or three blocks an SM, 8 warps (2 x 4), 128 d_in columns a block, dW
// in groups of 2 n-tiles, the k loop not unrolled or unrolled by 4. Runs
// of 4 tiles (data/encoding.py, RUN_TILES), as kernel 3's, so that one run
// table serves both.
//
// precision="default" runs the body in one TF32 pass (kPasses = 1:
// tf32x3::operand<1>, mma_tile<1, ...>), the Hopper form of the TPU
// kernel's one bf16 pass at default precision (JAX :461).
//
// The bf16 form (x and g in bf16, the TPU kernel's bf16 branch, JAX :461:
// one pass, f32 sums) is a body of its own on the m16n8k16 bf16 mma.sync
// (bf16_mma.cuh) with the same structure: one run, 64 d_in columns and one
// d_out slab of up to 128 a block, 64-row chunks through a 2-stage ring of
// 16-byte cp.async copies of 8 bf16 (2-byte plain copies where a width or
// pointer is not 16-byte aligned), dW in f32 registers over the run and one
// f32 partial per run, summed in run order as above: bitwise deterministic,
// exactly zero for unvisited relations (the wrapper's caller casts dW to
// the bank's dtype once, JAX :596-600). Its product is kernel
// 3's bf16 dW product (edge_transform_bwd.cu) for one bank: A = X^T, staged
// as X [rows][d_in] and read with ldmatrix.trans, B = the g chunk [rows =
// K][d_out] read with ldmatrix.trans, rows padded by 8 bf16. 2 x 2 warps of
// 32 d_in rows and half the slab's columns. What bounds it: the bytes of x
// and g, half of the f32 form's (0.26 GB at E=1.03M, d=64: 0.08 ms), plus
// the f32 run partials.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_mma.cuh"
#include "run_reduce.cuh"
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

// The counter of relation u's slab (d_in columns c0.., d_out slab blockIdx.y)
// among num_rel * cslabs * gridDim.y.
__device__ __forceinline__ int slot(int u, int c0, int cslabs) {
  return (u * cslabs + c0 / CS) * gridDim.y + blockIdx.y;
}

// d_out slab (64 or 128): n-tiles a warp, shared-memory layout.
template <int DOUT>
struct Shape {
  static constexpr int NW = DOUT / (8 * kWarpsN);  // n-tiles a warp
  static constexpr int NG = NW < 4 ? NW : 4;       // n-tiles per fragment group
  static constexpr int kGS = DOUT + 4;             // g rows, floats
  static constexpr int kStage = BM * (kXS + kGS);  // floats
  static constexpr int kSmem = kStages * kStage * 4;
};

template <int DOUT, bool kVec, int kPasses>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
segment_outer_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     const int32_t* __restrict__ tile_splits,
                     const int32_t* __restrict__ run_splits,
                     float* __restrict__ dw_out, float* __restrict__ partial,
                     int* __restrict__ counters, int num_edges, int d_in,
                     int d_out, int num_rel, int run_tiles) {
  using S = Shape<DOUT>;
  constexpr int NW = S::NW, NG = S::NG, kGS = S::kGS, kStage = S::kStage;
  extern __shared__ __align__(16) float smem[];  // [stage][X BM x kXS | G BM x kGS]

  const int cslabs = (d_in + CS - 1) / CS;
  const int run = blockIdx.x / cslabs;
  const int c0 = (blockIdx.x % cslabs) * CS;
  const int n0 = blockIdx.y * DOUT;
  const int64_t plane = (int64_t)d_in * d_out;
  if (run < num_rel && tile_splits[run] == tile_splits[run + 1])
    runred::zero_slab<1, kThreads>(dw_out, dw_out, run * plane, c0, n0,
                                   n0 + DOUT, d_in, d_out);  // no tile
  if (run >= run_splits[num_rel]) return;  // the grid is an upper bound
  int u = 0;  // the relation: run_splits[u] <= run < run_splits[u + 1]
  for (int hi = num_rel; hi - u > 1;) {
    const int mid = (u + hi) / 2;
    if (run_splits[mid] <= run) u = mid; else hi = mid;
  }
  const int q0 = run_splits[u], runs = run_splits[u + 1] - q0;
  const int t0 = tile_splits[u] + (run - q0) * run_tiles;
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
        tf32x3::operand<kPasses>(x0[i * 16], ahi[i][0], alo[i][0]);
        tf32x3::operand<kPasses>(x0[i * 16 + 8], ahi[i][1], alo[i][1]);
        tf32x3::operand<kPasses>(x0[kXS + i * 16], ahi[i][2], alo[i][2]);
        tf32x3::operand<kPasses>(x0[kXS + i * 16 + 8], ahi[i][3], alo[i][3]);
      }
#pragma unroll
      for (int q = 0; q < NW / NG; ++q) {
        uint32_t bhi[NG][2], blo[NG][2];
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          const int n = (q * NG + j) * 8;
          tf32x3::operand<kPasses>(g0[n], bhi[j][0], blo[j][0]);
          tf32x3::operand<kPasses>(g0[kGS + n], bhi[j][1], blo[j][1]);
        }
        tf32x3::mma_tile<kPasses, 2, NG>(dw[q], ahi, alo, bhi, blo);
      }
    }
  }

  // This run's dW rows c0 + cb.., columns n0 + nb..: dW[u] itself when it
  // is u's only run, else its partial.
  const int64_t bank = (int64_t)u * plane;
  float* __restrict__ p = runs == 1 ? dw_out + bank : partial + run * plane;
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
  if (runs > 1 && runred::last_arriver(counters + slot(u, c0, cslabs), runs))
    runred::sum_runs<1, DOUT, kThreads, kVec>(partial, q0, runs, dw_out,
                                              dw_out, bank, c0, n0, d_in,
                                              d_out);
}

// ---- The bf16 form: tensor cores, one bf16 pass --------------------------

using bf16mma::bf16;

// d_out slab (64 or 128): n-tiles a warp, shared-memory layout in bf16,
// rows padded by 8.
template <int DOUT>
struct ShapeH {
  static constexpr int NW = DOUT / (8 * kWarpsN);  // n-tiles a warp
  static constexpr int kXH = CS + 8;               // x rows, bf16
  static constexpr int kGH = DOUT + 8;             // g rows, bf16
  static constexpr int kStage = BM * (kXH + kGH);  // bf16
  static constexpr int kSmem = kStages * kStage * 2;
};

template <int DOUT, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
segment_outer_bf16_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ g,
                          const int32_t* __restrict__ tile_splits,
                          const int32_t* __restrict__ run_splits,
                          float* __restrict__ dw_out,
                          float* __restrict__ partial,
                          int* __restrict__ counters, int num_edges, int d_in,
                          int d_out, int num_rel, int run_tiles) {
  using S = ShapeH<DOUT>;
  constexpr int NW = S::NW, kXH = S::kXH, kGH = S::kGH, kStage = S::kStage;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const ring = reinterpret_cast<bf16*>(smem_raw);  // [stage][X | G]

  const int cslabs = (d_in + CS - 1) / CS;
  const int run = blockIdx.x / cslabs;
  const int c0 = (blockIdx.x % cslabs) * CS;
  const int n0 = blockIdx.y * DOUT;
  const int64_t plane = (int64_t)d_in * d_out;
  if (run < num_rel && tile_splits[run] == tile_splits[run + 1])
    runred::zero_slab<1, kThreads>(dw_out, dw_out, run * plane, c0, n0,
                                   n0 + DOUT, d_in, d_out);  // no tile
  if (run >= run_splits[num_rel]) return;  // the grid is an upper bound
  int u = 0;  // the relation: run_splits[u] <= run < run_splits[u + 1]
  for (int hi = num_rel; hi - u > 1;) {
    const int mid = (u + hi) / 2;
    if (run_splits[mid] <= run) u = mid; else hi = mid;
  }
  const int q0 = run_splits[u], runs = run_splits[u + 1] - q0;
  const int t0 = tile_splits[u] + (run - q0) * run_tiles;
  const int t1 = min(t0 + run_tiles, tile_splits[u + 1]);
  const int64_t row_begin = (int64_t)t0 * kTileRows;
  const int64_t row_end = min((int64_t)t1 * kTileRows, (int64_t)num_edges);
  const int chunks = (int)((row_end - row_begin + BM - 1) / BM);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;

  // Chunk ch's x columns c0.. and g columns n0.. into ring stage s.
  auto load = [&](int ch, int s) {
    bf16* X = ring + s * kStage;
    bf16* G = X + BM * kXH;
    const int64_t r0 = row_begin + (int64_t)ch * BM;
    if (kVec) {
#pragma unroll
      for (int v = tid; v < BM * CS / 8; v += kThreads) {
        const int r = v / (CS / 8), c = (v % (CS / 8)) * 8;
        const int64_t row = r0 + r;
        const bool ok = row < row_end && c0 + c < d_in;
        bf16mma::copy8(X + r * kXH + c, ok ? x + row * d_in + c0 + c : x, ok);
      }
#pragma unroll
      for (int v = tid; v < BM * DOUT / 8; v += kThreads) {
        const int r = v / (DOUT / 8), n = (v % (DOUT / 8)) * 8;
        const int64_t row = r0 + r;
        const bool ok = row < row_end && n0 + n < d_out;
        bf16mma::copy8(G + r * kGH + n, ok ? g + row * d_out + n0 + n : g, ok);
      }
    } else {
#pragma unroll 4
      for (int v = tid; v < BM * CS; v += kThreads) {
        const int r = v / CS, c = v % CS;
        const int64_t row = r0 + r;
        const bool ok = row < row_end && c0 + c < d_in;
        bf16mma::copy1(X + r * kXH + c, x + (ok ? row * d_in + c0 + c : 0), ok);
      }
#pragma unroll 4
      for (int v = tid; v < BM * DOUT; v += kThreads) {
        const int r = v / DOUT, n = v % DOUT;
        const int64_t row = r0 + r;
        const bool ok = row < row_end && n0 + n < d_out;
        bf16mma::copy1(G + r * kGH + n, g + (ok ? row * d_out + n0 + n : 0), ok);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) load(s, s);
    tf32x3::cp_async_commit();
  }

  float dw[2][NW][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int l = 0; l < 4; ++l) dw[i][j][l] = 0.f;

  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int cb = wm * 32, nb = wn * NW * 8;
  for (int ch = 0; ch < chunks; ++ch) {
    tf32x3::cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk ch landed; chunk ch - 1's stage is free
    if (ch + kStages - 1 < chunks)
      load(ch + kStages - 1, (ch + kStages - 1) % kStages);
    tf32x3::cp_async_commit();

    const bf16* X = ring + (ch % kStages) * kStage + cb;
    const bf16* G = ring + (ch % kStages) * kStage + BM * kXH + nb;
    // dW += X^T g, K = the chunk's rows.
#pragma unroll
    for (int kb = 0; kb < BM; kb += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        bf16mma::load_a_trans(af[i], X + kb * kXH + i * 16, kXH, lane);
#pragma unroll
      for (int q = 0; q < NW / 2; ++q) {
        uint32_t bf[2][2];
        bf16mma::load_b2_trans(bf, G + kb * kGH + q * 16, kGH, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          bf16mma::mma(dw[i][2 * q], af[i], bf[0]);
          bf16mma::mma(dw[i][2 * q + 1], af[i], bf[1]);
        }
      }
    }
  }

  // This run's f32 dW rows c0 + cb.., columns n0 + nb..: dW[u] itself when
  // it is u's only run, else its partial.
  const int64_t bank = (int64_t)u * plane;
  float* __restrict__ p = runs == 1 ? dw_out + bank : partial + run * plane;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int n = n0 + nb + j * 8 + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + cb + i * 16 + gid + 8 * h;
        if (c >= d_in) continue;
        float* dst = p + (int64_t)c * d_out + n;
        const float v0 = dw[i][j][2 * h], v1 = dw[i][j][2 * h + 1];
        if (kVec) {  // d_out % 8 == 0: n and n + 1 both in or both out
          if (n < d_out) *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          if (n < d_out) dst[0] = v0;
          if (n + 1 < d_out) dst[1] = v1;
        }
      }
    }
  if (runs > 1 && runred::last_arriver(counters + slot(u, c0, cslabs), runs))
    runred::sum_runs<1, DOUT, kThreads, kVec>(partial, q0, runs, dw_out,
                                              dw_out, bank, c0, n0, d_in,
                                              d_out);
}

// `kernel` with `smem` bytes of shared memory, one block per run index and
// 64-column d_in slab and per `dout`-column d_out slab: max(max_runs,
// num_rel) run indices, so that every relation's index reaches its blocks
// (zero_slab).
template <typename In>
cudaError_t start(void (*kernel)(const In*, const In*, const int32_t*,
                                 const int32_t*, float*, float*, int*, int, int,
                                 int, int, int),
                  int smem, int dout, const In* x, const In* g,
                  const int32_t* tile_splits, const int32_t* run_splits,
                  float* dw, float* partial, int* counters, int num_edges,
                  int d_in, int d_out, int num_rel, int run_tiles,
                  int max_runs, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int cslabs = (d_in + CS - 1) / CS;
  dim3 grid((unsigned)max(max_runs, num_rel) * cslabs,
            (d_out + dout - 1) / dout);
  kernel<<<grid, kThreads, smem, stream>>>(x, g, tile_splits, run_splits, dw,
                                           partial, counters, num_edges, d_in,
                                           d_out, num_rel, run_tiles);
  return cudaGetLastError();
}

// The f32 body at kPasses TF32 passes (float x and g) or the bf16 body
// (bf16 x and g), for the d_out slab DOUT and vec.
template <typename In, int kPasses, int DOUT, bool kVec>
cudaError_t launch(const In* x, const In* g, const int32_t* tile_splits,
                   const int32_t* run_splits, float* dw, float* partial,
                   int* counters, int num_edges, int d_in, int d_out,
                   int num_rel, int run_tiles, int max_runs,
                   cudaStream_t stream) {
  if constexpr (std::is_same<In, bf16>::value) {
    return start<In>(segment_outer_bf16_kernel<DOUT, kVec>, ShapeH<DOUT>::kSmem,
                     DOUT, x, g, tile_splits, run_splits, dw, partial, counters,
                     num_edges, d_in, d_out, num_rel, run_tiles, max_runs,
                     stream);
  } else {
    return start<In>(segment_outer_kernel<DOUT, kVec, kPasses>,
                     Shape<DOUT>::kSmem, DOUT, x, g, tile_splits, run_splits,
                     dw, partial, counters, num_edges, d_in, d_out, num_rel,
                     run_tiles, max_runs, stream);
  }
}

// The instance for the d_out slab (64 or 128 columns) and vec.
template <typename In, int kPasses>
int dispatch(const void* x, const void* g, const void* tile_splits,
             const void* run_splits, void* dw, void* partial, void* counters,
             int num_edges, int d_in, int d_out, int num_rel, int run_tiles,
             int max_runs, int vec, void* stream) {
  if (d_in <= 0 || d_out <= 0 || num_rel <= 0) return (int)cudaSuccess;
  const auto xp = static_cast<const In*>(x);
  const auto gp = static_cast<const In*>(g);
  const auto ts = static_cast<const int32_t*>(tile_splits);
  const auto rs = static_cast<const int32_t*>(run_splits);
  const auto dwp = static_cast<float*>(dw);
  const auto part = static_cast<float*>(partial);
  const auto cnt = static_cast<int*>(counters);
  const auto s = reinterpret_cast<cudaStream_t>(stream);
#define GHF_K6_LAUNCH(DOUT, VEC)                                           \
  launch<In, kPasses, DOUT, VEC>(xp, gp, ts, rs, dwp, part, cnt, num_edges, \
                                 d_in, d_out, num_rel, run_tiles, max_runs, s)
  cudaError_t err;
  if (d_out <= 64)
    err = vec ? GHF_K6_LAUNCH(64, true) : GHF_K6_LAUNCH(64, false);
  else
    err = vec ? GHF_K6_LAUNCH(128, true) : GHF_K6_LAUNCH(128, false);
#undef GHF_K6_LAUNCH
  return (int)err;
}
}  // namespace

// x: [E, d_in] f32; g: [E, d_out] f32; tile_splits, run_splits: [num_rel +
// 1] int32 (relation u's tiles and runs, as above); dw: [num_rel, d_in,
// d_out] f32, every element written; partial: [max_runs, d_in, d_out] f32
// scratch, max_runs >= run_splits[num_rel]; counters: [num_rel *
// ceil(d_in / 64) * ceil(d_out / slab)] int32 (slab 64 for d_out <= 64,
// else 128), zero before the launch and zero again after it
// (run_reduce.cuh). All contiguous. passes: 3 (3xTF32) or 1 (one TF32
// pass). vec != 0: d_in and d_out are multiples of 4 and every pointer is
// 16-byte aligned (16-byte copies). Launches on `stream`; returns the CUDA
// error of the launch.
extern "C" int ghf_segment_outer(const void* x, const void* g,
                                 const void* tile_splits,
                                 const void* run_splits, void* dw,
                                 void* partial, void* counters, int num_edges,
                                 int d_in, int d_out, int num_rel,
                                 int run_tiles, int max_runs, int passes,
                                 int vec, void* stream) {
  if (passes == 3)
    return dispatch<float, 3>(x, g, tile_splits, run_splits, dw, partial,
                              counters, num_edges, d_in, d_out, num_rel,
                              run_tiles, max_runs, vec, stream);
  if (passes == 1)
    return dispatch<float, 1>(x, g, tile_splits, run_splits, dw, partial,
                              counters, num_edges, d_in, d_out, num_rel,
                              run_tiles, max_runs, vec, stream);
  return (int)cudaErrorInvalidValue;
}

// The bf16 form: x and g bf16, dw and partial f32, the rest as
// ghf_segment_outer's. vec != 0: d_in and d_out are multiples of 8 and
// every pointer is 16-byte aligned.
extern "C" int ghf_segment_outer_bf16(const void* x, const void* g,
                                      const void* tile_splits,
                                      const void* run_splits, void* dw,
                                      void* partial, void* counters,
                                      int num_edges, int d_in, int d_out,
                                      int num_rel, int run_tiles,
                                      int max_runs, int vec, void* stream) {
  return dispatch<bf16, 1>(x, g, tile_splits, run_splits, dw, partial,
                           counters, num_edges, d_in, d_out, num_rel,
                           run_tiles, max_runs, vec, stream);
}
