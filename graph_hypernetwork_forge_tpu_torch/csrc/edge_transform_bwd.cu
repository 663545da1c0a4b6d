// Fused backward of the relation-grouped combined edge transform (sm_90a).
//
//   dx_src[e, :] = g[e, :] @ W_msg[r]^T      dx_dst[e, :] = g[e, :] @ W_self[r]^T
//   partial[q]   = [ x_src[run q]^T g[run q] | x_dst[run q]^T g[run q] ]
//   r = rel_sorted[(e / 256) * 256]                                    (f32)
//
// The edge rows come relation-sorted and group-padded, so every 256-row
// tile holds one relation (a ragged last tile too, its missing rows
// counting as zero) and a relation's tiles are consecutive. A run is up to
// `run_tiles` consecutive tiles of one relation: relation u's tiles
// [tile_splits[u], tile_splits[u + 1]) in groups of run_tiles from the
// first, the last group ragged, and its runs are run_splits[u] ..
// run_splits[u + 1] - 1, so runs are fixed by the tile index alone.
// dW_msg[u] and dW_self[u] are the sums of the partials of relation u's
// runs; the wrapper takes that sum with the CSR segment-sum kernel
// (segment_sum.cu) over run_splits, so a relation that no tile visits
// comes out exactly zero, the result is bitwise the same from run to run,
// and there are no float atomics.
//
// Replaces the TPU kernel _combined_bwd_fused_impl
// (graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:368, kernel
// body :334-365), the backward of edge_transform_sorted_combined. On the
// TPU the dW block of a relation stays in VMEM while the grid walks the
// relation's consecutive tiles in order. Here one block walks one run and
// keeps its dW in registers; Hopper's blocks run in no order, so each run
// writes its own partial and the second pass adds them.
//
// The products run on the tensor cores in 3xTF32 (tf32x3.cuh), f32-class
// at three TF32 passes. What bounds it on the H100, at E=1.03M: 8 E d_in
// d_out f32-class operations, three passes of which at 495 TFLOP/s take
// 0.20 ms at d=64 and 0.82 ms at d=128, against ~5 E d * 4 bytes plus the
// banks and partials, 0.40 ms at d=64 and 0.78 ms at d=128.
//
// What the design does about it: a block owns one run and one slab of 64
// d_in columns (d=128: two blocks per run, next to each other in launch
// order so the second reads the run's g from L2). It stages the slab's
// rows of both banks once with cp.async, in the same copy group as the
// first chunk (scalar loads of the banks took 8-9% more time), and walks the
// run in chunks of BM rows through a cp.async ring (16-byte copies; 4-byte
// ones when a width or pointer is not 16-byte aligned; zero fill past each
// edge). Each chunk's g, x_src and x_dst are staged once and feed both
// products, every operand split into TF32 halves as its fragment is read:
//   1. dx: [BM rows x (2 banks x 64 columns)], K = d_out, against the
//      staged banks; stored from the accumulators per chunk;
//   2. dW: [(x_src | x_dst)^T 128 rows x d_out] += X^T g with K = the
//      chunk's rows, accumulated in registers across the whole run.
// d_out up to 128 is one pass; a wider d_out walks the run once per
// 128-column slab and adds each slab's dx to the last (the same block
// reads back what it wrote, so it stays deterministic).
// Shared-memory rows are padded to = 4 (mod 32) floats; dW's fragments
// take k = tig and tig + 4 from rows 2 tig and 2 tig + 1, so every fragment
// load of both products, row-wise and column-wise over the same g chunk, is
// free of bank conflicts.
// Sizes chosen on the card (scripts/tune_edge_kernels.py): BM = 64, 2
// stages, one block of 8 warps per SM; 139,264 bytes of shared memory and
// 234-236 registers without spills at d_out <= 64, 204,800 bytes and 255
// registers with 44 bytes of spills at d_out <= 128. The banks stay f32
// and are split as read: split once into {hi, lo} pairs they fill twice the
// space, which at d_out = 128 leaves room for 32-row chunks only; that form
// ran 6-7% slower at both widths.
// 3 stages, 32-row chunks with two blocks an SM at d_out <= 64, dW in
// groups of 2 n-tiles and k loops not unrolled all ran slower or no
// faster. Runs of 4 tiles (ops/cuda/edge_transform_bwd.py, RUN_TILES).
//
// precision="default" runs the body in one TF32 pass (kPasses = 1), the
// Hopper form of the TPU kernel's one bf16 pass (JAX :344).
//
// The bf16 form (speed mode: g, x and the banks in bf16, the TPU kernel's
// bf16 branch, JAX :344, :351, :355, :410-411) is a body of its own on the
// m16n8k16 bf16 mma.sync (bf16_mma.cuh), one pass, f32 sums: dx is rounded
// once to bf16 (g's dtype) where it is stored, dW stays an f32 partial per
// run, summed by kernel 1's f32 form as above (the wrapper's caller casts it
// to the bank dtype, JAX :293-294). Same blocking: one run and 64 d_in
// columns a block, 64-row chunks through a 2-stage ring of 16-byte cp.async
// copies of 8 bf16 (2-byte plain copies for widths or pointers that are not
// 16-byte aligned), the slab's bank rows staged with the first chunk. Every
// tile in shared memory is row-major with rows padded by 8 bf16 (odd
// multiples of 16 bytes, so ldmatrix is free of bank conflicts), and each
// operand is read with the ldmatrix form that gives its fragment:
//   1. dx = g W^T: A = the g chunk [rows][d_out] (ldmatrix), B = W^T, whose
//      transpose [d_in][d_out] is what is staged: the col operand as it
//      comes (ldmatrix, no .trans);
//   2. dW += X^T g: A = X^T, staged as X [rows][d_in] (ldmatrix.trans), B =
//      the g chunk [rows = K][d_out] (ldmatrix.trans).
// d_out is one slab of at most 128 columns: dx is rounded once from its
// whole sum, so the f32 form's slab loop, which adds each slab's dx to the
// last in the output, has no bf16 counterpart. What bounds it at d=64: its
// bytes (g, x_src, x_dst read and dx_src, dx_dst written in bf16, ~0.66 GB
// at E=1.03M, 0.20 ms), against 8 E d^2 = 34 GFLOP at 989 TFLOP/s (0.03 ms).
// On an H100 80GB HBM3 at 700 W the wrapper (this kernel and kernel 1 over
// the partials) took 0.483 / 1.039 ms at xl d=64 / 128 (bf16 bmm per tile
// and index_add_ of the partials: 0.639 / 1.933); one TF32 pass 0.674 /
// 1.617.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kTileRows = 256;  // relation tile of the group-padded layout
constexpr int kThreads = 256;  // 8 warps
constexpr int CS = 64;          // d_in columns per block
constexpr int kXS = CS + 4;     // x rows in shared memory, floats

// d_out slab (64 or 128), chunk rows, ring stages, warp tiles.
template <int DOUT>
struct Shape {
  static constexpr int BM = 64;
  static constexpr int kStages = 2;
  // dx: [BM rows x (2 banks x CS columns)], 2 x 4 warps of MX m-tiles and
  // 4 n-tiles (32 columns of one bank) each.
  static constexpr int MX = BM / 32;
  // dW: [(x_src | x_dst)^T 2 CS rows x DOUT], 4 x 2 warps of 2 m-tiles and
  // NW n-tiles (half of DOUT) each.
  static constexpr int NW = DOUT / 16;
  static constexpr int kGS = DOUT + 4;  // g rows, floats
  static constexpr int kWS = DOUT + 4;  // bank rows, floats
  static constexpr int kStage = BM * kGS + 2 * BM * kXS;  // floats
  static constexpr int kSmem = (2 * CS * kWS + kStages * kStage) * 4;
};

template <int DOUT, bool kVec, int kPasses>
__global__ void __launch_bounds__(kThreads, 1)
edge_transform_bwd_kernel(const float* __restrict__ g,
                          const float* __restrict__ x_src,
                          const float* __restrict__ x_dst,
                          const int32_t* __restrict__ tile_splits,
                          const int32_t* __restrict__ run_splits,
                          const float* __restrict__ w_msg,
                          const float* __restrict__ w_self,
                          float* __restrict__ dx_src,
                          float* __restrict__ dx_dst,
                          float* __restrict__ partial, int num_edges,
                          int d_in, int d_out, int num_rel, int run_tiles) {
  using S = Shape<DOUT>;
  constexpr int BM = S::BM, kStages = S::kStages;
  constexpr int kGS = S::kGS, kWS = S::kWS, kStage = S::kStage;
  constexpr int MX = S::MX, NX = 4, NW = S::NW;
  constexpr int NG = 4;                // dW: n-tiles per fragment group
  extern __shared__ __align__(16) float smem[];
  float* const Ws = smem;                // [2][CS][kWS]
  float* const ring = smem + 2 * CS * kWS;  // [stage][kStage]

  const int cslabs = (d_in + CS - 1) / CS;
  const int run = blockIdx.x / cslabs;
  const int c0 = (blockIdx.x % cslabs) * CS;
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
  const int64_t bank = (int64_t)u * d_in * d_out;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;

  for (int n0 = 0; n0 < d_out; n0 += DOUT) {
    __syncthreads();  // the last slab's banks and ring are no longer read

    // Chunk ch's g columns n0.., x_src and x_dst columns c0.. into stage s.
    auto load = [&](int ch, int s) {
      float* G = ring + s * kStage;
      float* XS = G + BM * kGS;
      float* XD = XS + BM * kXS;
      const int64_t r0 = row_begin + (int64_t)ch * BM;
      if (kVec) {
#pragma unroll
        for (int v = tid; v < BM * DOUT / 4; v += kThreads) {
          const int r = v / (DOUT / 4), n = (v % (DOUT / 4)) * 4;
          const int64_t row = r0 + r;
          const bool ok = row < row_end && n0 + n < d_out;
          tf32x3::cp_async16(G + r * kGS + n,
                             ok ? g + row * d_out + n0 + n : g, ok);
        }
#pragma unroll
        for (int v = tid; v < BM * CS / 4; v += kThreads) {
          const int r = v / (CS / 4), c = (v % (CS / 4)) * 4;
          const int64_t row = r0 + r;
          const bool ok = row < row_end && c0 + c < d_in;
          const int64_t off = row * d_in + c0 + c;
          tf32x3::cp_async16(XS + r * kXS + c, ok ? x_src + off : x_src, ok);
          tf32x3::cp_async16(XD + r * kXS + c, ok ? x_dst + off : x_dst, ok);
        }
      } else {
#pragma unroll 4
        for (int v = tid; v < BM * DOUT; v += kThreads) {
          const int r = v / DOUT, n = v % DOUT;
          const int64_t row = r0 + r;
          const bool ok = row < row_end && n0 + n < d_out;
          tf32x3::cp_async4(G + r * kGS + n,
                            ok ? g + row * d_out + n0 + n : g, ok);
        }
#pragma unroll 4
        for (int v = tid; v < BM * CS; v += kThreads) {
          const int r = v / CS, c = v % CS;
          const int64_t row = r0 + r;
          const bool ok = row < row_end && c0 + c < d_in;
          const int64_t off = row * d_in + c0 + c;
          tf32x3::cp_async4(XS + r * kXS + c, ok ? x_src + off : x_src, ok);
          tf32x3::cp_async4(XD + r * kXS + c, ok ? x_dst + off : x_dst, ok);
        }
      }
    };

    // The slab's rows of both banks, Ws[b][c][k] = W_b[u][c0 + c][n0 + k]
    // (zero past d_in and d_out), land with chunk 0.
    if (kVec) {
#pragma unroll 4
      for (int v = tid; v < 2 * CS * DOUT / 4; v += kThreads) {
        const int b = v / (CS * DOUT / 4), c = (v / (DOUT / 4)) % CS;
        const int k = (v % (DOUT / 4)) * 4;
        const float* w = b ? w_self : w_msg;
        const bool ok = c0 + c < d_in && n0 + k < d_out;
        tf32x3::cp_async16(Ws + (b * CS + c) * kWS + k,
                           ok ? w + bank + (int64_t)(c0 + c) * d_out + n0 + k : w, ok);
      }
    } else {
#pragma unroll 4
      for (int v = tid; v < 2 * CS * DOUT; v += kThreads) {
        const int b = v / (CS * DOUT), c = (v / DOUT) % CS, k = v % DOUT;
        const float* w = b ? w_self : w_msg;
        const bool ok = c0 + c < d_in && n0 + k < d_out;
        tf32x3::cp_async4(Ws + (b * CS + c) * kWS + k,
                          ok ? w + bank + (int64_t)(c0 + c) * d_out + n0 + k : w, ok);
      }
    }
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

    for (int ch = 0; ch < chunks; ++ch) {
      tf32x3::cp_async_wait<kStages - 2>();
      __syncthreads();  // chunk ch (and the banks) landed; ch - 1's stage is free
      if (ch + kStages - 1 < chunks)
        load(ch + kStages - 1, (ch + kStages - 1) % kStages);
      tf32x3::cp_async_commit();

      const float* G = ring + (ch % kStages) * kStage;
      const float* XS = G + BM * kGS;
      const float* XD = XS + BM * kXS;
      const int64_t r0 = row_begin + (int64_t)ch * BM;

      // ---- 1. dx = g W^T: warps 2 (rows) x 4 (bank, 32 columns) ----------
      {
        const int wm = warp >> 2, wn = warp & 3;
        const int b = wn >> 1, cb = (wn & 1) * 32;
        float acc[MX][NX][4];
#pragma unroll
        for (int i = 0; i < MX; ++i)
#pragma unroll
          for (int j = 0; j < NX; ++j)
#pragma unroll
            for (int l = 0; l < 4; ++l) acc[i][j][l] = 0.f;
        const float* a0 = G + (wm * MX * 16 + gid) * kGS + tig;
        const float* w0 = Ws + (b * CS + cb + gid) * kWS + tig;
#pragma unroll 2
        for (int kb = 0; kb < DOUT; kb += 8) {
          uint32_t ahi[MX][4], alo[MX][4];
#pragma unroll
          for (int i = 0; i < MX; ++i) {
            const float* a = a0 + i * 16 * kGS + kb;
            tf32x3::operand<kPasses>(a[0], ahi[i][0], alo[i][0]);
            tf32x3::operand<kPasses>(a[8 * kGS], ahi[i][1], alo[i][1]);
            tf32x3::operand<kPasses>(a[4], ahi[i][2], alo[i][2]);
            tf32x3::operand<kPasses>(a[8 * kGS + 4], ahi[i][3], alo[i][3]);
          }
          uint32_t bhi[NX][2], blo[NX][2];
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            tf32x3::operand<kPasses>(w0[j * 8 * kWS + kb], bhi[j][0], blo[j][0]);
            tf32x3::operand<kPasses>(w0[j * 8 * kWS + kb + 4], bhi[j][1], blo[j][1]);
          }
          tf32x3::mma_tile<kPasses, MX, NX>(acc, ahi, alo, bhi, blo);
        }
        float* __restrict__ dx = b ? dx_dst : dx_src;
#pragma unroll
        for (int i = 0; i < MX; ++i)
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            const int c = c0 + cb + j * 8 + 2 * tig;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int64_t row = r0 + (wm * MX + i) * 16 + gid + 8 * h;
              if (row >= row_end) continue;
              float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
              float* dst = dx + row * d_in + c;
              if (kVec) {  // d_in % 4 == 0: c and c + 1 both in or both out
                if (c < d_in) {
                  if (n0) {
                    const float2 prev = *reinterpret_cast<const float2*>(dst);
                    v0 += prev.x;
                    v1 += prev.y;
                  }
                  *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
                }
              } else {
                if (c < d_in) dst[0] = n0 ? dst[0] + v0 : v0;
                if (c + 1 < d_in) dst[1] = n0 ? dst[1] + v1 : v1;
              }
            }
          }
      }

      // ---- 2. dW += X^T g: warps 4 (x_src^T, x_dst^T rows) x 2 (d_out) ---
      {
        const int wm = warp >> 1, wn = warp & 1;
        const float* X = (wm >> 1) ? XD : XS;
        const int cb = (wm & 1) * 32;
        const int nb = wn * NW * 8;
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
    }

    // This run's dW rows c0.. of both banks, columns n0..
    {
      const int wm = warp >> 1, wn = warp & 1;
      float* __restrict__ pb =
          partial + ((int64_t)run * 2 + (wm >> 1)) * d_in * d_out;
      const int cb = c0 + (wm & 1) * 32;
      const int nb = n0 + wn * NW * 8;
#pragma unroll
      for (int q = 0; q < NW / NG; ++q)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < NG; ++j) {
            const int n = nb + (q * NG + j) * 8 + 2 * tig;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c = cb + i * 16 + gid + 8 * h;
              if (c >= d_in) continue;
              float* dst = pb + (int64_t)c * d_out + n;
              const float v0 = dw[q][i][j][2 * h], v1 = dw[q][i][j][2 * h + 1];
              if (kVec) {
                if (n < d_out) *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
              } else {
                if (n < d_out) dst[0] = v0;
                if (n + 1 < d_out) dst[1] = v1;
              }
            }
          }
    }
  }
}

template <int DOUT, bool kVec, int kPasses>
cudaError_t launch(const float* g, const float* x_src, const float* x_dst,
                   const int32_t* tile_splits, const int32_t* run_splits,
                   const float* w_msg, const float* w_self, float* dx_src,
                   float* dx_dst, float* partial, int num_edges, int d_in,
                   int d_out, int num_rel, int run_tiles, int max_runs,
                   cudaStream_t stream) {
  auto kernel = edge_transform_bwd_kernel<DOUT, kVec, kPasses>;
  constexpr int smem = Shape<DOUT>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int cslabs = (d_in + CS - 1) / CS;
  kernel<<<(unsigned)max_runs * cslabs, kThreads, smem, stream>>>(
      g, x_src, x_dst, tile_splits, run_splits, w_msg, w_self, dx_src, dx_dst,
      partial, num_edges, d_in, d_out, num_rel, run_tiles);
  return cudaGetLastError();
}

// ---- Kernel 3's bf16 form: tensor cores, one bf16 pass -------------------

using bf16mma::bf16;

// d_out slab (64 or 128, the whole d_out), chunk rows, ring stages; tiles
// in bf16, rows padded by 8.
template <int DOUT>
struct ShapeH {
  static constexpr int BM = 64;
  static constexpr int kStages = 2;
  static constexpr int kGS = DOUT + 8;  // g rows
  static constexpr int kXS = CS + 8;    // x rows
  static constexpr int kWS = DOUT + 8;  // bank rows
  static constexpr int kStage = BM * kGS + 2 * BM * kXS;           // bf16
  static constexpr int kSmem = (2 * CS * kWS + kStages * kStage) * 2;  // bytes
};

template <int DOUT, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
edge_transform_bwd_bf16_kernel(const bf16* __restrict__ g,
                               const bf16* __restrict__ x_src,
                               const bf16* __restrict__ x_dst,
                               const int32_t* __restrict__ tile_splits,
                               const int32_t* __restrict__ run_splits,
                               const bf16* __restrict__ w_msg,
                               const bf16* __restrict__ w_self,
                               bf16* __restrict__ dx_src,
                               bf16* __restrict__ dx_dst,
                               float* __restrict__ partial, int num_edges,
                               int d_in, int d_out, int num_rel,
                               int run_tiles) {
  using S = ShapeH<DOUT>;
  constexpr int BM = S::BM, kStages = S::kStages;
  constexpr int kGS = S::kGS, kXH = S::kXS, kWS = S::kWS, kStage = S::kStage;
  constexpr int NW = DOUT / 16;  // dW: n-tiles of a warp (half of DOUT)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const Ws = reinterpret_cast<bf16*>(smem_raw);  // [2][CS][kWS]
  bf16* const ring = Ws + 2 * CS * kWS;                 // [stage][kStage]

  const int cslabs = (d_in + CS - 1) / CS;
  const int run = blockIdx.x / cslabs;
  const int c0 = (blockIdx.x % cslabs) * CS;
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
  const int64_t bank = (int64_t)u * d_in * d_out;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;

  // Chunk ch's g, x_src and x_dst columns c0.. into stage s.
  auto load = [&](int ch, int s) {
    bf16* G = ring + s * kStage;
    bf16* XS = G + BM * kGS;
    bf16* XD = XS + BM * kXH;
    const int64_t r0 = row_begin + (int64_t)ch * BM;
    if (kVec) {
#pragma unroll
      for (int v = tid; v < BM * DOUT / 8; v += kThreads) {
        const int r = v / (DOUT / 8), n = (v % (DOUT / 8)) * 8;
        const int64_t row = r0 + r;
        const bool ok = row < row_end && n < d_out;
        bf16mma::copy8(G + r * kGS + n, ok ? g + row * d_out + n : g, ok);
      }
#pragma unroll
      for (int v = tid; v < BM * CS / 8; v += kThreads) {
        const int r = v / (CS / 8), c = (v % (CS / 8)) * 8;
        const int64_t row = r0 + r;
        const bool ok = row < row_end && c0 + c < d_in;
        const int64_t off = row * d_in + c0 + c;
        bf16mma::copy8(XS + r * kXH + c, ok ? x_src + off : x_src, ok);
        bf16mma::copy8(XD + r * kXH + c, ok ? x_dst + off : x_dst, ok);
      }
    } else {
#pragma unroll 4
      for (int v = tid; v < BM * DOUT; v += kThreads) {
        const int r = v / DOUT, n = v % DOUT;
        const int64_t row = r0 + r;
        const bool ok = row < row_end && n < d_out;
        bf16mma::copy1(G + r * kGS + n, g + (ok ? row * d_out + n : 0), ok);
      }
#pragma unroll 4
      for (int v = tid; v < BM * CS; v += kThreads) {
        const int r = v / CS, c = v % CS;
        const int64_t row = r0 + r;
        const bool ok = row < row_end && c0 + c < d_in;
        const int64_t off = ok ? row * d_in + c0 + c : 0;
        bf16mma::copy1(XS + r * kXH + c, x_src + off, ok);
        bf16mma::copy1(XD + r * kXH + c, x_dst + off, ok);
      }
    }
  };

  // The slab's rows of both banks, Ws[b][c][k] = W_b[u][c0 + c][k] (zero
  // past d_in and d_out), land with chunk 0.
  if (kVec) {
#pragma unroll 4
    for (int v = tid; v < 2 * CS * DOUT / 8; v += kThreads) {
      const int b = v / (CS * DOUT / 8), c = (v / (DOUT / 8)) % CS;
      const int k = (v % (DOUT / 8)) * 8;
      const bf16* w = b ? w_self : w_msg;
      const bool ok = c0 + c < d_in && k < d_out;
      bf16mma::copy8(Ws + (b * CS + c) * kWS + k,
                     ok ? w + bank + (int64_t)(c0 + c) * d_out + k : w, ok);
    }
  } else {
#pragma unroll 4
    for (int v = tid; v < 2 * CS * DOUT; v += kThreads) {
      const int b = v / (CS * DOUT), c = (v / DOUT) % CS, k = v % DOUT;
      const bf16* w = b ? w_self : w_msg;
      const bool ok = c0 + c < d_in && k < d_out;
      bf16mma::copy1(Ws + (b * CS + c) * kWS + k,
                     w + (ok ? bank + (int64_t)(c0 + c) * d_out + k : 0), ok);
    }
  }
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

  for (int ch = 0; ch < chunks; ++ch) {
    tf32x3::cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk ch (and the banks) landed; ch - 1's stage is free
    if (ch + kStages - 1 < chunks)
      load(ch + kStages - 1, (ch + kStages - 1) % kStages);
    tf32x3::cp_async_commit();

    const bf16* G = ring + (ch % kStages) * kStage;
    const bf16* XS = G + BM * kGS;
    const bf16* XD = XS + BM * kXH;
    const int64_t r0 = row_begin + (int64_t)ch * BM;

    // ---- 1. dx = g W^T: warps 2 (rows) x 4 (bank, 32 columns) ------------
    {
      const int wm = warp >> 2, wn = warp & 3;
      const int b = wn >> 1, cb = (wn & 1) * 32;
      float acc[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int l = 0; l < 4; ++l) acc[i][j][l] = 0.f;
      const bf16* a0 = G + wm * 32 * kGS;
      const bf16* w0 = Ws + (b * CS + cb) * kWS;
#pragma unroll
      for (int kb = 0; kb < DOUT; kb += 16) {
        uint32_t af[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          bf16mma::load_a(af[i], a0 + i * 16 * kGS + kb, kGS, lane);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          uint32_t bf[2][2];
          bf16mma::load_b2(bf, w0 + q * 16 * kWS + kb, kWS, lane);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            bf16mma::mma(acc[i][2 * q], af[i], bf[0]);
            bf16mma::mma(acc[i][2 * q + 1], af[i], bf[1]);
          }
        }
      }
      bf16* __restrict__ dx = b ? dx_dst : dx_src;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + cb + j * 8 + 2 * tig;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int64_t row = r0 + wm * 32 + i * 16 + gid + 8 * h;
            if (row >= row_end) continue;
            const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
            bf16* dst = dx + row * d_in + c;
            if (kVec) {  // d_in % 8 == 0: c and c + 1 both in or both out
              if (c < d_in)
                *reinterpret_cast<__nv_bfloat162*>(dst) = bf16mma::pack(v0, v1);
            } else {
              if (c < d_in) dst[0] = __float2bfloat16(v0);
              if (c + 1 < d_in) dst[1] = __float2bfloat16(v1);
            }
          }
        }
    }

    // ---- 2. dW += X^T g: warps 4 (x_src^T, x_dst^T rows) x 2 (d_out) -----
    {
      const int wm = warp >> 1, wn = warp & 1;
      const bf16* X = ((wm >> 1) ? XD : XS) + (wm & 1) * 32;
      const bf16* g0 = G + wn * (DOUT / 2);
#pragma unroll
      for (int kb = 0; kb < BM; kb += 16) {
        uint32_t af[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          bf16mma::load_a_trans(af[i], X + kb * kXH + i * 16, kXH, lane);
#pragma unroll
        for (int q = 0; q < NW / 2; ++q) {
          uint32_t bf[2][2];
          bf16mma::load_b2_trans(bf, g0 + kb * kGS + q * 16, kGS, lane);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            bf16mma::mma(dw[i][2 * q], af[i], bf[0]);
            bf16mma::mma(dw[i][2 * q + 1], af[i], bf[1]);
          }
        }
      }
    }
  }

  // This run's f32 dW rows c0.. of both banks.
  {
    const int wm = warp >> 1, wn = warp & 1;
    float* __restrict__ pb =
        partial + ((int64_t)run * 2 + (wm >> 1)) * d_in * d_out;
    const int cb = c0 + (wm & 1) * 32;
    const int nb = wn * (DOUT / 2);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const int n = nb + j * 8 + 2 * tig;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = cb + i * 16 + gid + 8 * h;
          if (c >= d_in) continue;
          float* dst = pb + (int64_t)c * d_out + n;
          const float v0 = dw[i][j][2 * h], v1 = dw[i][j][2 * h + 1];
          if (kVec) {
            if (n < d_out) *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            if (n < d_out) dst[0] = v0;
            if (n + 1 < d_out) dst[1] = v1;
          }
        }
      }
  }
}

template <int DOUT, bool kVec>
cudaError_t launch_bf16(const bf16* g, const bf16* x_src, const bf16* x_dst,
                        const int32_t* tile_splits, const int32_t* run_splits,
                        const bf16* w_msg, const bf16* w_self, bf16* dx_src,
                        bf16* dx_dst, float* partial, int num_edges, int d_in,
                        int d_out, int num_rel, int run_tiles, int max_runs,
                        cudaStream_t stream) {
  auto kernel = edge_transform_bwd_bf16_kernel<DOUT, kVec>;
  constexpr int smem = ShapeH<DOUT>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int cslabs = (d_in + CS - 1) / CS;
  kernel<<<(unsigned)max_runs * cslabs, kThreads, smem, stream>>>(
      g, x_src, x_dst, tile_splits, run_splits, w_msg, w_self, dx_src, dx_dst,
      partial, num_edges, d_in, d_out, num_rel, run_tiles);
  return cudaGetLastError();
}

template <int kPasses>
cudaError_t dispatch(const float* gp, const float* xs, const float* xd,
                     const int32_t* ts, const int32_t* rs, const float* wm,
                     const float* ws, float* dxs, float* dxd, float* part,
                     int num_edges, int d_in, int d_out, int num_rel,
                     int run_tiles, int max_runs, int vec, cudaStream_t s) {
  if (d_out <= 64) {
    return vec ? launch<64, true, kPasses>(gp, xs, xd, ts, rs, wm, ws, dxs, dxd,
                                           part, num_edges, d_in, d_out,
                                           num_rel, run_tiles, max_runs, s)
               : launch<64, false, kPasses>(gp, xs, xd, ts, rs, wm, ws, dxs,
                                            dxd, part, num_edges, d_in, d_out,
                                            num_rel, run_tiles, max_runs, s);
  }
  return vec ? launch<128, true, kPasses>(gp, xs, xd, ts, rs, wm, ws, dxs, dxd,
                                          part, num_edges, d_in, d_out, num_rel,
                                          run_tiles, max_runs, s)
             : launch<128, false, kPasses>(gp, xs, xd, ts, rs, wm, ws, dxs, dxd,
                                           part, num_edges, d_in, d_out,
                                           num_rel, run_tiles, max_runs, s);
}

}  // namespace

// g: [E, d_out] f32; x_src, x_dst: [E, d_in] f32; tile_splits, run_splits:
// [num_rel + 1] int32 (relation u's tiles and runs, as above); w_msg,
// w_self: [U, d_in, d_out] f32 (num_rel = U); dx_src, dx_dst: [E, d_in]
// f32; partial: [max_runs, 2, d_in, d_out] f32, rows 0 ..
// run_splits[num_rel] - 1 written, max_runs >= run_splits[num_rel]. All
// contiguous. passes: 3 (3xTF32) or 1 (one TF32 pass). vec != 0: d_in and
// d_out are multiples of 4 and every pointer is 16-byte aligned (16-byte
// copies). Launches on `stream`; returns the CUDA error of the launch.
extern "C" int ghf_edge_transform_bwd(const void* g, const void* x_src,
                                      const void* x_dst,
                                      const void* tile_splits,
                                      const void* run_splits,
                                      const void* w_msg, const void* w_self,
                                      void* dx_src, void* dx_dst,
                                      void* partial, int num_edges, int d_in,
                                      int d_out, int num_rel, int run_tiles,
                                      int max_runs, int passes, int vec,
                                      void* stream) {
  if (num_edges <= 0 || d_in <= 0 || d_out <= 0 || max_runs <= 0)
    return (int)cudaSuccess;
  const auto gp = static_cast<const float*>(g);
  const auto xs = static_cast<const float*>(x_src);
  const auto xd = static_cast<const float*>(x_dst);
  const auto ts = static_cast<const int32_t*>(tile_splits);
  const auto rs = static_cast<const int32_t*>(run_splits);
  const auto wm = static_cast<const float*>(w_msg);
  const auto ws = static_cast<const float*>(w_self);
  const auto dxs = static_cast<float*>(dx_src);
  const auto dxd = static_cast<float*>(dx_dst);
  const auto part = static_cast<float*>(partial);
  const auto s = reinterpret_cast<cudaStream_t>(stream);
  if (passes == 3)
    return (int)dispatch<3>(gp, xs, xd, ts, rs, wm, ws, dxs, dxd, part,
                            num_edges, d_in, d_out, num_rel, run_tiles,
                            max_runs, vec, s);
  if (passes == 1)
    return (int)dispatch<1>(gp, xs, xd, ts, rs, wm, ws, dxs, dxd, part,
                            num_edges, d_in, d_out, num_rel, run_tiles,
                            max_runs, vec, s);
  return (int)cudaErrorInvalidValue;
}

// The bf16 form: g, x_src, x_dst, w_msg, w_self, dx_src and dx_dst in bf16,
// partial f32, the rest as ghf_edge_transform_bwd's; d_out <= 128. vec != 0:
// d_in and d_out are multiples of 8 and every pointer is 16-byte aligned.
extern "C" int ghf_edge_transform_bwd_bf16(
    const void* g, const void* x_src, const void* x_dst,
    const void* tile_splits, const void* run_splits, const void* w_msg,
    const void* w_self, void* dx_src, void* dx_dst, void* partial,
    int num_edges, int d_in, int d_out, int num_rel, int run_tiles,
    int max_runs, int vec, void* stream) {
  if (num_edges <= 0 || d_in <= 0 || d_out <= 0 || max_runs <= 0)
    return (int)cudaSuccess;
  if (d_out > 128) return (int)cudaErrorInvalidValue;
  const auto gp = static_cast<const bf16*>(g);
  const auto xs = static_cast<const bf16*>(x_src);
  const auto xd = static_cast<const bf16*>(x_dst);
  const auto ts = static_cast<const int32_t*>(tile_splits);
  const auto rs = static_cast<const int32_t*>(run_splits);
  const auto wm = static_cast<const bf16*>(w_msg);
  const auto ws = static_cast<const bf16*>(w_self);
  const auto dxs = static_cast<bf16*>(dx_src);
  const auto dxd = static_cast<bf16*>(dx_dst);
  const auto part = static_cast<float*>(partial);
  const auto s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d_out <= 64) {
    err = vec ? launch_bf16<64, true>(gp, xs, xd, ts, rs, wm, ws, dxs, dxd,
                                      part, num_edges, d_in, d_out, num_rel,
                                      run_tiles, max_runs, s)
              : launch_bf16<64, false>(gp, xs, xd, ts, rs, wm, ws, dxs, dxd,
                                       part, num_edges, d_in, d_out, num_rel,
                                       run_tiles, max_runs, s);
  } else {
    err = vec ? launch_bf16<128, true>(gp, xs, xd, ts, rs, wm, ws, dxs, dxd,
                                       part, num_edges, d_in, d_out, num_rel,
                                       run_tiles, max_runs, s)
              : launch_bf16<128, false>(gp, xs, xd, ts, rs, wm, ws, dxs, dxd,
                                        part, num_edges, d_in, d_out, num_rel,
                                        run_tiles, max_runs, s);
  }
  return (int)err;
}
