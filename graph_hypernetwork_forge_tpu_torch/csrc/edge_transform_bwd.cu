// Fused backward of the relation-grouped combined edge transform (sm_90a).
//
//   dx_src[e, :] = g[e, :] @ W_msg[r]^T      dx_dst[e, :] = g[e, :] @ W_self[r]^T
//   dW_msg[u]    = sum over e with r = u of x_src[e]^T g[e]   (dW_self: x_dst)
//   r = rel_sorted[(e / 256) * 256]                                    (f32)
//
// The edge rows come relation-sorted and group-padded, so every 256-row
// tile holds one relation (a ragged last tile too, its missing rows
// counting as zero) and a relation's tiles are consecutive. A run is up to
// `run_tiles` consecutive tiles of one relation: relation u's tiles
// [tile_splits[u], tile_splits[u + 1]) in groups of run_tiles from the
// first, the last group ragged, and its runs are run_splits[u] ..
// run_splits[u + 1] - 1, so runs are fixed by the tile index alone. The
// run table comes from the SortPlan, built on the host once per layout, or
// from run_table_kernel below (one launch of one block) where there is no
// plan. A relation's runs add their dW inside this kernel: each run writes
// an f32 partial [x_src^T g | x_dst^T g] and the block that finishes the
// relation's last run sums its partials in run order (run_reduce.cuh, an
// ordered last-arriver reduction), so the result is bitwise the same from
// launch to launch with no float atomics and no second launch; a relation
// with one run writes dW directly, and one that no tile visits comes out
// exactly zero (written by the blocks of its run index).
//
// Replaces the TPU kernel _combined_bwd_fused_impl
// (graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:368, kernel
// body :334-365), the backward of edge_transform_sorted_combined. On the
// TPU the dW block of a relation stays in VMEM while the grid walks the
// relation's consecutive tiles in order. Here one block walks one run and
// keeps its dW in registers; Hopper's blocks run in no order, so the last
// of a relation's runs to finish adds the partials, in run order.
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
// faster. Runs of 4 tiles (data/encoding.py, RUN_TILES): 1, 2 and 8 ran
// slower or no faster in every form, with the reduction inside the kernel.
//
// precision="default" runs the body in one TF32 pass (kPasses = 1), the
// Hopper form of the TPU kernel's one bf16 pass (JAX :344).
//
// The bf16 form (speed mode: g, x and the banks in bf16, the TPU kernel's
// bf16 branch, JAX :344, :351, :355, :410-411) is a body of its own on the
// m16n8k16 bf16 mma.sync (bf16_mma.cuh), one pass, f32 sums: dx is rounded
// once to bf16 (g's dtype) from its f32 sum over the whole of d_out, dW is
// summed in f32 over the runs as above (the wrapper's caller casts it to
// the bank dtype, JAX :293-294). Every tile in shared memory is row-major
// with rows padded by 8 bf16 (odd multiples of 16 bytes, so ldmatrix is
// free of bank conflicts), and each operand is read with the ldmatrix form
// that gives its fragment:
//   1. dx = g W^T: A = the g chunk [rows][d_out] (ldmatrix), B = W^T, whose
//      transpose [d_in][d_out] is what is staged: the col operand as it
//      comes (ldmatrix, no .trans);
//   2. dW += X^T g: A = X^T, staged as X [rows][d_in] (ldmatrix.trans), B =
//      the g chunk [rows = K][d_out] (ldmatrix.trans).
// What bounds it at d=64: its bytes (g, x_src, x_dst read and dx_src,
// dx_dst written in bf16, ~0.66 GB at E=1.03M, 0.20 ms), against 8 E d^2 =
// 34 GFLOP at 989 TFLOP/s (0.03 ms): a block has to keep enough bytes in
// flight, and to store dx in whole sectors. One run and 64 d_in columns a
// block, 64-row chunks of 16-byte cp.async copies of 8 bf16 (2-byte plain
// copies for widths or pointers that are not 16-byte aligned) through a
// 4-stage ring, the slab's bank rows staged with the first chunk. dx leaves
// the accumulators through a shared tile (two, alternating by chunk) and
// goes out one chunk later in 16-byte stores of whole rows: stored from the
// accumulators, each warp store wrote 16-byte pieces of 8 rows. Any d_out:
// above 128 columns the block walks the run once per 128-column slab, keeps
// dx's f32 sums of the slabs before the last in an f32 scratch (dx_acc)
// that only the thread that wrote them reads back, and rounds dx to bf16
// on the last slab; dW's columns are split by slab.
// On an H100 80GB HBM3 at 700 W (scripts/tune_edge_kernels.py, xl, with the
// SortPlan's run table) the wrapper took 0.322 / 0.885 ms at d=64 / 128;
// dx stored from the accumulators 0.365 / 0.897; before this body and the
// reduction inside the kernel (2 stages, kernel 1 over the partials), 0.483
// / 1.039. 2 or 3 stages ran 0.327-0.332 at d=64; two blocks an SM with 3
// stages, which caps the registers at 128, 0.368.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "run_reduce.cuh"
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
                          float* __restrict__ dw_msg,
                          float* __restrict__ dw_self,
                          float* __restrict__ partial,
                          int* __restrict__ counters, int num_edges, int d_in,
                          int d_out, int num_rel, int run_tiles) {
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
  const int64_t plane = (int64_t)d_in * d_out;
  if (run < num_rel && tile_splits[run] == tile_splits[run + 1])
    runred::zero_slab<2, kThreads>(dw_msg, dw_self, run * plane, c0, 0, d_out,
                                   d_in, d_out);  // relation `run` has no tile
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
  const int64_t bank = (int64_t)u * plane;
  // This run's dW: dW[u] itself when it is u's only run, else its partial.
  float* const out_msg = runs == 1 ? dw_msg + bank : partial + run * 2 * plane;
  float* const out_self = runs == 1 ? dw_self + bank : out_msg + plane;

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
      float* __restrict__ pb = (wm >> 1) ? out_self : out_msg;
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
  if (runs > 1 && runred::last_arriver(counters + u * cslabs + c0 / CS, runs))
    for (int n0 = 0; n0 < d_out; n0 += DOUT)
      runred::sum_runs<2, DOUT, kThreads, kVec>(partial, q0, runs, dw_msg,
                                                dw_self, bank, c0, n0, d_in,
                                                d_out);
}



// `kernel` with `smem` bytes of dynamic shared memory (and the most of the
// SM's memory given to shared memory, so that kMinBlocks blocks fit), one
// block per run index and 64-column d_in slab: max(max_runs, num_rel) run
// indices, so that every relation's index reaches its block (zero_slab).
template <typename... P, typename... A>
cudaError_t start(void (*kernel)(P...), int smem, int max_runs, int num_rel,
                  int d_in, cudaStream_t stream, A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const unsigned blocks =
      (unsigned)max(max_runs, num_rel) * ((d_in + CS - 1) / CS);
  kernel<<<blocks, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// ---- Kernel 3's bf16 form: tensor cores, one bf16 pass -------------------

using bf16mma::bf16;

// d_out slab (64, or 128 for any wider d_out), chunk rows, ring stages and
// blocks an SM; tiles in bf16, rows padded by 8. d_out <= 64: 4 stages of
// 27,648 bytes, the banks' 18,432 and two dx tiles of 18,432, 165,888
// bytes; 128-column slabs: 4 stages of 35,840 bytes, 34,816 of banks and the
// dx tiles, 215,040 bytes; one block an SM (scripts/tune_edge_kernels.py:
// two blocks an SM with 3 stages at d_out <= 64 cap the registers at 128 a
// thread and ran slower).
template <int DOUT>
struct ShapeH {
  static constexpr int BM = 64;
  static constexpr int kStages = 4;
  static constexpr int kMinBlocks = 1;
  // dx of a chunk goes through shared memory and leaves in 16-byte stores
  // (16-byte copies only; the 2-byte path stores from the accumulators).
  static constexpr bool kStageDx = true;
  static constexpr int kGS = DOUT + 8;  // g rows
  static constexpr int kXS = CS + 8;    // x rows, and dx rows
  static constexpr int kWS = DOUT + 8;  // bank rows
  static constexpr int kStage = BM * kGS + 2 * BM * kXS;           // bf16
  static constexpr int kDxTile = 2 * BM * kXS;  // dx of both banks, bf16
  static constexpr int kSmem =
      (2 * CS * kWS + kStages * kStage + (kStageDx ? 2 * kDxTile : 0)) * 2;
};

template <int DOUT, bool kVec>
__global__ void __launch_bounds__(kThreads, ShapeH<DOUT>::kMinBlocks)
edge_transform_bwd_bf16_kernel(const bf16* __restrict__ g,
                               const bf16* __restrict__ x_src,
                               const bf16* __restrict__ x_dst,
                               const int32_t* __restrict__ tile_splits,
                               const int32_t* __restrict__ run_splits,
                               const bf16* __restrict__ w_msg,
                               const bf16* __restrict__ w_self,
                               bf16* __restrict__ dx_src,
                               bf16* __restrict__ dx_dst,
                               float* __restrict__ dx_acc,
                               float* __restrict__ dw_msg,
                               float* __restrict__ dw_self,
                               float* __restrict__ partial,
                               int* __restrict__ counters, int num_edges,
                               int d_in, int d_out, int num_rel,
                               int run_tiles) {
  using S = ShapeH<DOUT>;
  constexpr int BM = S::BM, kStages = S::kStages;
  constexpr int kGS = S::kGS, kXH = S::kXS, kWS = S::kWS, kStage = S::kStage;
  constexpr int NW = DOUT / 16;  // dW: n-tiles of a warp (half of DOUT)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const Ws = reinterpret_cast<bf16*>(smem_raw);  // [2][CS][kWS]
  bf16* const ring = Ws + 2 * CS * kWS;                 // [stage][kStage]
  bf16* const dxs = ring + kStages * kStage;            // [2][bank][BM][kXH]
  constexpr bool kStageDx = kVec && S::kStageDx;

  const int cslabs = (d_in + CS - 1) / CS;
  const int run = blockIdx.x / cslabs;
  const int c0 = (blockIdx.x % cslabs) * CS;
  const int64_t plane = (int64_t)d_in * d_out;
  if (run < num_rel && tile_splits[run] == tile_splits[run + 1])
    runred::zero_slab<2, kThreads>(dw_msg, dw_self, run * plane, c0, 0, d_out,
                                   d_in, d_out);  // relation `run` has no tile
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
  const int64_t bank = (int64_t)u * plane;
  // This run's dW: dW[u] itself when it is u's only run, else its partial.
  float* const out_msg = runs == 1 ? dw_msg + bank : partial + run * 2 * plane;
  float* const out_self = runs == 1 ? dw_self + bank : out_msg + plane;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;

  // d_out <= 64 is one slab (known here, so the slab logic folds away).
  const int n_end = DOUT == 64 ? DOUT : d_out;
  for (int n0 = 0; n0 < n_end; n0 += DOUT) {
    const bool first = n0 == 0, last = DOUT == 64 || n0 + DOUT >= d_out;
    __syncthreads();  // the last slab's banks and ring are no longer read

    // Chunk ch's g columns n0.., x_src and x_dst columns c0.. into stage s.
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
          const bool ok = row < row_end && n0 + n < d_out;
          bf16mma::copy8(G + r * kGS + n, ok ? g + row * d_out + n0 + n : g, ok);
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
          const bool ok = row < row_end && n0 + n < d_out;
          bf16mma::copy1(G + r * kGS + n, g + (ok ? row * d_out + n0 + n : 0), ok);
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

    // Chunk ch's dx rows, staged in dxs[ch % 2], to dx_src and dx_dst in
    // 16-byte stores, 8 bf16 of one row each.
    auto store_dx = [&](int ch) {
      const bf16* T = dxs + (ch & 1) * S::kDxTile;
      const int64_t r0 = row_begin + (int64_t)ch * BM;
#pragma unroll
      for (int v = tid; v < 2 * BM * CS / 8; v += kThreads) {
        const int b = v / (BM * CS / 8), r = (v / (CS / 8)) % BM;
        const int c = (v % (CS / 8)) * 8;
        const int64_t row = r0 + r;
        if (row < row_end && c0 + c < d_in)
          *reinterpret_cast<uint4*>((b ? dx_dst : dx_src) + row * d_in + c0 + c) =
              *reinterpret_cast<const uint4*>(T + (b * BM + r) * kXH + c);
      }
    };

    // The slab's rows of both banks, Ws[b][c][k] = W_b[u][c0 + c][n0 + k]
    // (zero past d_in and d_out), land with chunk 0.
    if (kVec) {
#pragma unroll 4
      for (int v = tid; v < 2 * CS * DOUT / 8; v += kThreads) {
        const int b = v / (CS * DOUT / 8), c = (v / (DOUT / 8)) % CS;
        const int k = (v % (DOUT / 8)) * 8;
        const bf16* w = b ? w_self : w_msg;
        const bool ok = c0 + c < d_in && n0 + k < d_out;
        bf16mma::copy8(Ws + (b * CS + c) * kWS + k,
                       ok ? w + bank + (int64_t)(c0 + c) * d_out + n0 + k : w, ok);
      }
    } else {
#pragma unroll 4
      for (int v = tid; v < 2 * CS * DOUT; v += kThreads) {
        const int b = v / (CS * DOUT), c = (v / DOUT) % CS, k = v % DOUT;
        const bf16* w = b ? w_self : w_msg;
        const bool ok = c0 + c < d_in && n0 + k < d_out;
        bf16mma::copy1(Ws + (b * CS + c) * kWS + k,
                       w + (ok ? bank + (int64_t)(c0 + c) * d_out + n0 + k : 0), ok);
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
      // Chunk ch - 1's dx, staged before the barrier above.
      if (kStageDx && last && ch > 0) store_dx(ch - 1);

      const bf16* G = ring + (ch % kStages) * kStage;
      const bf16* XS = G + BM * kGS;
      const bf16* XD = XS + BM * kXH;
      const int64_t r0 = row_begin + (int64_t)ch * BM;

      // ---- 1. dx = g W^T: warps 2 (rows) x 4 (bank, 32 columns) ----------
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
        // dx is rounded to bf16 once, from its f32 sum over the whole of
        // d_out: a wider d_out keeps the sums of the slabs before the last
        // in dx_acc (f32), which only this thread writes and reads back.
        bf16* __restrict__ dx = b ? dx_dst : dx_src;
        float* __restrict__ dxf = dx_acc + (b ? (int64_t)num_edges * d_in : 0);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = c0 + cb + j * 8 + 2 * tig;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int64_t row = r0 + wm * 32 + i * 16 + gid + 8 * h;
              if (row >= row_end) continue;
              float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
              const int64_t at = row * d_in + c;
              if (kVec) {  // d_in % 8 == 0: c and c + 1 both in or both out
                if (c >= d_in) continue;
                float2* f = reinterpret_cast<float2*>(dxf + at);
                if (!first) {
                  const float2 prev = *f;
                  v0 += prev.x;
                  v1 += prev.y;
                }
                if (!last)
                  *f = make_float2(v0, v1);
                else if (kStageDx)
                  *reinterpret_cast<__nv_bfloat162*>(
                      dxs + (ch & 1) * S::kDxTile +
                      (b * BM + wm * 32 + i * 16 + gid + 8 * h) * kXH + c - c0) =
                      bf16mma::pack(v0, v1);
                else
                  *reinterpret_cast<__nv_bfloat162*>(dx + at) = bf16mma::pack(v0, v1);
              } else {
                if (c < d_in) {
                  if (!first) v0 += dxf[at];
                  if (last) dx[at] = __float2bfloat16(v0); else dxf[at] = v0;
                }
                if (c + 1 < d_in) {
                  if (!first) v1 += dxf[at + 1];
                  if (last) dx[at + 1] = __float2bfloat16(v1); else dxf[at + 1] = v1;
                }
              }
            }
          }
      }

      // ---- 2. dW += X^T g: warps 4 (x_src^T, x_dst^T rows) x 2 (d_out) ---
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

    if (kStageDx && last) {
      __syncthreads();  // the last chunk's dx is staged
      store_dx(chunks - 1);
    }

    // This run's f32 dW rows c0.. of both banks, columns n0..
    {
      const int wm = warp >> 1, wn = warp & 1;
      float* __restrict__ pb = (wm >> 1) ? out_self : out_msg;
      const int cb = c0 + (wm & 1) * 32;
      const int nb = n0 + wn * (DOUT / 2);
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
  if (runs > 1 && runred::last_arriver(counters + u * cslabs + c0 / CS, runs))
    for (int n0 = 0; n0 < n_end; n0 += DOUT)
      runred::sum_runs<2, DOUT, kThreads, kVec>(partial, q0, runs, dw_msg,
                                                dw_self, bank, c0, n0, d_in,
                                                d_out);
}

// ---- The run table, built on the card ------------------------------------

constexpr int kTableThreads = 1024;

// tile_splits[u] = the tiles whose first row's relation is below u, the
// searchsorted of the tiles' relations (ops/cuda/edge_transform_bwd.py,
// run_bounds); run_splits = the exclusive scan of each relation's runs,
// ceil(tiles of u / run_tiles). One block: a binary search per relation,
// then a block-wide scan over contiguous groups of relations.
__global__ void __launch_bounds__(kTableThreads)
run_table_kernel(const int32_t* __restrict__ rel_sorted, int num_edges,
                 int num_rel, int run_tiles, int32_t* __restrict__ tile_splits,
                 int32_t* __restrict__ run_splits) {
  __shared__ int warp_sums[kTableThreads / 32];
  const int tiles = (num_edges + kTileRows - 1) / kTileRows;
  for (int u = threadIdx.x; u <= num_rel; u += kTableThreads) {
    int lo = 0, hi = tiles;  // the first tile whose relation is >= u
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (rel_sorted[(int64_t)mid * kTileRows] < u) lo = mid + 1; else hi = mid;
    }
    tile_splits[u] = lo;
  }
  __syncthreads();  // every tile_splits entry is visible to the block

  const int per = (num_rel + kTableThreads - 1) / kTableThreads;
  const int u0 = min((int)threadIdx.x * per, num_rel), u1 = min(u0 + per, num_rel);
  auto runs_of = [&](int u) {
    return (tile_splits[u + 1] - tile_splits[u] + run_tiles - 1) / run_tiles;
  };
  int mine = 0;
  for (int u = u0; u < u1; ++u) mine += runs_of(u);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = mine;  // inclusive scan within the warp, then over the warps
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int at = incl - mine + (warp ? warp_sums[warp - 1] : 0);
  for (int u = u0; u < u1; ++u) {
    run_splits[u] = at;
    at += runs_of(u);
  }
  if (threadIdx.x == 0) run_splits[num_rel] = warp_sums[kTableThreads / 32 - 1];
}

template <int kPasses>
cudaError_t dispatch(const float* gp, const float* xs, const float* xd,
                     const int32_t* ts, const int32_t* rs, const float* wm,
                     const float* ws, float* dxs, float* dxd, float* dwm,
                     float* dws, float* part, int* cnt, int num_edges,
                     int d_in, int d_out, int num_rel, int run_tiles,
                     int max_runs, int vec, cudaStream_t s) {
#define GHF_K3_START(DOUT, VEC)                                                \
  start(edge_transform_bwd_kernel<DOUT, VEC, kPasses>, Shape<DOUT>::kSmem,     \
        max_runs, num_rel, d_in, s, gp, xs, xd, ts, rs, wm, ws, dxs, dxd, dwm, \
        dws, part, cnt, num_edges, d_in, d_out, num_rel, run_tiles)
  if (d_out <= 64) return vec ? GHF_K3_START(64, true) : GHF_K3_START(64, false);
  return vec ? GHF_K3_START(128, true) : GHF_K3_START(128, false);
#undef GHF_K3_START
}

}  // namespace

// g: [E, d_out] f32; x_src, x_dst: [E, d_in] f32; tile_splits, run_splits:
// [num_rel + 1] int32 (relation u's tiles and runs, as above); w_msg,
// w_self: [U, d_in, d_out] f32 (num_rel = U); dx_src, dx_dst: [E, d_in]
// f32; dw_msg, dw_self: [U, d_in, d_out] f32, every element written;
// partial: [max_runs, 2, d_in, d_out] f32 scratch, max_runs >=
// run_splits[num_rel]; counters: [num_rel * ceil(d_in / 64)] int32, zero
// before the launch and zero again after it (run_reduce.cuh). All
// contiguous. passes: 3 (3xTF32) or 1 (one TF32 pass). vec != 0: d_in and
// d_out are multiples of 4 and every pointer is 16-byte aligned (16-byte
// copies). Launches on `stream`; returns the CUDA error of the launch.
extern "C" int ghf_edge_transform_bwd(
    const void* g, const void* x_src, const void* x_dst,
    const void* tile_splits, const void* run_splits, const void* w_msg,
    const void* w_self, void* dx_src, void* dx_dst, void* dw_msg,
    void* dw_self, void* partial, void* counters, int num_edges, int d_in,
    int d_out, int num_rel, int run_tiles, int max_runs, int passes, int vec,
    void* stream) {
  if (d_in <= 0 || d_out <= 0 || num_rel <= 0) return (int)cudaSuccess;
  const auto gp = static_cast<const float*>(g);
  const auto xs = static_cast<const float*>(x_src);
  const auto xd = static_cast<const float*>(x_dst);
  const auto ts = static_cast<const int32_t*>(tile_splits);
  const auto rs = static_cast<const int32_t*>(run_splits);
  const auto wm = static_cast<const float*>(w_msg);
  const auto ws = static_cast<const float*>(w_self);
  const auto dxs = static_cast<float*>(dx_src);
  const auto dxd = static_cast<float*>(dx_dst);
  const auto dwm = static_cast<float*>(dw_msg);
  const auto dws = static_cast<float*>(dw_self);
  const auto part = static_cast<float*>(partial);
  const auto cnt = static_cast<int*>(counters);
  const auto s = reinterpret_cast<cudaStream_t>(stream);
  if (passes == 3)
    return (int)dispatch<3>(gp, xs, xd, ts, rs, wm, ws, dxs, dxd, dwm, dws,
                            part, cnt, num_edges, d_in, d_out, num_rel,
                            run_tiles, max_runs, vec, s);
  if (passes == 1)
    return (int)dispatch<1>(gp, xs, xd, ts, rs, wm, ws, dxs, dxd, dwm, dws,
                            part, cnt, num_edges, d_in, d_out, num_rel,
                            run_tiles, max_runs, vec, s);
  return (int)cudaErrorInvalidValue;
}

// The bf16 form: g, x_src, x_dst, w_msg, w_self, dx_src and dx_dst in bf16,
// dw_msg, dw_self and partial f32, the rest as ghf_edge_transform_bwd's;
// any d_out. dx_acc: [2, E, d_in] f32 scratch when d_out > 128 (dx's sums
// over the 128-column slabs before the last), else unused and may be null.
// vec != 0: d_in and d_out are multiples of 8 and every pointer is 16-byte
// aligned.
extern "C" int ghf_edge_transform_bwd_bf16(
    const void* g, const void* x_src, const void* x_dst,
    const void* tile_splits, const void* run_splits, const void* w_msg,
    const void* w_self, void* dx_src, void* dx_dst, void* dx_acc,
    void* dw_msg, void* dw_self, void* partial, void* counters, int num_edges,
    int d_in, int d_out, int num_rel, int run_tiles, int max_runs, int vec,
    void* stream) {
  if (d_in <= 0 || d_out <= 0 || num_rel <= 0) return (int)cudaSuccess;
  const auto gp = static_cast<const bf16*>(g);
  const auto xs = static_cast<const bf16*>(x_src);
  const auto xd = static_cast<const bf16*>(x_dst);
  const auto ts = static_cast<const int32_t*>(tile_splits);
  const auto rs = static_cast<const int32_t*>(run_splits);
  const auto wm = static_cast<const bf16*>(w_msg);
  const auto ws = static_cast<const bf16*>(w_self);
  const auto dxs = static_cast<bf16*>(dx_src);
  const auto dxd = static_cast<bf16*>(dx_dst);
  const auto acc = static_cast<float*>(dx_acc);
  const auto dwm = static_cast<float*>(dw_msg);
  const auto dws = static_cast<float*>(dw_self);
  const auto part = static_cast<float*>(partial);
  const auto cnt = static_cast<int*>(counters);
  const auto s = reinterpret_cast<cudaStream_t>(stream);
#define GHF_K3H_START(DOUT, VEC)                                               \
  start(edge_transform_bwd_bf16_kernel<DOUT, VEC>, ShapeH<DOUT>::kSmem,        \
        max_runs, num_rel, d_in, s, gp, xs, xd, ts, rs, wm, ws, dxs, dxd, acc, \
        dwm, dws, part, cnt, num_edges, d_in, d_out, num_rel, run_tiles)
  if (d_out <= 64)
    return (int)(vec ? GHF_K3H_START(64, true) : GHF_K3H_START(64, false));
  return (int)(vec ? GHF_K3H_START(128, true) : GHF_K3H_START(128, false));
#undef GHF_K3H_START
}

// rel_sorted: [num_edges] int32, non-decreasing; tile_splits, run_splits:
// [num_rel + 1] int32, written: the run table of runs of run_tiles tiles
// (as ops/cuda/edge_transform_bwd.py's run_bounds), in one launch of one
// block on `stream`. Returns the CUDA error of the launch.
extern "C" int ghf_run_table(const void* rel_sorted, int num_edges,
                             int num_rel, int run_tiles, void* tile_splits,
                             void* run_splits, void* stream) {
  if (num_rel < 0 || run_tiles <= 0) return (int)cudaErrorInvalidValue;
  const auto s = reinterpret_cast<cudaStream_t>(stream);
  run_table_kernel<<<1, kTableThreads, 0, s>>>(
      static_cast<const int32_t*>(rel_sorted), num_edges, num_rel, run_tiles,
      static_cast<int32_t*>(tile_splits), static_cast<int32_t*>(run_splits));
  return (int)cudaGetLastError();
}
