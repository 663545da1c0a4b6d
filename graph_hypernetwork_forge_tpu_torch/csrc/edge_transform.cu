// Relation-grouped edge transforms for Hopper (sm_90a), in two forms.
//
// Combined (kernel 2):
//   out[e, :]   = x_src[e, :] @ W_msg[r] + x_dst[e, :] @ W_self[r] + bias[r]
// Two outputs (kernel 5):
//   msg[e, :]   = x_src[e, :] @ W_msg[r] + bias[r]
//   selfc[e, :] = x_dst[e, :] @ W_self[r]
// with r = rel_sorted[(e / 256) * 256]                                 (f32)
//
// The edge rows come relation-sorted and group-padded so that every
// 256-row tile holds one relation (encode_graph(sort_by_relation=True,
// group_pad=256)); a tile takes its relation from its first row, and a
// ragged last tile from that same first row.
//
// The combined form replaces the TPU kernel edge_transform_sorted_combined
// (graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:239), both as
// the `pallas` backend runs it at d=128 and as the `pallas_packed` backend
// runs it at d=64 through [U, 128, 128] block-diagonal banks. The block-
// diagonal packing only fills the TPU's 128 lanes; here the product runs
// directly at the model's width. The two-output form replaces the TPU
// kernel of edge_transform_sorted, _edge_transform_fwd_impl (same file,
// :108, kernel body :77-105); its backward runs it again on the cotangents
// with the banks transposed ([U, d_out, d_in]) and a zero bias, so d_in and
// d_out are free and may differ.
//
// Both run on the tensor cores in 3xTF32 (tf32x3.cuh), f32-class products
// at three TF32 passes, in one kernel body. What bounds kernel 2 on the
// H100: at d=64 the bytes (~0.79 GB at E=1.03M, 0.24 ms at 3.35 TB/s)
// against ~17 GFLOP of f32-class work, 0.10 ms as 3 x 17 GFLOP at 495
// TFLOP/s of TF32; at d=128 the bytes (~1.6 GB, 0.47 ms) against 0.41 ms
// of three-pass operations. Kernel 5 does the same operations and writes
// a second output: bytes, ~1.06 GB at d=64 (0.32 ms) and ~2.1 GB at d=128
// (0.64 ms).
// Design: one block owns 128 rows (inside one 256-row tile, so one
// relation) and a 64- or 128-column slab of the output, the whole d_out
// up to 128, so each x_src / x_dst row is read from device memory once.
// Kernel 2's product is one GEMM with K = 2 * d_in, [x_src | x_dst]
// against [W_msg ; W_self] of the tile's relation. Kernel 5 (kTwo) keeps
// the halves apart: grid plane z = 0 takes x_src and W_msg with the bias
// into msg, plane 1 x_dst and W_self without it into selfc, each with K =
// d_in. K is streamed in slices of 32 through a 3-stage cp.async ring
// (16-byte copies; 4-byte copies when a width or pointer is not 16-byte
// aligned), zero-filled past each edge.
// Eight warps of 32 rows x half the slab each hold their accumulators in
// registers; fragments are split into TF32 halves as they are loaded. The
// x rows are padded to 40 floats and read as float2 pairs (k = tig and
// tig + 4 map to columns 2 tig and 2 tig + 1), the weight rows to slab + 4
// floats: both fragment loads are free of bank conflicts. The bias is
// added in the epilogue, which stores straight from the accumulators.
// At most 128 registers a thread, so two blocks share an SM: 116 without
// spills at d_out <= 64, 128 with 8 bytes of spill stores at d_out <= 128
// (kernel 5: 12; scripts/tune_edge_kernels.py). The four 8-deep steps of
// a K slice run as a loop: unrolled, d_out <= 64 spilled 64 bytes and ran
// 11% slower.
// Kernel 5 with this body took 0.47-0.48 ms at xl d=64 and 1.41-1.44 ms at
// d=128 (its f32-FMA form 0.81 / 2.83; torch's baddbmm and bmm of the same
// products 0.81-0.83 / 2.21-2.22). For kernel 5 too, 2 ring stages, one
// block an SM, 2 n-tiles per group and unrolled K slices were no faster
// beyond the 2% spread between calls.
//
// precision="default" runs the body in one TF32 pass (kPasses = 1: hi
// products alone, tf32x3::mma_tile<1>), the Hopper form of the TPU kernels'
// one bf16 pass at default precision (JAX :169 for kernel 2, :92 for
// kernel 5).
//
// Kernel 2's bf16 form (speed mode: x, banks and bias in bf16, the TPU
// kernel's bf16 branch, JAX :166-182) is a body of its own on the m16n8k16
// bf16 mma.sync (bf16_mma.cuh): one pass, both products into one f32
// fragment, the bias added in f32 and one rounding to bf16 where the output
// is stored (out dtype = input dtype, as in JAX). Its blocking is kernel 2's:
// 128 rows x a 64- or 128-column slab, 8 warps of 32 rows x half the slab,
// K = [x_src | x_dst] streamed in 32-wide slices through a 3-stage ring of
// 16-byte cp.async copies (8 bf16; plain 2-byte copies when a width or
// pointer is not 16-byte aligned). A tiles are [rows][k] and read with
// ldmatrix; the bank slice is [k][n] (row-major [d_in, d_out]), the col B
// operand's transpose, so it is read with ldmatrix.trans. Rows are padded by
// 8 bf16 to odd multiples of 16 bytes: no bank conflicts. What bounds it:
// bytes, half of kernel 2's (~0.4 GB at E=1.03M, d=64), against 17 GFLOP at
// 989 TFLOP/s of dense bf16 (0.02 ms). On an H100 80GB HBM3 at 700 W it took
// 0.219 / 0.472 ms at xl d=64 / 128 with stores from the accumulators
// (cuBLAS's bf16 baddbmm of the same products over tile-gathered banks:
// 0.335 / 0.712), 0.166 / 0.384 with the staged epilogue below; the
// one-TF32-pass mode 0.315 / 0.679.
//
// Kernel 5's bf16 form (the bf16 branch of the TPU kernel of
// edge_transform_sorted, JAX :90-103) is the kTwo mode of that body, as
// kernel 5's f32 form is of kernel 2's: grid plane z = 0 takes x_src and
// W_msg into msg, rounded once after the bias is added in f32, plane 1 x_dst
// and W_self into selfc, each with K = d_in. Its backward's dx runs it with
// the banks transposed ([U, d_out, d_in]) and a zero bias, so d_in and d_out
// are free: K slices and column slabs past an edge are zero-filled, the
// stores masked. What bounds it: bytes, half of kernel 5's f32 form (~0.53
// GB at E=1.03M, d=64: 0.16 ms), of which its two [E, d_out] outputs are
// half.
//
// The bf16 body's epilogue (kernels 2 and 5). Stored from the accumulators,
// each warp store wrote 4 bytes into each of 8 rows, so an output row was
// filled by several partial stores. Where d_out % 8 == 0 the tile now
// leaves through shared memory instead (kStageOut): once the last product
// is done the ring's space holds the [128][kBN + 8] bf16 tile, each thread
// writes its pairs (bias added in f32, one rounding), and the block stores
// whole output rows in 16-byte pieces; the masked scalar stores stay for
// d_out % 8 != 0. At 64-column slabs the body runs 3 blocks an SM (80
// registers), so one block's stores overlap another's loads; at 128, 2 (3
// spill). On an H100 80GB HBM3 at 700 W (scripts/tune_edge_kernels.py, xl
// d=64 / 128): kernel 5 0.218 / 0.474 ms against 0.328 / 0.695 stored from
// the accumulators (0.335 / 0.691 for the parent commit's body), 0.256 at
// d=64 with 2 blocks an SM; kernel 2 0.166 / 0.384 against 0.208 / 0.469.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kTileRows = 256;  // relation tile of the group-padded layout

// ---- Kernels 2 and 5: tensor cores, 3xTF32 -------------------------------

constexpr int kThreads2 = 256;
constexpr int BM2 = 128;            // rows per block (divides kTileRows)
constexpr int BK2 = 32;             // K slice per ring stage
constexpr int kStages2 = 3;
constexpr int kXStride = BK2 + 8;   // 40 floats: float2 loads conflict-free

static_assert(kTileRows % BM2 == 0, "a block must stay inside one tile");

template <int kBN>
__host__ __device__ constexpr int w_stride() { return kBN + 4; }  // = 4 (mod 32) floats

template <int kBN>
constexpr int smem_bytes2() {
  return kStages2 * (BM2 * kXStride + BK2 * w_stride<kBN>()) * 4;
}

// kTwo (kernel 5): blockIdx.z 0 writes msg (x_src, W_msg, the bias) to
// out, 1 writes selfc (x_dst, W_self) to out_self. Else (kernel 2) the sum
// of both with the bias to out. kPasses: 3 (3xTF32) or 1 TF32 pass.
template <int kBN, bool kVec, bool kTwo, int kPasses>
__global__ void __launch_bounds__(kThreads2, 2)
edge_transform_kernel(const float* __restrict__ x_src,
                      const float* __restrict__ x_dst,
                      const int32_t* __restrict__ rel_sorted,
                      const float* __restrict__ w_msg,
                      const float* __restrict__ w_self,
                      const float* __restrict__ bias, float* __restrict__ out,
                      float* __restrict__ out_self, int num_edges, int d_in,
                      int d_out) {
  constexpr int NT = kBN / 16;         // n-tiles of a warp (32 x kBN / 2)
  constexpr int NG = kBN == 128 ? 1 : NT;  // n-tiles per fragment group
  constexpr int kWS = w_stride<kBN>();
  constexpr int kAStage = BM2 * kXStride;
  constexpr int kBStage = BK2 * kWS;
  extern __shared__ __align__(16) float smem[];
  float* const As = smem;                      // [stage][BM2][kXStride]
  float* const Bs = smem + kStages2 * kAStage;  // [stage][BK2][kWS]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // 4 x 2 warps
  const int64_t row0 = (int64_t)blockIdx.x * BM2;
  const int col0 = blockIdx.y * kBN;
  const int rel = rel_sorted[(row0 / kTileRows) * kTileRows];
  const int64_t bank = (int64_t)rel * d_in * d_out;
  const int plane = kTwo ? (int)blockIdx.z : 0;
  const int kc = (d_in + BK2 - 1) / BK2;  // K slices per half
  const int chunks = kTwo ? kc : 2 * kc;

  // K slice c of [x_src | x_dst] and [W_msg ; W_self] (kTwo: of the
  // plane's half) into ring stage s.
  auto load = [&](int c, int s) {
    const int half = kTwo ? plane : c >= kc;
    const int k0 = (kTwo ? c : c - half * kc) * BK2;
    const float* __restrict__ x = half ? x_dst : x_src;
    const float* __restrict__ w = (half ? w_self : w_msg) + bank;
    float* a = As + s * kAStage;
    float* b = Bs + s * kBStage;
    if (kVec) {
#pragma unroll
      for (int v = tid; v < BM2 * BK2 / 4; v += kThreads2) {
        const int r = v / (BK2 / 4), k = (v % (BK2 / 4)) * 4;
        const int64_t row = row0 + r;
        const bool ok = row < num_edges && k0 + k < d_in;
        tf32x3::cp_async16(a + r * kXStride + k,
                           ok ? x + row * d_in + k0 + k : x, ok);
      }
#pragma unroll
      for (int v = tid; v < BK2 * kBN / 4; v += kThreads2) {
        const int k = v / (kBN / 4), n = (v % (kBN / 4)) * 4;
        const bool ok = k0 + k < d_in && col0 + n < d_out;
        tf32x3::cp_async16(b + k * kWS + n,
                           ok ? w + (int64_t)(k0 + k) * d_out + col0 + n : w,
                           ok);
      }
    } else {
#pragma unroll 4
      for (int v = tid; v < BM2 * BK2; v += kThreads2) {
        const int r = v / BK2, k = v % BK2;
        const int64_t row = row0 + r;
        const bool ok = row < num_edges && k0 + k < d_in;
        tf32x3::cp_async4(a + r * kXStride + k,
                          ok ? x + row * d_in + k0 + k : x, ok);
      }
#pragma unroll 4
      for (int v = tid; v < BK2 * kBN; v += kThreads2) {
        const int k = v / kBN, n = v % kBN;
        const bool ok = k0 + k < d_in && col0 + n < d_out;
        tf32x3::cp_async4(b + k * kWS + n,
                          ok ? w + (int64_t)(k0 + k) * d_out + col0 + n : w,
                          ok);
      }
    }
  };

  float acc[NT / NG][2][NG][4];
#pragma unroll
  for (int q = 0; q < NT / NG; ++q)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NG; ++j)
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[q][i][j][l] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages2 - 1; ++s) {
    if (s < chunks) load(s, s);
    tf32x3::cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    tf32x3::cp_async_wait<kStages2 - 2>();
    __syncthreads();  // slice c has landed; slice c - 1's stage is free
    if (c + kStages2 - 1 < chunks)
      load(c + kStages2 - 1, (c + kStages2 - 1) % kStages2);
    tf32x3::cp_async_commit();

    const float* a = As + (c % kStages2) * kAStage;
    const float* b = Bs + (c % kStages2) * kBStage;
#pragma unroll 1
    for (int ks = 0; ks < BK2 / 8; ++ks) {
      const int kb = ks * 8;
      // A: rows of x; fragment k = tig, tig + 4 <-> columns kb + 2 tig, +1.
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + i * 16 + gid;
        const float2 p =
            *reinterpret_cast<const float2*>(a + r * kXStride + kb + 2 * tig);
        const float2 q = *reinterpret_cast<const float2*>(
            a + (r + 8) * kXStride + kb + 2 * tig);
        tf32x3::operand<kPasses>(p.x, ahi[i][0], alo[i][0]);
        tf32x3::operand<kPasses>(q.x, ahi[i][1], alo[i][1]);
        tf32x3::operand<kPasses>(p.y, ahi[i][2], alo[i][2]);
        tf32x3::operand<kPasses>(q.y, ahi[i][3], alo[i][3]);
      }
      // B: rows kb + 2 tig and kb + 2 tig + 1 of the weight slice.
      const float* b0 = b + (kb + 2 * tig) * kWS + wn * (kBN / 2) + gid;
#pragma unroll
      for (int q = 0; q < NT / NG; ++q) {
        uint32_t bhi[NG][2], blo[NG][2];
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          const int n = (q * NG + j) * 8;
          tf32x3::operand<kPasses>(b0[n], bhi[j][0], blo[j][0]);
          tf32x3::operand<kPasses>(b0[kWS + n], bhi[j][1], blo[j][1]);
        }
        tf32x3::mma_tile<kPasses, 2, NG>(acc[q], ahi, alo, bhi, blo);
      }
    }
  }

  const float* __restrict__ b_rel = bias + (int64_t)rel * d_out;
  const bool with_bias = plane == 0;
  float* __restrict__ dst0 = plane ? out_self : out;
#pragma unroll
  for (int q = 0; q < NT / NG; ++q)
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int n = col0 + wn * (kBN / 2) + (q * NG + j) * 8 + 2 * tig;
      const float bias0 = with_bias && n < d_out ? __ldg(b_rel + n) : 0.f;
      const float bias1 = with_bias && n + 1 < d_out ? __ldg(b_rel + n + 1) : 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t row = row0 + wm * 32 + i * 16 + gid + 8 * h;
          if (row >= num_edges) continue;
          const float v0 = acc[q][i][j][2 * h] + bias0;
          const float v1 = acc[q][i][j][2 * h + 1] + bias1;
          float* dst = dst0 + row * d_out + n;
          if (kVec) {  // d_out % 4 == 0: n and n + 1 both in or both out
            if (n < d_out) *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            if (n < d_out) dst[0] = v0;
            if (n + 1 < d_out) dst[1] = v1;
          }
        }
    }
}

template <int kBN, bool kVec, bool kTwo, int kPasses>
cudaError_t launch(const float* x_src, const float* x_dst,
                   const int32_t* rel_sorted, const float* w_msg,
                   const float* w_self, const float* bias, float* out,
                   float* out_self, int num_edges, int d_in, int d_out,
                   cudaStream_t stream) {
  auto kernel = edge_transform_kernel<kBN, kVec, kTwo, kPasses>;
  constexpr int smem = smem_bytes2<kBN>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dim3 grid((num_edges + BM2 - 1) / BM2, (d_out + kBN - 1) / kBN, kTwo ? 2 : 1);
  kernel<<<grid, kThreads2, smem, stream>>>(x_src, x_dst, rel_sorted, w_msg,
                                            w_self, bias, out, out_self,
                                            num_edges, d_in, d_out);
  return cudaGetLastError();
}

// The instance for d_out (a 64- or 128-column slab) and vec.
template <bool kTwo, int kPasses>
cudaError_t dispatch(const void* x_src, const void* x_dst,
                     const void* rel_sorted, const void* w_msg,
                     const void* w_self, const void* bias, void* out,
                     void* out_self, int num_edges, int d_in, int d_out,
                     int vec, void* stream) {
  const auto xs = static_cast<const float*>(x_src);
  const auto xd = static_cast<const float*>(x_dst);
  const auto rel = static_cast<const int32_t*>(rel_sorted);
  const auto wm = static_cast<const float*>(w_msg);
  const auto ws = static_cast<const float*>(w_self);
  const auto b = static_cast<const float*>(bias);
  const auto o = static_cast<float*>(out);
  const auto o2 = static_cast<float*>(out_self);
  const auto s = reinterpret_cast<cudaStream_t>(stream);
  if (d_out <= 64) {
    return vec ? launch<64, true, kTwo, kPasses>(xs, xd, rel, wm, ws, b, o,
                                                 o2, num_edges, d_in, d_out, s)
               : launch<64, false, kTwo, kPasses>(xs, xd, rel, wm, ws, b, o,
                                                  o2, num_edges, d_in, d_out,
                                                  s);
  }
  return vec ? launch<128, true, kTwo, kPasses>(xs, xd, rel, wm, ws, b, o, o2,
                                                num_edges, d_in, d_out, s)
             : launch<128, false, kTwo, kPasses>(xs, xd, rel, wm, ws, b, o,
                                                 o2, num_edges, d_in, d_out,
                                                 s);
}

// ---- Kernel 2's bf16 form: tensor cores, one bf16 pass -------------------

using bf16mma::bf16;

constexpr int BKH = 32;             // K slice per ring stage, bf16
constexpr int kXStrideH = BKH + 8;  // 40 bf16 = 80 bytes: ldmatrix conflict-free

template <int kBN>
__host__ __device__ constexpr int w_stride_h() { return kBN + 8; }

template <int kBN>
constexpr int smem_bytes_h() {
  return kStages2 * (BM2 * kXStrideH + BKH * w_stride_h<kBN>()) * 2;
}

// The bf16 body's output tile [BM2][kBN] leaves through shared memory (the
// ring's space, once the last product is done) in 16-byte stores of whole
// rows where d_out % 8 == 0; else each thread stores its accumulators.
constexpr bool kStageOut = true;
// Resident blocks an SM the bf16 body is compiled for: 3 at 64-column slabs
// (80 registers, no spills), 2 at 128 (128 registers; 3 spilled and ran
// slower, scripts/tune_edge_kernels.py).
template <int kBN>
__host__ __device__ constexpr int blocks_h() { return kBN == 64 ? 3 : 2; }
template <int kBN>
__host__ __device__ constexpr int out_stride_h() { return kBN + 8; }  // odd x 16 bytes
static_assert(BM2 * out_stride_h<64>() * 2 <= smem_bytes_h<64>(), "staged tile fits");
static_assert(BM2 * out_stride_h<128>() * 2 <= smem_bytes_h<128>(), "staged tile fits");

// kTwo (kernel 5): blockIdx.z 0 writes msg (x_src, W_msg, the bias) to
// out, 1 writes selfc (x_dst, W_self) to out_self. Else (kernel 2) the sum
// of both with the bias to out.
template <int kBN, bool kVec, bool kTwo>
__global__ void __launch_bounds__(kThreads2, blocks_h<kBN>())
edge_transform_bf16_kernel(const bf16* __restrict__ x_src,
                           const bf16* __restrict__ x_dst,
                           const int32_t* __restrict__ rel_sorted,
                           const bf16* __restrict__ w_msg,
                           const bf16* __restrict__ w_self,
                           const bf16* __restrict__ bias,
                           bf16* __restrict__ out, bf16* __restrict__ out_self,
                           int num_edges, int d_in, int d_out) {
  constexpr int NT = kBN / 16;  // n-tiles of a warp (32 x kBN / 2)
  constexpr int kWS = w_stride_h<kBN>();
  constexpr int kAStage = BM2 * kXStrideH;
  constexpr int kBStage = BKH * kWS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const As = reinterpret_cast<bf16*>(smem_raw);  // [stage][BM2][kXStrideH]
  bf16* const Bs = As + kStages2 * kAStage;            // [stage][BKH][kWS]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // 4 x 2 warps
  const int64_t row0 = (int64_t)blockIdx.x * BM2;
  const int col0 = blockIdx.y * kBN;
  const int rel = rel_sorted[(row0 / kTileRows) * kTileRows];
  const int64_t bank = (int64_t)rel * d_in * d_out;
  const int plane = kTwo ? (int)blockIdx.z : 0;
  const int kc = (d_in + BKH - 1) / BKH;  // K slices per half
  const int chunks = kTwo ? kc : 2 * kc;

  // K slice c of [x_src | x_dst] and [W_msg ; W_self] (kTwo: of the
  // plane's half) into ring stage s.
  auto load = [&](int c, int s) {
    const int half = kTwo ? plane : c >= kc;
    const int k0 = (kTwo ? c : c - half * kc) * BKH;
    const bf16* __restrict__ x = half ? x_dst : x_src;
    const bf16* __restrict__ w = (half ? w_self : w_msg) + bank;
    bf16* a = As + s * kAStage;
    bf16* b = Bs + s * kBStage;
    if (kVec) {
#pragma unroll
      for (int v = tid; v < BM2 * BKH / 8; v += kThreads2) {
        const int r = v / (BKH / 8), k = (v % (BKH / 8)) * 8;
        const int64_t row = row0 + r;
        const bool ok = row < num_edges && k0 + k < d_in;
        bf16mma::copy8(a + r * kXStrideH + k, ok ? x + row * d_in + k0 + k : x,
                       ok);
      }
#pragma unroll
      for (int v = tid; v < BKH * kBN / 8; v += kThreads2) {
        const int k = v / (kBN / 8), n = (v % (kBN / 8)) * 8;
        const bool ok = k0 + k < d_in && col0 + n < d_out;
        bf16mma::copy8(b + k * kWS + n,
                       ok ? w + (int64_t)(k0 + k) * d_out + col0 + n : w, ok);
      }
    } else {
#pragma unroll 4
      for (int v = tid; v < BM2 * BKH; v += kThreads2) {
        const int r = v / BKH, k = v % BKH;
        const int64_t row = row0 + r;
        const bool ok = row < num_edges && k0 + k < d_in;
        bf16mma::copy1(a + r * kXStrideH + k, x + (ok ? row * d_in + k0 + k : 0),
                       ok);
      }
#pragma unroll 4
      for (int v = tid; v < BKH * kBN; v += kThreads2) {
        const int k = v / kBN, n = v % kBN;
        const bool ok = k0 + k < d_in && col0 + n < d_out;
        bf16mma::copy1(b + k * kWS + n,
                       w + (ok ? (int64_t)(k0 + k) * d_out + col0 + n : 0), ok);
      }
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int l = 0; l < 4; ++l) acc[i][j][l] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages2 - 1; ++s) {
    if (s < chunks) load(s, s);
    tf32x3::cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    tf32x3::cp_async_wait<kStages2 - 2>();
    __syncthreads();  // slice c has landed; slice c - 1's stage is free
    if (c + kStages2 - 1 < chunks)
      load(c + kStages2 - 1, (c + kStages2 - 1) % kStages2);
    tf32x3::cp_async_commit();

    const bf16* a = As + (c % kStages2) * kAStage + wm * 32 * kXStrideH;
    const bf16* b = Bs + (c % kStages2) * kBStage + wn * (kBN / 2);
#pragma unroll
    for (int kb = 0; kb < BKH; kb += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        bf16mma::load_a(af[i], a + i * 16 * kXStrideH + kb, kXStrideH, lane);
#pragma unroll
      for (int q = 0; q < NT / 2; ++q) {
        uint32_t bf[2][2];
        bf16mma::load_b2_trans(bf, b + kb * kWS + q * 16, kWS, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          bf16mma::mma(acc[i][2 * q], af[i], bf[0]);
          bf16mma::mma(acc[i][2 * q + 1], af[i], bf[1]);
        }
      }
    }
  }

  // The bias is added in f32 and the sum rounded once to bf16.
  const bf16* __restrict__ b_rel = bias + (int64_t)rel * d_out;
  const bool with_bias = plane == 0;
  bf16* __restrict__ dst0 = plane ? out_self : out;
  if constexpr (kVec && kStageOut) {
    // Fragments -> the staged tile [BM2][kOS] (pairs of columns: each warp
    // store covers 8 rows x 4 pairs in 32 distinct banks) -> 16-byte
    // pieces of whole output rows, consecutive threads on consecutive
    // pieces of a row.
    constexpr int kOS = out_stride_h<kBN>();
    bf16* const Os = As;
    tf32x3::cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = wn * (kBN / 2) + j * 8 + 2 * tig;
      const int n = col0 + c;
      // d_out % 8 == 0: n and n + 1 both in or both out
      const float bias0 = with_bias && n < d_out ? __bfloat162float(b_rel[n]) : 0.f;
      const float bias1 = with_bias && n < d_out ? __bfloat162float(b_rel[n + 1]) : 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + i * 16 + gid + 8 * h;
          *reinterpret_cast<__nv_bfloat162*>(Os + r * kOS + c) = bf16mma::pack(
              acc[i][j][2 * h] + bias0, acc[i][j][2 * h + 1] + bias1);
        }
    }
    __syncthreads();
    const int cols = min(kBN, d_out - col0);  // a multiple of 8
#pragma unroll
    for (int v = tid; v < BM2 * kBN / 8; v += kThreads2) {
      const int r = v / (kBN / 8), c = (v % (kBN / 8)) * 8;
      const int64_t row = row0 + r;
      if (row < num_edges && c < cols)
        *reinterpret_cast<uint4*>(dst0 + row * d_out + col0 + c) =
            *reinterpret_cast<const uint4*>(Os + r * kOS + c);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = col0 + wn * (kBN / 2) + j * 8 + 2 * tig;
    const float bias0 = with_bias && n < d_out ? __bfloat162float(b_rel[n]) : 0.f;
    const float bias1 =
        with_bias && n + 1 < d_out ? __bfloat162float(b_rel[n + 1]) : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = row0 + wm * 32 + i * 16 + gid + 8 * h;
        if (row >= num_edges) continue;
        const float v0 = acc[i][j][2 * h] + bias0;
        const float v1 = acc[i][j][2 * h + 1] + bias1;
        bf16* dst = dst0 + row * d_out + n;
        if (kVec) {  // d_out % 8 == 0: n and n + 1 both in or both out
          if (n < d_out)
            *reinterpret_cast<__nv_bfloat162*>(dst) = bf16mma::pack(v0, v1);
        } else {
          if (n < d_out) dst[0] = __float2bfloat16(v0);
          if (n + 1 < d_out) dst[1] = __float2bfloat16(v1);
        }
      }
  }
}

template <int kBN, bool kVec, bool kTwo>
cudaError_t launch_bf16(const bf16* x_src, const bf16* x_dst,
                        const int32_t* rel_sorted, const bf16* w_msg,
                        const bf16* w_self, const bf16* bias, bf16* out,
                        bf16* out_self, int num_edges, int d_in, int d_out,
                        cudaStream_t stream) {
  auto kernel = edge_transform_bf16_kernel<kBN, kVec, kTwo>;
  constexpr int smem = smem_bytes_h<kBN>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dim3 grid((num_edges + BM2 - 1) / BM2, (d_out + kBN - 1) / kBN, kTwo ? 2 : 1);
  kernel<<<grid, kThreads2, smem, stream>>>(x_src, x_dst, rel_sorted, w_msg,
                                            w_self, bias, out, out_self,
                                            num_edges, d_in, d_out);
  return cudaGetLastError();
}

// The bf16 instance for d_out (a 64- or 128-column slab) and vec.
template <bool kTwo>
cudaError_t dispatch_bf16(const void* x_src, const void* x_dst,
                          const void* rel_sorted, const void* w_msg,
                          const void* w_self, const void* bias, void* out,
                          void* out_self, int num_edges, int d_in, int d_out,
                          int vec, void* stream) {
  const auto xs = static_cast<const bf16*>(x_src);
  const auto xd = static_cast<const bf16*>(x_dst);
  const auto rel = static_cast<const int32_t*>(rel_sorted);
  const auto wm = static_cast<const bf16*>(w_msg);
  const auto ws = static_cast<const bf16*>(w_self);
  const auto b = static_cast<const bf16*>(bias);
  const auto o = static_cast<bf16*>(out);
  const auto o2 = static_cast<bf16*>(out_self);
  const auto s = reinterpret_cast<cudaStream_t>(stream);
  if (d_out <= 64) {
    return vec ? launch_bf16<64, true, kTwo>(xs, xd, rel, wm, ws, b, o, o2,
                                             num_edges, d_in, d_out, s)
               : launch_bf16<64, false, kTwo>(xs, xd, rel, wm, ws, b, o, o2,
                                              num_edges, d_in, d_out, s);
  }
  return vec ? launch_bf16<128, true, kTwo>(xs, xd, rel, wm, ws, b, o, o2,
                                            num_edges, d_in, d_out, s)
             : launch_bf16<128, false, kTwo>(xs, xd, rel, wm, ws, b, o, o2,
                                             num_edges, d_in, d_out, s);
}

// Kernels 2 (kTwo false) and 5 in f32 at 3 or 1 TF32 passes.
template <bool kTwo>
cudaError_t dispatch_passes(const void* x_src, const void* x_dst,
                            const void* rel_sorted, const void* w_msg,
                            const void* w_self, const void* bias, void* out,
                            void* out_self, int num_edges, int d_in, int d_out,
                            int passes, int vec, void* stream) {
  if (passes == 3)
    return dispatch<kTwo, 3>(x_src, x_dst, rel_sorted, w_msg, w_self, bias, out,
                             out_self, num_edges, d_in, d_out, vec, stream);
  if (passes == 1)
    return dispatch<kTwo, 1>(x_src, x_dst, rel_sorted, w_msg, w_self, bias, out,
                             out_self, num_edges, d_in, d_out, vec, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Kernel 2. x_src, x_dst: [E, d_in] f32; rel_sorted: [E] int32; w_msg,
// w_self: [U, d_in, d_out] f32; bias: [U, d_out] f32; out: [E, d_out] f32. All
// contiguous. passes: 3 (3xTF32) or 1 (one TF32 pass). vec != 0: d_in and
// d_out are multiples of 4 and every pointer is 16-byte aligned (16-byte
// copies). Launches on `stream`; returns the CUDA error of the launch.
extern "C" int ghf_edge_transform(const void* x_src, const void* x_dst,
                                  const void* rel_sorted, const void* w_msg,
                                  const void* w_self, const void* bias,
                                  void* out, int num_edges, int d_in,
                                  int d_out, int passes, int vec,
                                  void* stream) {
  if (num_edges <= 0 || d_out <= 0) return (int)cudaSuccess;
  return (int)dispatch_passes<false>(x_src, x_dst, rel_sorted, w_msg, w_self,
                                     bias, out, nullptr, num_edges, d_in,
                                     d_out, passes, vec, stream);
}

// Kernel 2's bf16 form: x_src, x_dst, w_msg, w_self, bias and out as
// ghf_edge_transform's, in bf16. vec != 0: d_in and d_out are multiples of
// 8 and every pointer is 16-byte aligned (16-byte copies).
extern "C" int ghf_edge_transform_bf16(const void* x_src, const void* x_dst,
                                       const void* rel_sorted,
                                       const void* w_msg, const void* w_self,
                                       const void* bias, void* out,
                                       int num_edges, int d_in, int d_out,
                                       int vec, void* stream) {
  if (num_edges <= 0 || d_out <= 0) return (int)cudaSuccess;
  return (int)dispatch_bf16<false>(x_src, x_dst, rel_sorted, w_msg, w_self,
                                   bias, out, nullptr, num_edges, d_in, d_out,
                                   vec, stream);
}

// Kernel 5. As kernel 2, with two outputs msg, selfc: [E, d_out] f32.
extern "C" int ghf_edge_transform_two(const void* x_src, const void* x_dst,
                                      const void* rel_sorted,
                                      const void* w_msg, const void* w_self,
                                      const void* bias, void* msg,
                                      void* selfc, int num_edges, int d_in,
                                      int d_out, int passes, int vec,
                                      void* stream) {
  if (num_edges <= 0 || d_out <= 0) return (int)cudaSuccess;
  return (int)dispatch_passes<true>(x_src, x_dst, rel_sorted, w_msg, w_self,
                                    bias, msg, selfc, num_edges, d_in, d_out,
                                    passes, vec, stream);
}

// Kernel 5's bf16 form: as ghf_edge_transform_bf16, with two outputs msg,
// selfc: [E, d_out] bf16.
extern "C" int ghf_edge_transform_two_bf16(const void* x_src,
                                           const void* x_dst,
                                           const void* rel_sorted,
                                           const void* w_msg,
                                           const void* w_self,
                                           const void* bias, void* msg,
                                           void* selfc, int num_edges,
                                           int d_in, int d_out, int vec,
                                           void* stream) {
  if (num_edges <= 0 || d_out <= 0) return (int)cudaSuccess;
  return (int)dispatch_bf16<true>(x_src, x_dst, rel_sorted, w_msg, w_self,
                                  bias, msg, selfc, num_edges, d_in, d_out,
                                  vec, stream);
}
