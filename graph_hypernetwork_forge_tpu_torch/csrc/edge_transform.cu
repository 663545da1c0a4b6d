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

#include <cuda_runtime.h>
#include <stdint.h>

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
// of both with the bias to out.
template <int kBN, bool kVec, bool kTwo>
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
        tf32x3::split(p.x, ahi[i][0], alo[i][0]);
        tf32x3::split(q.x, ahi[i][1], alo[i][1]);
        tf32x3::split(p.y, ahi[i][2], alo[i][2]);
        tf32x3::split(q.y, ahi[i][3], alo[i][3]);
      }
      // B: rows kb + 2 tig and kb + 2 tig + 1 of the weight slice.
      const float* b0 = b + (kb + 2 * tig) * kWS + wn * (kBN / 2) + gid;
#pragma unroll
      for (int q = 0; q < NT / NG; ++q) {
        uint32_t bhi[NG][2], blo[NG][2];
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          const int n = (q * NG + j) * 8;
          tf32x3::split(b0[n], bhi[j][0], blo[j][0]);
          tf32x3::split(b0[kWS + n], bhi[j][1], blo[j][1]);
        }
        tf32x3::mma3_tile<2, NG>(acc[q], ahi, alo, bhi, blo);
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

template <int kBN, bool kVec, bool kTwo>
cudaError_t launch(const float* x_src, const float* x_dst,
                   const int32_t* rel_sorted, const float* w_msg,
                   const float* w_self, const float* bias, float* out,
                   float* out_self, int num_edges, int d_in, int d_out,
                   cudaStream_t stream) {
  auto kernel = edge_transform_kernel<kBN, kVec, kTwo>;
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
template <bool kTwo>
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
    return vec ? launch<64, true, kTwo>(xs, xd, rel, wm, ws, b, o, o2,
                                        num_edges, d_in, d_out, s)
               : launch<64, false, kTwo>(xs, xd, rel, wm, ws, b, o, o2,
                                         num_edges, d_in, d_out, s);
  }
  return vec ? launch<128, true, kTwo>(xs, xd, rel, wm, ws, b, o, o2,
                                       num_edges, d_in, d_out, s)
             : launch<128, false, kTwo>(xs, xd, rel, wm, ws, b, o, o2,
                                        num_edges, d_in, d_out, s);
}

}  // namespace

// Kernel 2. x_src, x_dst: [E, d_in] f32; rel_sorted: [E] int32; w_msg,
// w_self: [U, d_in, d_out] f32; bias: [U, d_out] f32; out: [E, d_out] f32. All
// contiguous. vec != 0: d_in and d_out are multiples of 4 and every pointer
// is 16-byte aligned (16-byte copies). Launches on `stream`; returns the
// CUDA error of the launch.
extern "C" int ghf_edge_transform(const void* x_src, const void* x_dst,
                                  const void* rel_sorted, const void* w_msg,
                                  const void* w_self, const void* bias,
                                  void* out, int num_edges, int d_in,
                                  int d_out, int vec, void* stream) {
  if (num_edges <= 0 || d_out <= 0) return (int)cudaSuccess;
  return (int)dispatch<false>(x_src, x_dst, rel_sorted, w_msg, w_self, bias,
                              out, nullptr, num_edges, d_in, d_out, vec,
                              stream);
}

// Kernel 5. As kernel 2, with two outputs msg, selfc: [E, d_out] f32.
extern "C" int ghf_edge_transform_two(const void* x_src, const void* x_dst,
                                      const void* rel_sorted,
                                      const void* w_msg, const void* w_self,
                                      const void* bias, void* msg,
                                      void* selfc, int num_edges, int d_in,
                                      int d_out, int vec, void* stream) {
  if (num_edges <= 0 || d_out <= 0) return (int)cudaSuccess;
  return (int)dispatch<true>(x_src, x_dst, rel_sorted, w_msg, w_self, bias,
                             msg, selfc, num_edges, d_in, d_out, vec, stream);
}
