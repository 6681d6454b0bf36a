// The q8 block-quantized gradient all-reduce with error feedback: the
// sender's encode (K6a) and the receiver's dequantize-and-sum (K6b).
//
// Replaces: ray_tpu/parallel/collectives.py `q8_encode`, `q8_decode` and
// `_leaf_allreduce_q8` (as run by `psum_quantized`/`pmean_quantized`),
// which XLA fused inside the learner's shard_map. Between the two
// kernels the ranks all-gather the wire images (parallel/mesh.py).
//
// Layout. The gradient is packed f32 [nb * 1024]: every parameter leaf
// in its own block-aligned slot, zero-padded to the block boundary, so
// per-block quantization of the packed buffer gives per-leaf codes. A
// wire image is nb * 1024 int8 codes followed by nb f32 scales.
//
// K6a q8_encode_ef, per 1024-element block (one CTA, 256 threads x 4
// elements, float4 loads):
//   v     = g + err                       (__fadd_rn)
//   scale = max(amax|v| / 127, 1e-30)     (__fdiv_rn, then the clamp)
//   q     = clip(rint(v / scale), +-127)  (__fdiv_rn; rintf: half to even)
//   err'  = v - q * scale                 (__fmul_rn then __fsub_rn)
// This is numpy's `q8_quantize` bit for bit: a plain `/` (or a
// reciprocal multiply) is not correctly rounded under fast math, and nvcc
// would contract `v - q*scale` into an FMA, which rounds once instead of
// twice. The residual is written in place; padding stays exactly 0.
//
// K6b q8_gather_sum, one thread per 4 elements: the f32 sum over senders
// s = 0..D-1, in that order, of __fmul_rn((float)q_s, scale_s), each
// added with __fadd_rn, then optionally __fdiv_rn by D (a mean loss).
// Every rank sums the same gathered bytes in the same order, so every
// rank's result is the same, bit for bit.
//
// Bound on an H100: bytes. K6a reads g and err and writes q and err
// (13 B per element) plus 4 B per block of scales: at the Nature CNN's
// 1,654 blocks that is 22.0 MB, 6.6 us at 3.35 TB/s; its ~10 f32
// operations per element are far below the byte bound. K6b reads D
// codes and D/1024 scales per element and writes 4 B: at D = 2, 10.2 MB,
// 3.0 us. The design is one pass over memory each: K6a keeps a block's
// 4 values per thread in registers between the amax reduction (warp
// shuffles, then 8 warp maxima through shared memory) and the quantize,
// so g and err are read once; K6b reads each sender's scale once per
// 4 elements. The plain PyTorch versions are `_q8_encode_ef_plain` and
// `_q8_gather_sum_plain` in parallel/collectives.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;
constexpr int kThreads = 256;  // x 4 elements = one block
constexpr float kScaleEps = 1e-30f;

__device__ __forceinline__ int8_t quantize(float v, float scale) {
  float q = rintf(__fdiv_rn(v, scale));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int8_t>(q);
}

__device__ __forceinline__ float residual(float v, int8_t q, float scale) {
  return __fsub_rn(v, __fmul_rn(static_cast<float>(q), scale));
}

__global__ void __launch_bounds__(kThreads)
q8_encode_kernel(const float* __restrict__ g, float* __restrict__ err,
                 int8_t* __restrict__ codes, float* __restrict__ scales) {
  const size_t base = static_cast<size_t>(blockIdx.x) * kBlock;
  const int i = threadIdx.x * 4;
  const float4 gv = *reinterpret_cast<const float4*>(g + base + i);
  const float4 ev = *reinterpret_cast<const float4*>(err + base + i);
  float4 v;
  v.x = __fadd_rn(gv.x, ev.x);
  v.y = __fadd_rn(gv.y, ev.y);
  v.z = __fadd_rn(gv.z, ev.z);
  v.w = __fadd_rn(gv.w, ev.w);
  float amax = fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                     fmaxf(fabsf(v.z), fabsf(v.w)));
  for (int offset = 16; offset > 0; offset >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, offset));
  __shared__ float warp_max[kThreads / 32];
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) warp_max[warp] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  const float scale = fmaxf(__fdiv_rn(amax, 127.0f), kScaleEps);

  char4 q;
  q.x = quantize(v.x, scale);
  q.y = quantize(v.y, scale);
  q.z = quantize(v.z, scale);
  q.w = quantize(v.w, scale);
  *reinterpret_cast<char4*>(codes + base + i) = q;
  float4 e;
  e.x = residual(v.x, q.x, scale);
  e.y = residual(v.y, q.y, scale);
  e.z = residual(v.z, q.z, scale);
  e.w = residual(v.w, q.w, scale);
  *reinterpret_cast<float4*>(err + base + i) = e;
  if (threadIdx.x == 0) scales[blockIdx.x] = scale;
}

__global__ void q8_gather_sum_kernel(const uint8_t* __restrict__ gathered,
                                     float* __restrict__ out, int nb, int D,
                                     int mean) {
  const size_t quad = static_cast<size_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const size_t n = static_cast<size_t>(nb) * kBlock;
  const size_t i = quad * 4;
  if (i >= n) return;
  const size_t row = n + 4 * static_cast<size_t>(nb);  // wire image bytes
  const size_t block = i / kBlock;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int s = 0; s < D; ++s) {
    const uint8_t* image = gathered + s * row;
    const char4 q = *reinterpret_cast<const char4*>(image + i);
    const float scale = reinterpret_cast<const float*>(image + n)[block];
    acc.x = __fadd_rn(acc.x, __fmul_rn(static_cast<float>(q.x), scale));
    acc.y = __fadd_rn(acc.y, __fmul_rn(static_cast<float>(q.y), scale));
    acc.z = __fadd_rn(acc.z, __fmul_rn(static_cast<float>(q.z), scale));
    acc.w = __fadd_rn(acc.w, __fmul_rn(static_cast<float>(q.w), scale));
  }
  if (mean) {
    const float d = static_cast<float>(D);
    acc.x = __fdiv_rn(acc.x, d);
    acc.y = __fdiv_rn(acc.y, d);
    acc.z = __fdiv_rn(acc.z, d);
    acc.w = __fdiv_rn(acc.w, d);
  }
  *reinterpret_cast<float4*>(out + i) = acc;
}

}  // namespace

// K6a: g, err f32 [nb * 1024] (err updated in place); wire uint8
// [nb * 1024 + 4 * nb] (codes, then scales).
extern "C" int q8_encode_ef(const float* g, float* err, uint8_t* wire,
                            int nb, void* stream) {
  if (nb <= 0) return static_cast<int>(cudaSuccess);
  int8_t* codes = reinterpret_cast<int8_t*>(wire);
  float* scales =
      reinterpret_cast<float*>(wire + static_cast<size_t>(nb) * kBlock);
  q8_encode_kernel<<<nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, err, codes, scales);
  return static_cast<int>(cudaGetLastError());
}

// K6b: gathered uint8 [D, nb * 1024 + 4 * nb] (rank order); out f32
// [nb * 1024]; mean != 0 divides the sum by D.
extern "C" int q8_gather_sum(const uint8_t* gathered, float* out, int nb,
                             int D, int mean, void* stream) {
  if (nb <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const size_t quads = static_cast<size_t>(nb) * (kBlock / 4);
  const unsigned blocks =
      static_cast<unsigned>((quads + threads - 1) / threads);
  q8_gather_sum_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      gathered, out, nb, D, mean);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
