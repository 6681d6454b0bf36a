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
//
// K6b with the leaf table, `q8_gather_sum_unpack`: the same sum, written
// straight in the model's `parameters()` element order, the unpacking
// gather of the packed sum fused in (its plain version is
// `_q8_gather_sum_unpack_plain`). Each parameter is a permutation of a
// view of at most 4 dims, [rows, i1, i2, i3] (models/convert.py
// `LeafLayout`): element (o, r) sits at packed position p0 + prow(r) *
// rows + o, where `rows` is the packed slot's fastest dimension. The
// large leaves are transposes (the conv kernels OIHW -> HWIO, the dense
// kernels [out, in] -> [in, out]), so neighbouring outputs read codes
// `rows` bytes apart: a thread per output would touch a sector per byte.
// So a block takes one tile of a leaf, up to 64 rows x 64 columns (4,096
// elements; narrower leaves get fewer rows and longer columns: the Nature
// CNN is 420 tiles, one wave on the card), and transposes it through
// shared memory. The loads run along o: where `rows` is a multiple of 4,
// a thread reads 4 rows' codes as one char4 with one scale per sender (16
// lanes on 64 neighbouring code bytes), 4 quads a thread, their loads
// issued together per sender and summed in registers; other leaves
// (biases, a 6-row head) load one code at a time. The stores run along
// r: float4 rows where the leaf's rows sit on 16-byte boundaries, else
// scalars, 32 lanes on contiguous output either way. The tiles are
// planned in Python (`q8_unpack_tiles`): 16 ints per tile, loaded as 4 int4. The
// bytes are K6b's own for the real elements: D codes plus D/1024 scales
// read, 4 B written per element (at the Nature CNN's D = 2, 10.1 MB, 3.0
// us).

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

// ---- K6b with the leaf table ---------------------------------------------
constexpr int kTileElems = 4096;
constexpr int kTileThreads = 256;
constexpr int kQuads = kTileElems / 4 / kTileThreads;  // 4 a thread
constexpr int kMaxTileRows = 64;
constexpr int kVecIn = 1;   // record flag: rows % 4 == 0, char4 code loads
constexpr int kVecOut = 2;  // record flag: float4 output rows

__device__ __forceinline__ float finish(float acc, int mean, int D) {
  return mean ? __fdiv_rn(acc, static_cast<float>(D)) : acc;
}

// A tile's record, 16 ints (mirrored by `q8_unpack_tiles`):
//   0 out0: output index of the tile's element (0, 0)
//   1 row_len: the leaf's elements per row (its output row stride)
//   2 p0: packed position of (0, 0) before the column's row offset
//   3 rows: the leaf's rows (the packed slot's fastest dimension)
//   4 log2 of the tile's row capacity tp, 5 log2 of its columns tr
//   6 rows in this tile, 7 columns in this tile
//   8 first column r0, 9 sizes[1] * sizes[2], 10 sizes[2]
//   11-13 the packed strides of (i1, i2, i3), 14 flags, 15 unused
__global__ void __launch_bounds__(kTileThreads)
q8_gather_sum_unpack_kernel(const uint8_t* __restrict__ gathered,
                            float* __restrict__ out, int nb, int D,
                            int mean, const int4* __restrict__ tiles) {
  __shared__ float tile[kTileElems + kMaxTileRows];
  __shared__ int prow[kTileElems];
  const int4 f0 = tiles[4 * blockIdx.x];
  const int4 f1 = tiles[4 * blockIdx.x + 1];
  const int4 f2 = tiles[4 * blockIdx.x + 2];
  const int4 f3 = tiles[4 * blockIdx.x + 3];
  const int out0 = f0.x, row_len = f0.y, p0 = f0.z, rows = f0.w;
  const int log_tp = f1.x, log_tr = f1.y, n_rows = f1.z, n_cols = f1.w;
  const int r0 = f2.x, d23 = f2.y, d3 = f2.z, s1 = f2.w;
  const int s2 = f3.x, s3 = f3.y, flags = f3.z;
  const int tp = 1 << log_tp, tr = 1 << log_tr, pitch = tr + 1;
  // Each column's packed position (its row of `rows` codes).
  for (int j = threadIdx.x; j < n_cols; j += kTileThreads) {
    const int r = r0 + j;
    const int i1 = r / d23;
    const int rem = r - i1 * d23;
    const int i2 = rem / d3;
    const int i3 = rem - i2 * d3;
    prow[j] = p0 + (i1 * s1 + i2 * s2 + i3 * s3) * rows;
  }
  __syncthreads();
  const size_t n = static_cast<size_t>(nb) * kBlock;
  const size_t image = n + 4 * static_cast<size_t>(nb);
  if (flags & kVecIn) {
    // Loads along o, 4 rows a thread (one char4 and one scale per
    // sender: 4 neighbouring codes never straddle a block), 4 quads a
    // thread, summed in registers over the senders in rank order.
    const int log_tq = log_tp - 2;
    int pos[kQuads];
    bool live[kQuads];
    float4 acc[kQuads];
#pragma unroll
    for (int u = 0; u < kQuads; ++u) {
      const int k = threadIdx.x + u * kTileThreads;
      const int o = (k & ((1 << log_tq) - 1)) * 4, j = k >> log_tq;
      live[u] = o < n_rows && j < n_cols;
      pos[u] = live[u] ? prow[j] + o : 0;
      acc[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    for (int s = 0; s < D; ++s) {
      const uint8_t* codes = gathered + s * image;
      const float* scales = reinterpret_cast<const float*>(codes + n);
      char4 q[kQuads];
      float sc[kQuads];
#pragma unroll
      for (int u = 0; u < kQuads; ++u) {
        q[u] = live[u] ? *reinterpret_cast<const char4*>(codes + pos[u])
                       : make_char4(0, 0, 0, 0);
        sc[u] = live[u] ? scales[pos[u] / kBlock] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kQuads; ++u) {
        acc[u].x = __fadd_rn(acc[u].x,
                             __fmul_rn(static_cast<float>(q[u].x), sc[u]));
        acc[u].y = __fadd_rn(acc[u].y,
                             __fmul_rn(static_cast<float>(q[u].y), sc[u]));
        acc[u].z = __fadd_rn(acc[u].z,
                             __fmul_rn(static_cast<float>(q[u].z), sc[u]));
        acc[u].w = __fadd_rn(acc[u].w,
                             __fmul_rn(static_cast<float>(q[u].w), sc[u]));
      }
    }
#pragma unroll
    for (int u = 0; u < kQuads; ++u) {
      if (!live[u]) continue;
      const int k = threadIdx.x + u * kTileThreads;
      const int o = (k & ((1 << log_tq) - 1)) * 4, j = k >> log_tq;
      tile[o * pitch + j] = finish(acc[u].x, mean, D);
      tile[(o + 1) * pitch + j] = finish(acc[u].y, mean, D);
      tile[(o + 2) * pitch + j] = finish(acc[u].z, mean, D);
      tile[(o + 3) * pitch + j] = finish(acc[u].w, mean, D);
    }
  } else {
    // Leaves of fewer or unaligned rows (biases, narrow heads): one
    // element at a time along o, 4 in flight a thread.
#pragma unroll 1
    for (int round = 0; round < 4 * kQuads; round += 4) {
      int pos[4];
      bool live[4];
      float acc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = threadIdx.x + (round + u) * kTileThreads;
        const int o = k & (tp - 1), j = k >> log_tp;
        live[u] = o < n_rows && j < n_cols;
        pos[u] = live[u] ? prow[j] + o : 0;
        acc[u] = 0.0f;
      }
      for (int s = 0; s < D; ++s) {
        const uint8_t* codes = gathered + s * image;
        const float* scales = reinterpret_cast<const float*>(codes + n);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int8_t q = live[u] ? static_cast<int8_t>(codes[pos[u]]) : 0;
          const float sc = live[u] ? scales[pos[u] / kBlock] : 0.0f;
          acc[u] = __fadd_rn(acc[u], __fmul_rn(static_cast<float>(q), sc));
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (!live[u]) continue;
        const int k = threadIdx.x + (round + u) * kTileThreads;
        tile[(k & (tp - 1)) * pitch + (k >> log_tp)] =
            finish(acc[u], mean, D);
      }
    }
  }
  __syncthreads();
  // Stores along r: rows of the leaf in `parameters()` order.
  if (flags & kVecOut) {
    const int log_trq = log_tr - 2;
#pragma unroll
    for (int u = 0; u < kQuads; ++u) {
      const int k = threadIdx.x + u * kTileThreads;
      const int j = (k & ((1 << log_trq) - 1)) * 4, o = k >> log_trq;
      if (o < n_rows && j < n_cols) {
        const float* t = tile + o * pitch + j;
        *reinterpret_cast<float4*>(out + out0 + o * row_len + j) =
            make_float4(t[0], t[1], t[2], t[3]);
      }
    }
  } else {
#pragma unroll 4
    for (int u = 0; u < 4 * kQuads; ++u) {
      const int k = threadIdx.x + u * kTileThreads;
      const int j = k & (tr - 1), o = k >> log_tr;
      if (o < n_rows && j < n_cols)
        out[out0 + o * row_len + j] = tile[o * pitch + j];
    }
  }
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

// K6b with the leaf table: gathered as above; out f32 [n] in
// `parameters()` order; tiles int32 [num_tiles * 16] (`q8_unpack_tiles`),
// one block each.
extern "C" int q8_gather_sum_unpack(const uint8_t* gathered, float* out,
                                    int nb, int D, int mean,
                                    const int* tiles, int num_tiles,
                                    void* stream) {
  if (nb <= 0 || D <= 0 || num_tiles <= 0)
    return static_cast<int>(cudaSuccess);
  q8_gather_sum_unpack_kernel<<<num_tiles, kTileThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      gathered, out, nb, D, mean, reinterpret_cast<const int4*>(tiles));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
