// Sebulba observation apply: full-row replace + delta scatter + frame stack.
//
// Replaces (kernel K3): the per-env-step device programs of the JAX
// Sebulba sampler, ray_tpu/rllib/evaluation/device_sampler.py
// `_build_fns.apply_delta` / `update_stack` and `_full_fn.apply_full`,
// which XLA ran as a bucketed row scatter, an index scatter with
// mode="drop" into the retained (donated) frame buffer, and a
// concatenate/where for the rolling [N, H, W, S] stack. Per env row:
//
//   1. if the row is one of rows[0..b): frames[row] = fulls[j]
//      (pad rows >= n are dropped);
//   2. decode K little-endian uint16 indices from packed[row, 0:2K] and
//      set frames[row, idx] = packed[row, 2K + e], dropping idx >= HW;
//   3. out[row] = the stack rolled by one channel with the new frame as
//      its last channel, or the new frame in every channel where the
//      row's done byte is set; with S <= 1, a copy of the frame.
//
// `frames` is updated in place (JAX donated it); `out` is always a fresh
// buffer, because the train batch retains every step's observation and
// the stack of the next step reads this one. The same kernel serves the
// frame-upload mode (K = 0, b = 0): `frames` is then the uploaded frame
// batch, read only, and `done` is its own [n] upload.
//
// Bound on an H100: bytes. At the Sebulba shape (n=32 envs, HW=7056,
// K=128, S=4, a quarter of the rows replaced, a tenth done) one call
// must move ~2.0 MB: the observation written (903 KB), the old stack of
// the rows not done (~813 KB; channel-last, a sector holds all four
// channels, so the dropped channel 0 is read too), the frames read
// except the replaced rows (169 KB), the replaced rows read from
// `fulls` and written (2 x 56 KB) plus the scattered entries (~3 KB),
// packed 12 KB: ~0.6 us at 3.35 TB/s, well under a launch, so the call
// is latency-bound. The design: one
// block per env row, so the three phases need only __syncthreads()
// between them and no second launch; the stack is read and written as
// one 16-byte vector per 4 pixels (4 channels each), so S=4 costs one
// uint4 load, a byte shift and one uint4 store per 4 pixels. The plain
// version is `_apply_obs_plain` in rllib/evaluation/device_sampler.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void obs_apply_kernel(
    uint8_t* __restrict__ frames, const uint8_t* __restrict__ packed,
    int packed_stride, int K, const uint8_t* __restrict__ done,
    int done_stride, const int32_t* __restrict__ rows,
    const uint8_t* __restrict__ fulls, int b,
    const uint8_t* __restrict__ stack, uint8_t* __restrict__ out, int n,
    int hw, int S, int vec) {
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  uint8_t* f = frames + static_cast<size_t>(row) * hw;

  // 1. full-row replacement
  if (b > 0) {
    __shared__ int src;
    if (tid == 0) src = -1;
    __syncthreads();
    for (int j = tid; j < b; j += kThreads)
      if (rows[j] == row) src = j;  // rows are distinct; pads never match
    __syncthreads();
    if (src >= 0) {
      const uint8_t* g = fulls + static_cast<size_t>(src) * hw;
      if (vec) {
        const uint4* g4 = reinterpret_cast<const uint4*>(g);
        uint4* f4 = reinterpret_cast<uint4*>(f);
        for (int i = tid; i < hw / 16; i += kThreads) f4[i] = g4[i];
      } else {
        for (int i = tid; i < hw; i += kThreads) f[i] = g[i];
      }
    }
    __syncthreads();
  }

  // 2. sparse delta scatter
  if (K > 0) {
    const uint8_t* p = packed + static_cast<size_t>(row) * packed_stride;
    for (int e = tid; e < K; e += kThreads) {
      const unsigned idx = static_cast<unsigned>(p[2 * e]) |
                           (static_cast<unsigned>(p[2 * e + 1]) << 8);
      if (idx < static_cast<unsigned>(hw)) f[idx] = p[2 * K + e];
    }
    __syncthreads();
  }

  // 3. the new observation
  const bool d = done[static_cast<size_t>(row) * done_stride] != 0;
  if (S <= 1) {
    uint8_t* o = out + static_cast<size_t>(row) * hw;
    if (vec) {
      const uint4* f4 = reinterpret_cast<const uint4*>(f);
      uint4* o4 = reinterpret_cast<uint4*>(o);
      for (int i = tid; i < hw / 16; i += kThreads) o4[i] = f4[i];
    } else {
      for (int i = tid; i < hw; i += kThreads) o[i] = f[i];
    }
    return;
  }
  const size_t base = static_cast<size_t>(row) * hw * S;
  if (S == 4 && vec) {
    // 4 pixels x 4 channels per thread: little-endian, channel c of a
    // pixel is byte c of its 32-bit word, so dropping channel 0 and
    // appending the frame is (word >> 8) | (frame << 24).
    const uint32_t* f4 = reinterpret_cast<const uint32_t*>(f);
    const uint4* s4 = reinterpret_cast<const uint4*>(stack + base);
    uint4* o4 = reinterpret_cast<uint4*>(out + base);
    for (int i = tid; i < hw / 4; i += kThreads) {
      const uint32_t px = f4[i];
      const uint32_t p0 = px & 0xffu, p1 = (px >> 8) & 0xffu,
                     p2 = (px >> 16) & 0xffu, p3 = px >> 24;
      uint4 o;
      if (d) {
        o.x = p0 * 0x01010101u;
        o.y = p1 * 0x01010101u;
        o.z = p2 * 0x01010101u;
        o.w = p3 * 0x01010101u;
      } else {
        const uint4 s = s4[i];
        o.x = (s.x >> 8) | (p0 << 24);
        o.y = (s.y >> 8) | (p1 << 24);
        o.z = (s.z >> 8) | (p2 << 24);
        o.w = (s.w >> 8) | (p3 << 24);
      }
      o4[i] = o;
    }
    return;
  }
  for (int i = tid; i < hw * S; i += kThreads) {
    const int px = i / S;
    const int c = i - px * S;
    const uint8_t v = f[px];
    out[base + i] = (d || c == S - 1) ? v : stack[base + i + 1];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" int obs_apply(uint8_t* frames, const uint8_t* packed,
                         int packed_stride, int K, const uint8_t* done,
                         int done_stride, const int32_t* rows,
                         const uint8_t* fulls, int b, const uint8_t* stack,
                         uint8_t* out, int n, int hw, int S, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  // The 16-byte paths need 16-byte rows and 16-byte aligned bases; the
  // frame rows of the S=4 path are read 4 bytes at a time.
  const bool vec = hw % 16 == 0 && aligned16(frames) && aligned16(out) &&
                   (b == 0 || aligned16(fulls)) &&
                   (S <= 1 || aligned16(stack));
  obs_apply_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      frames, packed, packed_stride, K, done, done_stride, rows, fulls, b,
      stack, out, n, hw, S, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
