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
//      row's done byte (packed[row, 3K], or done[row] in frame mode) is
//      set; with S <= 1, a copy of the frame.
//
// `frames` is updated in place (JAX donated it); `out` is always a fresh
// buffer, because the train batch retains every step's observation and
// the stack of the next step reads this one. The same kernel serves the
// frame-upload mode (no packed rows, b = 0): `frames` is then the
// uploaded frame batch, read only, and `done` is its own [n] upload.
//
// Bound on an H100: bytes. At the Sebulba shape (n=32 envs, HW=7056,
// K=128, S=4, a quarter of the rows replaced, a tenth done) one call
// must move ~2.0 MB: the observation written (903 KB), the old stack of
// the rows not done (~813 KB; channel-last, a sector holds all four
// channels, so the dropped channel 0 is read too), the frames read
// except the replaced rows (169 KB), the replaced rows read from
// `fulls` and written (2 x 56 KB) plus the scattered entries (~3 KB),
// packed 12 KB: ~0.6 us at 3.35 TB/s, under a launch, so the call is
// latency-bound: what counts is how many dependent memory round trips
// one block makes and how many blocks share the work.
//
// The design: a (row, pixel-chunk) grid. Block r * chunks + c owns the
// pixels [c * chunk_px, min((c + 1) * chunk_px, HW)) of row r, at most
// kMaxChunk = 1024 of them (one 4-pixel word per thread), and runs all
// three phases for that chunk alone, so no phase reads a pixel another
// block writes and one launch suffices. The chunk count comes from
// `obs_apply_plan` in rllib/evaluation/device_sampler.py: about two
// blocks per SM at n=32 (9 chunks of 784 pixels: 288 blocks, where one
// block per row gave 32 blocks looping 7 times over their row).
//
// What sets a small call's time is the chain of dependent memory round
// trips in a block, so each block issues every load that depends on
// nothing first, together: the row's done byte, its first 256 delta
// entries, its chunk of the retained frames (one 32-bit word of 4
// pixels per thread) and of the old stack (one 16-byte vector of 4
// pixels x 4 channels per thread), and the `rows` bucket. One barrier
// (`__syncthreads_or`) then says whether the row is replaced; only then
// does a replaced row's chunk come from `fulls` (a second round trip,
// for those rows alone). The chunk's frame bytes go to shared memory,
// the delta entries are applied there (and flag their 4-pixel word),
// and after a last barrier each thread writes its word back to the
// retained frames if the row was replaced or a delta entry touched it
// (duplicate indices thus leave frames and observation equal), and its
// observation vector: for S=4, per 32-bit word of 4 channels (little-
// endian, channel c is byte c), (word >> 8) | (frame << 24), or the
// frame byte in all 4 channels where the row is done. The stack is read
// for done rows too, which saves waiting for the done byte before
// reading it. Chunk edges are multiples of 16 pixels, so the word and
// vector paths stay aligned; other frame sizes, stack depths and
// misaligned buffers take the byte-wise paths. The plain version is
// `_apply_obs_plain` in rllib/evaluation/device_sampler.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 4 * kThreads;

__global__ void __launch_bounds__(kThreads) obs_apply_kernel(
    uint8_t* __restrict__ frames, const uint8_t* __restrict__ packed, int K,
    const uint8_t* __restrict__ done, int done_stride,
    const int32_t* __restrict__ rows, const uint8_t* __restrict__ fulls,
    int b, const uint8_t* __restrict__ stack, uint8_t* __restrict__ out,
    int hw, int S, int chunks, int chunk_px, int vec) {
  __shared__ __align__(16) uint8_t px[kMaxChunk];
  __shared__ uint8_t touched[kMaxChunk / 4];
  __shared__ int src;
  const int row = blockIdx.x / chunks;
  const int c0 = (blockIdx.x - row * chunks) * chunk_px;
  const int len = min(chunk_px, hw - c0);
  const int tid = threadIdx.x;
  uint8_t* f = frames + static_cast<size_t>(row) * hw + c0;
  // This thread's 4 pixels on the word paths: c0 + 4 * tid.
  const bool mine = vec && tid < len / 4;
  const bool stack4 = vec && S == 4;
  const uint8_t* p =
      K > 0 ? packed + static_cast<size_t>(row) * (3 * K + 1) : nullptr;

  // A. Every load that depends on nothing else, issued together.
  const bool d = done[static_cast<size_t>(row) * done_stride] != 0;
  int idx0 = -1;
  uint8_t val0 = 0;
  if (tid < K) {
    idx0 = static_cast<int>(p[2 * tid]) |
           (static_cast<int>(p[2 * tid + 1]) << 8);
    val0 = p[2 * K + tid];
  }
  uint32_t word = 0;
  uint4 s = make_uint4(0u, 0u, 0u, 0u);
  if (mine) {
    word = reinterpret_cast<const uint32_t*>(f)[tid];
    if (stack4)
      s = reinterpret_cast<const uint4*>(
          stack + (static_cast<size_t>(row) * hw + c0) * 4)[tid];
  }
  if (tid < kMaxChunk / 4) touched[tid] = 0;
  int found = 0;
  for (int j = tid; j < b; j += kThreads)
    if (rows[j] == row) {  // rows are distinct; pads (>= n) never match
      src = j;
      found = 1;
    }
  const bool replaced = __syncthreads_or(found) != 0;

  // B. The chunk's frame bytes into shared memory: the full row's where
  // the row is replaced, else the retained (or uploaded) frames'.
  const uint8_t* g =
      replaced ? fulls + static_cast<size_t>(src) * hw + c0 : nullptr;
  if (vec) {
    if (mine) {
      if (replaced) word = reinterpret_cast<const uint32_t*>(g)[tid];
      reinterpret_cast<uint32_t*>(px)[tid] = word;
    }
  } else {
    for (int i = tid; i < len; i += kThreads) px[i] = replaced ? g[i] : f[i];
  }
  __syncthreads();

  // C. The row's delta entries that fall in the chunk (indices >= HW
  // fall in none).
  if (K > 0) {
    if (idx0 >= c0 && idx0 < c0 + len) {
      px[idx0 - c0] = val0;
      touched[(idx0 - c0) >> 2] = 1;
    }
    for (int e = tid + kThreads; e < K; e += kThreads) {
      const int idx = static_cast<int>(p[2 * e]) |
                      (static_cast<int>(p[2 * e + 1]) << 8);
      if (idx >= c0 && idx < c0 + len) {
        px[idx - c0] = p[2 * K + e];
        touched[(idx - c0) >> 2] = 1;
      }
    }
    __syncthreads();
  }

  // D. The retained frames where they changed, and the observation.
  if (vec && (S <= 1 || S == 4)) {
    if (!mine) return;
    word = reinterpret_cast<const uint32_t*>(px)[tid];
    if (replaced || touched[tid]) reinterpret_cast<uint32_t*>(f)[tid] = word;
    if (S <= 1) {
      reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row) * hw +
                                  c0)[tid] = word;
      return;
    }
    const uint32_t p0 = word & 0xffu, p1 = (word >> 8) & 0xffu,
                   p2 = (word >> 16) & 0xffu, p3 = word >> 24;
    uint4 o;
    if (d) {
      o.x = p0 * 0x01010101u;
      o.y = p1 * 0x01010101u;
      o.z = p2 * 0x01010101u;
      o.w = p3 * 0x01010101u;
    } else {
      o.x = (s.x >> 8) | (p0 << 24);
      o.y = (s.y >> 8) | (p1 << 24);
      o.z = (s.z >> 8) | (p2 << 24);
      o.w = (s.w >> 8) | (p3 << 24);
    }
    reinterpret_cast<uint4*>(out + (static_cast<size_t>(row) * hw + c0) *
                                       4)[tid] = o;
    return;
  }
  for (int i = tid; i < len; i += kThreads)
    if (replaced || touched[i >> 2]) f[i] = px[i];
  if (S <= 1) {
    uint8_t* o = out + static_cast<size_t>(row) * hw + c0;
    for (int i = tid; i < len; i += kThreads) o[i] = px[i];
    return;
  }
  const size_t base = (static_cast<size_t>(row) * hw + c0) * S;
  for (int i = tid; i < len * S; i += kThreads) {
    const int q = i / S;
    const int c = i - q * S;
    out[base + i] = (d || c == S - 1) ? px[q] : stack[base + i + 1];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// `packed` null: frame mode, `done` is the [n] done upload. Otherwise
// `packed` is [n, 3K+1] (K may be 0) and `done` is not read. The grid is
// n * ceil(hw / chunk_px) blocks.
extern "C" int obs_apply(uint8_t* frames, const uint8_t* packed, int K,
                         const uint8_t* done, const int32_t* rows,
                         const uint8_t* fulls, int b, const uint8_t* stack,
                         uint8_t* out, int n, int hw, int S, int chunk_px,
                         void* stream) {
  if (n <= 0 || hw <= 0) return static_cast<int>(cudaSuccess);
  if (chunk_px <= 0 || chunk_px > kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = (hw + static_cast<long long>(chunk_px) - 1) /
                           chunk_px;
  const long long blocks = chunks * n;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int done_stride = 1;
  if (packed != nullptr) {
    done = packed + 3 * K;
    done_stride = 3 * K + 1;
  }
  // The 16-byte paths need 16-byte rows, chunk edges on 16-pixel lines
  // and 16-byte aligned bases; the frame rows of the S=4 path are read 4
  // bytes at a time.
  const bool vec = hw % 16 == 0 && (chunks == 1 || chunk_px % 16 == 0) &&
                   aligned16(frames) && aligned16(out) &&
                   (b == 0 || aligned16(fulls)) &&
                   (S <= 1 || aligned16(stack));
  obs_apply_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      frames, packed, packed != nullptr ? K : 0, done, done_stride, rows,
      fulls, b, stack, out, hw, S, static_cast<int>(chunks), chunk_px,
      vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
