// V-trace targets (IMPALA): the reverse walk over time, staged through
// shared memory.
//
// Replaces: ray_tpu/rllib/agents/impala/vtrace.py `from_importance_weights`,
// where XLA fused the elementwise prologue and the reverse `lax.scan`
// (:53-58). Here the whole function is one kernel:
//
//   rho_t   = exp(log_rho_t)
//   delta_t = min(clip_rho, rho_t) * (r_t + gamma_t V_{t+1} - V_t)
//   acc_t   = delta_t + gamma_t * (lambda * min(1, rho_t)) * acc_{t+1}
//   vs_t    = acc_t + V_t
//   pg_t    = min(clip_pg_rho, rho_t) * (r_t + gamma_t vs_{t+1} - V_t)
//
// with V_T = vs_T = bootstrap. A clip threshold of +inf means no clip.
//
// Bound on an H100: at the learner's shape (T=50, B=32) it moves 38.5 KB
// (four [T,B] f32 inputs, a [B] bootstrap, two [T,B] f32 outputs; about
// 0.01 us at 3.35 TB/s) and does ~17 f32 operations per element, so the
// launch and the T-step dependent chain bound it; at T=500, B=4096 the
// bytes do (49 MB, 14.7 us). Only acc is serial.
//
// The design: one block of 128 threads per tile of `tile` batch columns;
// the plan (`vtrace_plan` in rllib/agents/impala/vtrace.py) picks the tile
// and the chunk of T staged at a time, so that the grid fills the card and
// the staged chunk fits the default 48 KB of shared memory. Per chunk, from
// the end of T:
// 1. Stage. The block copies the chunk of the four inputs into shared
//    memory with 16-byte `cp.async`s, each input along its own unit-stride
//    dimension, as it lies: the learner's batch-major columns (stride_t =
//    1, as vtrace_policy.py's `_time_major` views give them) column by
//    column, time-major inputs (stride_b = 1) row by row. Nothing is copied
//    or transposed in device memory first. A line (a column's steps or a
//    row's columns) is copied from the 16-byte boundary at or before its
//    first element, in whole 16-byte vectors that each hold at least one
//    of its elements (so every read stays inside the 16-byte granules of
//    the tensor's own allocation), and read back at its offset. Long T
//    walks chunk by chunk; the next (earlier) chunk's copies are in flight
//    in the other of two stages while this one is processed.
// 2. Prologue. All 128 threads compute, per element, rho, delta_t, the
//    recursion's factor gamma_t * lambda * min(1, rho_t) and
//    min(clip_pg_rho, rho_t), in the formulas above, into [t][b] arrays.
// 3. Walk. One thread per column walks t downward through the chunk:
//    acc_t = delta_t + factor_t * acc_{t+1}, vs_t = acc_t + V_t, the only
//    serial part, three shared loads and two operations per step, with vs
//    kept in shared memory.
// 4. Epilogue. All threads compute pg_t from vs_{t+1} and store vs and pg,
//    a row of the tile per group of lanes.
// Every value is the same f32 expression of the same operands as in the
// single-pass form, so the arithmetic matches the plain version's order.
//
// The plain PyTorch version of the same function (a Python loop of T steps
// of small launches) is `_from_importance_weights_plain` in
// rllib/agents/impala/vtrace.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr int kInputs = 4;  // log_rhos, discounts, rewards, values
constexpr int kMaxTile = 32;
// The default per-block shared memory (no opt-in attribute needed).
constexpr size_t kMaxSharedBytes = 48 * 1024;

// A [T, B] input: its address and its strides, in elements; one of them
// is 1 (the wrapper refuses other layouts).
struct Inputs {
  const float* ptr[kInputs];
  long long stride_t[kInputs];
  long long stride_b[kInputs];
};

// Floats between staged lines: room for a line's elements from the 16-byte
// boundary before it, a whole number of 16-byte vectors, and an odd number
// of them (so lines that neighbouring lanes read start in distinct banks).
__host__ __device__ inline int line_pitch(int length) {
  int vectors = (length + 3 + 3) / 4;
  if (vectors % 2 == 0) ++vectors;
  return 4 * vectors;
}

// Floats of one input's staged chunk, whichever way its lines run.
__host__ __device__ inline int slot_floats(int tile, int chunk) {
  const int columns = tile * line_pitch(chunk);
  const int rows = chunk * line_pitch(tile);
  return columns > rows ? columns : rows;
}

// The shared memory a launch takes: the staged inputs (two stages when T
// takes more than one chunk), four [chunk][tile + 1] work arrays, vs in
// [chunk + 1][tile + 1] and the next chunk's V_{t_hi} per column.
__host__ __device__ inline size_t shared_bytes(int T, int tile, int chunk) {
  const int stages = T > chunk ? 2 : 1;
  const size_t ld = tile + 1;
  return sizeof(float) *
         (static_cast<size_t>(stages) * kInputs * slot_floats(tile, chunk) +
          4 * chunk * ld + (chunk + 1) * ld + tile);
}

__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One input's view of a staged chunk [t_lo, t_lo + n) x [b0, b0 + cols):
// its lines run along its unit-stride dimension.
struct Staged {
  const float* src;
  long long st, sb;
  bool along_t;   // its lines are columns (stride_t == 1), else rows
  int pitch;      // floats between staged lines
  unsigned skew;  // src's offset within its 16-byte granule, in floats

  // The global element index of line i's first element.
  __device__ __forceinline__ long long first(int i, int t_lo, int b0) const {
    return along_t ? (b0 + i) * sb + t_lo : (t_lo + i) * st + b0;
  }

  // Line i's first element's offset within its 16-byte granule, where the
  // line starts in its staged row. Only the index's low bits count, so
  // they are taken in unsigned 32-bit arithmetic (which wraps).
  __device__ __forceinline__ int misalign(int i, int t_lo, int b0) const {
    const unsigned e =
        along_t ? static_cast<unsigned>(b0 + i) * static_cast<unsigned>(sb) +
                      static_cast<unsigned>(t_lo)
                : static_cast<unsigned>(t_lo + i) * static_cast<unsigned>(st) +
                      static_cast<unsigned>(b0);
    return static_cast<int>((skew + e) & 3u);
  }

  // Where element (t, b) of the chunk lies in `slot`.
  __device__ __forceinline__ int offset(int t, int b, int t_lo,
                                        int b0) const {
    return along_t ? b * pitch + misalign(b, t_lo, b0) + t
                   : t * pitch + misalign(t, t_lo, b0) + b;
  }
};

__device__ __forceinline__ Staged staged_input(const Inputs& in, int k,
                                               int tile, int chunk) {
  Staged s;
  s.src = in.ptr[k];
  s.st = in.stride_t[k];
  s.sb = in.stride_b[k];
  s.along_t = s.st == 1 && s.sb != 1;
  s.pitch = line_pitch(s.along_t ? chunk : tile);
  s.skew = static_cast<unsigned>(reinterpret_cast<uintptr_t>(s.src) >> 2) &
           3u;
  return s;
}

// Issue the copies of chunk [t_lo, t_lo + n) of every input into `buf`. A
// warp takes `per` lines at a time, V lanes to a line (V vectors cover a
// line from its granule); a line longer than 32 vectors takes a warp.
__device__ __forceinline__ void stage_chunk(float* buf, const Inputs& in,
                                            int tile, int chunk, int t_lo,
                                            int n, int b0, int cols) {
  const int slot = slot_floats(tile, chunk);
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
#pragma unroll
  for (int k = 0; k < kInputs; ++k) {
    const Staged s = staged_input(in, k, tile, chunk);
    const int lines = s.along_t ? cols : n;
    const int length = s.along_t ? n : cols;
    const int vectors = (length + 3 + 3) / 4;
    const int per = vectors >= kWarp ? 1 : kWarp / vectors;
    const int r = vectors >= kWarp ? 0 : lane / vectors;
    const int step = vectors >= kWarp ? kWarp : vectors;
    float* dst = buf + k * slot;
    if (r >= per) continue;
    for (int i = warp * per + r; i < lines; i += kWarps * per) {
      const int m = s.misalign(i, t_lo, b0);
      const float* granule = s.src + s.first(i, t_lo, b0) - m;
      // Only vectors that hold one of the line's elements.
      for (int j = lane - r * vectors; 4 * j < m + length; j += step) {
        copy16_async(dst + i * s.pitch + 4 * j, granule + 4 * j);
      }
    }
  }
  commit_copies();
}

// The serial part: acc_t = delta_t + factor_t * acc_{t+1}, vs_t = acc_t +
// V_t for t = n - 1 .. 0 of one column. Eight steps' operands are loaded
// before their eight stores (the stores may alias the loads as far as the
// compiler knows, so it would not hoist them itself).
__device__ __forceinline__ float walk(const float* delta,
                                      const float* factor,
                                      const float* value, float* vs, int n,
                                      int ld, float acc) {
  constexpr int kGroup = 8;
  int t = n - 1;
  for (; t >= kGroup - 1; t -= kGroup) {
    float d[kGroup], a[kGroup], v[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int s = (t - u) * ld;
      d[u] = delta[s];
      a[u] = factor[s];
      v[u] = value[s];
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      acc = d[u] + a[u] * acc;
      vs[(t - u) * ld] = acc + v[u];
    }
  }
  for (; t >= 0; --t) {
    const int s = t * ld;
    acc = delta[s] + factor[s] * acc;
    vs[s] = acc + value[s];
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    vtrace_kernel(const Inputs in, const float* __restrict__ bootstrap,
                  long long boot_stride, float* __restrict__ vs_out,
                  float* __restrict__ pg_out, int T, int B, int tile,
                  int chunk, float clip_rho, float clip_pg_rho,
                  float lambda_) {
  extern __shared__ __align__(16) float shared[];
  const int slot = slot_floats(tile, chunk);
  const int stage_floats = kInputs * slot;
  const int stages = T > chunk ? 2 : 1;
  const int ld = tile + 1;
  float* delta = shared + stages * stage_floats;  // [chunk][ld]
  float* factor = delta + chunk * ld;             // [chunk][ld]
  float* pg_rho = factor + chunk * ld;            // [chunk][ld]
  float* value = pg_rho + chunk * ld;             // [chunk][ld]
  float* vs = value + chunk * ld;                 // [chunk + 1][ld]
  float* v_end = vs + (chunk + 1) * ld;           // [tile]: V_{t_hi}
  const int chunks = (T + chunk - 1) / chunk;
  const int b0 = blockIdx.x * tile;
  const int cols = min(tile, B - b0);
  const int tile_shift = __ffs(tile) - 1;  // tile is a power of two

  // The first chunk's copies go out before the bootstrap's load, so the
  // two round trips overlap.
  stage_chunk(shared, in, tile, chunk, max(0, T - chunk), min(T, chunk), b0,
              cols);
  // The walker's state: thread b < cols owns column b0 + b.
  const int b = threadIdx.x;
  float acc = 0.0f;
  float vs_next = 0.0f;  // vs at the current chunk's t_hi
  if (b < cols) {
    vs_next = bootstrap[(b0 + b) * boot_stride];
    v_end[b] = vs_next;
  }

  for (int c = 0; c < chunks; ++c) {
    const int t_hi = T - c * chunk;
    const int t_lo = max(0, t_hi - chunk);
    const int n = t_hi - t_lo;
    if (c + 1 < chunks) {
      // The other stage was last read by chunk c - 1's epilogue, which
      // ended at the barrier closing the previous iteration.
      const int next_lo = max(0, t_lo - chunk);
      stage_chunk(shared + ((c + 1) & 1) * stage_floats, in, tile, chunk,
                  next_lo, t_lo - next_lo, b0, cols);
      wait_copies<1>();  // chunk c's group is complete
    } else {
      wait_copies<0>();
    }
    __syncthreads();
    const float* buf = shared + (c & 1) * stage_floats;
    const Staged lr = staged_input(in, 0, tile, chunk);
    const Staged dc = staged_input(in, 1, tile, chunk);
    const Staged rw = staged_input(in, 2, tile, chunk);
    const Staged vl = staged_input(in, 3, tile, chunk);

    // Prologue: element k is (t, b) = (k / tile, k % tile); a thread keeps
    // its column, since kThreads is a multiple of the tile.
    const float* lr_slot = buf;
    const float* dc_slot = buf + slot;
    const float* rw_slot = buf + 2 * slot;
    const float* vl_slot = buf + 3 * slot;
    const int bb = threadIdx.x & (tile - 1);
    const int total = bb < cols ? n << tile_shift : 0;
    for (int k = threadIdx.x; k < total; k += kThreads) {
      const int t = k >> tile_shift;
      const float rho = expf(lr_slot[lr.offset(t, bb, t_lo, b0)]);
      const float discount = dc_slot[dc.offset(t, bb, t_lo, b0)];
      const float reward = rw_slot[rw.offset(t, bb, t_lo, b0)];
      const float v = vl_slot[vl.offset(t, bb, t_lo, b0)];
      const float v_next = t + 1 < n
                               ? vl_slot[vl.offset(t + 1, bb, t_lo, b0)]
                               : v_end[bb];
      const int s = t * ld + bb;
      delta[s] = fminf(clip_rho, rho) * (reward + discount * v_next - v);
      factor[s] = discount * (lambda_ * fminf(1.0f, rho));
      pg_rho[s] = fminf(clip_pg_rho, rho);
      value[s] = v;
    }
    __syncthreads();

    if (b < cols) {
      vs[n * ld + b] = vs_next;
      acc = walk(delta + b, factor + b, value + b, vs + b, n, ld, acc);
      vs_next = vs[b];
      v_end[b] = value[b];  // V at this chunk's t_lo: the next one's t_hi
    }
    __syncthreads();

    // Epilogue: pg_t from vs_{t+1}; both outputs stored row by row.
    for (int k = threadIdx.x; k < total; k += kThreads) {
      const int t = k >> tile_shift;
      const int s = t * ld + bb;
      const float discount = dc_slot[dc.offset(t, bb, t_lo, b0)];
      const float reward = rw_slot[rw.offset(t, bb, t_lo, b0)];
      const size_t i = static_cast<size_t>(t_lo + t) * B + b0 + bb;
      vs_out[i] = vs[s];
      pg_out[i] = pg_rho[s] * (reward + discount * vs[s + ld] - value[s]);
    }
    __syncthreads();
  }
}

}  // namespace

// Each [T, B] input comes with its (stride_t, stride_b) in elements, one of
// them 1; the [B] bootstrap with its stride; the outputs are contiguous
// [T, B]. `tile` (a power of two up to 32 columns per block) and `chunk`
// (steps staged at a time) come from the wrapper's plan; a plan whose
// shared memory exceeds 48 KB, or an input with neither stride 1, is
// refused.
extern "C" int vtrace_forward(
    const float* log_rhos, long long log_rhos_st, long long log_rhos_sb,
    const float* discounts, long long discounts_st, long long discounts_sb,
    const float* rewards, long long rewards_st, long long rewards_sb,
    const float* values, long long values_st, long long values_sb,
    const float* bootstrap, long long boot_stride, float* vs_out,
    float* pg_out, int T, int B, int tile, int chunk, float clip_rho,
    float clip_pg_rho, float lambda_, void* stream) {
  if (T <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  const Inputs in = {{log_rhos, discounts, rewards, values},
                     {log_rhos_st, discounts_st, rewards_st, values_st},
                     {log_rhos_sb, discounts_sb, rewards_sb, values_sb}};
  if (tile < 1 || tile > kMaxTile || (tile & (tile - 1)) != 0 || chunk < 1 ||
      shared_bytes(T, tile, chunk) > kMaxSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = 0; k < kInputs; ++k) {
    if (in.stride_t[k] != 1 && in.stride_b[k] != 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int blocks = (B + tile - 1) / tile;
  vtrace_kernel<<<blocks, kThreads, shared_bytes(T, tile, chunk),
                  static_cast<cudaStream_t>(stream)>>>(
      in, bootstrap, boot_stride, vs_out, pg_out, T, B, tile, chunk,
      clip_rho, clip_pg_rho, lambda_);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
