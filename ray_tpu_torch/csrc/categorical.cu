// Categorical action-sampling tail: Gumbel-max draw (or argmax) + logp.
//
// Replaces: ray_tpu/models/distributions.py `Categorical.sample` and
// `Categorical.logp` as called from the policy's jitted action function
// (ray_tpu/rllib/policy/jax_policy.py `action_fn`), where XLA fused them
// behind the network forward. Per row of logits l[0..A):
//
//   explore: a = argmax_j (l_j - log(-log u_j))   (Gumbel-max draw)
//   else:    a = argmax_j l_j
//   logp    = (l_a - m) - log(sum_j exp(l_j - m)),   m = max_j l_j
//
// ties go to the first maximum, as jnp.argmax and torch.argmax do. The
// uniform noise u comes from the caller (torch.rand on the policy's
// generator), clamped below at FLT_MIN as jax.random.gumbel clamps it.
//
// Bound on an H100: launch latency. At the sampler's shape (B=32 envs,
// A=6 actions) it reads 1.5 KB and writes 0.4 KB, ~10 f32 operations per
// element; the bytes take under a nanosecond at 3.35 TB/s. The design:
// one warp per row, lanes striding over the A columns, the argmax
// (value, index) pair, the row max and the exp-sum reduced with warp
// shuffles in registers; one launch yields both outputs, where the plain
// version launches about ten small PyTorch kernels. The plain version is
// `_sample_logp_plain` in models/distributions.py.
//
// The step record: the local-mode sampler needs every env step's actions,
// logp, logits (the policy's ACTION_DIST_INPUTS) and value on the host.
// Given a record in pinned host memory (its device-mapped address, which
// the wrapper resolves once per buffer through `host_device_pointer`),
// the kernel also writes there, beside its device outputs: lane 0 of each
// row's warp the int64 action, the f32 logp and the row's f32 value (read
// from `value`; the column is left as it is when no value is given), and
// every lane its share of the row's logits, which the warp has just read. Layout, for B rows of A logits, back to
// back: actions int64 [B] | logp f32 [B] | value f32 [B] | logits f32
// [B, A]. That replaces four device-to-host copies (and the host sync
// each makes) per env step with one wait on an event recorded after the
// launch. The cost moves to the device: the kernel ends only after its
// PCIe writes (20 + 4A bytes per row, 1.4 KB at B=32, A=6, in 4-byte
// stores of one warp), which took K2k's launch from 1.7 to 2.7 us with
// its 4-byte wire output; the bound counts these bytes like any output.
//
// K2k, `categorical_sample_k`: the k-step form. Replaces the `lax.scan`
// over `jax.random.split(rng, k)` in `select_fn`
// (ray_tpu/rllib/evaluation/device_sampler.py `_build_fns`): k draws per
// env from ONE distribution (the window-head logits [N, A]) with k
// independent uniform rows [k, N, A] -> actions and logp [k, N]. One warp
// per (j, n) output row, running the same per-row code as K2, so k=1
// equals K2 exactly. Bound: launch latency at the Sebulba shape (k<=5,
// N=32, A=6: under 5 KB moved); at k=8, N=4096, A=18 the 2.4 MB of
// uniforms make it a bytes-bound kernel (~0.7 us at 3.35 TB/s). The
// logits row is re-read by each of the k warps and stays in L1/L2. Its
// plain version is `_sample_logp_k_plain`.
//
// The wire actions: the sampler ships every window's actions to the host
// as int32 [k, N]. Given a pinned host buffer, lane 0 of each warp also
// writes its action there, as int32, through the buffer's device-mapped
// address (`cudaHostGetDevicePointer`, resolved per call; a buffer the
// card cannot see makes the call fail before any launch). That replaces
// an int64->int32 cast kernel and a device->host copy per window: the
// writes (4 bytes per draw over PCIe) are complete and visible to the
// host once an event recorded after the launch has completed.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 4;

// One warp draws one action from one row of logits l[0..A) with the
// uniforms ur[0..A) (ignored unless exploring); the result is valid on
// lane 0. Both kernels below run this same code, so the k-step kernel at
// k=1 picks exactly what the single-step kernel picks.
struct Draw {
  int action;
  float logp;
};

__device__ __forceinline__ Draw sample_row(const float* __restrict__ l,
                                           const float* __restrict__ ur,
                                           int A, int explore, int lane) {
  float best = -INFINITY;
  int best_j = A;  // larger than any real index: loses every tie
  float m = -INFINITY;
  for (int j = lane; j < A; j += kWarp) {
    const float x = l[j];
    float score = x;
    if (explore) {
      const float g = -logf(-logf(fmaxf(ur[j], FLT_MIN)));
      score = x + g;
    }
    if (score > best) {  // j increases per lane: keeps the first max
      best = score;
      best_j = j;
    }
    m = fmaxf(m, x);
  }
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oj = __shfl_xor_sync(0xffffffffu, best_j, off);
    if (ob > best || (ob == best && oj < best_j)) {
      best = ob;
      best_j = oj;
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  if (best_j >= A) best_j = 0;  // every score NaN: fall back to column 0

  float s = 0.0f;
  for (int j = lane; j < A; j += kWarp) s += expf(l[j] - m);
  for (int off = kWarp / 2; off > 0; off /= 2)
    s += __shfl_xor_sync(0xffffffffu, s, off);

  Draw d{best_j, 0.0f};
  if (lane == 0) d.logp = (l[best_j] - m) - logf(s);
  return d;
}

// `record`: null, or the device-mapped address of a step record of B
// rows (layout in the note above); `value`: null, or f32 [B] on the
// device, the record's value column.
__global__ void categorical_sample_kernel(
    const float* __restrict__ logits, const float* __restrict__ u,
    int64_t* __restrict__ actions, float* __restrict__ logp,
    const float* __restrict__ value, char* __restrict__ record, int B, int A,
    int explore) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= B) return;  // whole warps leave together
  const float* l = logits + static_cast<size_t>(row) * A;
  // Issued before the draw, so its latency hides behind the row's loads.
  const float v =
      (record != nullptr && value != nullptr && lane == 0) ? value[row] : 0.0f;
  const Draw d =
      sample_row(l, explore ? u + static_cast<size_t>(row) * A : nullptr, A,
                 explore, lane);
  if (lane == 0) {
    actions[row] = d.action;
    logp[row] = d.logp;
  }
  if (record == nullptr) return;
  int64_t* rec_actions = reinterpret_cast<int64_t*>(record);
  float* rec_logp =
      reinterpret_cast<float*>(record + 8 * static_cast<size_t>(B));
  float* rec_value = rec_logp + B;
  float* rec_logits = rec_value + B;
  if (lane == 0) {
    rec_actions[row] = d.action;
    rec_logp[row] = d.logp;
    if (value != nullptr) rec_value[row] = v;
  }
  float* out = rec_logits + static_cast<size_t>(row) * A;
  for (int j = lane; j < A; j += kWarp) out[j] = l[j];
}

// k draws per row from one distribution (the Sebulba selection window):
// output row r = j * N + n reads logits[n] and uniforms u[j, n]; one warp
// per output row, as above. `wire` (device-mapped host memory, or null)
// gets the int32 copy of each action.
__global__ void categorical_sample_k_kernel(const float* __restrict__ logits,
                                            const float* __restrict__ u,
                                            int64_t* __restrict__ actions,
                                            float* __restrict__ logp,
                                            int32_t* __restrict__ wire,
                                            int k, int N, int A,
                                            int explore) {
  const int lane = threadIdx.x % kWarp;
  const long long r =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (r >= static_cast<long long>(k) * N) return;  // whole warps leave
  const int n = static_cast<int>(r % N);
  const Draw d = sample_row(logits + static_cast<size_t>(n) * A,
                            explore ? u + static_cast<size_t>(r) * A : nullptr,
                            A, explore, lane);
  if (lane == 0) {
    actions[r] = d.action;
    logp[r] = d.logp;
    if (wire != nullptr) wire[r] = d.action;
  }
}

}  // namespace

// `record`: null, or the device-mapped address (from
// `host_device_pointer`) of a pinned step record of B rows and A logits.
extern "C" int categorical_sample(const float* logits, const float* u,
                                  int64_t* actions, float* logp,
                                  const float* value, void* record, int B,
                                  int A, int explore, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  categorical_sample_kernel<<<blocks, kRowsPerBlock * kWarp, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      logits, u, actions, logp, value, static_cast<char*>(record), B, A,
      explore);
  return static_cast<int>(cudaGetLastError());
}

// The device-mapped address of pinned host memory at `host`, into
// `*device`. Memory the card cannot map (pageable) returns the error;
// it is then also this library's last runtime error, so it is cleared,
// or the next launch here would report it as its own.
extern "C" int host_device_pointer(void* host, void** device) {
  const cudaError_t err = cudaHostGetDevicePointer(device, host, 0);
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

// `host_actions`: null, or a pinned (page-locked) host buffer of k * N
// int32 that the kernel fills beside `actions`.
extern "C" int categorical_sample_k(const float* logits, const float* u,
                                    int64_t* actions, float* logp,
                                    int32_t* host_actions, int k, int N,
                                    int A, int explore, void* stream) {
  const long long rows = static_cast<long long>(k) * N;
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int32_t* wire = nullptr;
  if (host_actions != nullptr) {
    void* mapped = nullptr;
    const cudaError_t err = cudaHostGetDevicePointer(&mapped, host_actions, 0);
    if (err != cudaSuccess) {
      // Not sticky, but it is the runtime's last error now: clear it, or
      // the next launch of this library reports it as its own.
      cudaGetLastError();
      return static_cast<int>(err);
    }
    wire = static_cast<int32_t*>(mapped);
  }
  categorical_sample_k_kernel<<<static_cast<unsigned>(blocks),
                                kRowsPerBlock * kWarp, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      logits, u, actions, logp, wire, k, N, A, explore);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
