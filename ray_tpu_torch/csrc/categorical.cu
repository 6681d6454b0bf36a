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
// uniforms ur[0..A) (ignored unless exploring) and writes the action and
// its logp. Both kernels below run this same code, so the k-step kernel
// at k=1 picks exactly what the single-step kernel picks.
__device__ __forceinline__ void sample_row(const float* __restrict__ l,
                                           const float* __restrict__ ur,
                                           int A, int explore, int lane,
                                           int64_t* __restrict__ action,
                                           float* __restrict__ logp,
                                           int32_t* __restrict__ wire) {
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

  if (lane == 0) {
    *action = best_j;
    *logp = (l[best_j] - m) - logf(s);
    if (wire != nullptr) *wire = best_j;
  }
}

__global__ void categorical_sample_kernel(const float* __restrict__ logits,
                                          const float* __restrict__ u,
                                          int64_t* __restrict__ actions,
                                          float* __restrict__ logp, int B,
                                          int A, int explore) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= B) return;  // whole warps leave together
  sample_row(logits + static_cast<size_t>(row) * A,
             explore ? u + static_cast<size_t>(row) * A : nullptr, A,
             explore, lane, actions + row, logp + row, nullptr);
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
  sample_row(logits + static_cast<size_t>(n) * A,
             explore ? u + static_cast<size_t>(r) * A : nullptr, A, explore,
             lane, actions + r, logp + r,
             wire != nullptr ? wire + r : nullptr);
}

}  // namespace

extern "C" int categorical_sample(const float* logits, const float* u,
                                  int64_t* actions, float* logp, int B, int A,
                                  int explore, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  categorical_sample_kernel<<<blocks, kRowsPerBlock * kWarp, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      logits, u, actions, logp, B, A, explore);
  return static_cast<int>(cudaGetLastError());
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
