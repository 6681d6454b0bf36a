// Epsilon-greedy action tail of the Q-policies (K8).
//
// Replaces: ray_tpu/rllib/agents/dqn/dqn_policy.py:161-170
// `eps_action_fn`, where XLA fused the argmax, the random action and the
// epsilon swap behind the Q-network forward. Per row of Q-values
// q[0..A) and two uniforms u[0..2):
//
//   greedy = argmax_j q_j     (the FIRST maximum; NaN counts as above
//                              every number, as torch.argmax and
//                              jnp.argmax count it)
//   rand   = min(floor(u_1 * A), A - 1)
//   a      = u_0 < eps ? rand : greedy
//
// The product u_1 * A is one correctly rounded f32 multiply
// (`__fmul_rn`, so nvcc cannot fold it into anything else), which is
// what the plain version `_eps_greedy_plain` in models/eps_greedy.py
// computes on tensors: the two agree exactly on the same uniforms, at
// any epsilon. The uniforms come from the caller (torch.rand on the DQN
// policy's own generator).
//
// Bound on an H100: launch latency. At the DQN Atari path's shape (one
// env, A=6 actions) it reads 24 bytes of Q-values and 8 of uniforms and
// writes one 8-byte action: 40 bytes, 1.2e-5 us at 3.35 TB/s; at
// B=4096, A=18 it moves 360 KB (0.1 us). The design: one warp per row,
// lanes striding over the A columns, the (value, index) argmax reduced
// with warp shuffles in registers, and lane 0 making the epsilon swap;
// one launch, where the plain version launches about eight small
// PyTorch kernels.
//
// The host actions: the DQN policy's env step needs its actions on the
// host and nowhere else. Given the device-mapped address of a pinned
// int64 [B] host buffer (resolved once per buffer by the wrapper through
// `host_device_pointer`; a buffer the card cannot map fails there,
// before any launch), lane 0 writes the action there, beside the device
// output or instead of it: `actions` may be null when a host output is
// given. The step's tail is then the uniforms and this launch, followed
// by one wait on an event recorded after it, with no device output to
// allocate and no device-to-host copy. The writes are complete and
// visible to the host once that event has completed. The cost moves to
// the device: the kernel ends only after its PCIe write (8 bytes per
// row), as K2's launch went from 1.5 to 2.9 us with its step record and
// K9f's from 1.4 to 2.5 with its host actions; the bound counts the
// bytes like any output.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// Whether (v, j) comes before (bv, bj) in torch.argmax's order: NaN
// above every number, then the larger value, then the lower index. An
// index >= A (a lane that holds no column) loses to every real one.
__device__ __forceinline__ bool beats(float v, int j, float bv, int bj,
                                      int A) {
  if (j >= A) return false;
  if (bj >= A) return true;
  const bool v_nan = isnan(v);
  const bool b_nan = isnan(bv);
  if (v_nan != b_nan) return v_nan;
  if (!v_nan && v != bv) return v > bv;
  return j < bj;
}

// `actions`: null, or the int64 [B] device output; `host`: null, or the
// device-mapped address of the pinned int64 [B] host output.
__global__ void eps_greedy_kernel(const float* __restrict__ q,
                                  const float* __restrict__ u,
                                  int64_t* __restrict__ actions,
                                  int64_t* __restrict__ host, int B, int A,
                                  float eps) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= B) return;  // whole warps leave together
  const float* qr = q + static_cast<size_t>(row) * A;
  float best = 0.0f;
  int best_j = A;
  for (int j = lane; j < A; j += kWarp) {
    const float v = qr[j];
    if (beats(v, j, best, best_j, A)) {
      best = v;
      best_j = j;
    }
  }
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const float ov = __shfl_xor_sync(kFull, best, off);
    const int oj = __shfl_xor_sync(kFull, best_j, off);
    if (beats(ov, oj, best, best_j, A)) {
      best = ov;
      best_j = oj;
    }
  }
  if (lane == 0) {
    const float u0 = u[2 * static_cast<size_t>(row)];
    const float u1 = u[2 * static_cast<size_t>(row) + 1];
    int a = best_j;
    if (u0 < eps) {
      const int r = static_cast<int>(
          floorf(__fmul_rn(u1, static_cast<float>(A))));
      a = r < A - 1 ? r : A - 1;
    }
    if (actions != nullptr) actions[row] = a;
    if (host != nullptr) host[row] = a;
  }
}

}  // namespace

// `host_actions`: null, or the device-mapped address (from
// `host_device_pointer`) of a pinned int64 [B] host buffer that receives
// the actions; `actions` may then be null.
extern "C" int eps_greedy(const float* q, const float* u, int64_t* actions,
                          int64_t* host_actions, int B, int A, float eps,
                          void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  if (actions == nullptr && host_actions == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  eps_greedy_kernel<<<blocks, kRowsPerBlock * kWarp, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      q, u, actions, host_actions, B, A, eps);
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

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
