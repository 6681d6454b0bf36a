// Squashed-Gaussian action tail of SAC: the reparameterized tanh sample,
// its log-probability, and the gradient of both.
//
// Replaces: ray_tpu/rllib/agents/sac/sac_policy.py `_dist` and
// `_sample_action` (:131-150), which XLA fused into the SAC policy's
// jitted update (the critic's target, the actor loss), `td_fn` and
// `act_fn`; the class ray_tpu/models/distributions.py `SquashedGaussian`
// (:130-176) samples the same way. Per row of x[0..2d) = [mean, raw
// log_std] and normals z[0..d), with s = (high - low) / 2:
//
//   log_std_j = clamp(raw_j, -20, 2),  std_j = exp(log_std_j)
//   pre_j     = explore ? mean_j + std_j * z_j : mean_j   (z = 0 if not)
//   t_j       = tanh(pre_j),  a_j = low + (t_j + 1) * s
//   logp      = sum_j [-0.5 (z_j^2 + 2 log_std_j + log 2pi)
//                      - 2 (log 2 - pre_j - softplus(-2 pre_j))] - d log s
//
// with softplus(m) = max(m, 0) + log1p(exp(-|m|)) (jax.nn.softplus) and
// d log s passed in by the wrapper. logp is taken from the noise, as JAX
// takes it, not from an unsquashed action. The backward (K9b) takes the
// upstream gradients g_a [B, d] and g_logp [B] (either may be null, read
// as zeros) where autograd leaves them, each with its strides in
// elements: g_a arrives as a column slice of the critic's concat gradient
// (row stride obs_dim + d) or as the expand of a sum (strides 0), g_logp
// as the expand of a sum (stride 0); neither is copied first. It writes
// g_x [B, 2d]:
//
//   g_pre_j  = g_a_j * s * (1 - t_j^2) + g_logp * 2 t_j
//   g_mean_j = g_pre_j
//   g_raw_j  = 1[-20 <= raw_j <= 2] * (g_pre_j * std_j * z_j - g_logp)
//
// (d/dpre of the log-det term is 2 - 4 sigmoid(-2 pre) = 2 tanh(pre)). It
// recomputes pre and t from x and z rather than saving them. Every
// arithmetic operation is an `__f*_rn` intrinsic, so nvcc contracts
// nothing into an FMA, and the forward's sum runs over j = 0, 1, ..., d-1
// in that order (lane 0 of the row's warp collects the terms by
// shuffles); `_squashed_gaussian_plain` and
// `_squashed_gaussian_backward_plain` in models/distributions.py repeat
// the same steps on tensors. The normals come from the caller (torch.randn
// on the policy's generator).
//
// Bound on an H100: launch latency. On SAC's Pendulum path (d = 1) the
// forward reads 12 bytes and writes 8 per row, at B = 1 (an env step) or
// B = 256 (an update); at B = 4096, d = 17 it moves 1.4 MB (0.4 us at
// 3.35 TB/s). The design: the forward is one warp per row, lane j holding
// element j (lanes stride by 32 for d > 32), the row's sum made by
// shuffles in registers; the backward has no reduction and takes one
// thread per element. Each is one launch where the plain version launches
// about twenty small PyTorch kernels.
//
// The acted actions: SAC's env step needs its [B, d] actions on the host.
// Given the device-mapped address of a pinned f32 [B, d] host buffer
// (resolved once per buffer by the wrapper through `host_device_pointer`),
// the lane that writes an action to the device output also writes it
// there, so the step's tail is the normals and this launch, followed by
// one wait on an event recorded after it, instead of a device-to-host
// copy and the host sync it makes. The kernel then ends after its PCIe
// writes (4 bytes per element); the bound counts them like any output.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 4;
constexpr int kBackwardThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLogStdMin = -20.0f;
constexpr float kLogStdMax = 2.0f;
// f32 roundings of log(2 pi) and log(2), as the plain version's Python
// constants round when they meet an f32 tensor.
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr float kLog2 = 0.6931471805599453f;

__device__ __forceinline__ float clamp_log_std(float raw) {
  return fminf(fmaxf(raw, kLogStdMin), kLogStdMax);
}

// jax.nn.softplus: max(m, 0) + log1p(exp(-|m|)).
__device__ __forceinline__ float softplus(float m) {
  return __fadd_rn(fmaxf(m, 0.0f), log1pf(expf(-fabsf(m))));
}

__global__ void squashed_gaussian_sample_kernel(
    const float* __restrict__ x, const float* __restrict__ z,
    float* __restrict__ actions, float* __restrict__ logp,
    float* __restrict__ host_actions, int B, int d, int explore, float low,
    float s, float d_log_s) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= B) return;  // whole warps leave together
  const float* xr = x + static_cast<size_t>(row) * 2 * d;
  const float* zr = explore ? z + static_cast<size_t>(row) * d : nullptr;
  float* a_out = actions + static_cast<size_t>(row) * d;

  float sum = 0.0f;  // sum_j term_j, in j order (lane 0's copy is used)
  for (int base = 0; base < d; base += kWarp) {
    const int j = base + lane;
    float term = 0.0f;
    if (j < d) {
      const float mean = xr[j];
      const float log_std = clamp_log_std(xr[d + j]);
      const float zj = explore ? zr[j] : 0.0f;
      const float pre =
          explore ? __fadd_rn(mean, __fmul_rn(expf(log_std), zj)) : mean;
      const float t = tanhf(pre);
      const float a = __fadd_rn(low, __fmul_rn(__fadd_rn(t, 1.0f), s));
      a_out[j] = a;
      if (host_actions != nullptr)
        host_actions[static_cast<size_t>(row) * d + j] = a;
      const float gauss = __fadd_rn(
          __fadd_rn(__fmul_rn(zj, zj), __fmul_rn(2.0f, log_std)), kLog2Pi);
      const float logdet =
          __fsub_rn(__fsub_rn(kLog2, pre), softplus(__fmul_rn(-2.0f, pre)));
      term = __fsub_rn(__fmul_rn(-0.5f, gauss), __fmul_rn(2.0f, logdet));
    }
    const int n = min(kWarp, d - base);
    for (int k = 0; k < n; ++k) {
      sum = __fadd_rn(sum, __shfl_sync(kFull, term, k));
    }
  }
  if (lane == 0) logp[row] = __fsub_rn(sum, d_log_s);
}

__global__ void squashed_gaussian_backward_kernel(
    const float* __restrict__ x, const float* __restrict__ z,
    const float* __restrict__ g_a, long long g_a_row, long long g_a_col,
    const float* __restrict__ g_logp, long long g_logp_stride,
    float* __restrict__ g_x, int B, int d, int explore, float s) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= static_cast<int64_t>(B) * d) return;
  const int row = static_cast<int>(i / d);
  const int j = static_cast<int>(i % d);
  const float* xr = x + static_cast<size_t>(row) * 2 * d;
  const float mean = xr[j];
  const float raw = xr[d + j];
  const float std = expf(clamp_log_std(raw));
  const float zj = explore ? z[i] : 0.0f;
  const float pre = explore ? __fadd_rn(mean, __fmul_rn(std, zj)) : mean;
  const float t = tanhf(pre);
  const float ga = g_a != nullptr ? g_a[row * g_a_row + j * g_a_col] : 0.0f;
  const float gl = g_logp != nullptr ? g_logp[row * g_logp_stride] : 0.0f;
  const float g_pre =
      __fadd_rn(__fmul_rn(__fmul_rn(ga, s), __fsub_rn(1.0f, __fmul_rn(t, t))),
                __fmul_rn(__fmul_rn(gl, 2.0f), t));
  const bool inside = raw >= kLogStdMin && raw <= kLogStdMax;
  float* out = g_x + static_cast<size_t>(row) * 2 * d;
  out[j] = g_pre;
  out[d + j] =
      inside ? __fsub_rn(__fmul_rn(__fmul_rn(g_pre, std), zj), gl) : 0.0f;
}

}  // namespace

// `host_actions`: null, or the device-mapped address (from
// `host_device_pointer`) of a pinned f32 [B, d] host buffer that also
// receives the actions.
extern "C" int squashed_gaussian_sample(const float* x, const float* z,
                                        float* actions, float* logp,
                                        float* host_actions, int B, int d,
                                        int explore, float low, float s,
                                        float d_log_s, void* stream) {
  if (B <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  squashed_gaussian_sample_kernel<<<blocks, kRowsPerBlock * kWarp, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      x, z, actions, logp, host_actions, B, d, explore, low, s, d_log_s);
  return static_cast<int>(cudaGetLastError());
}

// g_a [B, d] with its (row, column) strides and g_logp [B] with its stride,
// in elements; a stride may be 0 (an expand).
extern "C" int squashed_gaussian_backward(
    const float* x, const float* z, const float* g_a, long long g_a_row,
    long long g_a_col, const float* g_logp, long long g_logp_stride,
    float* g_x, int B, int d, int explore, float s, void* stream) {
  if (B <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  const int64_t n = static_cast<int64_t>(B) * d;
  const int blocks =
      static_cast<int>((n + kBackwardThreads - 1) / kBackwardThreads);
  squashed_gaussian_backward_kernel<<<blocks, kBackwardThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      x, z, g_a, g_a_row, g_a_col, g_logp, g_logp_stride, g_x, B, d, explore,
      s);
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
