// DiagGaussian action-sampling tail: draw (or mean) + logp of the draw.
//
// Replaces: ray_tpu/models/distributions.py `DiagGaussian.sample`,
// `DiagGaussian.deterministic_sample` and `DiagGaussian.logp`, as the
// policy's jitted action function calls them
// (ray_tpu/rllib/policy/jax_policy.py `action_fn`), where XLA fused them
// behind the network forward. Per row of dist_inputs x[0..2d) = [mean,
// log_std] and normals z[0..d):
//
//   std_j = exp(log_std_j)
//   a_j   = explore ? mean_j + std_j * z_j : mean_j
//   y_j   = (a_j - mean_j) / std_j
//   logp  = -0.5 * sum_j y_j^2 - log_norm - sum_j log_std_j
//
// with log_norm = 0.5 * d * log(2 pi), passed in by the wrapper. logp is
// taken from the actions, as JAX takes it, not from z. Every operation is
// an `__f*_rn` intrinsic, so nvcc contracts nothing into an FMA, and both
// sums run over j = 0, 1, ..., d-1 in that order (lane 0 of the warp
// collects the terms by shuffles), so the plain version
// `_gaussian_sample_logp_plain` in models/distributions.py repeats the
// same steps on tensors. The normals come from the caller (torch.randn
// on the policy's generator).
//
// Bound on an H100: launch latency. At Pendulum's shape (B=8 envs, d=1)
// it reads 96 bytes and writes 64; at B=4096, d=17 it moves 1.4 MB
// (0.4 us at 3.35 TB/s). The design: one warp per row, lane j holding
// element j (lanes stride by 32 for d > 32), the row's two sums made by
// shuffles in registers; one launch yields both outputs, where the plain
// version launches about a dozen small PyTorch kernels.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

__global__ void diag_gaussian_sample_kernel(const float* __restrict__ inputs,
                                            const float* __restrict__ z,
                                            float* __restrict__ actions,
                                            float* __restrict__ logp, int B,
                                            int d, int explore,
                                            float log_norm) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= B) return;  // whole warps leave together
  const float* x = inputs + static_cast<size_t>(row) * 2 * d;
  const float* zr = explore ? z + static_cast<size_t>(row) * d : nullptr;
  float* a_out = actions + static_cast<size_t>(row) * d;

  float sq = 0.0f;  // sum_j y_j^2, in j order (lane 0's copy is used)
  float sls = 0.0f;  // sum_j log_std_j, in j order
  for (int base = 0; base < d; base += kWarp) {
    const int j = base + lane;
    float y2 = 0.0f;
    float ls = 0.0f;
    if (j < d) {
      const float mean = x[j];
      ls = x[d + j];
      const float std = expf(ls);
      const float a = explore ? __fadd_rn(mean, __fmul_rn(std, zr[j])) : mean;
      const float y = __fdiv_rn(__fsub_rn(a, mean), std);
      y2 = __fmul_rn(y, y);
      a_out[j] = a;
    }
    const int n = min(kWarp, d - base);
    for (int k = 0; k < n; ++k) {
      sq = __fadd_rn(sq, __shfl_sync(kFull, y2, k));
      sls = __fadd_rn(sls, __shfl_sync(kFull, ls, k));
    }
  }
  if (lane == 0) {
    logp[row] = __fsub_rn(__fsub_rn(__fmul_rn(-0.5f, sq), log_norm), sls);
  }
}

}  // namespace

extern "C" int diag_gaussian_sample(const float* inputs, const float* z,
                                    float* actions, float* logp, int B, int d,
                                    int explore, float log_norm,
                                    void* stream) {
  if (B <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  diag_gaussian_sample_kernel<<<blocks, kRowsPerBlock * kWarp, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      inputs, z, actions, logp, B, d, explore, log_norm);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
