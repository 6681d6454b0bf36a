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
//
// The step record: a Box policy's env step needs its actions, logp, dist
// inputs and value on the host and nowhere else. Given a record in
// pinned host memory (its device-mapped address, which the wrapper
// resolves once per buffer through `host_device_pointer`; a buffer the
// card cannot map fails there, before any launch), the row's warp writes
// there: the lane that computes action element j that element, lane 0
// the logp and the row's value (read from `value`, f32 [B] on the
// device), and lane j the mean and log_std it has just read. Layout,
// for B rows of a d-dim box, back to back as K2's record in
// categorical.cu: actions f32 [B, d] | logp f32 [B] | value f32 [B] |
// inputs f32 [B, 2d]. With a record the device outputs may be null: the
// step's tail is then the normals and this launch, followed by one wait
// on an event recorded after it, where it was an exp, two output
// allocations and four device-to-host copies, each a host sync. Only
// stores are added; the arithmetic above is unchanged. The cost moves to
// the device: the kernel ends only after its PCIe writes (8 + 12d bytes
// per row), as K2's launch went from 1.5 to 2.9 us with its record and
// K9f's from 1.4 to 2.5 with its host actions; the bound counts these
// bytes like any output.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// `actions`, `logp`: null, or the device outputs; `record`: null, or the
// device-mapped address of a step record of B rows (layout in the note
// above); `value`: null, or f32 [B] on the device, the record's value
// column (left as it is when null).
__global__ void diag_gaussian_sample_kernel(const float* __restrict__ inputs,
                                            const float* __restrict__ z,
                                            float* __restrict__ actions,
                                            float* __restrict__ logp,
                                            const float* __restrict__ value,
                                            char* __restrict__ record, int B,
                                            int d, int explore,
                                            float log_norm) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= B) return;  // whole warps leave together
  const size_t r = static_cast<size_t>(row);
  // Issued first, so its latency hides behind the row's loads.
  const float v =
      (record != nullptr && value != nullptr && lane == 0) ? value[row] : 0.0f;
  const float* x = inputs + r * 2 * d;
  const float* zr = explore ? z + r * d : nullptr;
  float* a_out = actions != nullptr ? actions + r * d : nullptr;
  float* rec_actions = nullptr;
  float* rec_logp = nullptr;
  float* rec_value = nullptr;
  float* rec_inputs = nullptr;
  if (record != nullptr) {
    float* rec = reinterpret_cast<float*>(record);
    const size_t rows = static_cast<size_t>(B);
    rec_actions = rec + r * d;
    rec_logp = rec + rows * d;
    rec_value = rec_logp + rows;
    rec_inputs = rec_value + rows + r * 2 * d;
  }

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
      if (a_out != nullptr) a_out[j] = a;
      if (record != nullptr) {
        rec_actions[j] = a;
        rec_inputs[j] = mean;
        rec_inputs[d + j] = ls;
      }
    }
    const int n = min(kWarp, d - base);
    for (int k = 0; k < n; ++k) {
      sq = __fadd_rn(sq, __shfl_sync(kFull, y2, k));
      sls = __fadd_rn(sls, __shfl_sync(kFull, ls, k));
    }
  }
  if (lane == 0) {
    const float lp =
        __fsub_rn(__fsub_rn(__fmul_rn(-0.5f, sq), log_norm), sls);
    if (logp != nullptr) logp[row] = lp;
    if (record != nullptr) {
      rec_logp[row] = lp;
      if (value != nullptr) rec_value[row] = v;
    }
  }
}

}  // namespace

// `record`: null, or the device-mapped address (from
// `host_device_pointer`) of a pinned step record of B rows of a d-dim
// box; `actions` and `logp` may then be null.
extern "C" int diag_gaussian_sample(const float* inputs, const float* z,
                                    float* actions, float* logp,
                                    const float* value, void* record, int B,
                                    int d, int explore, float log_norm,
                                    void* stream) {
  if (B <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  if (record == nullptr && (actions == nullptr || logp == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  diag_gaussian_sample_kernel<<<blocks, kRowsPerBlock * kWarp, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      inputs, z, actions, logp, value, static_cast<char*>(record), B, d,
      explore, log_norm);
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
