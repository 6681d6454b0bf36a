// Device-resident environments for the Anakin path: one batched step (or
// reset) of N envs per launch, with the episode bookkeeping fused in.
//
// Replaces: ray_tpu/rllib/env/jax_env.py `JaxSyntheticAtari._obs`,
// `reset` and `step` (:60-82) and `JaxCartPole.reset` and `step`
// (:105-132), which XLA ran vmapped inside the Anakin scan body
// (ray_tpu/rllib/optimizers/anakin_optimizer.py `_build_fn`, :85), and
// that body's episode bookkeeping (:106-114).
//
// Random numbers: Philox4x32-10 (Salmon et al., SC'11; the Random123
// constants), written out below so that the plain versions in
// rllib/env/device_env.py reproduce the stream bit for bit with torch
// integer ops. key = (seed lo, seed hi); counter = (word, env, launch lo,
// launch hi), where `launch` is the host's launch counter:
//   word < 0x80000000   16-byte chunk `word` of the env's frame;
//   word = 0x80000000   the env's draws: x -> SyntheticAtari's target,
//                       x, y, z, w -> CartPole's four reset uniforms.
// A target is floor(x * A / 2^32); a uniform on [-0.05, 0.05) is
// (w >> 8) * 2^-24 * 0.1f - 0.05f, each step rounded.
//
// Bookkeeping (both kernels), per env and without atomics, so the result
// does not depend on scheduling: ep_rew += reward, ep_len += 1; where the
// step ends an episode, done_rew += ep_rew, done_len += ep_len,
// done_cnt += 1 and ep_rew, ep_len restart at 0. The optimizer reduces
// the per-env sums once per call.
//
// K5a `synthetic_atari_step`. Bound on an H100: bytes. Each env step
// writes an 84x84x4 uint8 frame (28,224 bytes); at N=4096 that is 115.6
// MB, 34.5 us at 3.35 TB/s, against ~28 bytes of state per env. The
// design: one block per env; thread 0 steps the state, draws the target
// and books the episode, then every thread renders 16-byte chunks: one
// Philox call gives 16 random bytes, `& 0x3f` makes each exactly uniform
// on [0, 64) (the reference's randint(0, 64)), the band rows get |0x80
// (+128), and one 16-byte store writes the chunk straight into the env's
// slot of the trajectory buffer (row stride `obs_stride`). A row of the
// frame is 336 bytes = 21 chunks, so a chunk never straddles two rows.
// Philox costs ~20 integer operations per random byte pair; the frame
// store is the bytes bound.
//
// K5b `cartpole_step`. Bound on an H100: launch latency (N=32 on the
// path; under 200 KB even at N=4096). One thread per env runs the f32
// Euler step in the reference's order of operations, every operation
// rounded on its own (__fmul_rn and friends: nvcc would otherwise fuse
// a*b+c into one FMA and move the last bit), sincosf without fast math
// (one shared range reduction; on the card it gave the same bits as
// cosf/sinf and the plain version's torch.cos/sin on every checked
// case), the thresholds as the f32 values JAX's weak-typed comparisons
// use, and the auto-reset from the Philox draws. Since nothing but the
// launch bounds it, the design shortens the one thread's critical path:
// - one round of loads: the state row (one float4), t, the action and
//   all five episode fields are issued at entry, before any store, so
//   nothing waits on a second round trip to memory;
// - the reset draw is computed for every env, since it depends only on
//   (env, launch), so its integer work overlaps the dynamics' divisions
//   instead of following them in a divergent branch;
// - the episode update is selects, not a branch, and the state and obs
//   rows are stored as float4 (obs rows off 16 bytes, which the generic
//   entry point still takes, get four scalar stores);
// - blocks of one warp: 32 envs per block, more blocks at larger N.
// The fixed arguments travel in one `CartPoleArgs`: `cartpole_step`
// fills it from its arguments; `cartpole_step_bound` copies one that the
// host built once (rllib/env/device_env.py `BoundCartPoleStep`, one per
// trajectory slot) and takes only the action pointer and the counter.

#include <cstdint>
#include <cuda_runtime.h>

// K5b's fixed arguments, outside the unnamed namespace: the C entry
// point `cartpole_step_bound` takes one and must stay exported. Its
// layout is mirrored by `_CartPoleArgs` in rllib/env/device_env.py
// (ctypes, native alignment); keep them equal.
struct CartPoleArgs {
  float* s;          // [N, 4], 16-byte aligned
  int* t;            // [N]
  float* obs;        // rows of 4 at `obs_stride` floats
  float* reward;     // at `out_stride`
  uint8_t* done;     // at `out_stride`
  float* ep_rew;     // the five episode fields, or all null
  int* ep_len;
  float* done_rew;
  int* done_len;
  int* done_cnt;
  long long obs_stride;
  long long out_stride;
  unsigned long long seed;
  int n;
  int max_steps;
  int reset;
  int obs_vec;       // obs rows on 16 bytes: one float4 store each
};

namespace {

constexpr unsigned kPhiloxM0 = 0xD2511F53u;
constexpr unsigned kPhiloxM1 = 0xCD9E8D57u;
constexpr unsigned kPhiloxW0 = 0x9E3779B9u;
constexpr unsigned kPhiloxW1 = 0xBB67AE85u;
constexpr unsigned kDrawWord = 0x80000000u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += kPhiloxW0;
      k.y += kPhiloxW1;
    }
    const unsigned hi0 = __umulhi(kPhiloxM0, c.x);
    const unsigned lo0 = kPhiloxM0 * c.x;
    const unsigned hi1 = __umulhi(kPhiloxM1, c.z);
    const unsigned lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

struct Episodes {
  float* ep_rew;
  int* ep_len;
  float* done_rew;
  int* done_len;
  int* done_cnt;
};

__device__ __forceinline__ void book_episode(const Episodes& e, int n,
                                             float reward, bool done) {
  if (e.ep_rew == nullptr) return;
  const float r = e.ep_rew[n] + reward;
  const int l = e.ep_len[n] + 1;
  if (done) {
    e.done_rew[n] += r;
    e.done_len[n] += l;
    e.done_cnt[n] += 1;
  }
  e.ep_rew[n] = done ? 0.0f : r;
  e.ep_len[n] = done ? 0 : l;
}

// ---- K5a: SyntheticAtari --------------------------------------------------
constexpr int kRowBytes = 84 * 4;                 // one frame row, HWC
constexpr int kChunksPerRow = kRowBytes / 16;     // 21
constexpr int kChunks = 84 * kChunksPerRow;       // 1764 per frame
constexpr int kAtariThreads = 256;

__global__ void __launch_bounds__(kAtariThreads) synthetic_atari_kernel(
    int* __restrict__ t, int* __restrict__ target,
    const int64_t* __restrict__ actions, uint8_t* __restrict__ obs,
    long long obs_stride, float* __restrict__ reward,
    uint8_t* __restrict__ done, long long out_stride, Episodes ep, int A,
    int episode_len, uint2 key, unsigned ctr_lo, unsigned ctr_hi,
    int reset) {
  const int n = blockIdx.x;
  __shared__ int s_target;
  if (threadIdx.x == 0) {
    const uint4 draw =
        philox4x32_10(make_uint4(kDrawWord, n, ctr_lo, ctr_hi), key);
    const int new_target = static_cast<int>(
        (static_cast<unsigned long long>(draw.x) * A) >> 32);
    if (reset) {
      t[n] = 0;
    } else {
      const float r = actions[n] == target[n] ? 1.0f : 0.0f;
      const int tn = t[n] + 1;
      const bool d = tn >= episode_len;
      t[n] = d ? 0 : tn;
      reward[n * out_stride] = r;
      done[n * out_stride] = d;
      book_episode(ep, n, r, d);
    }
    target[n] = new_target;
    s_target = new_target;
  }
  __syncthreads();
  const int band_chunks = (84 / A) * kChunksPerRow;
  const int lo = s_target * band_chunks;
  const int hi = lo + band_chunks;
  uint4* out = reinterpret_cast<uint4*>(obs + n * obs_stride);
  for (int i = threadIdx.x; i < kChunks; i += kAtariThreads) {
    uint4 r = philox4x32_10(make_uint4(i, n, ctr_lo, ctr_hi), key);
    const unsigned band = (i >= lo && i < hi) ? 0x80808080u : 0u;
    r.x = (r.x & 0x3f3f3f3fu) | band;
    r.y = (r.y & 0x3f3f3f3fu) | band;
    r.z = (r.z & 0x3f3f3f3fu) | band;
    r.w = (r.w & 0x3f3f3f3fu) | band;
    out[i] = r;
  }
}

// ---- K5b: CartPole --------------------------------------------------------
// The reference's constants as the f32 values its weak-typed Python floats
// become (jax_env.py:88-97).
constexpr float kGravity = 9.8f;
constexpr float kMassPole = 0.1f;
constexpr float kTotalMass = 1.1f;          // 1.0 + 0.1
constexpr float kLength = 0.5f;
constexpr float kPoleMassLength = 0.05f;    // 0.1 * 0.5
constexpr float kForceMag = 10.0f;
constexpr float kTau = 0.02f;
constexpr float kFourThirds = 1.33333337f;  // f32(4.0 / 3.0)
constexpr float kThetaThreshold = 0.209439516f;  // f32(12 * 2 * pi / 360)
constexpr float kXThreshold = 2.4f;
constexpr int kCartPoleThreads = 32;

__device__ __forceinline__ float reset_uniform(unsigned w) {
  const float u = __fmul_rn(__uint2float_rn(w >> 8), 0x1p-24f);
  return __fadd_rn(__fmul_rn(u, 0.1f), -0.05f);
}

__global__ void __launch_bounds__(kCartPoleThreads)
    cartpole_kernel(const CartPoleArgs a, const int64_t* __restrict__ actions,
                    unsigned long long counter) {
  const int n = blockIdx.x * kCartPoleThreads + threadIdx.x;
  if (n >= a.n) return;
  const bool step = !a.reset;
  const bool book = step && a.ep_rew != nullptr;
  float4* __restrict__ row = reinterpret_cast<float4*>(a.s) + n;
  // One round of loads: everything the step can read, before any store.
  float4 st = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int t_prev = 0;
  int64_t action = 0;
  float ep_rew = 0.0f, done_rew = 0.0f;
  int ep_len = 0, done_len = 0, done_cnt = 0;
  if (step) {
    st = *row;
    t_prev = a.t[n];
    action = actions[n];
  }
  if (book) {
    ep_rew = a.ep_rew[n];
    ep_len = a.ep_len[n];
    done_rew = a.done_rew[n];
    done_len = a.done_len[n];
    done_cnt = a.done_cnt[n];
  }
  // The next episode's initial state, drawn for every env.
  const uint4 draw = philox4x32_10(
      make_uint4(kDrawWord, n, static_cast<unsigned>(counter),
                 static_cast<unsigned>(counter >> 32)),
      make_uint2(static_cast<unsigned>(a.seed),
                 static_cast<unsigned>(a.seed >> 32)));
  float4 next = make_float4(reset_uniform(draw.x), reset_uniform(draw.y),
                            reset_uniform(draw.z), reset_uniform(draw.w));
  bool d = true;
  int tn = 0;
  if (step) {
    const float theta = st.z, theta_dot = st.w;
    const float force = action == 1 ? kForceMag : -kForceMag;
    float c, sn;
    sincosf(theta, &sn, &c);
    const float temp = __fdiv_rn(
        __fadd_rn(force, __fmul_rn(__fmul_rn(kPoleMassLength,
                                             __fmul_rn(theta_dot, theta_dot)),
                                   sn)),
        kTotalMass);
    const float thetaacc = __fdiv_rn(
        __fsub_rn(__fmul_rn(kGravity, sn), __fmul_rn(c, temp)),
        __fmul_rn(kLength,
                  __fsub_rn(kFourThirds,
                            __fdiv_rn(__fmul_rn(kMassPole, __fmul_rn(c, c)),
                                      kTotalMass))));
    const float xacc = __fsub_rn(
        temp, __fdiv_rn(__fmul_rn(__fmul_rn(kPoleMassLength, thetaacc), c),
                        kTotalMass));
    const float4 moved = make_float4(
        __fadd_rn(st.x, __fmul_rn(kTau, st.y)),
        __fadd_rn(st.y, __fmul_rn(kTau, xacc)),
        __fadd_rn(theta, __fmul_rn(kTau, theta_dot)),
        __fadd_rn(theta_dot, __fmul_rn(kTau, thetaacc)));
    const int t_next = t_prev + 1;
    d = fabsf(moved.x) > kXThreshold || fabsf(moved.z) > kThetaThreshold ||
        t_next >= a.max_steps;
    next.x = d ? next.x : moved.x;
    next.y = d ? next.y : moved.y;
    next.z = d ? next.z : moved.z;
    next.w = d ? next.w : moved.w;
    tn = d ? 0 : t_next;
  }
  *row = next;
  a.t[n] = tn;
  float* o = a.obs + n * a.obs_stride;
  if (a.obs_vec) {
    *reinterpret_cast<float4*>(o) = next;
  } else {
    o[0] = next.x;
    o[1] = next.y;
    o[2] = next.z;
    o[3] = next.w;
  }
  if (step) {
    a.reward[n * a.out_stride] = 1.0f;
    a.done[n * a.out_stride] = d;
  }
  if (book) {
    const float r = __fadd_rn(ep_rew, 1.0f);
    const int l = ep_len + 1;
    a.ep_rew[n] = d ? 0.0f : r;
    a.ep_len[n] = d ? 0 : l;
    a.done_rew[n] = d ? __fadd_rn(done_rew, r) : done_rew;
    a.done_len[n] = d ? done_len + l : done_len;
    a.done_cnt[n] = d ? done_cnt + 1 : done_cnt;
  }
}

int launch_cartpole(const CartPoleArgs& a, const int64_t* actions,
                    unsigned long long counter, void* stream) {
  if (a.n <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (a.n + kCartPoleThreads - 1) / kCartPoleThreads;
  cartpole_kernel<<<blocks, kCartPoleThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a, actions,
                                                         counter);
  return static_cast<int>(cudaGetLastError());
}

uint2 philox_key(unsigned long long seed) {
  return make_uint2(static_cast<unsigned>(seed),
                    static_cast<unsigned>(seed >> 32));
}

}  // namespace

extern "C" int synthetic_atari_step(
    int* t, int* target, const int64_t* actions, uint8_t* obs,
    long long obs_stride, float* reward, uint8_t* done, long long out_stride,
    float* ep_rew, int* ep_len, float* done_rew, int* done_len,
    int* done_cnt, int N, int A, int episode_len, unsigned long long seed,
    unsigned long long counter, int reset, void* stream) {
  if (N <= 0) return static_cast<int>(cudaSuccess);
  const Episodes ep{ep_rew, ep_len, done_rew, done_len, done_cnt};
  synthetic_atari_kernel<<<N, kAtariThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      t, target, actions, obs, obs_stride, reward, done, out_stride, ep, A,
      episode_len, philox_key(seed), static_cast<unsigned>(counter),
      static_cast<unsigned>(counter >> 32), reset);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cartpole_step(
    float* s, int* t, const int64_t* actions, float* obs,
    long long obs_stride, float* reward, uint8_t* done, long long out_stride,
    float* ep_rew, int* ep_len, float* done_rew, int* done_len,
    int* done_cnt, int N, int max_steps, unsigned long long seed,
    unsigned long long counter, int reset, void* stream) {
  const bool vec = reinterpret_cast<uintptr_t>(obs) % 16 == 0 &&
                   obs_stride % 4 == 0;
  const CartPoleArgs a{s,      t,        obs,        reward,
                       done,   ep_rew,   ep_len,     done_rew,
                       done_len, done_cnt, obs_stride, out_stride,
                       seed,   N,        max_steps,  reset,
                       vec ? 1 : 0};
  return launch_cartpole(a, actions, counter, stream);
}

// The bound step: `args` as the host built it once for a trajectory slot.
extern "C" int cartpole_step_bound(const CartPoleArgs* args,
                                   const int64_t* actions,
                                   unsigned long long counter, void* stream) {
  return launch_cartpole(*args, actions, counter, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
