// Windows sample fetch for the voice render (the `fetch="windows"` path).
//
// Replaces libzl_tpu/ops/fetch_pallas.py::fetch_interp. On the TPU that
// kernel DMAs each voice's two 512-aligned fetch regions into VMEM and
// interpolates with banded one-hot weight slabs fed to MXU dots; none of that
// machinery has a purpose on Hopper, where the fetch is a plain two-tap lerp.
//
// Contract (identical to the TPU kernel's): for voice v and frame b, with
// p = pos_local[v, b] window-relative and region = region_rows(B, r_max),
//   out[v, c, b] = s_c[q(p)] * (1 - alpha) + s_c[q(p + 1)] * alpha
// where q(t) = t < region ? win_blk_a[v] * 512 + t
//                         : win_blk_b[v] * 512 + (t - region),
// for 0 <= p < 2 * region - 1; any other p gives exactly 0. Tap p + 1 ==
// region reads region B's first sample. An int16 bank is dequantized
// x/32767 before the lerp. The bank is planar [2, N]. A tap outside [0, N)
// reads 0: the host's tail guard (engine/soundbank.region_tail_guard) keeps
// taps in range, and a broken guard must not fault.
//
// Bound: memory. Per (voice, frame) 2 taps x 2 channels are read and 2 f32
// written, about 24 B (16 B with an int16 bank); at V=1024, B=1024 a call
// moves about 25 MB. Design: one thread per (v, b). Consecutive threads take
// consecutive frames of one voice, whose taps are neighbouring samples, so
// the tap loads and the pos/alpha/out accesses coalesce. Index math is
// 64-bit. The kernel allocates nothing, never synchronises, and launches on
// the caller's stream; the C entry points return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int64_t kSoundBlock = 512;   // window anchor granularity (samples)
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int16_t x) {
  return static_cast<float>(x) * (1.0f / 32767.0f);
}

template <typename T>
__device__ __forceinline__ float tap(const T* __restrict__ ch, int64_t i,
                                     int64_t n) {
  return (i >= 0 && i < n) ? to_f32(__ldg(ch + i)) : 0.0f;
}

template <typename T>
__global__ void fetch_interp_kernel(const T* __restrict__ sound, int64_t n,
                                    const int32_t* __restrict__ pos_local,
                                    const float* __restrict__ alpha,
                                    const int32_t* __restrict__ win_blk_a,
                                    const int32_t* __restrict__ win_blk_b,
                                    float* __restrict__ out, int64_t V,
                                    int64_t B, int64_t region) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= V * B) return;
  const int64_t v = idx / B;
  const int64_t b = idx - v * B;
  float* o = out + v * 2 * B + b;  // out[v, 0, b]; out[v, 1, b] is o[B]
  const int64_t p = pos_local[idx];
  if (p < 0 || p >= 2 * region - 1) {
    o[0] = 0.0f;
    o[B] = 0.0f;
    return;
  }
  const int64_t base_a = static_cast<int64_t>(win_blk_a[v]) * kSoundBlock;
  const int64_t base_b = static_cast<int64_t>(win_blk_b[v]) * kSoundBlock;
  const int64_t q = p + 1;
  const int64_t i0 = p < region ? base_a + p : base_b + (p - region);
  const int64_t i1 = q < region ? base_a + q : base_b + (q - region);
  const float a = alpha[idx];
  const T* left = sound;
  const T* right = sound + n;
  o[0] = tap(left, i0, n) * (1.0f - a) + tap(left, i1, n) * a;
  o[B] = tap(right, i0, n) * (1.0f - a) + tap(right, i1, n) * a;
}

template <typename T>
int launch(const void* sound, int64_t n, const void* pos_local,
           const void* alpha, const void* win_blk_a, const void* win_blk_b,
           void* out, int64_t V, int64_t B, int64_t region, void* stream) {
  const int64_t total = V * B;
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  fetch_interp_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(sound), n,
      static_cast<const int32_t*>(pos_local),
      static_cast<const float*>(alpha),
      static_cast<const int32_t*>(win_blk_a),
      static_cast<const int32_t*>(win_blk_b), static_cast<float*>(out), V, B,
      region);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int zl_fetch_interp_f32(const void* sound, int64_t n, const void* pos_local,
                        const void* alpha, const void* win_blk_a,
                        const void* win_blk_b, void* out, int64_t V,
                        int64_t B, int64_t region, void* stream) {
  return launch<float>(sound, n, pos_local, alpha, win_blk_a, win_blk_b, out,
                       V, B, region, stream);
}

int zl_fetch_interp_i16(const void* sound, int64_t n, const void* pos_local,
                        const void* alpha, const void* win_blk_a,
                        const void* win_blk_b, void* out, int64_t V,
                        int64_t B, int64_t region, void* stream) {
  return launch<int16_t>(sound, n, pos_local, alpha, win_blk_a, win_blk_b,
                         out, V, B, region, stream);
}

const char* zl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
