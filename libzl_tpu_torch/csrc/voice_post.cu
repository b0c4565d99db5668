// Voice post of the windows render (ops/voice_render.py::voice_post): from
// the fetch's interpolated taps to the voices' contributions and peaks.
//
// Replaces the tail of the reference's fused block program,
// libzl_tpu/ops/voice.py::render_voices :612-675 (the gain :612, the valid
// mask :660, the M/S pan of lib/SamplerSynthVoice.cpp:207-211 at :663 and
// the per-voice peak of :213 at :673), which XLA fuses on the TPU.
//
// Contract (voice_post_plain's, bit for bit): for voice v and frame b,
//   l, r = valid ? interp[v, 0|1, b] * g : +0.0    (a select: the product
//          of a zero gain would give -0.0 where the select gives +0.0)
//   l_pan = 0.5 * (1 + pan[v]), r_pan = 0.5 * (1 - pan[v])
//   m = 0.5 * (l + r), s = l - r
//   contrib[v, b] = (l_pan * m + s, r_pan * m - s)
//   voice_peak[v] = max(max_b (contrib_l + contrib_r), 0)
// each product and sum rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn;
// no FMA contraction), in the plain version's order. The peak is a max,
// exact in any order; a NaN propagates, as torch.amax's does.
//
// Inputs: interp [V, 2, B] f32, g [V, B] f32, valid [V, B] bool,
// contiguous; pan [V] f32 at any stride (a column of the program). Output:
// contrib [V, B, 2] f32 (8-byte aligned: a slice of a horizon's stacked
// contributions when the caller passes one) and voice_peak [V] f32.
//
// Bound: memory. interp 8 B, g 4 B and valid 1 B read and contrib 8 B
// written a voice and frame: at V=1024, B=1024 about 22 MB, 6.6 us at
// 3.35 TB/s; ~10 float operations a frame.
//
// Design: a voice takes a warp up to 128 frames (two voices a CTA of 64
// threads at B=128), two warps past it (a CTA of its own: at B=1024 each
// thread walks four steps of 4 frames, 256 apart). Of the shapes measured
// (64 to 256 threads a voice), this one was the fastest with its inputs in
// L2, as the render leaves them, and no slower cold. At each step a thread
// takes 4 consecutive frames: the two tap rows and g as 16-byte loads,
// valid as one 4-byte load, the contributions as two 16-byte stores (four
// 8-byte stores where `contrib` is only 8-byte aligned); frame by frame
// where B is not a multiple of 4. The peak is a warp-shuffle max, then a
// shared-memory max over the voice's two warps.
//
// The kernel allocates nothing, never synchronises, and launches on the
// caller's stream; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kMaxThreads = 64;    // threads a voice at most, and a CTA
constexpr int kLaneFrames = 4;

// torch.amax's max: a NaN propagates
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

struct Pan {
  float l, r;
};

// one frame: (contrib_l, contrib_r)
__device__ __forceinline__ float2 frame(float tap_l, float tap_r, float gain,
                                        bool ok, Pan pan) {
  const float l = ok ? __fmul_rn(tap_l, gain) : 0.0f;
  const float r = ok ? __fmul_rn(tap_r, gain) : 0.0f;
  const float m = __fmul_rn(0.5f, __fadd_rn(l, r));
  const float s = __fsub_rn(l, r);
  return make_float2(__fadd_rn(__fmul_rn(pan.l, m), s),
                     __fsub_rn(__fmul_rn(pan.r, m), s));
}

__global__ void __launch_bounds__(kMaxThreads)
voice_post_kernel(const float* __restrict__ interp,
                  const float* __restrict__ g,
                  const uint8_t* __restrict__ valid,
                  const float* __restrict__ pan, int64_t pan_stride,
                  float* __restrict__ contrib, float* __restrict__ peak,
                  int V, int B, int per_voice, bool vec, bool store16) {
  __shared__ float warp_max[kMaxThreads / 32];
  const int group = threadIdx.x / per_voice;
  const int t = threadIdx.x - group * per_voice;
  const int64_t v =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / per_voice) + group;
  float best = -INFINITY;
  if (v < V) {
    const float p = __ldg(pan + v * pan_stride);
    const Pan pn{__fmul_rn(0.5f, __fadd_rn(1.0f, p)),
                 __fmul_rn(0.5f, __fsub_rn(1.0f, p))};
    const float* taps_l = interp + v * 2 * B;
    const float* taps_r = taps_l + B;
    const float* gv = g + v * B;
    const uint8_t* ok = valid + v * B;
    float* out = contrib + v * 2 * B;
    if (vec) {  // B % 4 == 0 and the inputs 16-byte aligned
      for (int k = kLaneFrames * t; k < B; k += kLaneFrames * per_voice) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(taps_l + k));
        const float4 b = __ldg(reinterpret_cast<const float4*>(taps_r + k));
        const float4 gg = __ldg(reinterpret_cast<const float4*>(gv + k));
        const uint32_t m = __ldg(reinterpret_cast<const uint32_t*>(ok + k));
        const float2 f0 = frame(a.x, b.x, gg.x, m & 0xFFu, pn);
        const float2 f1 = frame(a.y, b.y, gg.y, (m >> 8) & 0xFFu, pn);
        const float2 f2 = frame(a.z, b.z, gg.z, (m >> 16) & 0xFFu, pn);
        const float2 f3 = frame(a.w, b.w, gg.w, m >> 24, pn);
        if (store16) {
          reinterpret_cast<float4*>(out + 2 * k)[0] =
              make_float4(f0.x, f0.y, f1.x, f1.y);
          reinterpret_cast<float4*>(out + 2 * k)[1] =
              make_float4(f2.x, f2.y, f3.x, f3.y);
        } else {
          float2* o = reinterpret_cast<float2*>(out + 2 * k);
          o[0] = f0;
          o[1] = f1;
          o[2] = f2;
          o[3] = f3;
        }
        best = nan_max(best, __fadd_rn(f0.x, f0.y));
        best = nan_max(best, __fadd_rn(f1.x, f1.y));
        best = nan_max(best, __fadd_rn(f2.x, f2.y));
        best = nan_max(best, __fadd_rn(f3.x, f3.y));
      }
    } else {
      for (int k = t; k < B; k += per_voice) {
        const float2 f = frame(taps_l[k], taps_r[k], gv[k], ok[k] != 0, pn);
        reinterpret_cast<float2*>(out)[k] = f;
        best = nan_max(best, __fadd_rn(f.x, f.y));
      }
    }
  }
  for (int off = 16; off > 0; off /= 2)
    best = nan_max(best, __shfl_xor_sync(0xffffffffu, best, off));
  if (per_voice > 32) {  // the voice's warps, through shared memory
    if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = best;
    __syncthreads();
    const int w0 = group * per_voice / 32;
    for (int w = 1; w < per_voice / 32; ++w)
      best = nan_max(best, warp_max[w0 + w]);
  }
  if (t == 0 && v < V)
    peak[v] = best != best ? best : fmaxf(best, 0.0f);  // clamp_min(., 0)
}

}  // namespace

extern "C" {

int zl_voice_post(const void* interp, const void* g, const void* valid,
                  const void* pan, int64_t pan_stride, void* contrib,
                  void* peak, int64_t V, int64_t B, void* stream) {
  if (V <= 0 || B <= 0) return static_cast<int>(cudaGetLastError());
  if (V > INT_MAX || B > INT_MAX / 2 ||
      reinterpret_cast<uintptr_t>(contrib) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int per_voice = 32;
  while (per_voice < kMaxThreads &&
         per_voice * static_cast<int64_t>(kLaneFrames) < B)
    per_voice *= 2;
  const int threads = kMaxThreads;
  const int64_t voices = threads / per_voice;  // a CTA
  const auto at = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  const bool vec = B % kLaneFrames == 0 && at(interp, 16) && at(g, 16) &&
                   at(valid, 4);
  voice_post_kernel<<<static_cast<unsigned>((V + voices - 1) / voices),
                      threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(interp), static_cast<const float*>(g),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(pan),
      pan_stride, static_cast<float*>(contrib), static_cast<float*>(peak),
      static_cast<int>(V), static_cast<int>(B), per_voice, vec,
      vec && at(contrib, 16));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
