// Voice post of the windows render (ops/voice_render.py::voice_post): from
// the fetch's interpolated taps to the voices' contributions and peaks.
//
// Replaces the tail of the reference's fused block program,
// libzl_tpu/ops/voice.py::render_voices :612-675 (the gain :612, the valid
// mask :660, the M/S pan of lib/SamplerSynthVoice.cpp:207-211 at :663 and
// the per-voice peak of :213 at :673), which XLA fuses on the TPU and the
// port ran as ~20 plain ops.
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
// Design, simple first: one CTA of 256 threads a voice, each thread walking
// the voice's frames 256 apart (coalesced loads, one 8-byte store a frame),
// then a warp-shuffle and shared-memory max for the peak.
//
// The kernel allocates nothing, never synchronises, and launches on the
// caller's stream; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// torch.amax's max: a NaN propagates
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__global__ void __launch_bounds__(kThreads)
voice_post_kernel(const float* __restrict__ interp,
                  const float* __restrict__ g,
                  const uint8_t* __restrict__ valid,
                  const float* __restrict__ pan, int64_t pan_stride,
                  float2* __restrict__ contrib, float* __restrict__ peak,
                  int B) {
  __shared__ float warp_max[kWarps];
  const int64_t v = blockIdx.x;
  const int t = threadIdx.x;
  const float p = __ldg(pan + v * pan_stride);
  const float l_pan = __fmul_rn(0.5f, __fadd_rn(1.0f, p));
  const float r_pan = __fmul_rn(0.5f, __fsub_rn(1.0f, p));
  const float* taps_l = interp + v * 2 * B;
  const float* taps_r = taps_l + B;
  float best = -INFINITY;
  for (int b = t; b < B; b += kThreads) {
    const int64_t i = v * B + b;
    const float gain = g[i];
    const bool ok = valid[i] != 0;
    const float l = ok ? __fmul_rn(taps_l[b], gain) : 0.0f;
    const float r = ok ? __fmul_rn(taps_r[b], gain) : 0.0f;
    const float m = __fmul_rn(0.5f, __fadd_rn(l, r));
    const float s = __fsub_rn(l, r);
    const float lo = __fadd_rn(__fmul_rn(l_pan, m), s);
    const float ro = __fsub_rn(__fmul_rn(r_pan, m), s);
    contrib[i] = make_float2(lo, ro);
    best = nan_max(best, __fadd_rn(lo, ro));
  }
  for (int off = 16; off > 0; off /= 2)
    best = nan_max(best, __shfl_xor_sync(0xffffffffu, best, off));
  if (t % 32 == 0) warp_max[t / 32] = best;
  __syncthreads();
  if (t == 0) {
    float m = warp_max[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = nan_max(m, warp_max[w]);
    peak[v] = m != m ? m : fmaxf(m, 0.0f);  // torch.clamp_min(m, 0)
  }
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
  voice_post_kernel<<<static_cast<unsigned>(V), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(interp), static_cast<const float*>(g),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(pan),
      pan_stride, static_cast<float2*>(contrib), static_cast<float*>(peak),
      static_cast<int>(B));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
