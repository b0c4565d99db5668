// The finish of a render (ops/finish.py::finish): master bus, channel strips
// and block meters, for one block or a horizon's stacked slices.
//
// Replaces libzl_tpu/engine/render.py::finish_block (:50-73: the additive
// master sum, the 11 JackPassthrough strips of ops/mixer.py, the peak and
// RMS meters of ops/meters.py), which XLA fuses into the block's program on
// the TPU and the port ran as ~20 plain ops a slice.
//
// Contract (finish_plain's, bit for bit), for slice h, frame b, channel c,
// with L lanes and K = L - 1 strips:
//   master_raw = ((mix[h,0] + mix[h,1]) + ...) + mix[h,L-1]   one chain
//   strip input x_0 = master_raw, x_k = mix[h, k + 1] for k >= 1
//   scale_c    = min(1 -/+ pan[k], 1) * (1 - muted[k])      (c = 0: 1 - pan)
//   dry/wet1/wet2[h,k,b,c] = (x_k * scale_c) * amount[k]
//   lane_peaks[h,l,c] = max_b |mix[h,l,b,c]|,  master_peak[h,c] =
//               max_b |dry[h,0,b,c]|
//   lane_rms[h,l,c] = sqrt(tree(mix^2) / B): the squares zero-padded to
//               the next power of two P and halved level by level (element
//               i + element i + half), the tree ops/finish._tree_sum spells
// every product, sum, quotient and root rounded on its own (no FMA
// contraction). Peaks are maxima, exact in any order; a NaN propagates.
//
// Layout: mix [H, L, B, 2] f32, strips [5, K] f32 (dry, wet1, wet2, pan,
// muted), contiguous. Outputs: strips_out [3, H, K, B, 2] (dry, wet1,
// wet2), meters [2, H, L, 2] (peaks, RMS), master_peak [H, 2].
//
// Bound: memory. The mix read once and the three strip planes written once
// (8 B and 3 x 8 x K/L B a lane and frame): at H=1, B=1024 about 0.63 MB,
// 0.19 us at 3.35 TB/s; an H=16 horizon at B=128 1.3 MB. The float work is
// ~20 operations a lane and frame.
//
// Design, simple first: a CTA of 256 threads a (job, slice), jobs 0..L-1
// one lane each (its peak, its squares' tree in shared memory, 2 P floats,
// and for lanes >= 2 its strip), job L the master (the chain over the L
// lanes, strip 0, the master peak). A thread walks frames 256 apart.
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
constexpr int kFirstChannelLane = 2;  // lanes 2.. feed strips 1..
constexpr int64_t kMaxFrames = 16384;  // ops/finish.MAX_FRAMES

__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float clamp_max_f(float x, float hi) {
  return x != x ? x : fminf(x, hi);
}

// the CTA's max of x; every thread gets it
__device__ float block_max(float x, float* scratch) {
  for (int off = 16; off > 0; off /= 2)
    x = nan_max(x, __shfl_xor_sync(0xffffffffu, x, off));
  __syncthreads();  // scratch is free again
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = x;
  __syncthreads();
  float m = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = nan_max(m, scratch[w]);
  return m;
}

__global__ void __launch_bounds__(kThreads)
finish_block_kernel(const float* __restrict__ mix,
                    const float* __restrict__ strips,
                    float* __restrict__ strips_out,
                    float* __restrict__ meters,
                    float* __restrict__ master_peak, int H, int L, int B,
                    int P) {
  extern __shared__ float squares[];  // [2][P]
  __shared__ float scratch[kWarps];
  const int job = blockIdx.x;  // a lane, or L: the master
  const int64_t h = blockIdx.y;
  const int t = threadIdx.x;
  const int K = L - 1;
  const int64_t row = 2 * static_cast<int64_t>(B);  // a lane's floats
  const float* hmix = mix + h * L * row;
  const int64_t plane = static_cast<int64_t>(H) * K * row;  // dry->wet1
  const bool master = job == L;
  const int strip = master ? 0 : (job >= kFirstChannelLane ? job - 1 : -1);

  float scale0 = 0.0f, scale1 = 0.0f, dry = 0.0f, wet1 = 0.0f, wet2 = 0.0f;
  if (strip >= 0) {
    const float pan = strips[3 * K + strip];
    const float gate = __fsub_rn(1.0f, strips[4 * K + strip]);
    scale0 = __fmul_rn(clamp_max_f(__fsub_rn(1.0f, pan), 1.0f), gate);
    scale1 = __fmul_rn(clamp_max_f(__fadd_rn(1.0f, pan), 1.0f), gate);
    dry = strips[strip];
    wet1 = strips[K + strip];
    wet2 = strips[2 * K + strip];
  }
  float* out = strip >= 0 ? strips_out + (h * K + strip) * row : nullptr;

  float peak0 = -INFINITY, peak1 = -INFINITY;
  for (int b = t; b < P; b += kThreads) {
    if (b >= B) {  // the tree's zero padding
      if (!master) squares[b] = squares[P + b] = 0.0f;
      continue;
    }
    float x0, x1;
    if (master) {
      x0 = hmix[2 * b];
      x1 = hmix[2 * b + 1];
      for (int l = 1; l < L; ++l) {
        x0 = __fadd_rn(x0, hmix[l * row + 2 * b]);
        x1 = __fadd_rn(x1, hmix[l * row + 2 * b + 1]);
      }
    } else {
      x0 = hmix[job * row + 2 * b];
      x1 = hmix[job * row + 2 * b + 1];
      peak0 = nan_max(peak0, fabsf(x0));
      peak1 = nan_max(peak1, fabsf(x1));
      squares[b] = __fmul_rn(x0, x0);
      squares[P + b] = __fmul_rn(x1, x1);
    }
    if (strip >= 0) {
      const float s0 = __fmul_rn(x0, scale0), s1 = __fmul_rn(x1, scale1);
      const float d0 = __fmul_rn(s0, dry), d1 = __fmul_rn(s1, dry);
      out[2 * b] = d0;
      out[2 * b + 1] = d1;
      out[plane + 2 * b] = __fmul_rn(s0, wet1);
      out[plane + 2 * b + 1] = __fmul_rn(s1, wet1);
      out[2 * plane + 2 * b] = __fmul_rn(s0, wet2);
      out[2 * plane + 2 * b + 1] = __fmul_rn(s1, wet2);
      if (master) {  // the master is strip 0's dry send
        peak0 = nan_max(peak0, fabsf(d0));
        peak1 = nan_max(peak1, fabsf(d1));
      }
    }
  }
  peak0 = block_max(peak0, scratch);
  peak1 = block_max(peak1, scratch);
  if (master) {
    if (t == 0) {
      master_peak[2 * h] = peak0;
      master_peak[2 * h + 1] = peak1;
    }
    return;
  }
  // the squares' halving tree, both channels at once
  for (int half = P / 2; half >= 1; half /= 2) {
    __syncthreads();
    for (int i = t; i < 2 * half; i += kThreads) {
      float* s = squares + (i < half ? 0 : P);
      const int j = i < half ? i : i - half;
      s[j] = __fadd_rn(s[j], s[j + half]);
    }
  }
  __syncthreads();
  const int64_t m = (h * L + job) * 2;
  if (t == 0) {
    meters[m] = peak0;
    meters[m + 1] = peak1;
  }
  if (t < 2) {
    const int64_t rms = static_cast<int64_t>(H) * L * 2;  // peaks -> RMS
    meters[rms + m + t] =
        __fsqrt_rn(__fdiv_rn(squares[t * P], static_cast<float>(B)));
  }
}

}  // namespace

extern "C" {

int zl_finish_block(const void* mix, const void* strips, void* strips_out,
                    void* meters, void* master_peak, int64_t H, int64_t L,
                    int64_t B, void* stream) {
  if (H <= 0) return static_cast<int>(cudaGetLastError());
  if (H > 65535 || L <= kFirstChannelLane || L > 1024 || B <= 0 ||
      B > kMaxFrames)
    return static_cast<int>(cudaErrorInvalidValue);
  int P = 1;
  while (P < B) P *= 2;
  const size_t smem = 2 * static_cast<size_t>(P) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        finish_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(L + 1), static_cast<unsigned>(H));
  finish_block_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mix), static_cast<const float*>(strips),
      static_cast<float*>(strips_out), static_cast<float*>(meters),
      static_cast<float*>(master_peak), static_cast<int>(H),
      static_cast<int>(L), static_cast<int>(B), P);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
