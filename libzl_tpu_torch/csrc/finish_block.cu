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
// Design, simple first: a CTA of 256 threads a (job, slice, class), jobs
// 0..L-1 one lane each (its peak, its squares' tree in shared memory, and
// for lanes >= 2 its strip), job L the master (the chain over the L lanes,
// strip 0, the master peak). A thread walks its class's frames 256 apart.
// The tree splits on the lowest index bit at its root (element i meets
// element i + P/2, of the same residue mod any R dividing P/2), so with R
// classes of residue r mod R (frames r, r + R, ...) each class's tree is
// the first levels of the whole tree restricted to the class, and the whole
// tree is the same halving tree over the R class sums. Up to P = 16384
// frames (128 KB of squares) R = 1: one CTA a lane, the tree whole. Past
// it R = P / 16384 CTAs a lane each write their class's sum and peaks to
// `partial`, and a second kernel, a CTA a (lane or master, slice), halves
// the R sums in the same tree and takes the peaks' max.
//
// The kernels allocate nothing, never synchronise, and launch on the
// caller's stream; the C entry points return cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFirstChannelLane = 2;  // lanes 2.. feed strips 1..
constexpr int64_t kMaxClass = 16384;  // frames of a CTA's tree, classes

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

// the halving tree of squares[0..n) and squares[n..2n), both channels at
// once, into squares[0] and squares[n]; ends with the CTA synchronised
__device__ void tree_sum(float* squares, int n) {
  for (int half = n / 2; half >= 1; half /= 2) {
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * half; i += kThreads) {
      float* s = squares + (i < half ? 0 : n);
      const int j = i < half ? i : i - half;
      s[j] = __fadd_rn(s[j], s[j + half]);
    }
  }
  __syncthreads();
}

// lane l's RMS from its squares' sum
__device__ __forceinline__ float rms(float sum, int B) {
  return __fsqrt_rn(__fdiv_rn(sum, static_cast<float>(B)));
}

// kSplit: R > 1 classes a lane, each writing its partials; else R = 1 and
// the CTA writes the lane's meters (the unsplit kernel keeps its int
// arithmetic: the split one measured slower at B <= 16384)
template <bool kSplit>
__global__ void __launch_bounds__(kThreads)
finish_block_kernel(const float* __restrict__ mix,
                    const float* __restrict__ strips,
                    float* __restrict__ strips_out,
                    float* __restrict__ meters,
                    float* __restrict__ master_peak,
                    float* __restrict__ partial, int H, int L, int B, int Q,
                    int R) {
  extern __shared__ float squares[];  // [2][Q]
  __shared__ float scratch[kWarps];
  const int job = blockIdx.x;  // a lane, or L: the master
  const int64_t h = blockIdx.y;
  const int r = kSplit ? blockIdx.z : 0;  // the residue class r mod R
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
  for (int m = t; m < Q; m += kThreads) {
    const int64_t b = kSplit ? r + static_cast<int64_t>(R) * m : m;
    if (b >= B) {  // the tree's zero padding
      if (!master) squares[m] = squares[Q + m] = 0.0f;
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
      squares[m] = __fmul_rn(x0, x0);
      squares[Q + m] = __fmul_rn(x1, x1);
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
  // R > 1: [H][L + 1][R][2] partial peaks (the master's at job L), then
  // [H][L][R][2] partial sums
  float* pk = kSplit ? partial + ((h * (L + 1) + job) * R + r) * 2
                     : master_peak + 2 * h;
  if (master) {
    if (t == 0) {
      pk[0] = peak0;
      pk[1] = peak1;
    }
    return;
  }
  tree_sum(squares, Q);
  const int64_t m = (h * L + job) * 2;
  if (kSplit) {
    if (t < 2) {
      pk[t] = t == 0 ? peak0 : peak1;
      partial[static_cast<int64_t>(H) * (L + 1) * R * 2 +
              ((h * L + job) * R + r) * 2 + t] = squares[t * Q];
    }
    return;
  }
  if (t == 0) {
    meters[m] = peak0;
    meters[m + 1] = peak1;
  }
  if (t < 2) {
    const int64_t rms_at = static_cast<int64_t>(H) * L * 2;  // peaks -> RMS
    meters[rms_at + m + t] = rms(squares[t * Q], B);
  }
}

// R > 1: a (lane or master, slice)'s R partials -> its meters
__global__ void __launch_bounds__(kThreads)
finish_combine_kernel(const float* __restrict__ partial,
                      float* __restrict__ meters,
                      float* __restrict__ master_peak, int H, int L, int B,
                      int R) {
  extern __shared__ float sums[];  // [2][R]
  __shared__ float scratch[kWarps];
  const int job = blockIdx.x;
  const int64_t h = blockIdx.y;
  const int t = threadIdx.x;
  const float* pk = partial + (h * (L + 1) + job) * R * 2;
  const float* sq = partial + static_cast<int64_t>(H) * (L + 1) * R * 2 +
                    (h * L + job) * R * 2;
  float peak0 = -INFINITY, peak1 = -INFINITY;
  for (int r = t; r < R; r += kThreads) {
    peak0 = nan_max(peak0, pk[2 * r]);
    peak1 = nan_max(peak1, pk[2 * r + 1]);
    if (job < L) {
      sums[r] = sq[2 * r];
      sums[R + r] = sq[2 * r + 1];
    }
  }
  peak0 = block_max(peak0, scratch);
  peak1 = block_max(peak1, scratch);
  if (job == L) {
    if (t == 0) {
      master_peak[2 * h] = peak0;
      master_peak[2 * h + 1] = peak1;
    }
    return;
  }
  tree_sum(sums, R);
  const int64_t m = (h * L + job) * 2;
  if (t == 0) {
    meters[m] = peak0;
    meters[m + 1] = peak1;
  }
  if (t < 2)
    meters[static_cast<int64_t>(H) * L * 2 + m + t] = rms(sums[t * R], B);
}

// P = the power of two at or above B, R classes of Q = P / R frames
void plan(int64_t B, int64_t* Q, int64_t* R) {
  int64_t P = 1;
  while (P < B) P *= 2;
  *Q = P < kMaxClass ? P : kMaxClass;
  *R = P / *Q;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

// floats of `partial` a finish of this shape needs (0: none)
int64_t zl_finish_block_scratch(int64_t H, int64_t L, int64_t B) {
  int64_t Q, R;
  plan(B, &Q, &R);
  return R > 1 ? H * (2 * L + 1) * R * 2 : 0;
}

int zl_finish_block(const void* mix, const void* strips, void* strips_out,
                    void* meters, void* master_peak, void* partial,
                    int64_t H, int64_t L, int64_t B, void* stream) {
  if (H <= 0) return static_cast<int>(cudaGetLastError());
  if (H > 65535 || L <= kFirstChannelLane || L > 1024 || B <= 0 ||
      B > INT_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t Q, R;
  plan(B, &Q, &R);
  // the second pass's tree of R sums lies in shared memory too
  if (R > kMaxClass || (R > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t smem = 2 * static_cast<size_t>(Q) * sizeof(float);
  const auto kernel =
      R > 1 ? finish_block_kernel<true> : finish_block_kernel<false>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(L + 1), static_cast<unsigned>(H),
                  static_cast<unsigned>(R));
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(mix), static_cast<const float*>(strips),
      static_cast<float*>(strips_out), static_cast<float*>(meters),
      static_cast<float*>(master_peak), static_cast<float*>(partial),
      static_cast<int>(H), static_cast<int>(L), static_cast<int>(B),
      static_cast<int>(Q), static_cast<int>(R));
  if (R == 1) return static_cast<int>(cudaGetLastError());
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  smem = 2 * static_cast<size_t>(R) * sizeof(float);
  e = allow_smem(finish_combine_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  finish_combine_kernel<<<dim3(static_cast<unsigned>(L + 1),
                               static_cast<unsigned>(H)),
                          kThreads, smem, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(meters),
      static_cast<float*>(master_peak), static_cast<int>(H),
      static_cast<int>(L), static_cast<int>(B), static_cast<int>(R));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
