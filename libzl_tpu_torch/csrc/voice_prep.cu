// Voice prep of the windows render (ops/voice_render.py::voice_prep): from a
// block's per-voice program to the fetch's per-frame inputs.
//
// Replaces the front of the reference's fused block program,
// libzl_tpu/ops/voice.py::render_voices (positions_block :496, the ADSR of
// libzl_tpu/ops/adsr.py::envelope_block :158, the render masks :567-574, the
// gain :576 and the windows addressing :599), which XLA fuses on the TPU and
// the port ran as ~150 plain PyTorch ops.
//
// Contract (voice_prep_plain's, bit for bit): for voice v and frame k,
//   seg       = max(#{s : seg_start[v, s] <= k} - 1, 0)
//   jc        = max(k - seg_start[v, seg], 0), then jc % loop_period in a
//               wrap segment (seg >= 1, loop_period > 0), then k - r for
//               each beat-quantized reset r <= k, in column order
//   frac_full = s_frac + f32(jc) * rate_frac   (s_frac: the masked sum of
//               seg_pos_frac[v, s] * (seg == s) over s, in s order)
//   pos_int   = seg_pos_int[v, seg] + jc * rate_int + floor(frac_full)
//   alpha     = frac_full - floor(frac_full)
//   g         = (gain * env(max(k - start_frame, 0))) * clip_volume, env
//               the closed-form juce ADSR (ads_env_at, release_env)
//   valid     = active > 0 && start_frame <= k < stop_frame
//               && 0 <= pos_int < len_minus1
//   pos_local = pos_int + base - anchor * 512 + (seg == 0 ? 0 : region),
//               anchor = seg == 0 ? win_blk_a : win_blk_b
// Integer arithmetic wraps as int32 does in PyTorch. Every float product,
// sum and quotient is rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn; nvcc's -fmad would otherwise contract them into FMAs), in the
// plain version's order, and the release's power of two is exp2f, as
// torch.exp2 on the card; so the kernel is torch.equal to the plain version
// on the card.
//
// Inputs: the program's columns, each an address and a row stride in
// elements (PrepColumns; the S segment and W reset columns of a block are
// adjacent). For a block they are strided views of the staged fused [V, K]
// int32 program, the floats bit-cast; for a horizon slice the tensors that
// ops/voice.horizon_programs builds. Outputs [V, B] contiguous: pos_local
// int32 and alpha f32 (the fetch's), g f32 and valid bool (voice_post's).
//
// Bound: memory. Each output byte written once (13 B a voice and frame) and
// each program column read once (~140 B a voice): at V=1024, B=1024 about
// 13.8 MB, 4.1 us at 3.35 TB/s. The float work (~30 operations a frame and
// an exp2) is under 1 us at the card's float32 rate.
//
// Design, simple first: a thread a (voice, frame), 128 frames a CTA, the
// grid voices x frame chunks. Every thread of a voice reads the voice's
// columns itself (the same addresses across the CTA: one transaction each,
// served by L1), and the outputs are written coalesced. Nothing is staged
// and no thread waits on another.
//
// The kernel allocates nothing, never synchronises, and launches on the
// caller's stream; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

// ops/voice_render.py::PREP_COLUMNS, in order
enum Col {
  kActive, kBase, kLenMinus1, kWinBlkA, kWinBlkB, kRateInt, kRateFrac,
  kStartFrame, kStopFrame, kGain, kClipVolume, kLoopPeriod, kStage0,
  kReleaseFrame, kRelMode, kEnv0, kARate, kDRate, kSustain, kRelRate,
  kInvRel, kRelLog2, kSegStart, kSegPosInt, kSegPosFrac, kBqReset, kCols
};

struct PrepColumns {
  const void* ptr[kCols];
  int64_t stride[kCols];
};

constexpr int kThreads = 128;        // frames a CTA
constexpr int kMaxSegments = 8;      // voice_render.MAX_SEGMENTS
constexpr int kMaxBqResets = 64;     // voice_render.MAX_BQ_RESETS
constexpr int kSoundBlock = 512;     // window anchor granularity (samples)
constexpr int kStageIdle = 0;        // ops/adsr.py's stage codes
constexpr int kStageAttack = 1;
constexpr int kStageDecay = 2;
constexpr int kStageRelease = 4;
constexpr int kReleaseExponential = 1;

__device__ __forceinline__ int32_t icol(const PrepColumns& c, int col,
                                        int64_t v, int j = 0) {
  return __ldg(static_cast<const int32_t*>(c.ptr[col]) + v * c.stride[col] +
               j);
}

__device__ __forceinline__ float fcol(const PrepColumns& c, int col,
                                      int64_t v, int j = 0) {
  return __ldg(static_cast<const float*>(c.ptr[col]) + v * c.stride[col] +
               j);
}

// int32 arithmetic that wraps, as PyTorch's does
__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                              static_cast<uint32_t>(b));
}

// torch.clamp_min / clamp_max / maximum on floats: a NaN propagates
__device__ __forceinline__ float clamp_min_f(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max_f(float x, float hi) {
  return x != x ? x : fminf(x, hi);
}
__device__ __forceinline__ float maximum_f(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

struct Env {
  int32_t stage0, release_frame, rel_mode;
  float env0, a_rate, d_rate, sustain, rel_rate, inv_rel, rel_log2;
};

// ceil(num / den) with den <= 0 -> 0, clamped to >= 0, as int32
__device__ __forceinline__ int32_t safe_ceil_div(float num, float den) {
  const float q = den > 0.0f ? __fdiv_rn(num, den) : 0.0f;
  return __float2int_rz(clamp_min_f(ceilf(q), 0.0f));
}

// the attack / decay / sustain envelope at voice-local frame k
__device__ float ads_env_at(const Env& e, int32_t k) {
  const bool in_attack = e.stage0 == kStageAttack;
  const int32_t ka =
      in_attack ? safe_ceil_div(__fsub_rn(1.0f, e.env0), e.a_rate) : 0;
  const float e_d = in_attack ? 1.0f : e.env0;
  const bool has_decay =
      (in_attack && e.d_rate > 0.0f) || e.stage0 == kStageDecay;
  const int32_t kd =
      has_decay ? safe_ceil_div(__fsub_rn(e_d, e.sustain), e.d_rate) : 0;
  if (k < ka)
    return clamp_max_f(
        __fadd_rn(e.env0, __fmul_rn(__int2float_rn(wadd(k, 1)), e.a_rate)),
        1.0f);
  if (k < wadd(ka, kd))
    return maximum_f(
        __fsub_rn(e_d, __fmul_rn(__int2float_rn(wadd(wsub(k, ka), 1)),
                                 e.d_rate)),
        e.sustain);
  return has_decay ? e.sustain : e_d;
}

// the envelope `steps` frames after entering release from e_r
__device__ float release_env(float e_r, int32_t steps, float rate,
                             float rel_log2, int32_t mode) {
  const float sf = __int2float_rn(steps > 0 ? steps : 0);
  if (mode == kReleaseExponential)
    return __fmul_rn(e_r, exp2f(__fmul_rn(sf, rel_log2)));
  return clamp_min_f(__fsub_rn(e_r, __fmul_rn(sf, rate)), 0.0f);
}

__device__ float envelope(const Env& e, int32_t k) {
  if (e.stage0 == kStageIdle) return 0.0f;
  if (e.stage0 == kStageRelease)
    return release_env(e.env0, wadd(k, 1), e.rel_rate, e.rel_log2,
                       e.rel_mode);
  if (k < e.release_frame) return ads_env_at(e, k);
  // inv_rel <= 0: release <= 0, an immediate cut (juce noteOff)
  if (e.inv_rel <= 0.0f) return 0.0f;
  const int32_t before = wsub(e.release_frame, 1);
  const float e_r = e.release_frame > 0
                        ? ads_env_at(e, before > 0 ? before : 0)
                        : e.env0;
  return release_env(e_r, wadd(wsub(k, e.release_frame), 1),
                     __fmul_rn(e_r, e.inv_rel), e.rel_log2, e.rel_mode);
}

__global__ void __launch_bounds__(kThreads)
voice_prep_kernel(PrepColumns c, int S, int W, int B, int region,
                  int32_t* __restrict__ pos_local,
                  float* __restrict__ alpha_out, float* __restrict__ g_out,
                  uint8_t* __restrict__ valid_out) {
  const int64_t v = blockIdx.x;
  const int k = blockIdx.y * kThreads + threadIdx.x;
  if (k >= B) return;

  // ---- positions
  int started = 0;
  for (int s = 0; s < S; ++s) started += icol(c, kSegStart, v, s) <= k;
  const int seg = started > 0 ? started - 1 : 0;
  float s_frac =
      __fmul_rn(fcol(c, kSegPosFrac, v, 0), seg == 0 ? 1.0f : 0.0f);
  for (int s = 1; s < S; ++s)
    s_frac = __fadd_rn(s_frac, __fmul_rn(fcol(c, kSegPosFrac, v, s),
                                         seg == s ? 1.0f : 0.0f));
  int32_t jc = wsub(k, icol(c, kSegStart, v, seg));
  if (jc < 0) jc = 0;
  const int32_t period = icol(c, kLoopPeriod, v);
  if (seg >= 1 && period > 0) jc %= period;
  for (int e = 0; e < W; ++e) {
    const int32_t r = icol(c, kBqReset, v, e);
    if (k >= r) jc = wsub(k, r);
  }
  const float frac_full =
      __fadd_rn(s_frac, __fmul_rn(__int2float_rn(jc), fcol(c, kRateFrac, v)));
  const float carry = floorf(frac_full);
  const int32_t pos_int =
      wadd(wadd(icol(c, kSegPosInt, v, seg), wmul(jc, icol(c, kRateInt, v))),
           __float2int_rz(carry));

  // ---- envelope and gain, voice-local frames from start_frame
  const int32_t start = icol(c, kStartFrame, v);
  int32_t local = wsub(k, start);
  if (local < 0) local = 0;
  const Env e{icol(c, kStage0, v),  icol(c, kReleaseFrame, v),
              icol(c, kRelMode, v), fcol(c, kEnv0, v),
              fcol(c, kARate, v),   fcol(c, kDRate, v),
              fcol(c, kSustain, v), fcol(c, kRelRate, v),
              fcol(c, kInvRel, v),  fcol(c, kRelLog2, v)};
  const float g = __fmul_rn(__fmul_rn(fcol(c, kGain, v), envelope(e, local)),
                            fcol(c, kClipVolume, v));

  // ---- masks and the windows addressing
  const bool renders =
      icol(c, kActive, v) > 0 && k >= start && k < icol(c, kStopFrame, v);
  const bool valid =
      renders && pos_int >= 0 && pos_int < icol(c, kLenMinus1, v);
  const bool in_a = seg == 0;
  const int32_t anchor = in_a ? icol(c, kWinBlkA, v) : icol(c, kWinBlkB, v);
  const int32_t local_pos =
      wadd(wsub(wadd(pos_int, icol(c, kBase, v)), wmul(anchor, kSoundBlock)),
           in_a ? 0 : region);

  const int64_t o = v * B + k;
  pos_local[o] = local_pos;
  alpha_out[o] = __fsub_rn(frac_full, carry);
  g_out[o] = g;
  valid_out[o] = valid;
}

}  // namespace

extern "C" {

int zl_voice_prep(const void* columns, int64_t S, int64_t W, void* pos_local,
                  void* alpha, void* g, void* valid, int64_t V, int64_t B,
                  int64_t region, void* stream) {
  if (V <= 0 || B <= 0) return static_cast<int>(cudaGetLastError());
  if (V > INT_MAX || B > INT_MAX || region > INT_MAX || S < 1 ||
      S > kMaxSegments || W < 0 || W > kMaxBqResets)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(V),
                  static_cast<unsigned>((B + kThreads - 1) / kThreads));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  voice_prep_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *static_cast<const PrepColumns*>(columns), static_cast<int>(S),
      static_cast<int>(W), static_cast<int>(B), static_cast<int>(region),
      static_cast<int32_t*>(pos_local), static_cast<float*>(alpha),
      static_cast<float*>(g), static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
