// Voice prep of the windows render (ops/voice_render.py::voice_prep and
// voice_prep_slice): from a block's or a horizon slice's per-voice program
// to the fetch's per-frame inputs.
//
// Replaces the front of the reference's fused block program,
// libzl_tpu/ops/voice.py::render_voices (positions_block :496, the ADSR of
// libzl_tpu/ops/adsr.py::envelope_block :158, the render masks :567-574, the
// gain :576 and the windows addressing :599), and for a horizon slice its
// unpack_horizon_slice (:347), which XLA fuses on the TPU.
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
// and the window anchors win_blk_a, win_blk_b [V] (the fetch's).
// Integer arithmetic wraps as int32 does in PyTorch. Every float product,
// sum and quotient is rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn; nvcc's -fmad would otherwise contract them into FMAs), in the
// plain version's order, and the release's power of two is exp2f, as
// torch.exp2 on the card; so the kernel is torch.equal to the plain version
// on the card.
//
// Two column sources. A block: the program's columns, each an address and
// a row stride in elements (PrepColumns; the S segment and W reset columns
// are adjacent), strided views of the staged fused [V, K] int32 program
// (floats bit-cast) or tensors of their own. A horizon slice h >= 1
// (voice_prep_slice_plain: ops/voice.unpack_horizon_slice, then the
// above): the base program's columns for the statics and slice h's words
// of the compact dynamics [V, 1 + (H-1) D] int32 (PrepSlice; layout
// ops/voice.pack_horizon_dynamics) for the rest: pos_int, the bit-cast
// pos_frac, env0 and rel_rate, the 16-bit wrap and stop pairs, the flags
// (release_frame, 0xFFFF for none, active, stage0, rel_mode), the 16-bit
// reset pairs; wrap segments start at istart (column 0) where their frame is
// in the block, start_frame is 0 and win_blk_a = max((base + pos_int) >> 9,
// 0). Outputs contiguous: pos_local int32 and alpha f32 [V, B] (the
// fetch's), g f32 and valid bool [V, B] (voice_post's), win_a and win_b
// int32 [V] (the fetch's).
//
// Bound: memory. Each output byte written once (13 B a voice and frame, 8 B
// a voice) and each program word read once (~140 B a voice): at V=1024,
// B=1024 about 13.8 MB, 4.1 us at 3.35 TB/s. The float work (~30
// operations a frame and an exp2) is under 1 us at the card's float32 rate.
//
// Design. A CTA of 4 to 8 warps takes consecutive (voice, chunk) items, a
// warp each; a chunk is 128 frames, 256 past 896 frames a block, so that
// at V=1024 every CTA is resident at once (one voice a CTA of 4 warps at
// B=1024, four voices at B=128).
// - Stage 1, once a voice and CTA: one warp per voice of the CTA loads the
//   voice's program into shared memory, a lane a word, the first 64 words
//   in one round trip (a block's fused row is adjacent words; a slice's
//   words are decoded from the dynamics as they are read); then its lane 0
//   computes, in registers and with the plain version's operations, what
//   is constant over the voice: the attack and decay lengths (the
//   envelope's two divisions), the release's start level and rate, the
//   segment fraction's masked sum for each segment, the window offsets and
//   the loop period's reciprocal. The first kStagedResets resets are staged
//   with the rest; any beyond are read from global memory as needed.
// - Stage 2: each lane takes 4 consecutive frames of each 128 of its
//   chunk, reading only shared memory and registers, with no division (the
//   modulo is a double product by the reciprocal, mended by one step), and
//   writes them as 16-byte stores (valid as one 4-byte word) where B is a
//   multiple of 4, frame by frame otherwise.
// The kernel is a template on its column source, so a block's kernel
// carries none of a slice's decoding: stage 1 is latency-bound, and less
// code is less to fetch.
//
// The kernel allocates nothing, never synchronises, and launches on the
// caller's stream; the C entry points return cudaGetLastError().

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
constexpr int kScalars = kSegStart;  // the columns of one word a voice

struct PrepColumns {
  const void* ptr[kCols];
  int64_t stride[kCols];
};

// a horizon slice's words in the compact dynamics
struct PrepSlice {
  const int32_t* dyn;  // [V, 1 + (H-1) D]: istart, then D words a slice
  int64_t stride;      // row stride in elements
  int64_t off;         // 1 + (h-1) D: slice h's first word
};

constexpr int kLaneFrames = 4;
constexpr int kRow = 32 * kLaneFrames;  // frames a warp covers at once
constexpr int kMinWarps = 4;
constexpr int kMaxWarps = 8;
constexpr int kMaxSegments = 8;      // voice_render.MAX_SEGMENTS
constexpr int kStagedResets = 512;   // resets a voice kept in shared memory
constexpr int kSoundBlock = 512;     // window anchor granularity (samples)
constexpr int kAnchorShift = 9;      // log2(kSoundBlock): a floor division
constexpr int32_t kReleaseNone = 1 << 30;  // ops/voice.RELEASE_NONE
constexpr int32_t kField16 = 0xFFFF;       // a 16-bit field; rf's "none"
constexpr int kStageIdle = 0;        // ops/adsr.py's stage codes
constexpr int kStageAttack = 1;
constexpr int kStageDecay = 2;
constexpr int kStageRelease = 4;
constexpr int kReleaseExponential = 1;

// the envelope's program and what is constant over it
struct Env {
  int32_t stage0, rf, rel_mode;
  int32_t ka, kad;                  // attack frames; attack + decay frames
  float env0, a_rate, d_rate, sustain, rel_rate, inv_rel, rel_log2;
  float e_d, e_s, e_r, r_rate;      // decay start, sustain, release start
};

// one voice's program and what is constant over it, in shared memory
struct Voice {
  int32_t word[kScalars];  // the scalar columns, floats bit-cast
  int32_t seg_start[kMaxSegments];
  int32_t seg_pos_int[kMaxSegments];
  float seg_pos_frac[kMaxSegments];
  float s_frac[kMaxSegments];       // the masked fraction sum by segment
  double period_inv;                // RN(1 / loop_period)
  int32_t off_a, off_b;             // pos_local - pos_int by region
  Env env;
};

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

// a % d for 0 <= a, 0 < d, from inv = RN(1 / d): the double quotient is
// within 2^-21 of a / d (a < 2^31), so its floor is off by at most one,
// which one step mends
__device__ __forceinline__ int32_t mod_by(int32_t a, int32_t d, double inv) {
  const int64_t q = __double2ll_rz(__dmul_rn(static_cast<double>(a), inv));
  int64_t r = a - q * d;
  if (r < 0)
    r += d;
  else if (r >= d)
    r -= d;
  return static_cast<int32_t>(r);
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

// ceil(num / den) with den <= 0 -> 0, clamped to >= 0, as int32
__device__ __forceinline__ int32_t safe_ceil_div(float num, float den) {
  const float q = den > 0.0f ? __fdiv_rn(num, den) : 0.0f;
  return __float2int_rz(clamp_min_f(ceilf(q), 0.0f));
}

// the attack / decay / sustain envelope at voice-local frame k
__device__ __forceinline__ float ads_env_at(const Env& e, int32_t k) {
  if (k < e.ka)
    return clamp_max_f(
        __fadd_rn(e.env0, __fmul_rn(__int2float_rn(wadd(k, 1)), e.a_rate)),
        1.0f);
  if (k < e.kad)
    return maximum_f(
        __fsub_rn(e.e_d, __fmul_rn(__int2float_rn(wadd(wsub(k, e.ka), 1)),
                                   e.d_rate)),
        e.sustain);
  return e.e_s;
}

// the envelope `steps` frames after entering release from e_r
__device__ __forceinline__ float release_env(float e_r, int32_t steps,
                                             float rate, float rel_log2,
                                             int32_t mode) {
  const float sf = __int2float_rn(steps > 0 ? steps : 0);
  if (mode == kReleaseExponential)
    return __fmul_rn(e_r, exp2f(__fmul_rn(sf, rel_log2)));
  return clamp_min_f(__fsub_rn(e_r, __fmul_rn(sf, rate)), 0.0f);
}

__device__ __forceinline__ float envelope(const Env& e, int32_t k) {
  if (e.stage0 == kStageIdle) return 0.0f;
  // a release from the block's start (stage0 release) or from rf
  const bool from_start = e.stage0 == kStageRelease;
  if (!from_start) {
    if (k < e.rf) return ads_env_at(e, k);
    // inv_rel <= 0: release <= 0, an immediate cut (juce noteOff)
    if (e.inv_rel <= 0.0f) return 0.0f;
  }
  return release_env(from_start ? e.env0 : e.e_r,
                     from_start ? wadd(k, 1) : wadd(wsub(k, e.rf), 1),
                     from_start ? e.rel_rate : e.r_rate, e.rel_log2,
                     e.rel_mode);
}

// word j of a voice's program in its staged order: the scalar columns, the
// S seg_start, seg_pos_int and seg_pos_frac words, then the W resets
__device__ __forceinline__ void column_of(int j, int S, int* col, int* e) {
  *col = j;
  *e = 0;
  if (j < kScalars) return;
  j -= kScalars;
  for (*col = kSegStart; *col < kBqReset && j >= S; ++*col) j -= S;
  *e = j;
}

__device__ __forceinline__ int32_t block_word(const PrepColumns& c,
                                              int64_t v, int col, int e) {
  return __ldg(static_cast<const int32_t*>(c.ptr[col]) + v * c.stride[col] +
               e);
}

// column `col`, element e of slice `sl` of voice v (unpack_horizon_slice)
__device__ int32_t slice_word(const PrepColumns& c, const PrepSlice& sl,
                              int64_t v, int col, int e, int S, int B) {
  const int32_t* row = sl.dyn + v * sl.stride;
  const int32_t* w = row + sl.off;  // pos_int, pos_frac, env0, rel_rate, ..
  const int npack = (S + 1) / 2;
  const int32_t flags = col == kActive || col == kStage0 ||
                                col == kReleaseFrame || col == kRelMode
                            ? __ldg(w + 4 + npack)
                            : 0;
  // the 16-bit fields: wraps 1..S-1, then stop_frame
  auto field = [&](int i) {
    return (__ldg(w + 4 + i / 2) >> (16 * (i % 2))) & kField16;
  };
  switch (col) {
    case kActive:
      return (flags >> 16) & 1;
    case kWinBlkA: {
      const int32_t a =
          wadd(block_word(c, v, kBase, 0), __ldg(w)) >> kAnchorShift;
      return a > 0 ? a : 0;
    }
    case kStartFrame:
      return 0;
    case kStopFrame:
      return field(S - 1);
    case kStage0:
      return (flags >> 17) & 7;
    case kReleaseFrame: {
      const int32_t rf = flags & kField16;
      return rf == kField16 ? kReleaseNone : rf;
    }
    case kRelMode:
      return (flags >> 20) & 3;
    case kEnv0:
      return __ldg(w + 2);
    case kRelRate:
      return __ldg(w + 3);
    case kSegStart:
      return e == 0 ? 0 : field(e - 1);
    case kSegPosInt:
      return e == 0 ? __ldg(w) : (field(e - 1) < B ? __ldg(row) : 0);
    case kSegPosFrac:
      return e == 0 ? __ldg(w + 1) : 0;  // +0.0f
    case kBqReset:
      return (__ldg(w + 5 + npack + e / 2) >> (16 * (e % 2))) & kField16;
    default:  // the base program's statics
      return block_word(c, v, col, e);
  }
}

template <bool kSlice>
__device__ __forceinline__ int32_t program_word(const PrepColumns& c,
                                                const PrepSlice& sl,
                                                int64_t v, int j, int S,
                                                int B) {
  int col, e;
  column_of(j, S, &col, &e);
  return kSlice ? slice_word(c, sl, v, col, e, S, B)
                : block_word(c, v, col, e);
}

// where word j of the staged order lives
__device__ __forceinline__ int32_t* staged_word(Voice& p, int32_t* res,
                                                int j, int S) {
  if (j < kScalars) return &p.word[j];
  j -= kScalars;
  if (j < S) return &p.seg_start[j];
  if (j < 2 * S) return &p.seg_pos_int[j - S];
  if (j < 3 * S) return reinterpret_cast<int32_t*>(&p.seg_pos_frac[j - 2 * S]);
  return &res[j - 3 * S];
}

__device__ __forceinline__ float fword(const Voice& p, int col) {
  return __int_as_float(p.word[col]);
}

// what is constant over the voice, from its staged words, in registers
__device__ void voice_invariants(Voice& p, int S, int region) {
  Env e;
  e.stage0 = p.word[kStage0];
  e.rf = p.word[kReleaseFrame];
  e.rel_mode = p.word[kRelMode];
  e.env0 = fword(p, kEnv0);
  e.a_rate = fword(p, kARate);
  e.d_rate = fword(p, kDRate);
  e.sustain = fword(p, kSustain);
  e.rel_rate = fword(p, kRelRate);
  e.inv_rel = fword(p, kInvRel);
  e.rel_log2 = fword(p, kRelLog2);
  const bool in_attack = e.stage0 == kStageAttack;
  e.ka = in_attack ? safe_ceil_div(__fsub_rn(1.0f, e.env0), e.a_rate) : 0;
  e.e_d = in_attack ? 1.0f : e.env0;
  const bool has_decay =
      (in_attack && e.d_rate > 0.0f) || e.stage0 == kStageDecay;
  const int32_t kd =
      has_decay ? safe_ceil_div(__fsub_rn(e.e_d, e.sustain), e.d_rate) : 0;
  e.kad = wadd(e.ka, kd);
  e.e_s = has_decay ? e.sustain : e.e_d;
  // the level just before a release triggered in this block
  const int32_t before = wsub(e.rf, 1);
  e.e_r = e.rf > 0 ? ads_env_at(e, before > 0 ? before : 0) : e.env0;
  e.r_rate = __fmul_rn(e.e_r, e.inv_rel);
  p.env = e;
  // the segment fraction's masked sum for each segment, in s order
  float frac[kMaxSegments];
#pragma unroll
  for (int s = 0; s < kMaxSegments; ++s) frac[s] = p.seg_pos_frac[s];
  for (int seg = 0; seg < S; ++seg) {
    float f = __fmul_rn(frac[0], seg == 0 ? 1.0f : 0.0f);
#pragma unroll
    for (int s = 1; s < kMaxSegments; ++s)
      if (s < S) f = __fadd_rn(f, __fmul_rn(frac[s], seg == s ? 1.0f : 0.0f));
    p.s_frac[seg] = f;
  }
  const int32_t base = p.word[kBase];
  p.off_a = wsub(base, wmul(p.word[kWinBlkA], kSoundBlock));
  p.off_b = wadd(wsub(base, wmul(p.word[kWinBlkB], kSoundBlock)), region);
  const int32_t period = p.word[kLoopPeriod];
  p.period_inv = period > 0 ? __drcp_rn(static_cast<double>(period)) : 0.0;
}

// frames k0 .. k0 + 3 of voice v
template <bool kSlice>
__device__ __forceinline__ void four_frames(
    const Voice& p, const int32_t* res, const PrepColumns& c,
    const PrepSlice& sl, int64_t v, int k0, int S, int W, int staged, int B,
    bool vec, int32_t* __restrict__ pos_local, float* __restrict__ alpha_out,
    float* __restrict__ g_out, uint8_t* __restrict__ valid_out) {
  const int32_t period = p.word[kLoopPeriod];
  int32_t jc[kLaneFrames];
  int seg[kLaneFrames];
#pragma unroll
  for (int i = 0; i < kLaneFrames; ++i) {
    const int32_t k = k0 + i;
    int started = 0;
    for (int s = 0; s < S; ++s) started += p.seg_start[s] <= k;
    seg[i] = started > 0 ? started - 1 : 0;
    int32_t j = wsub(k, p.seg_start[seg[i]]);
    if (j < 0) j = 0;
    if (seg[i] >= 1 && period > 0) j = mod_by(j, period, p.period_inv);
    jc[i] = j;
  }
  // the beat-quantized resets, in column order
  for (int e = 0; e < staged; ++e) {
    const int32_t r = res[e];
#pragma unroll
    for (int i = 0; i < kLaneFrames; ++i)
      if (k0 + i >= r) jc[i] = wsub(k0 + i, r);
  }
  for (int e = staged; e < W; ++e) {
    const int32_t r =
        program_word<kSlice>(c, sl, v, kScalars + 3 * S + e, S, B);
#pragma unroll
    for (int i = 0; i < kLaneFrames; ++i)
      if (k0 + i >= r) jc[i] = wsub(k0 + i, r);
  }

  const float rate_frac = fword(p, kRateFrac);
  const int32_t rate_int = p.word[kRateInt];
  const int32_t start = p.word[kStartFrame];
  const bool active = p.word[kActive] > 0;
  const int32_t stop = p.word[kStopFrame];
  const int32_t len_minus1 = p.word[kLenMinus1];
  const float gain = fword(p, kGain), clip_volume = fword(p, kClipVolume);
  int32_t pos_o[kLaneFrames];
  float alpha_o[kLaneFrames], g_o[kLaneFrames];
  bool valid_o[kLaneFrames];
#pragma unroll
  for (int i = 0; i < kLaneFrames; ++i) {
    const int32_t k = k0 + i;
    const float frac_full = __fadd_rn(
        p.s_frac[seg[i]], __fmul_rn(__int2float_rn(jc[i]), rate_frac));
    const float carry = floorf(frac_full);
    const int32_t pos_int = wadd(
        wadd(p.seg_pos_int[seg[i]], wmul(jc[i], rate_int)),
        __float2int_rz(carry));
    alpha_o[i] = __fsub_rn(frac_full, carry);
    int32_t local = wsub(k, start);
    if (local < 0) local = 0;
    g_o[i] = __fmul_rn(__fmul_rn(gain, envelope(p.env, local)), clip_volume);
    valid_o[i] = active && k >= start && k < stop && pos_int >= 0 &&
                 pos_int < len_minus1;
    pos_o[i] = wadd(pos_int, seg[i] == 0 ? p.off_a : p.off_b);
  }

  const int64_t o = v * B + k0;
  if (vec) {  // B % 4 == 0: the four frames lie in the block
    *reinterpret_cast<int4*>(pos_local + o) =
        make_int4(pos_o[0], pos_o[1], pos_o[2], pos_o[3]);
    *reinterpret_cast<float4*>(alpha_out + o) =
        make_float4(alpha_o[0], alpha_o[1], alpha_o[2], alpha_o[3]);
    *reinterpret_cast<float4*>(g_out + o) =
        make_float4(g_o[0], g_o[1], g_o[2], g_o[3]);
    *reinterpret_cast<uint32_t*>(valid_out + o) =
        static_cast<uint32_t>(valid_o[0]) |
        static_cast<uint32_t>(valid_o[1]) << 8 |
        static_cast<uint32_t>(valid_o[2]) << 16 |
        static_cast<uint32_t>(valid_o[3]) << 24;
    return;
  }
#pragma unroll
  for (int i = 0; i < kLaneFrames; ++i) {
    if (k0 + i >= B) break;
    pos_local[o + i] = pos_o[i];
    alpha_out[o + i] = alpha_o[i];
    g_out[o + i] = g_o[i];
    valid_out[o + i] = valid_o[i];
  }
}

// kSlice: the column source is a horizon slice (sl), else a block's columns
template <bool kSlice>
__global__ void __launch_bounds__(kMaxWarps * 32)
voice_prep_kernel(PrepColumns c, PrepSlice sl, int S, int W, int staged,
                  int V, int B, int chunks, int rows, int region, bool vec,
                  int32_t* __restrict__ pos_local,
                  float* __restrict__ alpha_out, float* __restrict__ g_out,
                  uint8_t* __restrict__ valid_out,
                  int32_t* __restrict__ win_a, int32_t* __restrict__ win_b) {
  extern __shared__ double smem[];
  const int warps = blockDim.x / 32;
  Voice* voices = reinterpret_cast<Voice*>(smem);
  int32_t* resets = reinterpret_cast<int32_t*>(voices + warps);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t items = static_cast<int64_t>(V) * chunks;
  const int64_t item0 = static_cast<int64_t>(blockIdx.x) * warps;
  const int64_t last = (item0 + warps < items ? item0 + warps : items) - 1;
  const int64_t first = item0 / chunks;

  // ---- stage 1: one warp a voice of this CTA stages its program
  if (first + warp <= last / chunks) {
    const int64_t v = first + warp;
    Voice& p = voices[warp];
    int32_t* res = resets + warp * staged;
    const int n = kScalars + 3 * S + staged;
    // the first 64 words (the scalars, the segments and 64 - 22 - 3 S
    // resets) in one round trip
    const bool has0 = lane < n, has1 = lane + 32 < n;
    const int32_t x0 = has0 ? program_word<kSlice>(c, sl, v, lane, S, B) : 0;
    const int32_t x1 =
        has1 ? program_word<kSlice>(c, sl, v, lane + 32, S, B) : 0;
    if (has0) *staged_word(p, res, lane, S) = x0;
    if (has1) *staged_word(p, res, lane + 32, S) = x1;
    for (int j = lane + 64; j < n; j += 32)
      *staged_word(p, res, j, S) = program_word<kSlice>(c, sl, v, j, S, B);
    __syncwarp();
    if (lane == 0) {
      voice_invariants(p, S, region);
      if (v * chunks >= item0) {  // the voice's first chunk is this CTA's
        win_a[v] = p.word[kWinBlkA];
        win_b[v] = p.word[kWinBlkB];
      }
    }
  }
  __syncthreads();

  // ---- stage 2: a warp a (voice, chunk): four frames of each 128 a lane
  const int64_t item = item0 + warp;
  if (item >= items) return;
  const int64_t v = item / chunks;
  const int first_frame = static_cast<int>(item - v * chunks) * rows * kRow +
                          lane * kLaneFrames;
  const Voice& p = voices[v - first];
  const int32_t* res = resets + (v - first) * staged;
  for (int r = 0; r < rows; ++r) {
    const int k0 = first_frame + r * kRow;
    if (k0 >= B) return;
    four_frames<kSlice>(p, res, c, sl, v, k0, S, W, staged, B, vec,
                        pos_local, alpha_out, g_out, valid_out);
  }
}

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

int launch(const PrepColumns& c, const PrepSlice& sl, int64_t S, int64_t W,
           void* pos_local, void* alpha, void* g, void* valid, void* win_a,
           void* win_b, int64_t V, int64_t B, int64_t region, void* stream) {
  if (V <= 0 || B <= 0) return static_cast<int>(cudaGetLastError());
  if (V > INT_MAX || B > INT_MAX - 2 * kRow || region > INT_MAX || S < 1 ||
      S > kMaxSegments || W < 0 || W > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  // a chunk of two 128-frame rows past 896 frames: V=1024 voices' CTAs
  // then fit on the card at once
  const int rows = B > 7 * kRow ? 2 : 1;
  const int64_t chunks = (B + rows * kRow - 1) / (rows * kRow);
  const int64_t warps =
      chunks < kMinWarps ? kMinWarps : (chunks > kMaxWarps ? kMaxWarps
                                                           : chunks);
  const int64_t ctas = (V * chunks + warps - 1) / warps;
  if (ctas > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int staged = static_cast<int>(W < kStagedResets ? W : kStagedResets);
  const size_t smem = warps * (sizeof(Voice) + staged * sizeof(int32_t));
  const bool vec = B % kLaneFrames == 0 && aligned(pos_local, 16) &&
                   aligned(alpha, 16) && aligned(g, 16) && aligned(valid, 4);
  auto kernel = sl.dyn ? voice_prep_kernel<true> : voice_prep_kernel<false>;
  kernel<<<static_cast<unsigned>(ctas), static_cast<unsigned>(warps * 32),
           smem, static_cast<cudaStream_t>(stream)>>>(
      c, sl, static_cast<int>(S), static_cast<int>(W), staged,
      static_cast<int>(V), static_cast<int>(B), static_cast<int>(chunks),
      rows, static_cast<int>(region), vec, static_cast<int32_t*>(pos_local),
      static_cast<float*>(alpha), static_cast<float*>(g),
      static_cast<uint8_t*>(valid), static_cast<int32_t*>(win_a),
      static_cast<int32_t*>(win_b));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a block's program columns
int zl_voice_prep(const void* columns, int64_t S, int64_t W, void* pos_local,
                  void* alpha, void* g, void* valid, void* win_a, void* win_b,
                  int64_t V, int64_t B, int64_t region, void* stream) {
  return launch(*static_cast<const PrepColumns*>(columns),
                PrepSlice{nullptr, 0, 0}, S, W, pos_local, alpha, g, valid,
                win_a, win_b, V, B, region, stream);
}

// slice h of a compact horizon: the base program's columns and the
// dynamics' row `dyn` (stride `dyn_stride`), slice h's words at `dyn_off`
int zl_voice_prep_slice(const void* columns, const void* dyn,
                        int64_t dyn_stride, int64_t dyn_off, int64_t S,
                        int64_t W, void* pos_local, void* alpha, void* g,
                        void* valid, void* win_a, void* win_b, int64_t V,
                        int64_t B, int64_t region, void* stream) {
  if (dyn == nullptr || dyn_off < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(*static_cast<const PrepColumns*>(columns),
                PrepSlice{static_cast<const int32_t*>(dyn), dyn_stride,
                          dyn_off},
                S, W, pos_local, alpha, g, valid, win_a, win_b, V, B, region,
                stream);
}

}  // extern "C"
