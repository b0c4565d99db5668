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
// Bound: memory. utils/roofline.py::finish_bound counts the mix read once
// (8 B a lane and frame), the strips, the three strip planes written once
// (24 B a strip and frame) and the meters: at H=1, B=1024 369,060 B, 0.110
// us at 3.35 TB/s (98,304 B of mix, 270,336 of planes); the ~20 float
// operations a lane and frame take 0.003 us at 67 TFLOP/s. At these sizes
// a call is one launch and one or two trips to device memory: what the
// design cuts is the serial chain inside a CTA, not bytes.
//
// Design. A grid of (L * R lane CTAs and M master CTAs, slices), 256
// threads a CTA, L the engine's 12 lanes (a compile-time constant; the
// entry point refuses any other count).
// - Lane CTA l: lane l's peak and RMS, and for l >= 2 strip l - 1. The
//   halving tree lies in registers: tree element i (a frame of the lane)
//   sits at
//       i = row * 512 + warp * 64 + lane * 2 + e,   e in {0, 1},
//   so a thread holds frames 2j and 2j + 1 of a row (one 16-byte load of
//   both channels; a warp reads 512 contiguous bytes). The tree combines
//   index bits from the highest down, so its levels are, in order: the
//   row bits, in registers (rows taken in bit-reversed order, q = 0, 1,
//   ... the row rev(q); a binary counter of partials `Tree` combines rows
//   q and q + 1, then pairs of those, ... which is the halving of the row
//   bits), then the 3 warp bits after one shared-memory exchange (warp 0
//   adds warp w + 4, + 2, + 1 in registers), then the 5 lane bits by
//   __shfl_down_sync at 16, 8, 4, 2, 1, then e: one add. One barrier a
//   tree instead of one a level; both channels travel together, and the
//   peaks' NaN-propagating max rides the same exchange. The tree is padded
//   to at least 512 elements: adding a zero-padded upper half changes no
//   bit, since squares are never -0.0 (s + 0 = s for s >= +0, inf, NaN).
//   (Warps in the low bits keep the loads coalesced: lanes there would
//   put a warp's frames 8 apart.) A thread loads up to 4 rows at once.
// - Master CTAs: M = ceil(pairs / 512) chunks of 512 frame pairs a slice,
//   two pairs a thread, all 2 x 12 of a thread's 16-byte loads issued
//   before the first add, strip 0 and the chunk's peak. B <= 1024 (the
//   main path) is one master CTA writing the master peak itself, one
//   launch: a cluster of 2, 4 or 8 master CTAs folding their peaks through
//   distributed shared memory measured slower at B=128 and 1024 than one
//   CTA (PERF.md section 6). M > 1: each chunk's peak goes to `partial`
//   and the second pass folds them.
// - Past 16384 frames a lane's tree splits into R = P / 16384 residue
//   classes (frames r, r + R, ...): the tree splits on the lowest index
//   bit at its root (element i meets element i + P/2, of the same residue
//   mod any R dividing P/2), so each class's tree is the first levels of
//   the whole tree restricted to the class, and the whole tree is the same
//   halving tree over the R class sums. A lane CTA a class writes its sum
//   and peaks to `partial`; a second kernel halves the R sums in the same
//   register schedule. Those loads are strided (scalar), so there the lane
//   CTAs only read, and the master CTAs, which hold every lane's frames of
//   their pairs in registers, write all the strips, coalesced. The second
//   pass, a kernel of its own, runs when R > 1 or M > 1 (B > 1024): a CTA
//   a (lane, slice) and one a slice for the master's chunks; no float
//   atomics, nothing left behind for a graph replay to reset.
// - Frame pairs move as float4 when B is even and the mix and the planes
//   are 16-byte aligned (the main path), else as scalars, same schedule;
//   a split tree's class loads always as scalars.
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
constexpr int kRow = 2 * kThreads;    // tree elements a register row
constexpr int kFirstChannelLane = 2;  // lanes 2.. feed strips 1..
constexpr int kLanes = 12;            // the engine's lanes
constexpr int64_t kMaxClass = 16384;  // elements of one CTA's tree
constexpr int kLevels = 6;            // partials: rows up to kMaxClass/kRow
constexpr int kBatch = 4;             // rows a thread loads at once
constexpr int kPairs = 2;             // frame pairs a master thread
constexpr int kMasterPairs = kPairs * kThreads;  // a master CTA's pairs
static_assert(kMaxClass / kRow <= (1 << (kLevels - 1)), "Tree too short");

// floats of the lane partials ([H][L][R][2] peaks, then sums) when R > 1
__host__ __device__ __forceinline__ int64_t lane_partials(int64_t H,
                                                          int64_t L,
                                                          int64_t R) {
  return R > 1 ? H * L * R * 4 : 0;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float clamp_max_f(float x, float hi) {
  return x != x ? x : fminf(x, hi);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 sq4(float4 a) {
  return make_float4(__fmul_rn(a.x, a.x), __fmul_rn(a.y, a.y),
                     __fmul_rn(a.z, a.z), __fmul_rn(a.w, a.w));
}

// the running peaks of channels 0 and 1 over a frame pair
__device__ __forceinline__ void fold_peaks(float4 x, float& p0, float& p1) {
  p0 = nan_max(p0, nan_max(fabsf(x.x), fabsf(x.z)));
  p1 = nan_max(p1, nan_max(fabsf(x.y), fabsf(x.w)));
}

// frames b0 and b1 of a lane's [B, 2] row as {b0 c0, b0 c1, b1 c0, b1 c1},
// 0 past B; kVec: b1 = b0 + 1, b0 even, B even, the row 16-byte aligned
template <bool kVec>
__device__ __forceinline__ float4 load_pair(const float* row, int b0, int b1,
                                            int B) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (kVec) {
    if (b0 < B) v = __ldg(reinterpret_cast<const float4*>(row + 2 * b0));
    return v;
  }
  if (b0 < B) {
    v.x = __ldg(row + 2 * b0);
    v.y = __ldg(row + 2 * b0 + 1);
  }
  if (b1 < B) {
    v.z = __ldg(row + 2 * b1);
    v.w = __ldg(row + 2 * b1 + 1);
  }
  return v;
}

template <bool kVec>
__device__ __forceinline__ void store_pair(float* row, int b0, int b1, int B,
                                           float4 v) {
  if (kVec) {
    if (b0 < B) *reinterpret_cast<float4*>(row + 2 * b0) = v;
    return;
  }
  if (b0 < B) {
    row[2 * b0] = v.x;
    row[2 * b0 + 1] = v.y;
  }
  if (b1 < B) {
    row[2 * b1] = v.z;
    row[2 * b1 + 1] = v.w;
  }
}

// strip k's pan-and-mute scales and its three send amounts
struct Strip {
  float scale0, scale1, dry, wet1, wet2;
};

__device__ __forceinline__ Strip load_strip(const float* strips, int K,
                                            int k) {
  const float pan = strips[3 * K + k];
  const float gate = __fsub_rn(1.0f, strips[4 * K + k]);
  return {__fmul_rn(clamp_max_f(__fsub_rn(1.0f, pan), 1.0f), gate),
          __fmul_rn(clamp_max_f(__fadd_rn(1.0f, pan), 1.0f), gate),
          strips[k], strips[K + k], strips[2 * K + k]};
}

__device__ __forceinline__ float4 mul4(float4 a, float s) {
  return make_float4(__fmul_rn(a.x, s), __fmul_rn(a.y, s), __fmul_rn(a.z, s),
                     __fmul_rn(a.w, s));
}

// a frame pair's three sends into the planes (out: the dry plane's row,
// `plane` floats to the next); returns the dry send
template <bool kVec>
__device__ __forceinline__ float4 write_sends(const Strip& s, float4 x,
                                              float* out, int64_t plane,
                                              int b0, int b1, int B) {
  const float4 y = make_float4(__fmul_rn(x.x, s.scale0),
                               __fmul_rn(x.y, s.scale1),
                               __fmul_rn(x.z, s.scale0),
                               __fmul_rn(x.w, s.scale1));
  const float4 dry = mul4(y, s.dry);
  store_pair<kVec>(out, b0, b1, B, dry);
  store_pair<kVec>(out + plane, b0, b1, B, mul4(y, s.wet1));
  store_pair<kVec>(out + 2 * plane, b0, b1, B, mul4(y, s.wet2));
  return dry;
}

// The register levels of the tree: rows pushed in bit-reversed order, q =
// 0, 1, ...; part[k] holds the partial of the last 2^k rows pushed once
// bit k of the count is set, so row q meets row q + 1 first (rows rev(q)
// and rev(q) + n/2: the halving of the top row bit), then pairs meet pairs,
// the earlier always the left operand. After n = 2^d rows part[d] holds
// the register levels' sum.
struct Tree {
  float4 part[kLevels];

  __device__ __forceinline__ void push(int q, float4 v) {
    bool carry = true;  // static indices only: part stays in registers
#pragma unroll
    for (int k = 0; k < kLevels; ++k) {
      if (carry && ((q >> k) & 1)) {
        v = add4(part[k], v);
      } else if (carry) {
        part[k] = v;
        carry = false;
      }
    }
  }

  __device__ __forceinline__ float4 sum(int d) const {
    float4 s = part[0];
#pragma unroll
    for (int k = 1; k < kLevels; ++k)
      if (k == d) s = part[k];
    return s;
  }
};

// row q of the bit-reversed order of n = 2^d rows
__device__ __forceinline__ int reversed_row(int q, int d) {
  return d == 0 ? 0 : static_cast<int>(__brev(static_cast<unsigned>(q)) >>
                                       (32 - d));
}

// the warp's peaks, every lane
__device__ __forceinline__ void warp_peaks(float& p0, float& p1) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    p0 = nan_max(p0, __shfl_xor_sync(0xffffffffu, p0, off));
    p1 = nan_max(p1, __shfl_xor_sync(0xffffffffu, p1, off));
  }
}

struct Exchange {
  float4 sq[kWarps][32];  // each thread's register-level sums
  float2 peak[kWarps];    // each warp's peaks
};

struct Meter {
  float sum0, sum1, peak0, peak1;
};

// The tree's warp, lane and e levels and the CTA's peaks, from each
// thread's register-level sum `v` (elements w * 64 + lane * 2 + e) and
// peaks: one barrier; the result is thread 0's (the other threads' is
// unspecified)
__device__ __forceinline__ Meter cta_meter(float4 v, float p0, float p1,
                                           Exchange& x) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  warp_peaks(p0, p1);
  x.sq[w][lane] = v;
  if (lane == 0) x.peak[w] = make_float2(p0, p1);
  __syncthreads();
  Meter m = {0.0f, 0.0f, 0.0f, 0.0f};
  if (w != 0) return m;
  float4 s[kWarps];
#pragma unroll
  for (int k = 0; k < kWarps; ++k) s[k] = x.sq[k][lane];
#pragma unroll
  for (int half = kWarps / 2; half >= 1; half /= 2)
#pragma unroll
    for (int k = 0; k < half; ++k) s[k] = add4(s[k], s[k + half]);
  v = s[0];
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float4 o = make_float4(__shfl_down_sync(0xffffffffu, v.x, off),
                                 __shfl_down_sync(0xffffffffu, v.y, off),
                                 __shfl_down_sync(0xffffffffu, v.z, off),
                                 __shfl_down_sync(0xffffffffu, v.w, off));
    v = add4(v, o);
  }
  m.sum0 = __fadd_rn(v.x, v.z);
  m.sum1 = __fadd_rn(v.y, v.w);
  m.peak0 = x.peak[0].x;
  m.peak1 = x.peak[0].y;
#pragma unroll
  for (int k = 1; k < kWarps; ++k) {
    m.peak0 = nan_max(m.peak0, x.peak[k].x);
    m.peak1 = nan_max(m.peak1, x.peak[k].y);
  }
  return m;
}

__device__ __forceinline__ float rms(float sum, int B) {
  return __fsqrt_rn(__fdiv_rn(sum, static_cast<float>(B)));
}

// rows of a tree of Q elements (a power of two) and their log2
__device__ __forceinline__ void tree_rows(int Q, int* n, int* d) {
  *n = Q > kRow ? Q / kRow : 1;
  *d = __ffs(*n) - 1;
}

// The master of slice h, chunk c: frame pairs [2i, 2i + 1] for i in
// [c * kMasterPairs, (c + 1) * kMasterPairs), kPairs a thread, all kLanes
// lanes' loads of both pairs issued before the first add; strip 0 and the
// chunk's peak, into `peak` (the slice's master peak when it has one
// chunk, else the chunk's partial).
template <bool kVec, bool kAllStrips>
__device__ __forceinline__ void master_chunk(
    const float* hmix, const float* strips, float* out, int64_t plane,
    float* peak, Exchange& x, int B, int c) {
  constexpr int K = kLanes - 1;
  const int t = threadIdx.x;
  const int64_t row = 2 * static_cast<int64_t>(B);
  const Strip s = load_strip(strips, K, 0);
  const int pairs = (B + 1) / 2;
  int b0[kPairs];
  float4 v[kPairs];
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int i = c * kMasterPairs + j * kThreads + t;
    b0[j] = i < pairs ? 2 * i : B;
  }
  float4 lanes[kPairs][kLanes];
#pragma unroll
  for (int j = 0; j < kPairs; ++j)
#pragma unroll
    for (int l = 0; l < kLanes; ++l)
      lanes[j][l] = load_pair<kVec>(hmix + l * row, b0[j], b0[j] + 1, B);
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    v[j] = lanes[j][0];
#pragma unroll
    for (int l = 1; l < kLanes; ++l) v[j] = add4(v[j], lanes[j][l]);
    // kAllStrips: lane l's sends too, strip l - 1, from the loads in hand
#pragma unroll
    for (int l = kFirstChannelLane; kAllStrips && l < kLanes; ++l)
      write_sends<kVec>(load_strip(strips, K, l - 1), lanes[j][l],
                        out + (l - 1) * row, plane, b0[j], b0[j] + 1, B);
  }
  float p0 = -INFINITY, p1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    if (b0[j] >= B) continue;
    float4 dry = write_sends<kVec>(s, v[j], out, plane, b0[j], b0[j] + 1, B);
    if (b0[j] + 1 >= B) dry.z = dry.w = 0.0f;  // no frame b0 + 1
    fold_peaks(dry, p0, p1);
  }
  const Meter m = cta_meter(make_float4(0.0f, 0.0f, 0.0f, 0.0f), p0, p1, x);
  if (t == 0) {
    peak[0] = m.peak0;
    peak[1] = m.peak1;
  }
}

// Lane CTAs x < L * R (lane x / R, residue class x % R), master CTAs x in
// [L * R, L * R + M) (M chunks of kMasterPairs frame pairs); slices on y.
// kSplit: each lane CTA a class writes its partials ([H][L][R][2] peaks,
// then [H][L][R][2] sums), else R = 1 and the lane CTA writes its meters.
// M > 1: each master chunk writes its peak to [H][M][2] after the lane
// partials.
template <bool kVec, bool kSplit>
__global__ void __launch_bounds__(kThreads)
finish_block_kernel(const float* __restrict__ mix,
                    const float* __restrict__ strips,
                    float* __restrict__ strips_out,
                    float* __restrict__ meters,
                    float* __restrict__ master_peak,
                    float* __restrict__ partial, int H, int B, int Q, int R,
                    int M) {
  constexpr int L = kLanes, K = L - 1;
  __shared__ Exchange x;
  const int64_t h = blockIdx.y;
  const int64_t row = 2 * static_cast<int64_t>(B);  // a lane's floats
  const float* hmix = mix + h * L * row;
  const int64_t plane = static_cast<int64_t>(H) * K * row;  // dry->wet1
  if (static_cast<int>(blockIdx.x) >= L * R) {
    const int c = blockIdx.x - L * R;
    float* peak = M == 1 ? master_peak + 2 * h
                         : partial + lane_partials(H, L, R) + (h * M + c) * 2;
    master_chunk<kVec, kSplit>(hmix, strips, strips_out + h * K * row, plane,
                               peak, x, B, c);
    return;
  }
  const int job = kSplit ? blockIdx.x / R : blockIdx.x;  // the lane
  const int r = kSplit ? blockIdx.x % R : 0;
  // kSplit: a class's frames are R apart, so the master CTAs, which hold
  // every lane's frames in their registers, write the strips coalesced
  constexpr bool kLaneVec = kVec && !kSplit;
  const float* src = hmix + job * row;
  const bool has_strip = !kSplit && job >= kFirstChannelLane;
  const int strip = job - 1;
  Strip s = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (has_strip) s = load_strip(strips, K, strip);
  float* out = has_strip ? strips_out + (h * K + strip) * row : nullptr;

  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  int n, d;
  tree_rows(Q, &n, &d);
  // element m = row * kRow + base (+ 1) is frame r + R * m (kSplit) or m
  const int base = w * 64 + lane * 2;
  const int step = kSplit ? R : 1;
  Tree tree;
  float p0 = -INFINITY, p1 = -INFINITY;
  for (int q0 = 0; q0 < n; q0 += kBatch) {  // kBatch rows' loads in flight
    int b0[kBatch];
    float4 v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int m = reversed_row(q0 + j, d) * kRow + base;
      b0[j] = q0 + j >= n ? B : kSplit ? r + R * m : m;
      v[j] = load_pair<kLaneVec>(src, b0[j], b0[j] + step, B);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (q0 + j >= n) break;
      fold_peaks(v[j], p0, p1);  // padding reads 0: no peak moves
      tree.push(q0 + j, sq4(v[j]));
      if (has_strip)
        write_sends<kLaneVec>(s, v[j], out, plane, b0[j], b0[j] + step, B);
    }
  }
  const Meter m = cta_meter(tree.sum(d), p0, p1, x);
  if (threadIdx.x != 0) return;
  const int64_t at = (h * L + job) * 2;
  if (kSplit) {
    float* pk = partial + ((h * L + job) * R + r) * 2;
    float* sq = pk + static_cast<int64_t>(H) * L * R * 2;
    pk[0] = m.peak0;
    pk[1] = m.peak1;
    sq[0] = m.sum0;
    sq[1] = m.sum1;
    return;
  }
  const int64_t rms_at = static_cast<int64_t>(H) * L * 2;  // peaks -> RMS
  meters[at] = m.peak0;
  meters[at + 1] = m.peak1;
  meters[rms_at + at] = rms(m.sum0, B);
  meters[rms_at + at + 1] = rms(m.sum1, B);
}

// The second pass, a CTA a (job, slice): R > 1, jobs 0..L-1, a lane's R
// class partials -> its meters, the R sums halved in the lane kernel's
// register schedule (element m: class m); M > 1, job L, the master chunks'
// peaks -> the master peak. `first`: the first job (L when R = 1).
__global__ void __launch_bounds__(kThreads)
finish_combine_kernel(const float* __restrict__ partial,
                      float* __restrict__ meters,
                      float* __restrict__ master_peak, int H, int B, int R,
                      int M, int first) {
  constexpr int L = kLanes;
  __shared__ Exchange x;
  const int job = first + blockIdx.x;
  const int64_t h = blockIdx.y;
  float p0 = -INFINITY, p1 = -INFINITY;
  if (job == L) {
    const float* pk = partial + lane_partials(H, L, R) + h * M * 2;
    for (int c = threadIdx.x; c < M; c += kThreads) {
      p0 = nan_max(p0, pk[2 * c]);
      p1 = nan_max(p1, pk[2 * c + 1]);
    }
    const Meter m = cta_meter(make_float4(0.0f, 0.0f, 0.0f, 0.0f), p0, p1,
                              x);
    if (threadIdx.x == 0) {
      master_peak[2 * h] = m.peak0;
      master_peak[2 * h + 1] = m.peak1;
    }
    return;
  }
  const float* pk = partial + (h * L + job) * R * 2;
  const float* sq = pk + static_cast<int64_t>(H) * L * R * 2;
  const int base = (threadIdx.x / 32) * 64 + (threadIdx.x % 32) * 2;
  int n, d;
  tree_rows(R, &n, &d);
  Tree tree;
  for (int q = 0; q < n; ++q) {
    const int m = reversed_row(q, d) * kRow + base;
    // R a power of two >= 2: classes m, m + 1 both present or both not
    fold_peaks(load_pair<true>(pk, m, m + 1, R), p0, p1);
    tree.push(q, load_pair<true>(sq, m, m + 1, R));
  }
  const Meter m = cta_meter(tree.sum(d), p0, p1, x);
  if (threadIdx.x != 0) return;
  const int64_t at = (h * L + job) * 2;
  const int64_t rms_at = static_cast<int64_t>(H) * L * 2;
  meters[at] = m.peak0;
  meters[at + 1] = m.peak1;
  meters[rms_at + at] = rms(m.sum0, B);
  meters[rms_at + at + 1] = rms(m.sum1, B);
}

// P = the power of two at or above B, R classes of Q = P / R frames, M
// master chunks
void plan(int64_t B, int64_t* Q, int64_t* R, int64_t* M) {
  int64_t P = 1;
  while (P < B) P *= 2;
  *Q = P < kMaxClass ? P : kMaxClass;
  *R = P / *Q;
  *M = ((B + 1) / 2 + kMasterPairs - 1) / kMasterPairs;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// floats of `partial` a finish of this shape needs (0: none)
int64_t zl_finish_block_scratch(int64_t H, int64_t L, int64_t B) {
  int64_t Q, R, M;
  plan(B, &Q, &R, &M);
  return lane_partials(H, L, R) + (M > 1 ? H * M * 2 : 0);
}

int zl_finish_block(const void* mix, const void* strips, void* strips_out,
                    void* meters, void* master_peak, void* partial,
                    int64_t H, int64_t L, int64_t B, void* stream) {
  if (H <= 0) return static_cast<int>(cudaGetLastError());
  if (H > 65535 || L != kLanes || B <= 0 || B > INT_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t Q, R, M;
  plan(B, &Q, &R, &M);
  // the second pass's tree of R sums takes the same register schedule
  if (R > kMaxClass || ((R > 1 || M > 1) && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(kLanes * R + M),
                  static_cast<unsigned>(H));
  const bool vec = B % 2 == 0 && aligned16(mix) && aligned16(strips_out);
  const auto kernel = R > 1 ? (vec ? finish_block_kernel<true, true>
                                  : finish_block_kernel<false, true>)
                      : vec ? finish_block_kernel<true, false>
                            : finish_block_kernel<false, false>;
  kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(mix), static_cast<const float*>(strips),
      static_cast<float*>(strips_out), static_cast<float*>(meters),
      static_cast<float*>(master_peak), static_cast<float*>(partial),
      static_cast<int>(H), static_cast<int>(B), static_cast<int>(Q),
      static_cast<int>(R), static_cast<int>(M));
  if (R == 1 && M == 1) return static_cast<int>(cudaGetLastError());
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t first = R > 1 ? 0 : kLanes;
  const int64_t jobs = (R > 1 ? kLanes : 0) + (M > 1 ? 1 : 0);
  finish_combine_kernel<<<dim3(static_cast<unsigned>(jobs),
                               static_cast<unsigned>(H)),
                          kThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(meters),
      static_cast<float*>(master_peak), static_cast<int>(H),
      static_cast<int>(B), static_cast<int>(R), static_cast<int>(M),
      static_cast<int>(first));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
