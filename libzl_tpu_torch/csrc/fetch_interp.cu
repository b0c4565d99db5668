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
// Bound: memory. Each input byte read once and each output byte written
// once: pos and alpha 8 B and the output 8 B per (voice, frame), the two
// window anchors 8 B per voice, and the unique samples the frames tap, of
// both channels (4 B a sample and channel in f32, 2 B in int16). At
// V=1024, B=1024 that is 20-34 MB, or 6-10 us at 3.35 TB/s.
//
// Design. One CTA covers G voices x a chunk of at most 1024 frames, 4
// consecutive frames a thread: G = 1 at B=1024, G = 8 at B=128 (about 256
// threads), so the 2-D grid (voice groups x frame chunks) needs no divide.
// pos and alpha arrive as 16-byte int4/float4 loads and the two output rows
// leave as float4 stores; a ragged B takes scalar accesses. Each voice then
// reduces the least and greatest tap of its frames in each region (warp
// shuffles, then shared-memory atomics) and stages those samples of both
// channels, region A then region B, into shared memory with 16-byte
// cp.async.cg copies (start aligned down to 16 bytes; a chunk that crosses
// 0 or N is copied element by element, staging 0 outside [0, N)). The lerp
// reads the staged samples, so each sample crosses from HBM once, in full
// 16-byte transactions, instead of being gathered by four taps in scalar
// loads. An int16 bank stages as int16 and dequantizes at the lerp.
//
// Ring. Where the rows take 16-byte accesses, the grid holds as many CTAs
// as fit on the card at once and each walks several voice groups: thread 0
// starts the bulk copy (cp.async.bulk on an mbarrier) of the next group's
// pos and alpha rows into the other of two shared-memory slots while this
// group's taps are staged and interpolated.
//
// Budget: a voice's taps in one chunk of f frames span at most r f + 4
// samples over both regions (its frames split between region A and region
// B, each region's run advancing by at most r a frame), so shared memory
// holds min(4, (region - 512) / B) f + 4 samples a channel and voice, plus
// the alignment slack: region - 512 >= r B + 2 (soundbank.region_tail_guard)
// sizes it for the caller's envelope, and 4 is the engine's MAX_PITCH_RATIO.
// Twice that (a whole run in each region) halves the CTAs an SM holds and
// measured slower on the engine's own inputs. A voice whose taps need more
// (positions that jump between the regions, or a direct call at a larger
// ratio) reads its taps with __ldg in the same kernel, a warp's lanes on
// consecutive frames. Both paths round the lerp's products alike, so a
// voice gives the same bits staged or not.
//
// What holds it back (PERF.md §6): the staging serialises each group's
// bytes behind two CTA-wide barriers (positions, range reduction, copy,
// lerp), the shared memory leaves fewer threads resident than a direct
// read would, and the ring hides only the positions of the next group.
// It reaches about 30-40% of the bound at V=1024, B=1024 on an H100.
//
// The kernel allocates nothing, never synchronises, and launches on the
// caller's stream; the C entry points return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int64_t kSoundBlock = 512;   // window anchor granularity (samples)
constexpr int kFrames = 4;             // consecutive frames per thread
constexpr int kChunkFrames = 1024;     // most frames one CTA covers
constexpr int kTargetThreads = 256;    // threads per CTA
constexpr int kMaxGroup = kTargetThreads / 32;  // voices per CTA, at most
constexpr int kMaxPitchRatio = 4;      // constants.MAX_PITCH_RATIO

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int16_t x) {
  return static_cast<float>(x) * (1.0f / 32767.0f);
}

// s0 (1 - a) + s1 a with each product rounded (no FMA contraction), so the
// staged and the direct tap paths give the same bits for the same taps
__device__ __forceinline__ float lerp(float s0, float s1, float a) {
  return __fadd_rn(__fmul_rn(s0, 1.0f - a), __fmul_rn(s1, a));
}

template <typename T>
__device__ __forceinline__ T tap_direct(const T* __restrict__ ch, int64_t i,
                                        int64_t n) {
  return (i >= 0 && i < n) ? __ldg(ch + i) : T(0);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ int warp_min(int x) {
  for (int o = 16; o > 0; o >>= 1)
    x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
  for (int o = 16; o > 0; o >>= 1)
    x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

struct Launch {
  int chunk;      // frames per CTA (a multiple of 128)
  int group;      // voices per CTA
  int cap;        // staged samples per channel and voice (a multiple of 16 B)
  int groups;     // voice groups: ceil(V / group)
  bool vec_io;    // int4/float4 pos, alpha and output accesses
  bool vec_copy;  // 16-byte cp.async staging
  bool ring;      // pos/alpha of the next group by bulk copy (needs vec_io)
};

// ---- mbarrier and bulk-copy primitives (sm_90)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      smem_addr(bar)));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  uint64_t state;
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;\n"
      : "=l"(state)
      : "r"(smem_addr(bar)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      " .reg .pred done;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// the two ring slots: pos then alpha rows of one voice group, row stride B
// (group > 1, one chunk) or the chunk (group == 1); 1024 frames either way
constexpr int kRingFrames = kChunkFrames;
constexpr size_t kRingBytes = 2 * 2 * kRingFrames * 4;

// One (voice group, frame chunk) of the fetch, with this thread's 4
// positions and weights in registers; `prow` and `arow` are the voice's
// positions and weights from the chunk's first frame on (in the ring slot
// or in global memory).
template <typename T>
__device__ __forceinline__ void fetch_item(
    const T* __restrict__ sound, int64_t n,
    const int32_t* __restrict__ win_blk_a,
    const int32_t* __restrict__ win_blk_b, float* __restrict__ out, int B,
    int region, const Launch& cfg, T* stage, int (*bounds)[4], int v,
    bool live, int b0, int64_t row, const int (&p)[kFrames],
    const float (&a)[kFrames], const int32_t* prow, const float* arow) {
  constexpr int kVec = 16 / sizeof(T);  // samples per 16-byte chunk
  const int tx = threadIdx.x;
  const int g = threadIdx.y;

  // ---- the voice's tap range in each region (window-relative t)
  const int last = 2 * region - 1;  // first invalid position
  int alo = INT_MAX, ahi = INT_MIN, blo = INT_MAX, bhi = INT_MIN;
#pragma unroll
  for (int k = 0; k < kFrames; ++k) {
    const int q = p[k];
    if (q < 0 || q >= last) continue;
    if (q < region) {
      alo = min(alo, q);
      ahi = max(ahi, min(q + 1, region - 1));
      if (q + 1 == region) {  // tap p + 1 is region B's first sample
        blo = min(blo, region);
        bhi = max(bhi, region);
      }
    } else {
      blo = min(blo, q);
      bhi = max(bhi, q + 1);
    }
  }
  alo = warp_min(alo);
  ahi = warp_max(ahi);
  blo = warp_min(blo);
  bhi = warp_max(bhi);
  __syncthreads();  // bounds initialised
  if ((tx & 31) == 0) {
    atomicMin(&bounds[g][0], alo);
    atomicMax(&bounds[g][1], ahi);
    atomicMin(&bounds[g][2], blo);
    atomicMax(&bounds[g][3], bhi);
  }
  __syncthreads();
  alo = bounds[g][0];
  ahi = bounds[g][1];
  blo = bounds[g][2];
  bhi = bounds[g][3];

  const int64_t base_a =
      live ? static_cast<int64_t>(win_blk_a[v]) * kSoundBlock : 0;
  const int64_t base_b =
      live ? static_cast<int64_t>(win_blk_b[v]) * kSoundBlock : 0;
  // staged absolute ranges, starts aligned down to 16 bytes
  const int64_t sa = (base_a + alo) & ~static_cast<int64_t>(kVec - 1);
  const int64_t sb = (base_b + blo - region) & ~static_cast<int64_t>(kVec - 1);
  const int na = alo <= ahi
      ? static_cast<int>((base_a + ahi - sa + kVec) / kVec) * kVec : 0;
  const int nb = blo <= bhi
      ? static_cast<int>((base_b + bhi - region - sb + kVec) / kVec) * kVec
      : 0;
  const bool staged = live && na + nb <= cfg.cap;

  // ---- stage [A | B] of both channels: 16-byte cp.async where whole
  if (staged) {
    const int chunks = (na + nb) / kVec;
    for (int c = 0; c < 2; ++c) {
      const T* ch = sound + c * n;
      T* dst = stage + c * cfg.cap;
      for (int k = tx; k < chunks; k += blockDim.x) {
        const int e = k * kVec;
        const int64_t src = e < na ? sa + e : sb + (e - na);
        if (cfg.vec_copy && src >= 0 && src + kVec <= n) {
          cp_async16(dst + e, ch + src);
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j)
            dst[e + j] = tap_direct(ch, src + j, n);
        }
      }
    }
    cp_async_wait_all();
  }
  __syncthreads();
  if (!live) return;

  if (!staged) {
    // ---- over the budget: taps straight from the bank, a warp's lanes on
    // consecutive frames (chunk0 + k * blockDim.x + tx), so that one tap
    // load of a warp touches few 32-byte sectors
    const int chunk0 = b0 - tx * kFrames;
    int q[kFrames];
    float w[kFrames];
#pragma unroll
    for (int k = 0; k < kFrames; ++k) {
      const int j = k * blockDim.x + tx;
      const bool in = chunk0 + j < B;
      q[k] = in ? prow[j] : -1;
      w[k] = in ? arow[j] : 0.0f;
    }
    float* o = out + 2 * row + chunk0;  // out[v, 0, chunk0]
#pragma unroll
    for (int k = 0; k < kFrames; ++k) {
      const int j = k * blockDim.x + tx;
      if (chunk0 + j >= B) continue;
      float lv = 0.0f, rv = 0.0f;
      if (q[k] >= 0 && q[k] < last) {
        const int64_t i0 =
            q[k] < region ? base_a + q[k] : base_b + (q[k] - region);
        const int64_t i1 = q[k] + 1 < region ? base_a + q[k] + 1
                                             : base_b + (q[k] + 1 - region);
        lv = lerp(to_f32(tap_direct(sound, i0, n)),
                  to_f32(tap_direct(sound, i1, n)), w[k]);
        rv = lerp(to_f32(tap_direct(sound + n, i0, n)),
                  to_f32(tap_direct(sound + n, i1, n)), w[k]);
      }
      o[j] = lv;
      o[B + j] = rv;
    }
    return;
  }
  if (b0 >= B) return;

  // ---- lerp from the stage: window-relative tap t -> staged slot
  float l[kFrames], r[kFrames];
#pragma unroll
  for (int k = 0; k < kFrames; ++k) {
    const int q = p[k];
    l[k] = 0.0f;
    r[k] = 0.0f;
    if (q < 0 || q >= last) continue;
    const int i0 = q < region ? static_cast<int>(base_a + q - sa)
                              : na + static_cast<int>(base_b + q - region - sb);
    const int i1 = q + 1 < region
        ? static_cast<int>(base_a + q + 1 - sa)
        : na + static_cast<int>(base_b + q + 1 - region - sb);
    l[k] = lerp(to_f32(stage[i0]), to_f32(stage[i1]), a[k]);
    r[k] = lerp(to_f32(stage[cfg.cap + i0]), to_f32(stage[cfg.cap + i1]),
                a[k]);
  }

  float* o = out + 2 * row + b0;  // out[v, 0, b0]; out[v, 1, b0] is o[B]
  if (cfg.vec_io && b0 + kFrames <= B) {
    *reinterpret_cast<float4*>(o) = make_float4(l[0], l[1], l[2], l[3]);
    *reinterpret_cast<float4*>(o + B) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kFrames; ++k) {
      if (b0 + k < B) {
        o[k] = l[k];
        o[B + k] = r[k];
      }
    }
  }
}

// The CTA walks voice groups blockIdx.x, + gridDim.x, ... of frame chunk
// blockIdx.y. With the ring, thread 0 starts the bulk copy of the next
// group's pos and alpha rows into the other ring slot before this group's
// taps are staged, so that load overlaps this group's work.
template <typename T>
__global__ void __launch_bounds__(kTargetThreads)
fetch_interp_kernel(const T* __restrict__ sound, int64_t n,
                    const int32_t* __restrict__ pos_local,
                    const float* __restrict__ alpha,
                    const int32_t* __restrict__ win_blk_a,
                    const int32_t* __restrict__ win_blk_b,
                    float* __restrict__ out, int V, int B, int region,
                    Launch cfg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int bounds[kMaxGroup][4];  // lo/hi taps in region A, region B
  __shared__ __align__(8) uint64_t bar[2];

  const int tx = threadIdx.x;
  const int g = threadIdx.y;
  const bool lead = tx == 0 && g == 0;
  int32_t* ring_pos = reinterpret_cast<int32_t*>(smem_raw);  // [2][1024]
  float* ring_alpha =
      reinterpret_cast<float*>(smem_raw) + 2 * kRingFrames;  // [2][1024]
  T* stage = reinterpret_cast<T*>(smem_raw + (cfg.ring ? kRingBytes : 0)) +
             static_cast<int64_t>(g) * 2 * cfg.cap;  // [2 channels][cap]
  const int chunk0 = blockIdx.y * cfg.chunk;
  const int rstride = cfg.group > 1 ? B : cfg.chunk;

  // bulk copy of group gx's rows (contiguous: one chunk of one voice, or
  // whole rows of `group` voices) into ring slot s
  auto fetch_rows = [&](int gx, int s) {
    const int v0 = gx * cfg.group;
    const int rows = min(cfg.group, V - v0);
    const int64_t start = static_cast<int64_t>(v0) * B + chunk0;
    const unsigned bytes = 4u * static_cast<unsigned>(
        cfg.group > 1 ? rows * B : min(cfg.chunk, B - chunk0));
    mbar_expect_tx(&bar[s], 2 * bytes);
    bulk_g2s(ring_pos + s * kRingFrames, pos_local + start, bytes, &bar[s]);
    bulk_g2s(ring_alpha + s * kRingFrames, alpha + start, bytes, &bar[s]);
  };
  if (cfg.ring) {
    if (lead) {
      mbar_init(&bar[0]);
      mbar_init(&bar[1]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (lead && blockIdx.x < cfg.groups) fetch_rows(blockIdx.x, 0);
  }

  int it = 0;
  for (int gx = blockIdx.x; gx < cfg.groups; gx += gridDim.x, ++it) {
    const int v = gx * cfg.group + g;
    const bool live = v < V;
    const int b0 = chunk0 + tx * kFrames;
    const int64_t row = static_cast<int64_t>(live ? v : 0) * B;
    if (tx < 4) bounds[g][tx] = (tx & 1) ? INT_MIN : INT_MAX;

    // ---- this thread's 4 frames: positions and weights
    int p[kFrames];
    float a[kFrames];
    const int32_t* prow = pos_local + row + chunk0;
    const float* arow = alpha + row + chunk0;
    if (cfg.ring) {
      const int s = it & 1;
      if (lead && gx + static_cast<int>(gridDim.x) < cfg.groups) {
        // slot s ^ 1 was read before the last iteration's final barrier
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        fetch_rows(gx + gridDim.x, s ^ 1);
      }
      mbar_wait(&bar[s], (it >> 1) & 1);
      prow = ring_pos + s * kRingFrames + g * rstride;
      arow = ring_alpha + s * kRingFrames + g * rstride;
      if (live && b0 + kFrames <= B) {
        const int4 pv = *reinterpret_cast<const int4*>(prow + tx * kFrames);
        const float4 av = *reinterpret_cast<const float4*>(arow + tx * kFrames);
        p[0] = pv.x; p[1] = pv.y; p[2] = pv.z; p[3] = pv.w;
        a[0] = av.x; a[1] = av.y; a[2] = av.z; a[3] = av.w;
      } else {
#pragma unroll
        for (int k = 0; k < kFrames; ++k) {
          p[k] = -1;
          a[k] = 0.0f;
        }
      }
    } else if (live && cfg.vec_io && b0 + kFrames <= B) {
      const int4 pv = *reinterpret_cast<const int4*>(pos_local + row + b0);
      const float4 av = *reinterpret_cast<const float4*>(alpha + row + b0);
      p[0] = pv.x; p[1] = pv.y; p[2] = pv.z; p[3] = pv.w;
      a[0] = av.x; a[1] = av.y; a[2] = av.z; a[3] = av.w;
    } else {
#pragma unroll
      for (int k = 0; k < kFrames; ++k) {
        const bool in = live && b0 + k < B;
        p[k] = in ? pos_local[row + b0 + k] : -1;
        a[k] = in ? alpha[row + b0 + k] : 0.0f;
      }
    }
    fetch_item<T>(sound, n, win_blk_a, win_blk_b, out, B, region, cfg, stage,
                  bounds, v, live, b0, row, p, a, prow, arow);
    __syncthreads();  // the ring slot, the stage and the bounds are free
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

template <typename T>
Launch plan(const void* sound, int64_t n, const void* pos_local,
            const void* alpha, const void* out, int64_t V, int64_t B,
            int64_t region) {
  constexpr int kVec = 16 / sizeof(T);
  Launch cfg;
  const int64_t rounded = (B + 127) / 128 * 128;
  cfg.chunk = static_cast<int>(rounded < kChunkFrames ? rounded
                                                      : kChunkFrames);
  const int tpv = cfg.chunk / kFrames;
  cfg.group = tpv >= kTargetThreads ? 1 : kTargetThreads / tpv;
  cfg.groups = static_cast<int>((V + cfg.group - 1) / cfg.group);
  const int64_t f = B < cfg.chunk ? B : cfg.chunk;  // frames a CTA covers
  int64_t span = (region > kSoundBlock ? region - kSoundBlock : 0) * f / B;
  if (span > kMaxPitchRatio * f) span = kMaxPitchRatio * f;
  // each region's staged run starts up to kVec-1 samples early and ends in
  // a whole chunk: at most 2 (kVec - 1) more samples a region
  span += 4 + 4 * (kVec - 1);
  cfg.cap = static_cast<int>((span + kVec - 1) / kVec * kVec);
  cfg.vec_io = B % kFrames == 0 && aligned16(pos_local) &&
               aligned16(alpha) && aligned16(out);
  cfg.vec_copy = aligned16(sound) && n % kVec == 0;
  cfg.ring = cfg.vec_io;
  return cfg;
}

template <typename T>
int launch(const void* sound, int64_t n, const void* pos_local,
           const void* alpha, const void* win_blk_a, const void* win_blk_b,
           void* out, int64_t V, int64_t B, int64_t region, void* stream) {
  if (V <= 0 || B <= 0) return static_cast<int>(cudaGetLastError());
  if (V > INT_MAX || B > INT_MAX || 2 * region > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch cfg = plan<T>(sound, n, pos_local, alpha, out, V, B, region);
  const dim3 block(cfg.chunk / kFrames, cfg.group);
  const unsigned chunks = static_cast<unsigned>((B + cfg.chunk - 1) /
                                                cfg.chunk);
  const size_t smem = (cfg.ring ? kRingBytes : 0) +
                      static_cast<size_t>(cfg.group) * 2 * cfg.cap *
                          sizeof(T);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fetch_interp_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  unsigned ctas = static_cast<unsigned>(cfg.groups);
  if (cfg.ring) {
    // as many CTAs as fit on the card at once; each walks several groups
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, fetch_interp_kernel<T>, block.x * block.y, smem)) !=
            cudaSuccess)
      return static_cast<int>(e);
    const unsigned resident =
        static_cast<unsigned>(sms * (per_sm > 0 ? per_sm : 1)) / chunks;
    if (resident > 0 && resident < ctas) ctas = resident;
  }
  const dim3 grid(ctas, chunks);
  fetch_interp_kernel<T><<<grid, block, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(sound), n,
      static_cast<const int32_t*>(pos_local),
      static_cast<const float*>(alpha),
      static_cast<const int32_t*>(win_blk_a),
      static_cast<const int32_t*>(win_blk_b), static_cast<float*>(out),
      static_cast<int>(V), static_cast<int>(B), static_cast<int>(region),
      cfg);
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

// The staged-sample budget per channel and voice (samples) that a launch at
// (B, region) plans: chip_smoke.py reports which voices exceed it.
int zl_fetch_interp_stage_cap(int64_t B, int64_t region, int int16_bank) {
  return int16_bank
      ? plan<int16_t>(nullptr, 0, nullptr, nullptr, nullptr, 1, B, region)
            .cap
      : plan<float>(nullptr, 0, nullptr, nullptr, nullptr, 1, B, region).cap;
}

const char* zl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
