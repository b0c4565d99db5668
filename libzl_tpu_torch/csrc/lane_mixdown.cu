// In-order lane mixdown of the voice render (ops/mixdown.py).
//
// Replaces the one-hot lane product of libzl_tpu/ops/voice.py::render_voices
// (an XLA dot_general of a one-hot [12, V] by the [V, 2B] contributions, then
// a psum over the mesh in libzl_tpu/parallel/sharding.py). That product's
// summation order is the library's and changes with V, so a mesh that splits
// the voices would not give the unsharded engine's bits. This kernel fixes
// the order instead.
//
// Contract: for each slice h, lane l, frame b and channel c,
//   out[h, l, b, c] = init[h, l, b, c] (or +0.0 without init)
//                     + contrib[h, v0, b, c] + contrib[h, v1, b, c] + ...
// summed left to right, one IEEE f32 add (round to nearest) per voice, over
// the voices v0 < v1 < ... whose lane[h, v] == l, in index order. A voice
// whose lane lies outside [0, L) adds nothing. Because shard i of a mesh
// starts from shard i-1's result (init), the k shards together make the same
// adds, in the same order, as one call over the whole pool.
//
// Layout: contrib [H, V, 2B] f32 (frames and channels interleaved, as the
// render stacks them), lane [H, V] int32 (or [V] shared by every slice:
// lane_stride 0), init and out [H, L, 2B] f32; out may alias init.
//
// Bound: memory. Each contribution is read once (8 B a voice and frame),
// the lanes once (4 B a voice), init read and out written once (8 B a lane
// and frame): at V=1024, B=1024 about 8.6 MB, or 2.6 us at 3.35 TB/s. The
// adds (one a voice and element) are < 0.1 us of float32 work.
//
// Design. One CTA covers one (slice, lane) pair and a tile of 256 of the 2B
// elements, one element a thread, so a warp reads 128 consecutive bytes of
// one voice's row. The CTA walks the voices in chunks of 256: each thread
// tests one voice's lane, a warp ballot and the per-warp counts compact the
// matching voices into a shared-memory list in index order, and every thread
// then adds those voices' elements into its one accumulator with __fadd_rn,
// four loads in flight ahead of the dependent adds. There are no atomics and
// no split of the voice axis, so the result does not depend on the launch
// shape and is bit-equal to the plain version by construction. Each CTA reads
// the lanes of all V voices (4 KB at V=1024, from L2 after the first), and
// the grid has L x ceil(2B / 256) x H CTAs: 12 at B=128 (192 for a 16-slice
// horizon), 96 at B=1024. What bounds it in practice is that serial walk, not
// the bytes: a thread makes ~V/12 dependent adds behind V/256 barriers, so
// the time barely moves with B or H (PERF.md). The adds must stay one chain
// an element (a split of the voices would round differently); what a faster
// version can add is more loads in flight and more CTAs at small B.
//
// The kernel allocates nothing, never synchronises, and launches on the
// caller's stream; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kThreads = 256;            // elements a CTA, voices a chunk
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;               // loads in flight ahead of the adds

__global__ void __launch_bounds__(kThreads)
lane_mixdown_kernel(const float* __restrict__ contrib,
                    const int32_t* __restrict__ lane, int64_t lane_stride,
                    const float* init, float* out, int V, int E, int L) {
  __shared__ int list[kThreads];
  __shared__ int warp_count[kWarps];

  const int l = blockIdx.y;
  const int64_t h = blockIdx.z;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int warp = threadIdx.x / 32, lane_id = threadIdx.x % 32;
  const bool live = e < E;

  const int32_t* lanes = lane + h * lane_stride;
  const float* src = contrib + h * V * static_cast<int64_t>(E) + e;
  const int64_t o = (h * L + l) * static_cast<int64_t>(E) + e;
  float acc = (init != nullptr && live) ? init[o] : 0.0f;

  for (int v0 = 0; v0 < V; v0 += kThreads) {
    // the chunk's voices of lane l, in index order
    const int v = v0 + threadIdx.x;
    const bool hit = v < V && lanes[v] == l;
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane_id == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_count[w];
      offset += w < warp ? c : 0;
      total += c;
    }
    if (hit) list[offset + __popc(ballot & ((1u << lane_id) - 1u))] = v;
    __syncthreads();

    if (live) {
      int i = 0;
      for (; i + kUnroll <= total; i += kUnroll) {
        float x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          x[u] = __ldg(src + static_cast<int64_t>(list[i + u]) * E);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc = __fadd_rn(acc, x[u]);
      }
      for (; i < total; ++i)
        acc = __fadd_rn(acc, __ldg(src + static_cast<int64_t>(list[i]) * E));
    }
    __syncthreads();  // the next chunk rewrites list and warp_count
  }
  if (live) out[o] = acc;
}

}  // namespace

extern "C" {

int zl_lane_mixdown(const void* contrib, const void* lane,
                    int64_t lane_stride, const void* init, void* out,
                    int64_t H, int64_t V, int64_t E, int64_t L,
                    void* stream) {
  if (H <= 0 || E <= 0 || L <= 0) return static_cast<int>(cudaGetLastError());
  if (V < 0 || V > INT_MAX || E > INT_MAX || L > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((E + kThreads - 1) / kThreads),
                  static_cast<unsigned>(L), static_cast<unsigned>(H));
  lane_mixdown_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(contrib),
      static_cast<const int32_t*>(lane), lane_stride,
      static_cast<const float*>(init), static_cast<float*>(out),
      static_cast<int>(V), static_cast<int>(E), static_cast<int>(L));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
