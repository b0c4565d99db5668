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
// Layout: contrib [H, V, E] f32 with E = 2B (frames and channels interleaved,
// as the render stacks them), lane [H, V] int32 (or [V] shared by every
// slice: lane_stride 0), init and out [H, L, E] f32; out may alias init.
//
// Bound: memory. Each contribution is read once (8 B a voice and frame),
// the lanes once (4 B a voice), init read and out written once (8 B a lane
// and frame): at V=1024, B=1024 about 8.6 MB, or 2.6 us at 3.35 TB/s. The
// adds (one a voice and element) are < 0.3 us of float32 work.
//
// Design. An element's adds are one serial chain (a split of the voices would
// round differently), but its loads are not: every row a lane will add is
// known once the lane's voice list is. So the loads run ahead of the adds,
// and the copying is spread over more threads than the adding needs.
//
// - A CTA of 4 warps owns one (slice, lane) pair and a tile of 128 elements.
// - List once: the CTA loads the lanes of up to 1024 voices before it looks
//   at any (8 independent loads a thread: one round trip to memory, not one
//   a chunk); each warp ballots its 256 voices and the per-warp counts place
//   the lane's voices in a shared-memory list in index order.
// - Stream rows through shared memory: a listed row's 512-byte segment is
//   copied into a ring of 128 stages (64 KB) with cp.async, in chunks of
//   kVec floats (16, 8 or 4 bytes, by what the addresses and E allow; 4
//   bytes take every odd shape), kVec rows a pass of the CTA, so a thread
//   makes a quarter or less of the lane's copies. Up to 128 rows are in
//   flight before the first add (the session's lanes hold ~102 voices: all
//   of them); a deeper lane refills a batch's stages once it has been added.
// - Fold from shared memory: thread t adds element t of each stage in list
//   order, 16 stages a batch behind one cp.async.wait_group and one barrier
//   (the wait covers a thread's own copies, the barrier everyone's), so the
//   adds wait on shared memory, not on device memory.
// - Little's law: an SM's share of 3.35 TB/s is ~25 B/ns, so at ~700 ns of
//   memory latency it needs >= ~18 KB in flight; one CTA's ring is enough
//   for its SM, and three fit an SM.
// - The grid is ceil(E / 128) x L x H CTAs: 24 at B=128, 192 at B=1024, 384
//   for a 16-slice horizon at B=128; a lane without voices costs a list.
// - init is read (before the list, so its latency hides behind it) and out
//   written once, straight from and to global memory.
//
// What is left (PERF.md): at B=128 the launch and one CTA's chain of list,
// copies and adds, which inputs already in L2 barely shorten; at B=1024 and
// on a horizon the rows' arrival from device memory.
//
// There are no atomics and no split of the voice axis, so the result does not
// depend on the launch shape and is bit-equal to the plain version by
// construction. More than 1024 voices are listed and streamed 1024 at a time
// into the same accumulators.
//
// The kernel allocates nothing, never synchronises, and launches on the
// caller's stream; the C entry points return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kThreads = 128;                  // and elements a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kSegment = 1024;                 // voices listed at a time
constexpr int kListLoads = kSegment / kThreads;  // lane loads a thread
constexpr int kStages = 128;                   // rows in flight a CTA
constexpr int kBatch = 16;                     // rows a cp.async group
constexpr int kGroups = kStages / kBatch;
constexpr size_t kSmemBytes =
    (kStages * kThreads + kSegment + kWarps) * sizeof(float);

template <int kVec>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kVec == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  } else if constexpr (kVec == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  }
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `kPending` of this thread's newest groups are in flight
template <int kPending>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
lane_mixdown_kernel(const float* __restrict__ contrib,
                    const int32_t* __restrict__ lane, int64_t lane_stride,
                    const float* init, float* out, int V, int E, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);  // [kStages][kThreads]
  int* list = reinterpret_cast<int*>(ring + kStages * kThreads);
  int* warp_count = list + kSegment;

  const int t = threadIdx.x;
  const int warp = t / 32, lane_id = t % 32;
  const int l = blockIdx.y;
  const int64_t h = blockIdx.z;
  const int e0 = blockIdx.x * kThreads;
  const bool live = e0 + t < E;

  // this thread's share of the copies: chunk `c` (kVec floats) of every
  // kVec-th row, from row `first` on. E is a multiple of kVec, so a chunk
  // lies inside the row or outside it.
  constexpr int kChunks = kThreads / kVec;  // chunks a row segment
  constexpr int kCopies = kBatch / kVec;    // this thread's rows a batch
  const int c = t % kChunks, first = t / kChunks;
  const bool copies = e0 + c * kVec < E;

  const int32_t* lanes = lane + h * lane_stride;
  const float* src = contrib + h * V * static_cast<int64_t>(E) + e0 + c * kVec;
  float* dst = ring + first * kThreads + c * kVec;
  const int64_t o = (h * L + l) * static_cast<int64_t>(E) + e0 + t;
  float acc = (init != nullptr && live) ? init[o] : 0.0f;

  // copy this thread's chunks of the batch of rows from `row` on into the
  // stages from `stage` on; the list entries first, so that no copy waits
  // on a shared-memory read behind the copy before it
  auto copy_rows = [&](int row, int stage, int n) {
    int v[kCopies];
#pragma unroll
    for (int q = 0; q < kCopies; ++q) {
      const int r = row + first + q * kVec;
      v[q] = r < n ? list[r] : -1;
    }
#pragma unroll
    for (int q = 0; q < kCopies; ++q)
      if (v[q] >= 0 && copies)
        copy_async<kVec>(dst + (stage + q * kVec) * kThreads,
                         src + static_cast<int64_t>(v[q]) * E);
  };

  const unsigned below = (1u << lane_id) - 1u;
  for (int v0 = 0; v0 < V; v0 += kSegment) {
    // ---- the segment's voices of lane l, in index order: warp w ballots
    // voices [256 w, 256 w + 256) of the segment
    unsigned hits[kListLoads];
    int mine = 0;
#pragma unroll
    for (int j = 0; j < kListLoads; ++j) {
      const int v = v0 + (warp * kListLoads + j) * 32 + lane_id;
      const int ln = v < V ? __ldg(lanes + v) : -1;  // l >= 0: no match
      hits[j] = ln == l;
    }
#pragma unroll
    for (int j = 0; j < kListLoads; ++j) {
      hits[j] = __ballot_sync(0xffffffffu, hits[j]);
      mine += __popc(hits[j]);
    }
    if (lane_id == 0) warp_count[warp] = mine;
    __syncthreads();
    int at = 0, n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int count = warp_count[w];
      at += w < warp ? count : 0;
      n += count;
    }
#pragma unroll
    for (int j = 0; j < kListLoads; ++j) {
      if (hits[j] >> lane_id & 1u)
        list[at + __popc(hits[j] & below)] =
            v0 + (warp * kListLoads + j) * 32 + lane_id;
      at += __popc(hits[j]);
    }
    __syncthreads();

    // ---- fill the ring: the first kStages rows, kBatch rows a group. Every
    // group is committed, empty or not, so the count in flight is fixed.
#pragma unroll 1
    for (int i = 0; i < kStages; i += kBatch) {
      copy_rows(i, i, n);
      commit_group();
    }

    // ---- batch k: refill batch k-1's stages (everyone is past its adds:
    // the barrier) with batch k-1+kGroups, then add batch k's stages.
    // kGroups groups were committed before batch 0 and one more in every
    // round, the refills one group late: batch k has landed once at most
    // kGroups - 2 of the newest are in flight.
    int stage = 0;
#pragma unroll 1
    for (int base = 0; base < n; base += kBatch) {
      wait_group<kGroups - 2>();
      __syncthreads();
      if (base > 0)
        copy_rows(base - kBatch + kStages,
                  (stage == 0 ? kStages : stage) - kBatch, n);
      commit_group();
      float x[kBatch];
#pragma unroll
      for (int g = 0; g < kBatch; ++g)
        if (base + g < n) x[g] = ring[(stage + g) * kThreads + t];
#pragma unroll
      for (int g = 0; g < kBatch; ++g)
        if (base + g < n) acc = __fadd_rn(acc, x[g]);
      stage = stage + kBatch == kStages ? 0 : stage + kBatch;
    }
    wait_group<0>();
    __syncthreads();  // the next segment rewrites list and the ring
  }
  if (live) out[o] = acc;
}

// the same grid and block with nothing to do: the launch's own floor
__global__ void __launch_bounds__(kThreads) lane_mixdown_empty_kernel() {}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

dim3 grid_for(int64_t H, int64_t E, int64_t L) {
  return dim3(static_cast<unsigned>((E + kThreads - 1) / kThreads),
              static_cast<unsigned>(L), static_cast<unsigned>(H));
}

// The widest copy chunk (4, 2 or 1 floats) the pointers and E allow.
int widest_vec(const void* contrib, int64_t E) {
  for (int vec = 4; vec > 1; vec /= 2)
    if (E % vec == 0 && aligned(contrib, 4 * vec)) return vec;
  return 1;
}

template <int kVec>
cudaError_t launch(const float* contrib, const int32_t* lane,
                   int64_t lane_stride, const float* init, float* out,
                   int64_t H, int V, int E, int L, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      lane_mixdown_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return e;
  lane_mixdown_kernel<kVec><<<grid_for(H, E, L), kThreads, kSmemBytes,
                              stream>>>(contrib, lane, lane_stride, init, out,
                                        V, E, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// `vec` 0 copies in the widest chunks the addresses and E allow (4, 2 or 1
// floats); 4, 2 or 1 forces that width (tests and timings of each path) and
// is refused where they do not allow it.
int zl_lane_mixdown_as(const void* contrib, const void* lane,
                       int64_t lane_stride, const void* init, void* out,
                       int64_t H, int64_t V, int64_t E, int64_t L, int vec,
                       void* stream) {
  if (H <= 0 || E <= 0 || L <= 0) return static_cast<int>(cudaGetLastError());
  if (V < 0 || V > INT_MAX || E > INT_MAX || L > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int widest = widest_vec(contrib, E);
  if (vec == 0) vec = widest;
  if ((vec != 1 && vec != 2 && vec != 4) || vec > widest)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(contrib);
  const int32_t* ln = static_cast<const int32_t*>(lane);
  const float* in = static_cast<const float*>(init);
  float* o = static_cast<float*>(out);
  const int v = static_cast<int>(V), e = static_cast<int>(E);
  const int lanes = static_cast<int>(L);
  return static_cast<int>(
      vec == 4   ? launch<4>(c, ln, lane_stride, in, o, H, v, e, lanes, s)
      : vec == 2 ? launch<2>(c, ln, lane_stride, in, o, H, v, e, lanes, s)
                 : launch<1>(c, ln, lane_stride, in, o, H, v, e, lanes, s));
}

int zl_lane_mixdown(const void* contrib, const void* lane,
                    int64_t lane_stride, const void* init, void* out,
                    int64_t H, int64_t V, int64_t E, int64_t L,
                    void* stream) {
  return zl_lane_mixdown_as(contrib, lane, lane_stride, init, out, H, V, E, L,
                            0, stream);
}

// An empty kernel on the grid and block zl_lane_mixdown launches for this
// shape: what the launch alone costs.
int zl_lane_mixdown_empty(int64_t H, int64_t E, int64_t L, void* stream) {
  if (H <= 0 || E <= 0 || L <= 0 || E > INT_MAX || L > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  lane_mixdown_empty_kernel<<<grid_for(H, E, L), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
