// A block's device->host copy for the C ABI runtime's staging ring
// (capi/bridge.py::_StageRing): no kernel, two runtime calls in one C call.
//
// Contract: zl_host_copy enqueues, on `stream`, a copy of `bytes` bytes from
// device memory `src` into pinned host memory `dst`, then records `event`
// behind it; it returns the first cudaError_t that is not cudaSuccess, else
// 0. It does not wait: the caller waits on the event (or any later work of
// the stream) before it reads `dst`.
//
// Why one C call: the ring binds it with ctypes.PyDLL, which keeps the
// interpreter lock through the call. A torch copy_ and an Event.record each
// let go of the lock, and on a live host whose speculative workers want it
// every let-go can cost the realtime thread the workers' whole turn.

#include <cstdint>

#include <cuda_runtime.h>

extern "C" {

int zl_host_copy(void* dst, const void* src, int64_t bytes, void* stream,
                 void* event) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(dst, src, static_cast<size_t>(bytes),
                                    cudaMemcpyDeviceToHost, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaEventRecord(static_cast<cudaEvent_t>(event), s));
}

}  // extern "C"
