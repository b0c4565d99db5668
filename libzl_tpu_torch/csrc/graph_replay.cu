// A render graph's replay (engine/graphs.py): no kernel, the runtime calls
// of one replay in one C call.
//
// Contract: zl_graph_replay enqueues on `stream` (of device `device`), in
// this order: a wait for `done` (the entry's last replay); a copy of
// `prog_bytes` bytes from pinned host memory `staging` into the static
// program `prog` (device memory); a record of `copied` behind it (the
// staging slot may be written again after it); a launch of the graph
// executable `exec`; a copy of `out_bytes` bytes from the static outputs
// `src` into the output slot `dst` (both device memory); a record of `done`
// behind it. It returns the first cudaError_t that is not cudaSuccess, else
// 0. It does not wait. It makes `device` current for the call only where
// the calling thread has another current, and puts that one back.
//
// Why one C call: graphs.py binds it with ctypes.PyDLL, which keeps the
// interpreter lock through the call. torch's copy_, Event.record,
// wait_event, CUDAGraph.replay() and clone() each let go of the lock and
// pay their own set-up; a device entry around them costs tens of µs more.
// CUDAGraph.replay() also runs the default generator's replay prologue (two
// one-element fills) before its launch: graphs.py takes this path only for
// graphs whose capture left that generator's state as it was.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

cudaError_t enqueue(cudaGraphExec_t exec, cudaStream_t s, cudaEvent_t done,
                    void* prog, const void* staging, size_t prog_bytes,
                    cudaEvent_t copied, void* dst, const void* src,
                    size_t out_bytes) {
  cudaError_t err = cudaStreamWaitEvent(s, done, 0);
  if (err != cudaSuccess) return err;
  err = cudaMemcpyAsync(prog, staging, prog_bytes, cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return err;
  err = cudaEventRecord(copied, s);
  if (err != cudaSuccess) return err;
  err = cudaGraphLaunch(exec, s);
  if (err != cudaSuccess) return err;
  err = cudaMemcpyAsync(dst, src, out_bytes, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return err;
  return cudaEventRecord(done, s);
}

}  // namespace

extern "C" {

int zl_graph_replay(void* exec, void* stream, void* done, void* prog,
                    const void* staging, int64_t prog_bytes, void* copied,
                    void* dst, const void* src, int64_t out_bytes,
                    int device) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = enqueue(static_cast<cudaGraphExec_t>(exec),
                static_cast<cudaStream_t>(stream),
                static_cast<cudaEvent_t>(done), prog, staging,
                static_cast<size_t>(prog_bytes),
                static_cast<cudaEvent_t>(copied), dst, src,
                static_cast<size_t>(out_bytes));
  if (current != device) {
    cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

}  // extern "C"
