// Programmatic dependent launch, shared by the port's kernels
// (writeback.cu, segscan.cu).
//
// A kernel launched with launch_ex(..., overlap = true) may be scheduled
// while the kernel before it in the stream drains; it must call
// grid_dependency_wait() before its first read of memory that kernel
// wrote, and may call grid_launch_dependents() once its own loads are
// issued, to let the next dependent grid start launching. Stream capture
// keeps such a launch as a programmatic edge of the graph.

#pragma once

#include <cuda_runtime.h>

namespace {

// Wait for the grid before this one in the stream (a no-op when the
// launch did not ask for the overlap).
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Let the next grid in the stream start launching.
__device__ __forceinline__ void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Launches `kernel` on `stream`, as a programmatic dependent launch if
// `overlap`; returns the launch's error code (0 on success).
template <typename... Params, typename... Args>
int launch_ex(void (*kernel)(Params...), dim3 grid, dim3 block, bool overlap,
              void* stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute dependent[1];
  dependent[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dependent[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = dependent;
  cfg.numAttrs = overlap ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace
