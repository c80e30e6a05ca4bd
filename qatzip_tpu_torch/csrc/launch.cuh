// One kernel launch, the same for every C entry of this directory.
//
// qz::launch(kernel, grid, block, smem, stream, args...) is
// kernel<<<grid, block, smem, stream>>>(args...) followed by
// cudaGetLastError(), as one cudaLaunchKernel call: the arguments are
// converted to the kernel's parameter types and passed by address, and
// the call's own result is returned (0 when the launch was taken). It
// spares each launch the pushed launch configuration and the separate
// error query; chip_smoke.py times a launch both ways.
// qz::opt_in_smem lets a kernel take more than 48 KB of dynamic shared
// memory on the current device, once a device: the caller keeps a mask of
// the devices done.
#ifndef QZ_LAUNCH_CUH_
#define QZ_LAUNCH_CUH_

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <tuple>
#include <utility>

namespace qz {

template <typename... P, typename... A, size_t... I>
int launch_args(void (*kernel)(P...), dim3 grid, dim3 block, size_t smem,
                void* stream, std::index_sequence<I...>, A... a) {
  std::tuple<P...> v(static_cast<P>(a)...);
  void* args[] = {static_cast<void*>(&std::get<I>(v))..., nullptr};
  const cudaError_t e =
      cudaLaunchKernel(reinterpret_cast<const void*>(kernel), grid, block,
                       args, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) cudaGetLastError();  // leave no error behind
  return static_cast<int>(e);
}

template <typename... P, typename... A>
int launch(void (*kernel)(P...), dim3 grid, dim3 block, size_t smem,
           void* stream, A... a) {
  static_assert(sizeof...(P) == sizeof...(A), "one argument a parameter");
  return launch_args(kernel, grid, block, smem, stream,
                     std::index_sequence_for<P...>{}, a...);
}

template <typename... P>
int opt_in_smem(void (*kernel)(P...), size_t bytes,
                std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return 0;
  e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e != cudaSuccess) {
    cudaGetLastError();  // leave no error behind
    return static_cast<int>(e);
  }
  done.fetch_or(bit, std::memory_order_relaxed);
  return 0;
}

}  // namespace qz

#endif  // QZ_LAUNCH_CUH_
