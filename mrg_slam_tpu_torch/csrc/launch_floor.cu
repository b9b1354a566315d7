// An empty kernel: its CUDA-event time is the launch floor that
// chip_smoke.py prints beside each kernel's time, the least a launch of
// any kernel costs on the card however little work it does.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// One block of one thread on `stream`. Returns cudaGetLastError().
extern "C" int mrg_empty(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
