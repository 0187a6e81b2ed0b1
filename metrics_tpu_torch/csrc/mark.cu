// Device marks: a one-thread kernel that does nothing, launched at the
// boundaries of the port's captured programs so that a device trace can cut
// a replayed CUDA graph into the parts of the program that made it.
//
// Replaces no TPU kernel: the JAX package names its program's parts in the
// XLA profile through jax.named_scope, which has no counterpart in a CUDA
// graph (a replay runs no Python, so no host range can see its device time).
// Here the kernel's own name says the stage: metrics_tpu_torch_mark<stage>,
// one instance per tag of the closed set below, in the order of
// obs/trace.py's MARK_STAGES. The name holds neither "confusion_" nor
// "topk_mask", so no roofline reader counts it.
//
// Bound on an H100: the launch. A mark reads and writes nothing; inside a
// graph it costs one kernel node of a single thread.

#include <cuda_runtime.h>

namespace mt_stage {
struct format {};
struct update {};
struct end {};
struct wave {};
struct wave_end {};
}  // namespace mt_stage

template <typename Stage>
__global__ void metrics_tpu_torch_mark() {}

namespace {

template <typename Stage>
cudaError_t launch_mark(cudaStream_t stream) {
  metrics_tpu_torch_mark<Stage><<<1, 1, 0, stream>>>();
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// stage: the index of the stage in MARK_STAGES (format, update, end, wave,
// wave_end). Records into a graph while the stream captures.
int mt_mark(int device, int stage, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0: return static_cast<int>(launch_mark<mt_stage::format>(s));
    case 1: return static_cast<int>(launch_mark<mt_stage::update>(s));
    case 2: return static_cast<int>(launch_mark<mt_stage::end>(s));
    case 3: return static_cast<int>(launch_mark<mt_stage::wave>(s));
    case 4: return static_cast<int>(launch_mark<mt_stage::wave_end>(s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
