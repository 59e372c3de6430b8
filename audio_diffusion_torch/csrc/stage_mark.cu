// Stage marks: an empty kernel launched at each stage boundary of the fused
// request's CUDA graph (pipelines/pipeline.py::_segment), so that a device
// trace shows where the denoise, the VAE decode and the mel inversion begin
// and end inside one graph replay. It replaces no TPU kernel: the JAX package
// has no such mark. Each boundary k is its own instantiation, named
// adt_stage_mark<k> in a trace:
//   0  the request's start, before the input prep and the denoise
//   1  the denoise's end
//   2  the end of the VAE decode and the uint8 postprocess
//   3  the end of NNLS + Griffin-Lim [+ int16 PCM]
// One thread, no memory read or written: a launch costs the card a few µs.
#include <cuda_runtime.h>

template <int K>
__global__ void adt_stage_mark() {}

// k in 0..3, launched on the given stream. Returns cudaGetLastError().
extern "C" int adt_stage_mark_launch(int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 0: adt_stage_mark<0><<<1, 1, 0, s>>>(); break;
    case 1: adt_stage_mark<1><<<1, 1, 0, s>>>(); break;
    case 2: adt_stage_mark<2><<<1, 1, 0, s>>>(); break;
    case 3: adt_stage_mark<3><<<1, 1, 0, s>>>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
