// probe_ops.cu — the op-support probe, for sm_90a.
//
// Replaces the Pallas TPU kernel of
//     tools/probe_pallas_ops.py (main, body `kernel`)
// which checked that Mosaic lowers the operations the bounce megakernel
// needs.  Here it checks that nvcc compiles them and that they give what
// PyTorch gives: int32 div/mod by constants, a uint32 PCG round, the
// float32 conversion of the top 24 bits, a scalar read of a packed vector,
// sin, cos, sqrt and pow, and a select.  Beside that output, which matches
// the JAX probe case for case, it writes the operations the textures and the
// media added to the bounce kernels (tools/probe_ops.py EXT_ROWS): floor of
// a negative float and its int32 conversion, that int32 read as uint32 and
// hashed, log, atan2 and rsqrt.  Its plain PyTorch twin is
// scheme_raytrace_torch/tools/probe_ops.py:probe_plain.
//
// Design.  One thread per item of the (8, 128) int32 array and per group of
// outputs, 256 threads per block: the grid's y picks the group, 0 the JAX
// probe's output and 1 the extension's five rows, and each thread computes
// its item's uniform (the int path) itself.  The int path follows jnp's
// operators: % and // round toward minus infinity (Python's rule), where C++
// truncates, so the remainder is moved into [0, npx).  The scalar comes from
// the (1, 16) float32 pack through the read-only cache.  The float path
// keeps nvcc's defaults (no --use_fast_math: IEEE sqrt, full-accuracy sin,
// cos and pow, mul+add contracted into FMA), as the bounce kernels do, so
// its outputs agree with the plain version to a few ulp, and the
// int-derived outputs (the extension's floor and hash rows among them)
// exactly.
//
// What bounds it.  1,024 items, 29 KB moved and some 120 operations an item:
// the bytes bound is a few nanoseconds, far under what the card takes to
// launch any kernel.  Three things set the time: the launch, the round trip
// of the item's read and the outputs' writes, and the longest chain of
// dependent operations a thread runs, since a launch of 4 blocks a group
// ends with its slowest thread.  The first two are measured by two kernels
// of K5's arguments and grid, launched through the same wrapper path
// (tools/probe_ops.py): srt_probe_empty, with an empty body (the launch
// floor), and srt_probe_copy, which reads K5's inputs and writes its outputs
// with no arithmetic between (the floor of a launch that moves K5's bytes);
// chip_smoke.py's probes phase times them in turns with K5.  The chain is
// what the design cuts: one thread an item would run the int path, then sin,
// cos, sqrt and pow, then floor, the hash, log, atan2 and rsqrt, one after
// the other; the two groups run theirs side by side, on other SMs, and the
// longest left is group 0's, the int path and its four transcendentals.

#include "bounce_common.cuh"

namespace {

// An item's uniform: int div/mod by constants (jnp's floor rules), a uint32
// PCG round, the top 24 bits as a float32 in [0, 1).  *xs is the pixel's x.
__device__ __forceinline__ float item_uniform(int32_t item, int32_t* xs) {
  const int32_t npx = 200 * 200;
  int32_t pix = item % npx;
  if (pix < 0) pix += npx;
  const int32_t ys = pix / 200;                 // pix >= 0: floor = trunc
  *xs = pix - ys * 200;
  uint32_t a = uint32_t(item);
  uint32_t b = uint32_t(ys + 1);
  a = a * PCG_MULT + PCG_ADD;
  b = b * PCG_MULT + PCG_ADD;
  a = a + b * a;
  a = a ^ (a >> 16);
  return float(int32_t(a >> 8)) * (1.0f / 16777216.0f);
}

__global__ void __launch_bounds__(kThreads)
probe_ops_kernel(const float* __restrict__ pack,
                 const int32_t* __restrict__ items, float* __restrict__ out,
                 float* __restrict__ ext, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t xs;
  const float u = item_uniform(items[i], &xs);
  if (blockIdx.y == 0) {
    // a scalar read, transcendentals and a select: the JAX probe's output
    const float k = __ldg(pack + 3);
    const float s = sinf(u * 6.28f) + cosf(u) + sqrtf(u + 1.0f);
    const float c = powf(u + 0.5f, 1.0f / 3.0f);
    out[i] = u < 0.5f ? s * k + c : float(xs);
    return;
  }
  // the extension: x in [-18.75, 18.75)
  const float x = (u - 0.5f) * 37.5f;
  const float fl = floorf(x);
  uint32_t h = uint32_t(int32_t(fl));           // int32 bits as uint32
  h = h * PCG_MULT + PCG_ADD;
  h = h ^ (h >> 16);
  ext[i] = fl;
  ext[n + i] = float(int32_t(h >> 8)) * (1.0f / 16777216.0f);
  ext[2 * n + i] = logf(u < 1.17549435e-38f ? 1.17549435e-38f : u);
  ext[3 * n + i] = atan2f(x, u - 0.25f);
  ext[4 * n + i] = rsqrtf(u + 0.25f);
}

// The launch floor: K5's arguments and grid, and no body.
__global__ void __launch_bounds__(kThreads)
probe_empty_kernel(const float* __restrict__, const int32_t* __restrict__,
                   float* __restrict__, float* __restrict__, int) {}

// The floor of a launch that moves K5's bytes: each thread reads what its
// K5 thread reads and writes what it writes, with no arithmetic between but
// the scalar's product.
__global__ void __launch_bounds__(kThreads)
probe_copy_kernel(const float* __restrict__ pack,
                  const int32_t* __restrict__ items, float* __restrict__ out,
                  float* __restrict__ ext, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = __int_as_float(items[i]);
  if (blockIdx.y == 0) {
    out[i] = v * __ldg(pack + 3);
    return;
  }
  for (int r = 0; r < 5; ++r) ext[r * n + i] = v;
}

// One launch of `kernel` on K5's grid: a block of kThreads items, and one
// such row of blocks a group.
template <typename Kernel>
int launch(Kernel kernel, void* const* ptrs, int n, void* stream) {
  if (n <= 0) return 0;
  kernel<<<dim3((n + kThreads - 1) / kThreads, 2), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ptrs[0]),
      static_cast<const int32_t*>(ptrs[1]), static_cast<float*>(ptrs[2]),
      static_cast<float*>(ptrs[3]), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes by tools/probe_ops.py (probe_cuda,
// empty_cuda, copy_cuda).  ptrs: 4 device pointers — the (1, 16) float32
// pack, the n int32 items, the n float32 outputs and the (5, n) float32
// extension rows.  Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 = launched).  srt_probe_empty and srt_probe_copy
// launch the two floors on the same grid; their outputs are not the probe's.
extern "C" int srt_probe_ops(void* const* ptrs, int n, void* stream) {
  return launch(probe_ops_kernel, ptrs, n, stream);
}

extern "C" int srt_probe_empty(void* const* ptrs, int n, void* stream) {
  return launch(probe_empty_kernel, ptrs, n, stream);
}

extern "C" int srt_probe_copy(void* const* ptrs, int n, void* stream) {
  return launch(probe_copy_kernel, ptrs, n, stream);
}
