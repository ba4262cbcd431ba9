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
// Design.  One thread per item of the (8, 128) int32 array, 256 threads per
// block; the scalar comes from the (1, 16) float32 pack through the
// read-only cache.  The int path follows jnp's operators: % and // round
// toward minus infinity (Python's rule), where C++ truncates, so the
// remainder is moved into [0, npx).  The float path keeps nvcc's defaults
// (no --use_fast_math: IEEE sqrt, full-accuracy sin, cos and pow, mul+add
// contracted into FMA), so its outputs agree with the plain version to a
// few ulp, and the int-derived outputs (the extension's floor and hash rows
// among them) exactly.
//
// What bounds it.  1,024 items: one launch's latency.

#include "bounce_common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
probe_ops_kernel(const float* __restrict__ pack,
                 const int32_t* __restrict__ items, float* __restrict__ out,
                 float* __restrict__ ext, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t item = items[i];
  // int div/mod by constants (jnp's floor rules)
  const int32_t npx = 200 * 200;
  int32_t pix = item % npx;
  if (pix < 0) pix += npx;
  const int32_t ys = pix / 200;                 // pix >= 0: floor = trunc
  const int32_t xs = pix - ys * 200;
  // a uint32 PCG round
  uint32_t a = uint32_t(item);
  uint32_t b = uint32_t(ys + 1);
  a = a * PCG_MULT + PCG_ADD;
  b = b * PCG_MULT + PCG_ADD;
  a = a + b * a;
  a = a ^ (a >> 16);
  const float u = float(int32_t(a >> 8)) * (1.0f / 16777216.0f);
  // a scalar read
  const float k = __ldg(pack + 3);
  // transcendentals
  const float s = sinf(u * 6.28f) + cosf(u) + sqrtf(u + 1.0f);
  const float c = powf(u + 0.5f, 1.0f / 3.0f);
  // a select
  out[i] = u < 0.5f ? s * k + c : float(xs);
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

}  // namespace

// C interface, loaded with ctypes by tools/probe_ops.py:probe_cuda.
// ptrs: 4 device pointers — the (1, 16) float32 pack, the n int32 items, the
// n float32 outputs and the (5, n) float32 extension rows.  Launches on
// `stream` without synchronising and returns cudaGetLastError()
// (0 = launched).
extern "C" int srt_probe_ops(void* const* ptrs, int n, void* stream) {
  if (n <= 0) return 0;
  probe_ops_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ptrs[0]),
      static_cast<const int32_t*>(ptrs[1]), static_cast<float*>(ptrs[2]),
      static_cast<float*>(ptrs[3]), n);
  return static_cast<int>(cudaGetLastError());
}
