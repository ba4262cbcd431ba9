// bounce_packed.cu — one iteration of the strided pool on the packed pool
// state, for sm_90a.
//
// Replaces the Pallas TPU kernel
//     scheme_raytrace_tpu/integrator/bounce.py:as_pallas_packed
// with the coverage of bounce_step.cu (rects, spheres, kleins, bezier
// ribbons, media, every texture kind), built per feature set as it is: one bounce of every
// lane plus the strided work re-issue (a lane whose path terminates takes the
// item m further on), on the whole pool state held in one [N_PACKED, m]
// float32 array with the int fields stored as their bits.
// Its plain PyTorch twin is scheme_raytrace_torch/integrator/
// bounce.py:step_packed, built on the plain step.
//
// Design.  One thread per lane, 256 threads per block.  A thread reads its
// lane's 16 state words (one per row, so neighbouring threads read
// neighbouring addresses), runs packed_step (bounce_common.cuh: the work
// item's pixel and RNG key, bounce_lane, the re-issue) and writes the 16
// words of the new state.  The input is not aliased to the output, as in
// the reference (one buffer in, one out).  The TPU kernel's (16 * rows,
// 128) buffer is the same memory as the [16, m] array, row group for row
// group.  K1 (bounce_step.cu) and the persistent kernel (bounce_persist.cu)
// run the same lane body, so the three trace the same paths from the same
// inputs.  float32 only, as the reference.
//
// What bounds it on an H100.  A lane moves 32 words of 4 B (8.4 MB at
// m = 65,536, about 2.5 us at 3.35 TB/s), fewer than K1's 33 columns, and
// computes what K1 computes: bytes bound it on Cornell, the sphere sweep's
// operations on a scene of hundreds of spheres.  PERF.md holds what was
// measured.

#include "bounce_common.cuh"

namespace {

struct PackedParams {
  const float* pk;
  const int32_t* sample_base;   // [1], on the device
  const float* st_in;           // [N_PACKED, m]
  float* st_out;                // [N_PACKED, m]
  const float* atlas;           // image texels; null without images
  Statics s;
  Queue q;
  float t_min, t_max;
};

__global__ void __launch_bounds__(kThreads)
bounce_packed_kernel(const PackedParams prm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int m = prm.q.m;
  if (i >= m) return;
  float v[N_PACKED];
#pragma unroll
  for (int k = 0; k < N_PACKED; ++k) v[k] = prm.st_in[size_t(k) * m + i];
  bool terminated;
  int pix;
  packed_step(prm.pk, prm.atlas, prm.s, prm.t_min, prm.t_max, prm.q,
              __ldg(prm.sample_base), v, terminated, pix);
#pragma unroll
  for (int k = 0; k < N_PACKED; ++k) prm.st_out[size_t(k) * m + i] = v[k];
}

}  // namespace

// C interface, loaded with ctypes by integrator/bounce.py:step_packed_cuda.
// ptrs: 5 device pointers — pk, sample_base ([1] int32), the state in and
// the state out ([N_PACKED, m] float32 each), the image texel atlas (null
// when img_rows is 0).  Launches on `stream` without synchronising and
// returns cudaGetLastError() (0 = launched).
extern "C" int srt_bounce_packed(void* const* ptrs, int m, int n_work,
                                 int n_pix, int pix0, int total_pix,
                                 SRT_SCENE_PARAMS, void* stream) {
  if (m <= 0) return 0;
  PackedParams prm;
  prm.pk = static_cast<const float*>(ptrs[0]);
  prm.sample_base = static_cast<const int32_t*>(ptrs[1]);
  prm.st_in = static_cast<const float*>(ptrs[2]);
  prm.st_out = static_cast<float*>(ptrs[3]);
  prm.atlas = static_cast<const float*>(ptrs[4]);
  prm.s = SRT_STATICS(m);
  if (!features_cover(prm.s)) return int(cudaErrorInvalidValue);
  prm.q = Queue{m, n_work, n_pix, pix0, total_pix};
  prm.t_min = float(t_min);
  prm.t_max = float(t_max);
  const int blocks = (m + kThreads - 1) / kThreads;
  bounce_packed_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(
                                                  stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}
