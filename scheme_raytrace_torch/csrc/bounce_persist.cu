// bounce_persist.cu — T iterations of the strided pool in one launch, for
// sm_90a: the persistent-state pool kernel.
//
// Replaces the Pallas TPU kernel
//     scheme_raytrace_tpu/integrator/persist.py:_make_call (body _kernel)
// with the coverage of bounce_step.cu (rects, spheres, kleins, bezier
// ribbons, media, every texture kind), built per feature set as it is.  It
// takes the packed pool state (bounce_packed.cu's [N_PACKED, m] float32
// layout) and returns the state after T iterations, the T flush rows
// ([T, 4, m] float32: the finished path's pixel as int32 bits, -1 where the
// lane finished no path, then its radiance, 0 there) and the per-iteration
// count of live lanes ([T] int32: the segments traced).  Its plain PyTorch
// twin is scheme_raytrace_torch/integrator/persist.py:chunk_plain.
//
// Design, for the GPU rather than copied from the TPU grid.  The TPU kernel
// is a grid of T sequential steps over one VMEM-resident block of the whole
// pool.  Here lanes are independent, so each thread owns one lane: it loads
// the lane's 16 state words into registers once, runs T iterations of
// packed_step (bounce_common.cuh: the pixel and RNG key of the work item,
// bounce_lane, the strided re-issue), writes its flush words as each
// iteration ends, and writes the state once at the end.  Nothing crosses
// lanes but the segment count: each block counts its live lanes with
// __syncthreads_count and adds the count to seg[t] with an integer
// atomicAdd, which is exact in any order, so the count is deterministic.
// Drained lanes (item >= n_work) run no-op iterations, as in the reference.
//
// Bitwise equal to T launches of bounce_packed.cu.  The iteration is the
// same packed_step.  Between iterations the carried state (time included,
// which feeds the moving spheres' centres) passes through an empty asm
// statement (opaque), so the compiler sees it as K3 does, as values loaded
// from memory: no mul of one iteration is contracted with an add of the
// next into an FMA.
//
// What bounds it on an H100.  Per iteration a lane does K1's work (~1 kflop
// on Cornell, ~10 kflop with 227 spheres) and writes 4 flush words (1 MB per iteration at m = 65,536); the state moves
// once per launch.  A warp runs until its slowest lane's T paths are done
// with their iterations; paths of different lengths diverge in the shading
// branches.  Compute and divergence, not bandwidth, are the expected
// limit; PERF.md holds what was measured.

#include "bounce_common.cuh"

namespace {

struct PersistParams {
  const float* pk;
  const int32_t* sample_base;   // [1], on the device
  const float* st_in;           // [N_PACKED, m]
  float* st_out;                // [N_PACKED, m]
  float* flush;                 // [T, 4, m]
  int32_t* seg;                 // [T], zeroed by the caller
  const float* atlas;           // image texels; null without images
  int T;
  Statics s;
  Queue q;
  float t_min, t_max;
};

// Hide x's origin from the optimiser (see the header comment).
__device__ __forceinline__ void opaque(float& x) {
  asm volatile("" : "+f"(x));
}

__global__ void __launch_bounds__(kThreads)
bounce_persist_kernel(const PersistParams prm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int m = prm.q.m;
  const bool lane = i < m;          // every thread reaches the block count
  const int32_t sample_base = __ldg(prm.sample_base);
  float v[N_PACKED];
#pragma unroll
  for (int k = 0; k < N_PACKED; ++k)
    v[k] = lane ? prm.st_in[size_t(k) * m + i] : 0.0f;
  for (int t = 0; t < prm.T; ++t) {
    bool alive = false;
    if (lane) {
#pragma unroll
      for (int k = 0; k < N_PACKED; ++k) opaque(v[k]);
      bool terminated;
      int pix;
      alive = packed_step(prm.pk, prm.atlas, prm.s, prm.t_min, prm.t_max, prm.q,
                          sample_base, v, terminated, pix);
      float* f = prm.flush + size_t(t) * 4 * m + i;
      f[0] = __int_as_float(terminated ? pix : -1);
      f[m] = terminated ? v[10] : 0.0f;
      f[2 * m] = terminated ? v[11] : 0.0f;
      f[3 * m] = terminated ? v[12] : 0.0f;
    }
    const int live = __syncthreads_count(alive);
    if (threadIdx.x == 0 && live) atomicAdd(prm.seg + t, live);
  }
  if (lane) {
#pragma unroll
    for (int k = 0; k < N_PACKED; ++k) prm.st_out[size_t(k) * m + i] = v[k];
  }
}

}  // namespace

// C interface, loaded with ctypes by integrator/persist.py:chunk_cuda.
// ptrs: 7 device pointers — pk, sample_base ([1] int32), the state in and
// the state out ([N_PACKED, m] float32 each), the flush rows ([T, 4, m]
// float32), the segment counts ([T] int32, zeroed by the caller) and the
// image texel atlas (null when img_rows is 0).  Launches on `stream`
// without synchronising and returns cudaGetLastError() (0 = launched).
extern "C" int srt_bounce_persist(void* const* ptrs, int T, int m,
                                  int n_work, int n_pix, int pix0,
                                  int total_pix, SRT_SCENE_PARAMS,
                                  void* stream) {
  if (m <= 0 || T <= 0) return 0;
  PersistParams prm;
  prm.pk = static_cast<const float*>(ptrs[0]);
  prm.sample_base = static_cast<const int32_t*>(ptrs[1]);
  prm.st_in = static_cast<const float*>(ptrs[2]);
  prm.st_out = static_cast<float*>(ptrs[3]);
  prm.flush = static_cast<float*>(ptrs[4]);
  prm.seg = static_cast<int32_t*>(ptrs[5]);
  prm.atlas = static_cast<const float*>(ptrs[6]);
  prm.T = T;
  prm.s = SRT_STATICS(m);
  if (!features_cover(prm.s)) return int(cudaErrorInvalidValue);
  prm.q = Queue{m, n_work, n_pix, pix0, total_pix};
  prm.t_min = float(t_min);
  prm.t_max = float(t_max);
  const int blocks = (m + kThreads - 1) / kThreads;
  bounce_persist_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(
                                                   stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}
