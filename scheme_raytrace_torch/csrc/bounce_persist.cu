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
// pool.  Here lanes are independent, so each lane is owned by a tile of w
// consecutive threads of a warp (w = 1, 2, 4 or 8, a kernel argument:
// integrator/persist.py tile_width), 256 threads per block, lane_blocks(m,
// w) blocks, as K1 and K3 run.  Every thread of a tile loads the lane's 16
// state words into registers once and runs T iterations of packed_step
// (bounce_common.cuh: the pixel and RNG key of the work item, bounce_lane
// with the closest-hit sweeps split over the tile, the strided re-issue) on
// the same values; the tile's first thread writes the flush words as each
// iteration ends and the state once at the end.  Drained lanes (item >=
// n_work) run no-op iterations, as in the reference.
//
// Nothing crosses lanes but the segment count, and nothing crosses warps
// inside the loop: each warp counts its tiles' live lanes with a ballot of
// the first threads' alive flags (threads past m vote false) and its lane
// 0 adds the count into the block's row of T counters in shared memory.
// After the loop one __syncthreads, then the block adds its T counts into
// seg with integer atomicAdds.  Integer sums are exact in any order, so the
// counts are deterministic.  With no block barrier in the loop a warp runs
// its T iterations at its own lanes' pace: the block takes the slowest
// warp's sum over the iterations, not the sum over the iterations of the
// slowest warp, which matters where a few lanes run long (a klein march at
// its 100-step cap, a ribbon hit beside misses).
//
// Bitwise equal to T launches of bounce_packed.cu at any w.  The iteration
// is the same packed_step.  Between iterations the carried state (time
// included, which feeds the moving spheres' centres) passes through an
// empty asm statement (opaque), so the compiler sees it as K3 does, as
// values loaded from memory: no mul of one iteration is contracted with an
// add of the next into an FMA.
//
// What bounds it on an H100.  Per iteration a lane does K1's work (~1 kflop
// on Cornell, ~10 kflop with 227 spheres, 17 k operations a ribbon) and
// writes 4 flush words (1 MB per iteration at m = 65,536); the state moves
// once per launch.  Compute and the chain of the slowest lanes, not
// bandwidth, are the limit.  A persistent block holds its SM for all T
// iterations, so a launch of more blocks than the card keeps resident (5, 4
// and 3 blocks of 256 an SM at 48, 64 and 80 registers) runs its extra
// blocks only after the first finish their whole chunk: the width rule
// (persist.py tile_width) keeps the launch within one wave unless the
// sweep shows more winning.  Measured on the H100 (PERF.md): the loop
// without its barrier, at w = 1, cut a chunk by 19% on klein, 5-8% on the
// ribbons and cornell_klein, under 5% elsewhere; the tile then cut RTOW
// 1.72 to 1.53 ms and Cornell 0.312 to 0.294 ms at w = 2, and the ribbons
// 6.24 to 5.63 ms at w = 4 (three waves at 80 registers).  The tile gains
// less than in K3, where one launch is one iteration: here different warps
// are at different iterations and already fill the SM between the slowest
// lanes' chains (RTOW at w = 1: 54 us an iteration against K3's 87 us).
//
// The klein marches' work, while a profiler records: persist.py passes a
// counter buffer then, and a null pointer otherwise.  A klein variant
// holds the kernel twice, counting (kCount) and not, and launches the
// counting one only for a buffer, so a frame that is not traced runs the
// same code as without the counters; a variant without kleins holds the
// other alone.  Each lane's march reports its marches, DE evaluations and
// capped marches (KleinWork); at each iteration's ballot, where the warp
// has reconverged, the warp sums them over its tiles' first threads and
// takes 32 times the most steps any of its lanes took (the warp's step
// slots, busy or idle); after the loop its lane 0 adds the four sums into
// the buffer with 64-bit integer atomics, exact in any order.

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
  // [4]: klein marches, steps, capped marches, warp step slots; added to;
  // null: nothing counted
  unsigned long long* klein;
  int T;
  int w;                        // threads a lane (the tile's width)
  Statics s;
  Queue q;
  float t_min, t_max;
};

// Hide x's origin from the optimiser (see the header comment).
__device__ __forceinline__ void opaque(float& x) {
  asm volatile("" : "+f"(x));
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads)
bounce_persist_kernel(const PersistParams prm) {
  extern __shared__ int32_t live[];   // [T]: the block's live lanes
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / prm.w;
  const int m = prm.q.m;
  const bool lane = i < m;          // every thread reaches the block's count
  const Tile tl = lane_tile(prm.w);
  const bool first = lane && tl.r == 0;
  for (int t = threadIdx.x; t < prm.T; t += blockDim.x) live[t] = 0;
  __syncthreads();
  KleinWork warp_kw;                // kCount: the warp's sums over the
  int warp_slots = 0;               // iterations
  const int32_t sample_base = __ldg(prm.sample_base);
  float v[N_PACKED];
#pragma unroll
  for (int k = 0; k < N_PACKED; ++k)
    v[k] = lane ? prm.st_in[size_t(k) * m + i] : 0.0f;
  for (int t = 0; t < prm.T; ++t) {
    bool alive = false;
    KleinWork kw;
    if (lane) {
#pragma unroll
      for (int k = 0; k < N_PACKED; ++k) opaque(v[k]);
      bool terminated;
      int pix;
      alive = packed_step(prm.pk, prm.atlas, prm.s, prm.t_min, prm.t_max, prm.q,
                          sample_base, v, terminated, pix, tl,
                          kCount ? &kw : nullptr);
      if (first) {
        float* f = prm.flush + size_t(t) * 4 * m + i;
        f[0] = __int_as_float(terminated ? pix : -1);
        f[m] = terminated ? v[10] : 0.0f;
        f[2 * m] = terminated ? v[11] : 0.0f;
        f[3 * m] = terminated ? v[12] : 0.0f;
      }
    }
    const int n = __popc(__ballot_sync(kFullMask, first && alive));
    if ((threadIdx.x & 31) == 0 && n) atomicAdd(live + t, n);
    if constexpr (kCount) {
      const KleinWork c = first ? kw : KleinWork{};
      warp_kw.marches += __reduce_add_sync(kFullMask, c.marches);
      warp_kw.steps += __reduce_add_sync(kFullMask, c.steps);
      warp_kw.capped += __reduce_add_sync(kFullMask, c.capped);
      warp_slots += 32 * __reduce_max_sync(kFullMask, c.steps);
    }
  }
  if constexpr (kCount) {
    if ((threadIdx.x & 31) == 0 && warp_kw.marches) {
      atomicAdd(prm.klein, static_cast<unsigned long long>(warp_kw.marches));
      atomicAdd(prm.klein + 1, static_cast<unsigned long long>(warp_kw.steps));
      atomicAdd(prm.klein + 2,
                static_cast<unsigned long long>(warp_kw.capped));
      atomicAdd(prm.klein + 3, static_cast<unsigned long long>(warp_slots));
    }
  }
  if (first) {
#pragma unroll
    for (int k = 0; k < N_PACKED; ++k) prm.st_out[size_t(k) * m + i] = v[k];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < prm.T; t += blockDim.x)
    if (live[t]) atomicAdd(prm.seg + t, live[t]);
}

}  // namespace

// C interface, loaded with ctypes by integrator/persist.py:chunk_cuda.
// ptrs: 8 device pointers — pk, sample_base ([1] int32), the state in and
// the state out ([N_PACKED, m] float32 each), the flush rows ([T, 4, m]
// float32), the segment counts ([T] int32, zeroed by the caller), the
// image texel atlas (null when img_rows is 0) and the klein counters ([4]
// int64, added to; null: nothing counted).  w: threads a lane, a power
// of two from 1 to kMaxTile.  Launches on `stream` without synchronising,
// with T * 4 bytes of dynamic shared memory, and returns cudaGetLastError()
// (0 = launched), or cudaErrorInvalidValue for a plan that this variant's
// feature set does not cover or a w it does not take.
extern "C" int srt_bounce_persist(void* const* ptrs, int T, int w, int m,
                                  int n_work, int n_pix, int pix0,
                                  int total_pix, SRT_SCENE_PARAMS,
                                  void* stream) {
  if (m <= 0 || T <= 0) return 0;
  if (!tile_width_ok(w)) return int(cudaErrorInvalidValue);
  PersistParams prm;
  prm.pk = static_cast<const float*>(ptrs[0]);
  prm.sample_base = static_cast<const int32_t*>(ptrs[1]);
  prm.st_in = static_cast<const float*>(ptrs[2]);
  prm.st_out = static_cast<float*>(ptrs[3]);
  prm.flush = static_cast<float*>(ptrs[4]);
  prm.seg = static_cast<int32_t*>(ptrs[5]);
  prm.atlas = static_cast<const float*>(ptrs[6]);
  prm.klein = static_cast<unsigned long long*>(ptrs[7]);
  prm.T = T;
  prm.w = w;
  prm.s = SRT_STATICS(m);
  if (!features_cover(prm.s)) return int(cudaErrorInvalidValue);
  prm.q = Queue{m, n_work, n_pix, pix0, total_pix};
  prm.t_min = float(t_min);
  prm.t_max = float(t_max);
  const auto st = static_cast<cudaStream_t>(stream);
  if (kKleins && prm.klein != nullptr)
    bounce_persist_kernel<kKleins>
        <<<lane_blocks(m, w), kThreads, T * sizeof(int32_t), st>>>(prm);
  else
    bounce_persist_kernel<false>
        <<<lane_blocks(m, w), kThreads, T * sizeof(int32_t), st>>>(prm);
  return static_cast<int>(cudaGetLastError());
}
