// probe_loops.cu — the loop-form probes, for sm_90a.
//
// Replaces the Pallas TPU kernel of
//     tools/repro_mosaic_crash.py (build, the nine case_* bodies)
// which reproduced the Mosaic compiler crashes of certain loop forms.  Here
// the same nine forms run in one kernel, one case per launch or every case in
// one launch: a counted loop, nested counted loops, a five-value carry with a
// mask, the forward-mode tangent of a loop (written by hand: CUDA has no
// jvp), float and bool carries in nested loops, a bool carried as an int, and
// an early-exit while loop whose condition is a cross-lane any() (here over
// the block, with __syncthreads_or).  These are the loop shapes of the rect
// sweep and the light loop.  Two extension cases follow the nine, which the
// JAX tool does not have: the loop form of the bezier probe (bounce_common.cuh
// bezier_probe), a loop over seeds, each a fixed count of guarded, clipped
// Newton steps on g'(s) = 0, then an accept test and a running minimum; and
// that of the klein march (klein_march), a bounded sphere trace whose lane
// retires on its own (an accept, backward-stuck, or past a bound) around an
// inner inversion loop that the lane leaves when its point escapes.  The
// plain PyTorch twins are scheme_raytrace_torch/tools/probe_loops.py:CASES
// and EXT_CASES.
//
// Design.  One thread per element of the (64, 128) float32 input, in blocks
// of kLoopThreads = 128 threads.  `which` >= 0 runs one case over the n
// elements (the yardstick of the one launch, and each case's own time).
// `which` = -1 runs every case in one launch into an (N_CASES, n) output,
// rows in the order of the Case enum: the grid is 2-D, blockIdx.y picks the
// case (through kIssueOrder, the longest chains first, so that their blocks
// are issued before the short ones) and blockIdx.x the block of elements.
// At 128 threads a case spans 64 blocks and the launch 704; at most 16 such
// blocks sit on an SM (2,048 threads), and 704 / 132 SMs is 5.3, so every
// block is resident in one wave, and each SM holds warps of several cases
// whose independent chains hide each other's latency.  Launched one case at
// a time, the cases would run one after another, each on 64 blocks: 68 of
// the 132 SMs idle, and one case's chains on each of the others.
//
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn): the
// masks compare carried values against thresholds (a*a < 4, a2 > 100), and
// an FMA contracted by nvcc could flip a lane away from the plain version,
// which rounds each op.  So every case is bitwise equal to its plain version,
// in either launch.
//
// The early-exit loop (WHILE_ANY) takes its any() over the block, with
// __syncthreads_or, which sees only the threads of one case: a block never
// spans two cases, since blockIdx.y alone picks the case.  The value of an
// element does not depend on how the any() groups the elements.  An element
// not yet done keeps its own group's any() true, so it iterates until it is
// done or k = 100, whatever the others do; a done element is frozen (a stays,
// done stays 1), so the iterations its group runs after it are no-ops for it.
// Hence blocks of 128 give what blocks of 256 and the JAX tool's whole-array
// jnp.any give (tests/test_torch_probes.py holds the three groupings equal on
// the CPU).
//
// What bounds it.  Each case reads its 32 KB input once and writes 32 KB
// once, with no reuse and no matrix product: shared memory, the tensor cores
// and TMA have no part here.  The bound of chip_smoke.bound is the float
// operations over the card's 67 TFLOP/s; but the bitwise rule forbids FMA,
// so an unfused multiply and add issue as two instructions and the reachable
// float32 rate is half of that.  Below both lies the kernel's real limit, the
// longest dependent chain: FORI_CARRY5's 1,000 iterations, each a product,
// a sum, a compare and a select on the carry `a` (four dependent
// instructions), which no spread over the SMs shortens.  The one launch
// lasts about as long as its slowest chain, where eleven launches would add
// theirs.

#include "bounce_common.cuh"

namespace {

__device__ __forceinline__ float fm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fa(float a, float b) { return __fadd_rn(a, b); }

// The cases, in the order of tools/repro_mosaic_crash.py:CASES.
enum Case {
  FORI, NESTED_FORI, FORI_CARRY5, JVP_FORI, NESTED_FLOAT_CARRY,
  SINGLE_BOOL_CARRY, NESTED_BOOL_CARRY, BOOL_CARRY_AS_I32, WHILE_ANY,
  BEZIER_SEEDS,      // the extension: tools/probe_loops.py:EXT_CASES
  KLEIN_MARCH,
  N_CASES
};

// Threads a block (see Design).
constexpr int kLoopThreads = 128;

// The case of each row of the one launch's grid (blockIdx.y), the longest
// dependent chains first: the block scheduler issues the lower rows first.
__constant__ int kIssueOrder[N_CASES] = {
    FORI_CARRY5, NESTED_BOOL_CARRY, NESTED_FLOAT_CARRY, NESTED_FORI,
    KLEIN_MARCH, BEZIER_SEEDS, WHILE_ANY, FORI, JVP_FORI, SINGLE_BOOL_CARRY,
    BOOL_CARRY_AS_I32};

// The extension's seeds and Newton steps a seed (probe_loops.py BEZ_SEEDS,
// BEZ_NEWTON).
constexpr int kBezSeeds = 8;
constexpr int kBezNewton = 4;
// The klein loop form's march steps and inversions a step at most
// (probe_loops.py KLEIN_STEPS, KLEIN_ITERS); its two inversion spheres'
// centres and r^2 (KLEIN_SPHERES, KLEIN_R2).
constexpr int kKlSteps = 40;
constexpr int kKlIters = 6;
__device__ __forceinline__ float klein_centre(int i) {
  return i == 0 ? -1.0f : 2.0f;
}
constexpr float kKlR2 = 0.36f;

// a * 1.1 + 0.1 where a * a < 4 (the masked update of the bool carries)
__device__ __forceinline__ void masked_step(float& a, bool& e) {
  const bool m = fm(a, a) < 4.0f;
  a = m ? fa(fm(a, 1.1f), 0.1f) : a;
  e = e && m;
}

__device__ float run_case(int which, float x) {
  switch (which) {
    case FORI: {
      float a = x;
      for (int i = 0; i < 100; ++i) a = fa(fm(a, 1.0001f), 0.1f);
      return a;
    }
    case NESTED_FORI: {
      float a = x;
      for (int i = 0; i < 100; ++i)
        for (int j = 0; j < 10; ++j) a = fa(fm(a, 1.0001f), 0.1f);
      return a;
    }
    case FORI_CARRY5: {
      float a = x, b = fa(x, 1.0f), c = fa(x, 2.0f), d = fa(x, 3.0f);
      bool e = x > 0.0f;
      for (int i = 0; i < 100; ++i)
        for (int j = 0; j < 10; ++j) {
          const bool m = fa(fm(a, a), fm(b, b)) < 4.0f;
          a = m ? fa(fm(a, 1.1f), 0.1f) : a;
          b = m ? fm(b, 0.9f) : b;
          d = m ? fm(d, 1.01f) : d;
          e = e && m;
        }
      return fa(fa(fa(fa(a, b), c), d), e ? 1.0f : 0.0f);
    }
    case JVP_FORI: {
      // f(t) = fori(10, b -> b * t + 0.1, t); returns f(x) + f'(x), the
      // tangent carried beside the value: d(b t) = db t + b dt, dt = 1
      const float t = x;
      float b = t, db = 1.0f;
      for (int j = 0; j < 10; ++j) {
        db = fa(fm(db, t), b);
        b = fa(fm(b, t), 0.1f);
      }
      return fa(b, db);
    }
    case NESTED_FLOAT_CARRY: {
      float a = x, b = fa(x, 1.0f);
      for (int i = 0; i < 100; ++i)
        for (int j = 0; j < 10; ++j) {
          const bool m = fm(a, a) < 4.0f;
          a = m ? fm(a, 1.1f) : a;
          b = m ? fm(b, 0.9f) : b;
        }
      return fa(a, b);
    }
    case SINGLE_BOOL_CARRY: {
      float a = x;
      bool e = x > 0.0f;
      for (int j = 0; j < 10; ++j) masked_step(a, e);
      return fa(a, e ? 1.0f : 0.0f);
    }
    case NESTED_BOOL_CARRY: {
      float a = x;
      bool e = x > 0.0f;
      for (int i = 0; i < 100; ++i)
        for (int j = 0; j < 10; ++j) masked_step(a, e);
      return fa(a, e ? 1.0f : 0.0f);
    }
    case BOOL_CARRY_AS_I32: {
      float a = x;
      int e = x > 0.0f ? 1 : 0;
      for (int j = 0; j < 10; ++j) {
        bool eb = e != 0;
        masked_step(a, eb);
        e = eb ? 1 : 0;
      }
      return fa(a, float(e));
    }
    case BEZIER_SEEDS: {
      // the curve c(s) = (s s - a, (s - 0.5) / 2) across a ray, a = x / 4:
      // Newton on g' = 0 for g = |c|^2 from kBezSeeds seeds, the ribbon hit
      // where g < 0.04 at distance 1 + s, the closest over the seeds
      const float a = fm(x, 0.25f);
      float best = 100.0f;
      for (int k = 0; k < kBezSeeds; ++k) {
        float s = fm(float(k) + 0.5f, 1.0f / float(kBezSeeds));
        float cx, cy;
        for (int it = 0; it <= kBezNewton; ++it) {
          cx = fa(fm(s, s), -a);
          cy = fm(fa(s, -0.5f), 0.5f);
          if (it == kBezNewton) break;          // g at the converged s
          const float cx1 = fm(s, 2.0f);
          const float dg = fm(fa(fm(cx, cx1), fm(cy, 0.5f)), 2.0f);
          const float d2g =
              fa(fm(fa(fm(cx1, cx1), 0.25f), 2.0f), fm(cx, 4.0f));
          const float stepn = d2g > 1e-12f ? dg / d2g : 0.0f;
          s = fa(s, -stepn);
          s = s < 0.0f ? 0.0f : s;
          s = s > 1.0f ? 1.0f : s;
        }
        const float g = fa(fm(cx, cx), fm(cy, cy));
        const float zc = g < 0.04f ? fa(1.0f, s) : 100.0f;
        best = zc < best ? zc : best;
      }
      return best;
    }
    case KLEIN_MARCH: {
      // from x along +1: the estimate 0.5 (|P| - 0.3) / |dr| after up to
      // kKlIters inversions (the first sphere holding the point), an
      // accept under 1e-3 past 1e-3, retired stuck or past 6
      float len = 0.0f;
      for (int k = 0; k < kKlSteps; ++k) {
        float p = fa(x, len), dr = 1.0f;
        for (int it = 0; it < kKlIters; ++it) {
          bool found = false;
          for (int i = 0; i < 2; ++i) {
            const float q = fa(p, -klein_centre(i));
            const float q2 = fm(q, q);
            if (q2 < kKlR2) {
              const float sc = kKlR2 / (q2 < 1.17549435e-38f
                                               ? 1.17549435e-38f : q2);
              p = fa(fm(q, sc), klein_centre(i));
              dr = fm(dr, sc);
              found = true;
              break;
            }
          }
          if (!found) break;
        }
        const float dist = fm(fa(fabsf(p), -0.3f), 0.5f) / fabsf(dr);
        const float new_len = fa(len, dist);
        if (dist < 1e-3f && new_len > 1e-3f) return new_len;
        const bool stuck = dist <= 0.0f && len <= 1e-3f;
        len = new_len;
        if (stuck || fa(x, len) > 6.0f) return 100.0f;
      }
      return 100.0f;
    }
  }
  return 0.0f;
}

__global__ void __launch_bounds__(kLoopThreads)
probe_loops_kernel(const float* __restrict__ x, float* __restrict__ out,
                   int n, int which) {
  // which < 0: every case, blockIdx.y picking it and its row of the output
  const int c = which < 0 ? kIssueOrder[blockIdx.y] : which;
  float* __restrict__ row = which < 0 ? out + size_t(c) * n : out;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (c == WHILE_ANY) {
    // every thread of the block runs the loop: the condition is a
    // block-wide any() of the lanes not yet done
    float a = i < n ? x[i] : 0.0f;
    int done = i < n ? 0 : 1;
    for (int k = 0; __syncthreads_or(done == 0) && k < 100; ++k) {
      const float a2 = fa(fm(a, 1.3f), 0.1f);
      done |= a2 > 100.0f ? 1 : 0;
      a = done ? a : a2;
    }
    if (i < n) row[i] = a;
    return;
  }
  if (i < n) row[i] = run_case(c, x[i]);
}

}  // namespace

// C interface, loaded with ctypes by tools/probe_loops.py (loops_cuda,
// loops_cuda_all).  ptrs: 2 device pointers — the n float32 inputs and the
// outputs.  `which` is a case's index in CASES, or len(CASES) + its index in
// EXT_CASES, with n float32 outputs; or -1, every case in one launch, with
// (N_CASES, n) float32 outputs in ALL_CASES' order.  Launches on `stream`
// without synchronising and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for an unknown case.
extern "C" int srt_probe_loops(void* const* ptrs, int n, int which,
                               void* stream) {
  if (which < -1 || which >= N_CASES) return int(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const dim3 grid((n + kLoopThreads - 1) / kLoopThreads,
                  which < 0 ? N_CASES : 1);
  probe_loops_kernel<<<grid, kLoopThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ptrs[0]), static_cast<float*>(ptrs[1]), n,
      which);
  return static_cast<int>(cudaGetLastError());
}
