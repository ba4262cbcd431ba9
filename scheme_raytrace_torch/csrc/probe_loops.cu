// probe_loops.cu — the loop-form probes, for sm_90a.
//
// Replaces the Pallas TPU kernel of
//     tools/repro_mosaic_crash.py (build, the nine case_* bodies)
// which reproduced the Mosaic compiler crashes of certain loop forms.  Here
// the same nine forms run in one kernel, one case per launch: a counted
// loop, nested counted loops, a five-value carry with a mask, the
// forward-mode tangent of a loop (written by hand: CUDA has no jvp), float
// and bool carries in nested loops, a bool carried as an int, and an
// early-exit while loop whose condition is a cross-lane any() (here over
// the block, with __syncthreads_or).  These are the loop shapes of the rect
// sweep and the light loop.  One extension case follows the nine, which the
// JAX tool does not have: the loop form of the bezier probe (bounce_common.cuh
// bezier_probe), a loop over seeds, each a fixed count of guarded, clipped
// Newton steps on g'(s) = 0, then an accept test and a running minimum.  The
// plain PyTorch twins are scheme_raytrace_torch/tools/probe_loops.py:CASES
// and EXT_CASES.
//
// Design.  One thread per element of the (64, 128) float32 input, 256
// threads per block.  Every product and sum is rounded on its own
// (__fmul_rn, __fadd_rn): the masks compare carried values against
// thresholds (a*a < 4, a2 > 100), and an FMA contracted by nvcc could flip
// a lane away from the plain version, which rounds each op.  So every case
// is bitwise equal to its plain version.
//
// What bounds it.  8,192 elements and up to 1,000 dependent iterations a
// thread: latency of the dependent chain, a few microseconds.

#include "bounce_common.cuh"

namespace {

__device__ __forceinline__ float fm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fa(float a, float b) { return __fadd_rn(a, b); }

// The cases, in the order of tools/repro_mosaic_crash.py:CASES.
enum Case {
  FORI, NESTED_FORI, FORI_CARRY5, JVP_FORI, NESTED_FLOAT_CARRY,
  SINGLE_BOOL_CARRY, NESTED_BOOL_CARRY, BOOL_CARRY_AS_I32, WHILE_ANY,
  BEZIER_SEEDS,      // the extension: tools/probe_loops.py:EXT_CASES
  N_CASES
};

// The extension's seeds and Newton steps a seed (probe_loops.py BEZ_SEEDS,
// BEZ_NEWTON).
constexpr int kBezSeeds = 8;
constexpr int kBezNewton = 4;

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
  }
  return 0.0f;
}

__global__ void __launch_bounds__(kThreads)
probe_loops_kernel(const float* __restrict__ x, float* __restrict__ out,
                   int n, int which) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (which == WHILE_ANY) {
    // every thread of the block runs the loop: the condition is a
    // block-wide any() of the lanes not yet done
    float a = i < n ? x[i] : 0.0f;
    int done = i < n ? 0 : 1;
    for (int k = 0; __syncthreads_or(done == 0) && k < 100; ++k) {
      const float a2 = fa(fm(a, 1.3f), 0.1f);
      done |= a2 > 100.0f ? 1 : 0;
      a = done ? a : a2;
    }
    if (i < n) out[i] = a;
    return;
  }
  if (i < n) out[i] = run_case(which, x[i]);
}

}  // namespace

// C interface, loaded with ctypes by tools/probe_loops.py:loops_cuda.
// ptrs: 2 device pointers — the n float32 inputs and the n float32 outputs;
// `which` is the case's index in CASES, or len(CASES) + its index in
// EXT_CASES.  Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for an unknown case.
extern "C" int srt_probe_loops(void* const* ptrs, int n, int which,
                               void* stream) {
  if (which < 0 || which >= N_CASES) return int(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  probe_loops_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ptrs[0]), static_cast<float*>(ptrs[1]), n,
      which);
  return static_cast<int>(cudaGetLastError());
}
