// The class-span Bernoulli update of the graph-sharded Gibbs sweep for
// Hopper (sm_90a): kernel K4.
//
// Replaces the Pallas TPU kernels of
// image_generation_tpu/ops/gibbs_graph_sharded_pallas.py: _update_hw_kernel
// (hardware PRNG seeded per row tile), _update_hw_rowseed_kernel (re-seeded
// per 8-row group from global row ids) and _update_fed_kernel (fed
// uniforms), built by make_pallas_update.  The graph-sharded sweep
// (ops/gibbs_graph_sharded.py) computes each rank's partial fields of a
// color-class span with a matrix product, all-reduces them over the graph
// axis and adds h; this kernel then turns the span's fields into new spins:
//
//     p   = sigmoid(-2 * beta_row * fields)
//     out = u < p ? +1 : -1                         (f32, like the TPU kernel)
//
// Fields arrive f32 in real units whatever the coupling form (dense f32 or
// bf16, int8 scaled out after the all-reduce, packed panels), so one kernel
// serves every composition.  beta is per chain row or one scalar.
//
// Uniforms: fed (a (rows, width) f32 view with leading dimension ld_u, the
// span's columns of the sweep's (n_sweeps, chains, n_pad) array), or drawn
// from Philox4x32-10 keyed by the run's 64-bit seed with the counter
// (global column, global chain row, sweep, 0) and u = (bits >> 8) * 2^-24:
// the counter layout of K1 (gibbs_common.cuh), so gibbs_cuda.philox_uniforms
// is this kernel's numpy twin too.  The span is implied by the column, so
// the stream does not depend on how the mesh splits rows or columns: every
// rank of a graph axis draws the same update from the same seed (which the
// agreement of the ranks requires), and a run on another mesh draws the
// same chain.  That covers both TPU variants, so PLRNG_ROW_SEED selects
// nothing here.
//
// What bounds it on the H100.  Elementwise: 4 B of fields in and 4 B of
// spins out per element (plus 4 B of uniforms when fed), ~40 integer
// operations of Philox and one expf per element.  At the scaled slice's
// shape (2,048 chain rows x a class span of up to ~1,000 columns) that is
// a few MB a launch, a few microseconds at 3.35 TB/s: memory-bound, and at
// these sizes launch-bound.  One thread per element, threads of a warp on
// neighbouring columns (coalesced loads and stores), a 2-D grid of
// (column tiles, row slices).
//
// C interface (bound with ctypes by ops/gibbs_graph_sharded_cuda.py); each
// entry returns a cudaError_t (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "gibbs_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowBlocks = 65535;

__global__ void span_update_kernel(const float* __restrict__ fields,
                                   const float* __restrict__ beta,
                                   int beta_per_row,
                                   const float* __restrict__ uniforms,
                                   long long ld_u,
                                   const int64_t* __restrict__ seed,
                                   float* __restrict__ out, int rows,
                                   int width, int row0, int col0, int sweep) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= width) return;
  uint32_t key0 = 0u, key1 = 0u;
  if (uniforms == nullptr) {
    const uint64_t s = static_cast<uint64_t>(*seed);
    key0 = static_cast<uint32_t>(s);
    key1 = static_cast<uint32_t>(s >> 32);
  }
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const size_t i = static_cast<size_t>(r) * width + c;
    const float neg2beta = -2.0f * beta[beta_per_row ? r : 0];
    const float x = neg2beta * fields[i];
    const float p = 1.0f / (1.0f + expf(-x));
    float u;
    if (uniforms != nullptr) {
      u = uniforms[static_cast<size_t>(r) * ld_u + c];
    } else {
      const uint32_t bits = philox4x32_10(static_cast<uint32_t>(col0 + c),
                                          static_cast<uint32_t>(row0 + r),
                                          static_cast<uint32_t>(sweep), 0u,
                                          key0, key1);
      u = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
    }
    out[i] = u < p ? 1.0f : -1.0f;
  }
}

}  // namespace

extern "C" {

const char* span_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int span_update_threads() { return kThreads; }

// fields, out: (rows, width) f32, contiguous.  beta: (rows,) f32 when
// beta_per_row, else one f32.  Exactly one of uniforms (fed, rows of ld_u
// floats) and seed (one int64 on the device: Philox) is non-null.  row0 /
// col0: the global chain row / padded column of element (0, 0); sweep: the
// sweep index of the counter.
int span_update(const float* fields, const float* beta, int beta_per_row,
                const float* uniforms, long long ld_u, const int64_t* seed,
                float* out, int rows, int width, int row0, int col0, int sweep,
                void* stream) {
  if (rows < 1 || width < 1 || row0 < 0 || col0 < 0 || sweep < 0 ||
      (uniforms == nullptr) == (seed == nullptr) ||
      (uniforms != nullptr && ld_u < width)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((width + kThreads - 1) / kThreads,
                  rows < kMaxRowBlocks ? rows : kMaxRowBlocks);
  span_update_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      fields, beta, beta_per_row, uniforms, ld_u, seed, out, rows, width,
      row0, col0, sweep);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
