// Fused multi-sweep colored block-Gibbs for Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernel image_generation_tpu/ops/gibbs_pallas.py
// (_kernel, _kernel_fed and their shared body _color_update).  It computes
// exactly what they compute: n_sweeps sweeps, each updating the color
// blocks of the plan in order,
//
//     fields = S[:, :] @ A[:, c0:c1] + h[c0:c1]      (f32 accumulation)
//     p      = sigmoid(-2 * beta_chain * fields)
//     S[:, c0:c1] = u < p ? +1 : -1
//
// with u either fed in ((n_sweeps, chains, n_pad) f32, read at
// [sweep, row, column] like _kernel_fed) or drawn in the kernel from a
// Philox4x32-10 keyed by a 64-bit seed with the counter (column, global
// chain row, sweep, 0), so the stream does not depend on the block size;
// u = (bits >> 8) * 2^-24, as on the TPU.
//
// Energy carry (the Pallas kernels' de_ref, _color_update's track mode,
// which parallel tempering uses to carry ladder energies across rounds):
// with a non-null delta_e the kernel also writes, per chain, the energy
// change of the run, sum over sweeps and color blocks of
// fields . (new - old), with fields = S @ A[:, c0:c1] + h[c0:c1] (beta
// excluded) and old the spin before the color step.  A color block has no
// intra-block couplings, so that sum is exactly E(out) - E(in).  Each
// thread keeps R partial sums in registers over the whole run (its own
// columns); the block reduces them once at the end (warp shuffles, then
// one shared-memory pass).  The summation order differs from the plain
// version's (per block, then per sweep), so the two agree to f32
// rounding.  Padding columns have h = 0 and zero coupling: they add 0.
//
// What bounds it on the H100.  The serving shape is C = 256 * bucket
// chains over n_pad = 640 padded spins, 80 sweeps: 2*C*n_pad^2 FLOP per
// sweep, 16.8 GFLOP for a 256-image request, at about 1 FLOP per byte of
// coupling read.  The TPU kernel held the whole coupling (1.64 MB in f32)
// in VMEM; a Hopper block has 227 KB of shared memory, so here the
// coupling stays in global memory and lives in the 50 MB L2, and every
// color step streams its column panel A[:, c0:c1] from there, coalesced
// across columns.  The chains are independent: one thread block owns R
// chain rows and keeps their spins in shared memory for the whole run
// (R * n_pad * 4 B, 20 KB at R = 8), plus a staging row block for the
// new spins of one color, so the fields of a color step are computed from
// the spins as they were when the step began.  Each thread owns columns
// and accumulates R fields in registers; a coupling value read from L2
// feeds R FMAs, and the spins are read from shared memory as broadcast
// float4.  R trades L2 traffic (every block re-reads the whole coupling
// once per sweep) against filled SMs (C / R blocks); the wrapper picks it.
// Tensor cores, a smaller pad and block sparsity are left to later work.
//
// Plain C interface for ctypes: the wrapper allocates everything, the
// kernel launches on the caller's stream, does not synchronise, and the
// entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 128;

struct Bounds {
  int c0[kMaxBlocks];
  int c1[kMaxBlocks];
};

__device__ __forceinline__ uint32_t mulhilo32(uint32_t a, uint32_t b,
                                              uint32_t* hi) {
  const uint64_t p = static_cast<uint64_t>(a) * static_cast<uint64_t>(b);
  *hi = static_cast<uint32_t>(p >> 32);
  return static_cast<uint32_t>(p);
}

// First 32-bit word of Philox4x32-10(counter, key) (Salmon et al., SC'11).
__device__ __forceinline__ uint32_t philox4x32_10(uint32_t c0, uint32_t c1,
                                                  uint32_t c2, uint32_t c3,
                                                  uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    uint32_t hi0, hi1;
    const uint32_t lo0 = mulhilo32(0xD2511F53u, c0, &hi0);
    const uint32_t lo1 = mulhilo32(0xCD9E8D57u, c2, &hi1);
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

template <int R>
__global__ void __launch_bounds__(kThreads)
gibbs_sweeps_kernel(const float* __restrict__ spins_in,
                    float* __restrict__ spins_out,
                    const float* __restrict__ coupling,
                    const float* __restrict__ h,
                    const float* __restrict__ beta,
                    const float* __restrict__ uniforms,  // null: Philox
                    const int64_t* __restrict__ seed,    // null: fed
                    float* __restrict__ delta_e,         // null: no carry
                    const Bounds bounds, const int n_blocks,
                    const int n_chains, const int n_pad, const int max_width,
                    const int n_sweeps) {
  extern __shared__ float4 smem4[];
  float* spins = reinterpret_cast<float*>(smem4);  // R x n_pad
  float* stage = spins + R * n_pad;                 // R x max_width
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, n_chains - row0);

  uint32_t key0 = 0, key1 = 0;
  if (seed != nullptr) {
    const uint64_t s = static_cast<uint64_t>(*seed);
    key0 = static_cast<uint32_t>(s);
    key1 = static_cast<uint32_t>(s >> 32);
  }
  float neg2beta[R];
  float de[R];  // this thread's share of each row's energy change
#pragma unroll
  for (int r = 0; r < R; ++r) {
    neg2beta[r] = r < rows ? -2.0f * beta[row0 + r] : 0.0f;
    de[r] = 0.0f;
  }
  // rows past the last chain hold zeros: they are computed, never stored
  for (int i = tid; i < R * n_pad; i += kThreads) {
    const int r = i / n_pad;
    spins[i] = r < rows
        ? spins_in[static_cast<size_t>(row0 + r) * n_pad + (i - r * n_pad)]
        : 0.0f;
  }
  __syncthreads();

  for (int sweep = 0; sweep < n_sweeps; ++sweep) {
    for (int b = 0; b < n_blocks; ++b) {
      const int c0 = bounds.c0[b];
      const int c1 = bounds.c1[b];
      for (int c = c0 + tid; c < c1; c += kThreads) {
        float acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0.0f;
        const float* a_col = coupling + c;
        for (int k = 0; k < n_pad; k += 4) {
          const float a0 = __ldg(a_col + static_cast<size_t>(k) * n_pad);
          const float a1 = __ldg(a_col + static_cast<size_t>(k + 1) * n_pad);
          const float a2 = __ldg(a_col + static_cast<size_t>(k + 2) * n_pad);
          const float a3 = __ldg(a_col + static_cast<size_t>(k + 3) * n_pad);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 s =
                *reinterpret_cast<const float4*>(spins + r * n_pad + k);
            acc[r] = fmaf(s.x, a0, acc[r]);
            acc[r] = fmaf(s.y, a1, acc[r]);
            acc[r] = fmaf(s.z, a2, acc[r]);
            acc[r] = fmaf(s.w, a3, acc[r]);
          }
        }
        const float hc = h[c];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < rows) {
            const float f = acc[r] + hc;
            const float x = neg2beta[r] * f;
            const float p = 1.0f / (1.0f + expf(-x));
            const int row = row0 + r;
            float u;
            if (uniforms != nullptr) {
              u = uniforms[(static_cast<size_t>(sweep) * n_chains + row) *
                               n_pad + c];
            } else {
              const uint32_t bits = philox4x32_10(
                  static_cast<uint32_t>(c), static_cast<uint32_t>(row),
                  static_cast<uint32_t>(sweep), 0u, key0, key1);
              u = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
            }
            const float s_new = u < p ? 1.0f : -1.0f;
            stage[r * max_width + (c - c0)] = s_new;
            if (delta_e != nullptr) {
              // f * (new - old) is exact: new - old is 0 or +-2
              de[r] += f * (s_new - spins[r * n_pad + c]);
            }
          }
        }
      }
      __syncthreads();
      const int width = c1 - c0;
      for (int i = tid; i < rows * width; i += kThreads) {
        const int r = i / width;
        const int j = i - r * width;
        spins[r * n_pad + c0 + j] = stage[r * max_width + j];
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < rows * n_pad; i += kThreads) {
    const int r = i / n_pad;
    spins_out[static_cast<size_t>(row0 + r) * n_pad + (i - r * n_pad)] =
        spins[i];
  }

  if (delta_e != nullptr) {  // uniform across the block: barrier is safe
    __shared__ float partial[R][kWarps];
    const int lane = tid & 31;
    const int warp = tid >> 5;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float v = de[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_down_sync(0xffffffffu, v, off);
      }
      if (lane == 0) partial[r][warp] = v;
    }
    __syncthreads();
    if (tid < rows) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += partial[tid][w];
      delta_e[row0 + tid] = sum;
    }
  }
}

template <int R>
cudaError_t launch(const float* spins_in, float* spins_out,
                   const float* coupling, const float* h, const float* beta,
                   const float* uniforms, const int64_t* seed,
                   float* delta_e, const Bounds& bounds, int n_blocks,
                   int n_chains, int n_pad, int max_width, int n_sweeps,
                   cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(R) * (n_pad + max_width) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gibbs_sweeps_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (n_chains + R - 1) / R;
  gibbs_sweeps_kernel<R><<<grid, kThreads, smem, stream>>>(
      spins_in, spins_out, coupling, h, beta, uniforms, seed, delta_e,
      bounds, n_blocks, n_chains, n_pad, max_width, n_sweeps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gibbs_sweeps_max_blocks() { return kMaxBlocks; }

const char* gibbs_sweeps_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// block_bounds: host array of n_blocks (c0, c1) pairs.  rows_per_block is
// one of 1, 2, 4, 8.  delta_e: null, or (n_chains,) f32 for the energy
// change of the run.  Returns a cudaError_t (0 on success).
int gibbs_sweeps_f32(const float* spins_in, float* spins_out,
                     const float* coupling, const float* h, const float* beta,
                     const float* uniforms, const int64_t* seed,
                     float* delta_e, const int* block_bounds, int n_blocks,
                     int n_chains, int n_pad, int max_width, int n_sweeps,
                     int rows_per_block, void* stream) {
  if (n_blocks < 1 || n_blocks > kMaxBlocks || n_pad % 4 != 0 ||
      n_chains < 1 || max_width < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Bounds bounds;
  for (int b = 0; b < n_blocks; ++b) {
    bounds.c0[b] = block_bounds[2 * b];
    bounds.c1[b] = block_bounds[2 * b + 1];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (rows_per_block) {
    case 1:
      err = launch<1>(spins_in, spins_out, coupling, h, beta, uniforms, seed,
                      delta_e, bounds, n_blocks, n_chains, n_pad, max_width,
                      n_sweeps, s);
      break;
    case 2:
      err = launch<2>(spins_in, spins_out, coupling, h, beta, uniforms, seed,
                      delta_e, bounds, n_blocks, n_chains, n_pad, max_width,
                      n_sweeps, s);
      break;
    case 4:
      err = launch<4>(spins_in, spins_out, coupling, h, beta, uniforms, seed,
                      delta_e, bounds, n_blocks, n_chains, n_pad, max_width,
                      n_sweeps, s);
      break;
    case 8:
      err = launch<8>(spins_in, spins_out, coupling, h, beta, uniforms, seed,
                      delta_e, bounds, n_blocks, n_chains, n_pad, max_width,
                      n_sweeps, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
