// Fused multi-sweep colored block-Gibbs for Hopper (sm_90a): kernel K1,
// with an f32 or bf16 coupling (K1's int8 mode is the sparse field gather
// of gibbs_sparse.cu).
//
// Replaces the Pallas TPU kernel image_generation_tpu/ops/gibbs_pallas.py
// (_kernel, _kernel_fed and their shared body _color_update).  It computes
// exactly what they compute: n_sweeps sweeps, each updating the color
// blocks of the plan in order,
//
//     fields = S[:, :] @ A[:, c0:c1] + h[c0:c1]
//     p      = sigmoid(-2 * beta_chain * fields)
//     S[:, c0:c1] = u < p ? +1 : -1
//
// with u either fed in ((n_sweeps, chains, n_pad) f32, read at
// [sweep, row, column] like _kernel_fed) or drawn in the kernel from a
// Philox4x32-10 keyed by a 64-bit seed with the counter (column, global
// chain row, sweep, 0), so the stream does not depend on the block size;
// u = (bits >> 8) * 2^-24, as on the TPU.
//
// Coupling types (_color_update's f32 and bf16 cases, gibbs_common.cuh's
// Ops<T>): f32; bf16, the +-1 spins times bf16 couplings accumulated in
// f32.  Spins are held in the coupling's type in shared memory (+-1 is
// exact in each) and come back as f32.
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
// What bounds it on the H100.  The f32 serving shape is C = 256 * bucket
// chains over n_pad = 640 padded spins, 80 sweeps: 2*C*n_pad^2 FLOP per
// sweep, 16.8 GFLOP for a 256-image request, at about 1 FLOP per byte of
// coupling read.  The TPU kernel held the whole coupling in VMEM; a
// Hopper block has 227 KB of shared memory, so here the coupling stays in
// global memory and lives in the 50 MB L2, and every color step streams
// its column panel A[:, c0:c1] from there, coalesced across columns.  The
// chains are independent: one thread block owns R chain rows and keeps
// their spins in shared memory for the whole run (R * n_pad values of the
// coupling's type), plus a staging row block for the new spins of one
// color, so the fields of a color step are computed from the spins as they
// were when the step began.  Each thread owns columns and accumulates R
// fields in registers; a coupling value read from L2 feeds R
// multiply-adds, and the spins are read from shared memory as broadcast
// vectors.  R trades L2 traffic (every block re-reads the whole coupling
// once per sweep) against filled SMs (C / R blocks); the wrapper picks it.
// Tensor cores, TMA, a smaller pad and block sparsity are left to later
// work.
//
// Plain C interface for ctypes: the wrapper allocates everything, the
// kernel launches on the caller's stream, does not synchronise, and the
// entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "gibbs_common.cuh"  // Philox, the uniform draw, Ops<T>, kStep

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 128;

struct Bounds {
  int c0[kMaxBlocks];
  int c1[kMaxBlocks];
};

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
gibbs_sweeps_kernel(const float* __restrict__ spins_in,
                    float* __restrict__ spins_out,
                    const T* __restrict__ coupling,
                    const float* __restrict__ h,
                    const float* __restrict__ beta,
                    const float* __restrict__ uniforms,  // null: Philox
                    const int64_t* __restrict__ seed,    // null: fed
                    float* __restrict__ delta_e,         // null: no carry
                    const Bounds bounds, const int n_blocks,
                    const int n_chains, const int n_pad, const int max_width,
                    const int n_sweeps) {
  typedef typename Ops<T>::Acc Acc;
  extern __shared__ float4 smem4[];
  T* spins = reinterpret_cast<T*>(smem4);  // R x n_pad
  T* stage = spins + R * n_pad;            // R x max_width
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
        ? Ops<T>::from_f32(spins_in[static_cast<size_t>(row0 + r) * n_pad + (i - r * n_pad)])
        : Ops<T>::zero();
  }
  __syncthreads();

  for (int sweep = 0; sweep < n_sweeps; ++sweep) {
    for (int b = 0; b < n_blocks; ++b) {
      const int c0 = bounds.c0[b];
      const int c1 = bounds.c1[b];
      for (int c = c0 + tid; c < c1; c += kThreads) {
        Acc acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0;
        const T* a_col = coupling + c;
        for (int k = 0; k < n_pad; k += kStep) {
          Ops<T>::template step<R>(acc, a_col + static_cast<size_t>(k) * n_pad,
                                   static_cast<size_t>(n_pad), spins + k, n_pad);
        }
        const float hc = h[c];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < rows) {
            const float f = Ops<T>::acc_f32(acc[r]) + hc;
            const float x = neg2beta[r] * f;
            const float p = 1.0f / (1.0f + expf(-x));
            const float u = draw_uniform(uniforms, c, row0 + r, sweep, n_chains, n_pad,
                                         key0, key1);
            const bool up = u < p;
            stage[r * max_width + (c - c0)] = Ops<T>::spin(up);
            if (delta_e != nullptr) {
              // f * (new - old) is exact: new - old is 0 or +-2
              de[r] += f * ((up ? 1.0f : -1.0f) - Ops<T>::to_f32(spins[r * n_pad + c]));
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
        Ops<T>::to_f32(spins[i]);
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

template <typename T>
size_t smem_bytes(int rows_per_block, int n_pad, int max_width) {
  return static_cast<size_t>(rows_per_block) * (n_pad + max_width) * sizeof(T);
}

struct Args {
  const float* spins_in;
  float* spins_out;
  const void* coupling;
  const float* h;
  const float* beta;
  const float* uniforms;
  const int64_t* seed;
  float* delta_e;
  Bounds bounds;
  int n_blocks, n_chains, n_pad, max_width, n_sweeps;
  cudaStream_t stream;
};

template <typename T, int R>
cudaError_t launch(const Args& a) {
  const size_t smem = smem_bytes<T>(R, a.n_pad, a.max_width);
  cudaError_t err = cudaFuncSetAttribute(
      gibbs_sweeps_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (a.n_chains + R - 1) / R;
  gibbs_sweeps_kernel<T, R><<<grid, kThreads, smem, a.stream>>>(
      a.spins_in, a.spins_out, static_cast<const T*>(a.coupling), a.h, a.beta,
      a.uniforms, a.seed, a.delta_e, a.bounds, a.n_blocks, a.n_chains, a.n_pad,
      a.max_width, a.n_sweeps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(const Args& a, int rows_per_block) {
  switch (rows_per_block) {
    case 1: return launch<T, 1>(a);
    case 2: return launch<T, 2>(a);
    case 4: return launch<T, 4>(a);
    case 8: return launch<T, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int gibbs_sweeps_max_blocks() { return kMaxBlocks; }

int gibbs_sweeps_step() { return kStep; }

const char* gibbs_sweeps_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory one thread block needs, in bytes (0 for an unknown
// dtype): the wrapper checks it against the card's limit.
long long gibbs_sweeps_smem_bytes(int dtype, int rows_per_block, int n_pad,
                                  int max_width) {
  switch (dtype) {
    case 0: return smem_bytes<float>(rows_per_block, n_pad, max_width);
    case 1: return smem_bytes<bf16_bits>(rows_per_block, n_pad, max_width);
    default: return 0;
  }
}

// dtype: 0 f32, 1 bf16 (its 16 bits).  block_bounds: host array of
// n_blocks (c0, c1) pairs.
// rows_per_block is one of 1, 2, 4, 8.  delta_e: null, or (n_chains,) f32
// for the energy change of the run.  Returns a cudaError_t (0 on success).
int gibbs_sweeps(int dtype, const float* spins_in, float* spins_out,
                 const void* coupling, const float* h, const float* beta,
                 const float* uniforms, const int64_t* seed, float* delta_e,
                 const int* block_bounds, int n_blocks, int n_chains, int n_pad,
                 int max_width, int n_sweeps, int rows_per_block, void* stream) {
  if (n_blocks < 1 || n_blocks > kMaxBlocks || n_pad % kStep != 0 ||
      n_chains < 1 || max_width < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{spins_in, spins_out, coupling, h, beta, uniforms, seed, delta_e,
         Bounds{}, n_blocks, n_chains, n_pad, max_width, n_sweeps,
         static_cast<cudaStream_t>(stream)};
  for (int b = 0; b < n_blocks; ++b) {
    a.bounds.c0[b] = block_bounds[2 * b];
    a.bounds.c1[b] = block_bounds[2 * b + 1];
  }
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_rows<float>(a, rows_per_block); break;
    case 1: err = launch_rows<bf16_bits>(a, rows_per_block); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
