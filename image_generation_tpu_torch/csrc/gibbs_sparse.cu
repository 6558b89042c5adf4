// Colored block-Gibbs as a sparse field gather, for Hopper (sm_90a): kernels
// K1, K2 and K3 in every value type (f32, bf16, int8).
//
// Replaces these Pallas TPU kernels:
// image_generation_tpu/ops/gibbs_pallas.py (_kernel, _kernel_fed and their
// shared body _color_update, with an f32 or bf16 coupling or a
// QuantCoupling) and image_generation_tpu/ops/gibbs_pallas_hbm.py (_kernel
// on the dense f32 or bf16 matrix or a QuantCoupling, _kernel_bs on f32,
// bf16 or int8 panels).  It computes what they compute: n_sweeps sweeps,
// each updating the color blocks,
//
//     fields = S . A[:, c] + h[c]
//     p      = sigmoid(-2 * beta_chain * fields)
//     S[:, c] = u < p ? +1 : -1
//
// with the coupling in one of three value types:
//   * f32: each product f32 x +-1 is exact, and the products are summed
//     in f32 in the table's slot order (ascending neighbour), then h is
//     added.  The dense K1 this replaced added fmaf(spin, A[k, c], acc) for
//     every k ascending; a zero coupling adds an exact 0, so the two give
//     the same fields bit for bit.  The Pallas K2 / K3 add one f32 dot
//     per column panel or chunk, another order: against them the fields
//     agree within an ulp or so, not bit for bit;
//   * bf16: the same, each bf16 value widened to f32;
//   * int8: the products summed exactly in int32, in the quantized units
//     of the Pallas kernels (the caller passes h / scale and
//     beta * scale and multiplies delta_e by the scale).
// u is fed ((>= n_sweeps, chains, n_pad) f32 read at [sweep, row, column])
// or drawn from K1's Philox4x32-10 with the counter (column, global chain
// row, sweep, 0) and the seed as key (gibbs_common.cuh).  With delta_e the
// kernel also writes each chain's energy change of the run, the sum of
// fields . (new - old) over sweeps and columns (the Pallas kernels'
// de_ref), reduced once at the end.
//
// What bounds it on the H100.  The couplings are the graph's: at most 15
// neighbours a spin on Pegasus, 20 on Zephyr, so the stored matrix is
// 99 % zeros (the flagship's 768 x 768 holds 4,654 nonzeros, 0.79 %; 0.7 %
// of the scaled plan's packed panels, 0.5 % of the 2,048-latent dense
// matrix).  The dense kernels streamed every element of it from L2 once
// per chain block per sweep or color step: the dense f32 K1 read the
// flagship's 2.4 MB panel set 256 x 16 times a training refresh.  The
// graph's own work is 2 operations a nonzero a chain a sweep (38 MFLOP at
// the flagship's 256 x 16, well under a microsecond at any peak), and the
// bytes it must move are the table (122,880 B of f32 words at the
// flagship) and the spins in and out.  What is left is the work of each
// update: a sweep is one dependent step per color class (6 at the
// flagship, 5 on the served checkpoint, 7 on the Pegasus plans), each
// step deg table loads, deg shared-memory reads, a Philox4x32-10 draw and
// an expf per (column, chain), then a barrier.  Measured on the served
// checkpoint's plan (n_pad 640) at 256 k chains x 80 sweeps, a sweep
// costs about 0.85 us a pass (col_step columns of a span, then the
// barrier) plus 1.8 ns a (column, chain) update on the busiest SM, which
// holds two blocks of 1,024 threads when 144 to 256 blocks share 132 SMs
// (within 9 % of every G's time, 1 to 16, with the live columns below:
// 0.42, 0.51, 0.63, 1.01 and 1.78 ms a launch; NVIDIA H100 80GB HBM3).
//
// So the kernel updates only the columns something reads.  build_plan
// rounds every block up to 128 columns (the TPU's lanes, kept so that both
// packages build one plan), and the padding has no couplings: the served
// plan holds 256 live columns of 640, the fresh flagship plan 256 of 768,
// the scaled plan 5,640 of 6,016.  For each class span the wrapper passes
// (c0, live_stop, c1), live_stop the valid stop of the span's last block
// where no other block of the span has padding and no edge touches it
// (ops/gibbs_sparse.py live_spans; else c1).  Every sweep updates
// [c0, live_stop), and the last sweep the whole span: a padding column's
// field is h alone, so its value after the run is the last sweep's draw
// whatever came before.  Every column keeps its padded index for the
// table, h, the spin slot and the Philox counter, so the spins written
// out, padding included, are the ones a sweep of every column gives, bit
// for bit.
//
// In f32 on the streaming route the same holds.  The 1,280-latent
// Advantage2_system1 plan (n_pad 1,664, 6 class spans of at most 384
// columns, 12,194 couplers, degree <= 20) stores an 11.1 MB dense f32
// matrix, which the dense streaming kernel this replaced read once per
// chain block and sweep; the gather reads a 266 KB table of 8-byte words
// (L2-resident), and its graph work at 256 chains x 80 sweeps is 1 GFLOP,
// 15 us at the f32 peak.  The scaled plan (n_pad 6,016, 7 spans, degree
// <= 15) stores 46.7 MB of f32 panels at chunk 256 (145 MB dense); its
// table is 722 KB.  Both are bound by the 6 or 7 dependent class steps a
// sweep, as above, not by the coupling's bytes.
//
// How the design meets that.
//   * A static neighbour table per plan (ops/gibbs_sparse.py, built on the
//     host from the plan's edge list, cached on the device): for each
//     padded column c and slot d < deg (the plan's largest degree), the
//     neighbour's spin position k and the offset of A[k, c] in the coupling
//     as it is stored (dense: k * n_pad + c; packed panels: the panel row
//     of k's chunk in c's color, times the panel width, plus c - c0), or
//     -1 for an empty slot.  The table holds no values, so one table
//     serves every value type.  The coupling is zero off the plan's edges,
//     so these entries are all of its nonzeros.  A first pass of every
//     launch gathers the coupling's current values into one word a slot,
//     laid out [d][c] so that neighbouring columns read neighbouring
//     words: (k << 8) | (A & 0xff) for int8 and (k << 16) | bf16 bits for
//     bf16 (4 bytes, read unsigned; a bf16 plan may be at most 65,536
//     wide), and an 8-byte {k, f32 bits} pair for f32, read with one
//     64-bit load.  The wrapper refuses a plan wider than the word holds.
//   * A thread block owns G chains for the whole run and holds their spins
//     in shared memory as int8, chain-fastest ([k][G]).  Its threads are
//     (column, chain) pairs, chain fastest: the G threads of a column share
//     its table words (one load, broadcast) and read G neighbouring spin
//     bytes.  A field costs deg table words and deg shared-memory bytes.
//   * A whole color class is updated per step: the blocks of a class share
//     no couplings (the table build checks it), and the uniforms are
//     indexed by column, so updating class_spans(plan) at once equals the
//     plan-order block loop bit for bit.  New spins are written in place:
//     no column of a span reads another's.  Between spans the block needs
//     one __syncthreads(), and no grid sync, because a chain never leaves
//     its block.
//   * The wrapper picks G (1, 2, 4, 8 or 16) so that the chains make at
//     least one full wave of blocks on the card's SMs (on an H100's 132:
//     256 chains G = 1, 256 blocks; 2,048 chains G = 8) and the spins fit
//     shared memory, and the threads a block (ops/gibbs_sparse.py
//     launch_shape).  On a plan whose live spans are wider than 512
//     columns (the scaled plan's reach 1,407) one chain fills a block's
//     passes, and G is 1 at any chain count: its time then grows with the
//     chains, where a grid of 16-chain blocks costs its busiest SM's two
//     blocks whether 144 or 256 blocks share the 132 SMs.
//
// Plain C interface for ctypes: the wrapper allocates everything (the
// gathered table too), both kernels launch on the caller's stream, nothing
// synchronises, and the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "gibbs_common.cuh"  // Philox, the uniform draw, bf16_bits

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kGatherThreads = 256;
constexpr int kMaxNPadInt8 = (1 << 23) - 1;  // the neighbour in 24 bits
constexpr int kMaxNPadBf16 = 1 << 16;        // the neighbour in 16 bits
constexpr int kMaxNPadF32 = 0x7fffffff;      // the neighbour in its own 32 bits

// Per value type: the table word T, the field accumulator, the neighbour a
// word names, and one slot's product added into the accumulator.
template <typename V>
struct Word;

template <>
struct Word<int8_t> {
  typedef uint32_t T;
  typedef int Acc;
  static __device__ __forceinline__ uint32_t make(int k, int8_t a) {
    return (static_cast<uint32_t>(k) << 8) | static_cast<uint8_t>(a);
  }
  static __device__ __forceinline__ uint32_t empty() { return 0u; }
  static __device__ __forceinline__ int nbr(uint32_t w) { return static_cast<int>(w >> 8); }
  static __device__ __forceinline__ void add(int& acc, uint32_t w, int8_t s) {
    acc += static_cast<int>(static_cast<int8_t>(w & 0xffu)) * s;
  }
  static __device__ __forceinline__ float field(int acc) { return static_cast<float>(acc); }
};

template <>
struct Word<bf16_bits> {
  typedef uint32_t T;
  typedef float Acc;
  static __device__ __forceinline__ uint32_t make(int k, bf16_bits a) {
    return (static_cast<uint32_t>(k) << 16) | a;
  }
  static __device__ __forceinline__ uint32_t empty() { return 0u; }
  static __device__ __forceinline__ int nbr(uint32_t w) { return static_cast<int>(w >> 16); }
  // bf16 x +-1 (or 0) is exact in f32, so the fma rounds once, as a
  // multiply then an add would
  static __device__ __forceinline__ void add(float& acc, uint32_t w, int8_t s) {
    acc = fmaf(__uint_as_float(w << 16), static_cast<float>(s), acc);
  }
  static __device__ __forceinline__ float field(float acc) { return acc; }
};

// An f32 value does not fit beside a neighbour in 32 bits: the word is the
// pair {k, f32 bits}, 8 bytes, read with one 64-bit load.
template <>
struct Word<float> {
  typedef uint2 T;
  typedef float Acc;
  static __device__ __forceinline__ uint2 make(int k, float a) {
    return make_uint2(static_cast<uint32_t>(k), __float_as_uint(a));
  }
  static __device__ __forceinline__ uint2 empty() { return make_uint2(0u, 0u); }
  static __device__ __forceinline__ int nbr(uint2 w) { return static_cast<int>(w.x); }
  // f32 x +-1 (or 0) is exact, so the fma rounds once, as an add would
  static __device__ __forceinline__ void add(float& acc, uint2 w, int8_t s) {
    acc = fmaf(__uint_as_float(w.y), static_cast<float>(s), acc);
  }
  static __device__ __forceinline__ float field(float acc) { return acc; }
};

// entry[i] = the word of (nbr[i], A[off[i]]), zero for an empty slot
template <typename V>
__global__ void gather_table_kernel(const V* __restrict__ coupling,
                                    const int* __restrict__ nbr,
                                    const int* __restrict__ off,
                                    typename Word<V>::T* __restrict__ entry, const int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const int o = off[i];
    entry[i] = o >= 0 ? Word<V>::make(nbr[i], coupling[o]) : Word<V>::empty();
  }
}

// At least two blocks of 1,024 threads an SM: at most 32 registers a
// thread.  The busiest SM then holds both blocks of a grid of 133 to 264.
template <typename V, int G>
__global__ void __launch_bounds__(kMaxThreads, 2)
sparse_sweeps_kernel(const float* __restrict__ spins_in,
                     float* __restrict__ spins_out,
                     const typename Word<V>::T* __restrict__ entry,  // (deg, n_pad)
                     const float* __restrict__ h,
                     const float* __restrict__ beta,
                     const float* __restrict__ uniforms,  // null: Philox
                     const int64_t* __restrict__ seed,    // null: fed
                     float* __restrict__ delta_e,         // null: no carry
                     const int* __restrict__ spans,       // (c0, live_stop, c1) per span
                     const int n_spans, const int deg, const int n_chains,
                     const int n_pad, const int n_sweeps) {
  extern __shared__ int8_t spins[];  // n_pad x G, chain fastest
  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;  // a multiple of 32 and of G
  const int g = tid % G;             // this thread's chain in the block
  const int row0 = blockIdx.x * G;
  const int rows = min(G, n_chains - row0);
  const bool live = g < rows;
  const int row = row0 + g;

  uint32_t key0 = 0, key1 = 0;
  if (seed != nullptr) {
    const uint64_t s = static_cast<uint64_t>(*seed);
    key0 = static_cast<uint32_t>(s);
    key1 = static_cast<uint32_t>(s >> 32);
  }
  const float neg2beta = live ? -2.0f * beta[row] : 0.0f;
  float de = 0.0f;  // this thread's share of its chain's energy change
  // chains past the last one hold zeros: computed, never stored
  for (int i = tid; i < G * n_pad; i += n_threads) {
    const int r = i / n_pad;
    const int c = i - r * n_pad;
    spins[c * G + r] = r < rows
        ? static_cast<int8_t>(spins_in[static_cast<size_t>(row0 + r) * n_pad + c])
        : static_cast<int8_t>(0);
  }
  __syncthreads();

  // Every sweep updates the live columns [c0, live_stop) of each span; the
  // last also the padding [live_stop, c1), which has no coupling and no
  // reader: its field is h alone, so its value after the run is the last
  // sweep's draw whatever came before, and its energy share is
  // h * (new - initial), the sum a sweep-by-sweep update would carry.
  const int col_step = n_threads / G;
  for (int sweep = 0; sweep < n_sweeps; ++sweep) {
    const int bound = sweep == n_sweeps - 1 ? 2 : 1;  // the span's c1 or live_stop
    for (int sp = 0; sp < n_spans; ++sp) {
      const int stop = __ldg(spans + 3 * sp + bound);
      for (int c = __ldg(spans + 3 * sp) + tid / G; c < stop; c += col_step) {
        typename Word<V>::Acc acc = 0;
        const typename Word<V>::T* e = entry + c;
#pragma unroll 5
        for (int d = 0; d < deg; ++d) {  // ascending slots: the plain version's order
          const typename Word<V>::T w = __ldg(e + static_cast<size_t>(d) * n_pad);
          Word<V>::add(acc, w, spins[Word<V>::nbr(w) * G + g]);
        }
        if (live) {
          const float f = Word<V>::field(acc) + __ldg(h + c);
          const float x = neg2beta * f;
          const float p = 1.0f / (1.0f + expf(-x));
          const float u = draw_uniform(uniforms, c, row, sweep, n_chains, n_pad, key0, key1);
          const bool up = u < p;
          int8_t* s = spins + c * G + g;
          if (delta_e != nullptr) {
            // f * (new - old) is exact: new - old is 0 or +-2
            de += f * ((up ? 1.0f : -1.0f) - static_cast<float>(*s));
          }
          *s = up ? 1 : -1;
        }
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < rows * n_pad; i += n_threads) {
    const int r = i / n_pad;
    const int c = i - r * n_pad;
    spins_out[static_cast<size_t>(row0 + r) * n_pad + c] = static_cast<float>(spins[c * G + r]);
  }

  if (delta_e != nullptr) {  // uniform across the block: barrier is safe
    __shared__ float partial[kMaxWarps][G];
    const int lane = tid & 31;
    const int warp = tid >> 5;
    float v = de;
#pragma unroll
    for (int o = 16; o >= G; o >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, o);  // lane + o holds the same chain
    }
    if (lane < G) partial[warp][lane] = v;
    __syncthreads();
    if (tid < rows) {
      float sum = 0.0f;
      for (int w = 0; w < n_threads / 32; ++w) sum += partial[w][tid];
      delta_e[row0 + tid] = sum;
    }
  }
}

size_t smem_bytes(int chains_per_block, int n_pad) {
  return static_cast<size_t>(chains_per_block) * n_pad;
}

struct Args {
  const void* coupling;
  const int* nbr;
  const int* off;
  void* entry;
  const float* spins_in;
  float* spins_out;
  const float* h;
  const float* beta;
  const float* uniforms;
  const int64_t* seed;
  float* delta_e;
  const int* spans;
  int n_spans, deg, n_chains, n_pad, n_sweeps, threads;
  cudaStream_t stream;
};

template <typename V, int G>
cudaError_t launch(const Args& a) {
  const size_t smem = smem_bytes(G, a.n_pad);
  cudaError_t err = cudaFuncSetAttribute(
      sparse_sweeps_kernel<V, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (a.n_chains + G - 1) / G;
  sparse_sweeps_kernel<V, G><<<grid, a.threads, smem, a.stream>>>(
      a.spins_in, a.spins_out, static_cast<const typename Word<V>::T*>(a.entry), a.h,
      a.beta, a.uniforms, a.seed, a.delta_e, a.spans, a.n_spans, a.deg, a.n_chains,
      a.n_pad, a.n_sweeps);
  return cudaGetLastError();
}

template <typename V>
cudaError_t launch_type(const Args& a, int chains_per_block) {
  const int n = a.deg * a.n_pad;
  gather_table_kernel<V><<<(n + kGatherThreads - 1) / kGatherThreads, kGatherThreads, 0,
                           a.stream>>>(static_cast<const V*>(a.coupling), a.nbr, a.off,
                                       static_cast<typename Word<V>::T*>(a.entry), n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (chains_per_block) {
    case 1: return launch<V, 1>(a);
    case 2: return launch<V, 2>(a);
    case 4: return launch<V, 4>(a);
    case 8: return launch<V, 8>(a);
    case 16: return launch<V, 16>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* gibbs_sparse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory one thread block needs, in bytes: the wrapper
// checks it against the card's limit.
long long gibbs_sparse_smem_bytes(int chains_per_block, int n_pad) {
  return static_cast<long long>(smem_bytes(chains_per_block, n_pad));
}

// The widest plan (n_pad) a table word of the value type holds (dtype 0
// int8, 1 bf16, 2 f32; 0 for another): the wrapper checks it before a
// launch.
int gibbs_sparse_max_n_pad(int dtype) {
  switch (dtype) {
    case 0: return kMaxNPadInt8;
    case 1: return kMaxNPadBf16;
    case 2: return kMaxNPadF32;
    default: return 0;
  }
}

// Bytes of one table word of the value type (0 for another): the wrapper
// sizes the gathered table's scratch by it.
int gibbs_sparse_word_bytes(int dtype) {
  switch (dtype) {
    case 0: return static_cast<int>(sizeof(Word<int8_t>::T));
    case 1: return static_cast<int>(sizeof(Word<bf16_bits>::T));
    case 2: return static_cast<int>(sizeof(Word<float>::T));
    default: return 0;
  }
}

// dtype: 0 int8, 1 bf16, 2 f32 (the stored coupling's values).  coupling:
// the stored coupling (dense or packed panels); nbr, off: the (deg, n_pad)
// int32 neighbour table (off -1 for an empty slot); entry: (deg, n_pad)
// scratch for the gathered table, gibbs_sparse_word_bytes(dtype) a slot.
// spans: device int32, (c0, live_stop, c1) per color-class span in plan
// order: the columns [live_stop, c1) must have no coupling (no table
// entry); only the last sweep updates them.  Their share of delta_e
// is h[c] * (final - initial) spin, exactly zero for every caller in the
// package, which holds h at zero on padding (permuted_model).  int8:
// h and beta in quantized units (h / scale, beta * scale); bf16 and f32:
// as they are.  uniforms: null, or
// f32 with at least n_sweeps rows of (n_chains, n_pad); seed: null (fed)
// or one int64.  delta_e: null, or (n_chains,) f32.  chains_per_block: 1,
// 2, 4, 8 or 16; threads: a multiple of 32 and of chains_per_block, at
// most 1024.  Returns a cudaError_t (0 on success).
int gibbs_sparse(int dtype, const void* coupling, const int* nbr, const int* off,
                 void* entry, int deg, const float* spins_in, float* spins_out,
                 const float* h, const float* beta, const float* uniforms,
                 const int64_t* seed, float* delta_e, const int* spans, int n_spans,
                 int n_chains, int n_pad, int n_sweeps, int chains_per_block,
                 int threads, void* stream) {
  if (deg < 1 || n_spans < 1 || n_chains < 1 || n_pad < 1 ||
      n_pad > gibbs_sparse_max_n_pad(dtype) || chains_per_block < 1 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || threads % chains_per_block != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{coupling, nbr, off, entry, spins_in, spins_out,
               h, beta, uniforms, seed, delta_e, spans, n_spans, deg, n_chains, n_pad,
               n_sweeps, threads, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_type<int8_t>(a, chains_per_block); break;
    case 1: err = launch_type<bf16_bits>(a, chains_per_block); break;
    case 2: err = launch_type<float>(a, chains_per_block); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
