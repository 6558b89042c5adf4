// Streaming colored block-Gibbs for Hopper (sm_90a): kernels K2 and K3
// with an f32 coupling (their int8 and bf16 modes are the sparse field
// gather of gibbs_sparse.cu).
//
// Replaces the Pallas TPU kernels of image_generation_tpu/ops/
// gibbs_pallas_hbm.py: _kernel (K2, the dense coupling streamed one color
// panel at a time) and _kernel_bs (K3, only the packed occupied row chunks
// of each color's panel, ops/block_sparse.py pack_coupling).  Both compute
// what those compute:
//
//   * n_sweeps is rounded up to an even count by the caller (the Pallas
//     kernels unroll two sweeps per loop step); fed uniforms are read at
//     [sweep, chain row, column] like the fed Pallas kernel, Philox draws
//     use K1's counter (column, global chain row, sweep, 0) and key;
//   * per color block in plan order, fields = spins . A[:, c0:c1] + h, in
//     K3 summed over the color's occupied chunks only, each chunk's panel
//     rows against spin columns starts[r] .. starts[r] + chunk; a color no
//     chunk couples into gets fields = h;
//   * p = sigmoid(-2 beta fields), new = u < p ? +1 : -1, written to the
//     spins only after the whole block's fields are complete;
//   * spins are held in f32 (+-1 is exact), and products accumulate in
//     f32;
//   * energy carry (delta_e non-null): per chain, the sum over sweeps and
//     blocks of fields . (new - old), kept as per-thread partial sums and
//     reduced once at the end, as in K1.
//
// What bounds it on the H100.  On the scaled path (5,640 spins padded to
// 6,016 in 47 color blocks of 128 columns; 2,048 parallel-tempering chains,
// 4 sweeps) the graph's work is 1.3 GFLOP, but a dense column-panel product
// does 593 GFLOP and the packed one 191 GFLOP per refresh, so on CUDA
// cores the multiply-adds and the coupling reads that feed them bound this
// design, not device memory: the packed f32 panels (46 MB) fit the 50 MB
// L2, and every thread block streams the whole panel set from there once
// per sweep.  The gather (gibbs_sparse.cu) does only the graph's work; the
// f32 modes, on no default path, stay here until they move to it too.
//
// How the design meets that.  The chains are independent: a thread block
// owns R chain rows and keeps their spins in shared memory for the whole
// run (R * 6,016 values: 24 KB per row), plus a staging row block for one
// color's new spins.  Its 256
// threads are 128 column lanes times 2 groups that split the panel rows;
// each thread loads 8 coupling values (coalesced across the lanes) before
// using them, and every value feeds R multiply-adds against spins read from
// shared memory as broadcast vectors, so R trades L2 traffic (grid / R
// panel streams per sweep) against filled SMs; the wrapper picks R.  The
// two groups' partial fields meet once per color in shared memory.  K3's
// per-color chunk lists are a small int32 array (the counterpart of the
// Pallas kernel's compile-time lists) copied to shared memory at the
// start.  Tensor cores, TMA and clusters are left to later work.
//
// Plain C interface for ctypes: the wrapper allocates everything, the
// kernel launches on the caller's stream, does not synchronise, and the
// entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "gibbs_common.cuh"  // Philox, the uniform draw, Ops<T>, kStep

namespace {

constexpr int kLanes = 128;   // columns of a color block per pass
constexpr int kGroups = 2;    // thread groups splitting the panel rows
constexpr int kThreads = kLanes * kGroups;
constexpr int kWarps = kThreads / 32;
constexpr int kMetaPerColor = 6;  // c0, c1, first panel row, column base,
                                  // first and end index into the chunk list

__host__ __device__ constexpr size_t align16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

template <typename T, int R>
__host__ __device__ constexpr size_t red_bytes() {
  return align16(sizeof(typename Ops<T>::Acc) * (kGroups - 1) * R * kLanes);
}

// meta: n_blocks * kMetaPerColor ints, then the chunk list (K3: the spin
// column each listed chunk starts at).  Dense (K2): first panel row 0,
// column base c0, one "chunk" of seg_len = n_pad rows starting at 0.
template <typename T, int R, bool kPacked>
__global__ void __launch_bounds__(kThreads)
gibbs_stream_kernel(const float* __restrict__ spins_in,
                    float* __restrict__ spins_out,
                    const T* __restrict__ coupling,
                    const float* __restrict__ h,
                    const float* __restrict__ beta,
                    const float* __restrict__ uniforms,  // null: Philox
                    const int64_t* __restrict__ seed,    // null: fed
                    float* __restrict__ delta_e,         // null: no carry
                    const int* __restrict__ meta, const int n_meta,
                    const int n_blocks, const int n_chains, const int n_pad,
                    const int ld, const int seg_len, const int max_width,
                    const int n_sweeps) {
  typedef typename Ops<T>::Acc Acc;
  extern __shared__ float4 smem4[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
  Acc* red = reinterpret_cast<Acc*>(base);  // (kGroups - 1) x R x kLanes
  int* smeta = reinterpret_cast<int*>(base + red_bytes<T, R>());
  T* spins = reinterpret_cast<T*>(base + red_bytes<T, R>() +
                                  align16(sizeof(int) * n_meta));  // R x n_pad
  T* stage = spins + R * n_pad;                                     // R x max_width
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int grp = tid / kLanes;
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
  for (int i = tid; i < n_meta; i += kThreads) smeta[i] = meta[i];
  // rows past the last chain hold zeros: they are computed, never stored
  for (int i = tid; i < R * n_pad; i += kThreads) {
    const int r = i / n_pad;
    spins[i] = r < rows
        ? Ops<T>::from_f32(spins_in[static_cast<size_t>(row0 + r) * n_pad + (i - r * n_pad)])
        : Ops<T>::zero();
  }
  __syncthreads();
  const int* chunk_start = smeta + n_blocks * kMetaPerColor;

  for (int sweep = 0; sweep < n_sweeps; ++sweep) {
    for (int b = 0; b < n_blocks; ++b) {
      const int* m = smeta + b * kMetaPerColor;
      const int c0 = m[0], c1 = m[1], panel_row = m[2], col_base = m[3];
      const int seg0 = m[4], seg1 = m[5];
      for (int tile = c0; tile < c1; tile += kLanes) {
        const int c = tile + lane;
        const bool active = c < c1;
        Acc acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0;
        if (active) {
          const T* a_col = coupling + static_cast<size_t>(panel_row) * ld + col_base + (c - c0);
          for (int sg = seg0; sg < seg1; ++sg) {
            const int s0 = kPacked ? chunk_start[sg] : 0;
            const T* a_seg = a_col + static_cast<size_t>(sg - seg0) * seg_len * ld;
            for (int k = grp * kStep; k < seg_len; k += kGroups * kStep) {
              Ops<T>::template step<R>(acc, a_seg + static_cast<size_t>(k) * ld,
                                       static_cast<size_t>(ld), spins + s0 + k, n_pad);
            }
          }
        }
        if (grp > 0 && active) {
#pragma unroll
          for (int r = 0; r < R; ++r) red[((grp - 1) * R + r) * kLanes + lane] = acc[r];
        }
        __syncthreads();
        if (grp == 0 && active) {
#pragma unroll
          for (int g = 1; g < kGroups; ++g) {
#pragma unroll
            for (int r = 0; r < R; ++r) acc[r] += red[((g - 1) * R + r) * kLanes + lane];
          }
          const float hc = h[c];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (r < rows) {
              const float f = Ops<T>::acc_f32(acc[r]) + hc;
              const float x = neg2beta[r] * f;
              const float p = 1.0f / (1.0f + expf(-x));
              const int row = row0 + r;
              const float u = draw_uniform(uniforms, c, row, sweep, n_chains, n_pad,
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
        __syncthreads();  // red is free again; stage holds this pass
      }
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
    const int wl = tid & 31;
    const int warp = tid >> 5;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float v = de[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_down_sync(0xffffffffu, v, off);
      }
      if (wl == 0) partial[r][warp] = v;
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

template <typename T, int R>
size_t smem_bytes(int n_meta, int n_pad, int max_width) {
  return red_bytes<T, R>() + align16(sizeof(int) * n_meta) +
         align16(sizeof(T) * static_cast<size_t>(R) * n_pad) +
         sizeof(T) * static_cast<size_t>(R) * max_width;
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
  const int* meta;
  int n_meta, n_blocks, n_chains, n_pad, ld, seg_len, max_width, n_sweeps;
  cudaStream_t stream;
};

template <typename T, int R, bool kPacked>
cudaError_t launch(const Args& a) {
  const size_t smem = smem_bytes<T, R>(a.n_meta, a.n_pad, a.max_width);
  cudaError_t err = cudaFuncSetAttribute(
      gibbs_stream_kernel<T, R, kPacked>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (a.n_chains + R - 1) / R;
  gibbs_stream_kernel<T, R, kPacked><<<grid, kThreads, smem, a.stream>>>(
      a.spins_in, a.spins_out, static_cast<const T*>(a.coupling), a.h, a.beta,
      a.uniforms, a.seed, a.delta_e, a.meta, a.n_meta, a.n_blocks, a.n_chains,
      a.n_pad, a.ld, a.seg_len, a.max_width, a.n_sweeps);
  return cudaGetLastError();
}

template <typename T, bool kPacked>
cudaError_t launch_rows(const Args& a, int rows_per_block) {
  switch (rows_per_block) {
    case 1: return launch<T, 1, kPacked>(a);
    case 2: return launch<T, 2, kPacked>(a);
    case 4: return launch<T, 4, kPacked>(a);
    case 8: return launch<T, 8, kPacked>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_form(const Args& a, int packed, int rows_per_block) {
  return packed ? launch_rows<T, true>(a, rows_per_block)
                : launch_rows<T, false>(a, rows_per_block);
}

}  // namespace

extern "C" {

const char* gibbs_stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int gibbs_stream_meta_per_color() { return kMetaPerColor; }

// Shared memory one thread block needs, in bytes (0 for an unknown
// rows_per_block): the wrapper checks it against the card's limit.
long long gibbs_stream_smem_bytes(int rows_per_block, int n_meta, int n_pad,
                                  int max_width) {
  switch (rows_per_block) {
    case 1: return smem_bytes<float, 1>(n_meta, n_pad, max_width);
    case 2: return smem_bytes<float, 2>(n_meta, n_pad, max_width);
    case 4: return smem_bytes<float, 4>(n_meta, n_pad, max_width);
    case 8: return smem_bytes<float, 8>(n_meta, n_pad, max_width);
    default: return 0;
  }
}

// An f32 coupling and f32 held spins.  packed: 0 K2 (coupling (n_pad,
// n_pad), ld = n_pad), 1 K3 (panels (rows, max_width), ld = max_width,
// seg_len = chunk).  meta: device int32 array of n_meta entries (see the
// kernel).  n_sweeps: already even.  delta_e: null, or (n_chains,) f32.
// Returns a cudaError_t (0 on success).
int gibbs_stream(int packed, const float* spins_in, float* spins_out,
                 const void* coupling, const float* h, const float* beta,
                 const float* uniforms, const int64_t* seed, float* delta_e,
                 const int* meta, int n_meta, int n_blocks, int n_chains,
                 int n_pad, int ld, int seg_len, int max_width, int n_sweeps,
                 int rows_per_block, void* stream) {
  if (n_blocks < 1 || n_chains < 1 || max_width < 1 || n_pad % kStep != 0 ||
      seg_len % kStep != 0 || n_meta < n_blocks * kMetaPerColor) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{spins_in, spins_out, coupling, h, beta, uniforms, seed,
               delta_e, meta, n_meta, n_blocks, n_chains, n_pad, ld, seg_len,
               max_width, n_sweeps, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch_form<float>(a, packed, rows_per_block));
}

}  // extern "C"
