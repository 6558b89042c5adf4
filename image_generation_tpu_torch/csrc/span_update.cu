// The class-span Bernoulli update of the graph-sharded Gibbs sweep for
// Hopper (sm_90a): kernel K4, one owned-window update.
//
// Replaces the Pallas TPU kernels of
// image_generation_tpu/ops/gibbs_graph_sharded_pallas.py: _update_hw_kernel
// (hardware PRNG seeded per row tile), _update_hw_rowseed_kernel (re-seeded
// per 8-row group from global row ids) and _update_fed_kernel (fed
// uniforms), built by make_pallas_update.  The graph-sharded sweep
// (ops/gibbs_graph_sharded.py) computes each rank's partial products of a
// color-class span [start, stop) with a matrix product and all-reduces
// them over the graph axis.  This kernel then does the rest of the span's
// update for the columns [a, b) = [max(start, lo), min(stop, lo + L)) that
// the rank owns, in one launch:
//
//     f    = partial + h[col]                  (f32 partial)
//          = (partial_int32 * scale) + h[col]  (int8 coupling: two roundings)
//          = h[col]                            (no shard couples into the span)
//     p    = sigmoid(-2 * beta_row * f)        (the expression of the plain
//                                               version, torch.sigmoid's bits)
//     new  = u < p ? +1 : -1
//     dE  += f * (new - old)                   (optional, per chain row)
//     spins[row, col - lo] = new               (in place, in the carry's
//                                               dtype: f32, bf16 or int8)
//
// A color-class span has no internal edge and f is formed before the
// write, so the in-place update is safe.  The int8 scale-out and the add
// of h use __fmul_rn / __fadd_rn: nvcc -O3 would otherwise contract them
// into one fmaf, and the fields would differ by an ulp from the JAX body's
// (and the plain version's) two roundings.  beta is per chain row or one
// scalar.
//
// Uniforms: fed (rows of ld_u floats whose column 0 is global column
// u_col0; the sweep's (chains, n_pad) plane is read at global columns), or
// drawn from Philox4x32-10 keyed by the run's 64-bit seed with the counter
// (global column, global chain row, sweep, 0) and u = (bits >> 8) * 2^-24:
// the counter layout of K1 (gibbs_common.cuh), so gibbs_cuda.philox_uniforms
// is this kernel's numpy twin too.  The counter holds global coordinates,
// never window-relative ones: an owned window draws exactly the bits a
// whole-span update draws for the same element, every rank of a graph
// axis agrees, and a run on another mesh draws the same chain.  That
// covers both TPU variants, so PLRNG_ROW_SEED selects nothing here.
//
// The whole-span update (the wrapper's span_update) is the case where the
// window is the span, h is absent (the fields are the partial) and the
// spins are a fresh f32 buffer; no second kernel.
//
// What bounds it on the H100.  Elementwise: per owned element 4 B of f32
// (or int32) partial in, the old spin read (only with dE) and the new one
// written in the carry's dtype (1-4 B), 4 B of uniforms when fed; ~60
// integer operations of Philox and one expf.  At the scaled plan a rank
// owns 1,504 of 6,016 columns of 2,048 chain rows: ~25 MB a sweep, ~7 us
// at 3.35 TB/s.  On the card a launch takes about three times that at
// the widest window, with Philox or fed uniforms alike (PERF.md section
// 6): the integer work and the load latency bound it, not the bytes.
// Launched back to back, the narrow windows are paced by the wrapper's
// host time a launch.
//
// Launch shape.  Without dE, one warp per (chain row, column chunk of up
// to 256 columns): the lanes walk the chunk with stride 32, so loads and
// stores of a warp are coalesced.  8 warps, so 8 chain rows, a block: the
// scaled plan's 128-column spans and the few-dozen-column windows where a
// span straddles two ranks are narrow, and a block of 256 threads along
// one row's columns (the earlier one-thread-per-element tiling) would
// leave most of them idle there.  The grid is (row groups, column
// chunks): 256 x 6 blocks at 2,048 rows x 1,504 columns.  Chunks of 32,
// 64 and 128 columns and the loop unrolled 4 times were timed against it
// (k4_variants.py, PERF.md section 6): each took longer at the widest
// window, and none was faster in both rounds over a sweep's launches,
// which the host paces.
//
// With dE the sum must repeat itself: the carried ladder energies feed
// the parallel-tempering swap test, so two runs with one seed must add a
// row's terms in one order.  Float atomics from several column chunks
// into one row do not (their order changes from launch to launch: 20
// distinct dE vectors in 20 launches of the earlier kernel).  So with dE
// a block holds whole rows, kDeWarps = 2 warps a row interleaving its
// owned columns in 32-column steps (the grid is row groups only): each
// lane sums its columns in ascending order, a warp adds its lanes in a
// fixed shuffle tree, the row's two totals are added in warp order
// through shared memory, and the row's one writer adds that to the
// accumulator, launches following each other on the stream.  Timed at
// 2,048 rows x 1,408 columns, bf16 carry, dE, Philox (k4_variants.py,
// PERF.md section 6): 2 warps a row 20.0 us, as fast as the atomics
// (20.3 us); 1 warp a row 34.5 us (a quarter of the warps in flight),
// 4 or 8 warps 22.2-22.6 us, and the other fixed-order design (each
// (row, chunk) warp's partial written to a scratch buffer and summed in
// chunk order by the row group's last block) 22.6 us.
//
// C interface (bound with ctypes by ops/gibbs_graph_sharded_cuda.py); each
// entry returns a cudaError_t (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "gibbs_common.cuh"

// What stays fixed over a sweep run (set once by the wrapper's per-call
// object); the per-span arguments go with each launch.  Outside the
// anonymous namespace: the C entry takes it, and is exported.
struct SpanWindowArgs {
  const float* h;         // (n_pad,) global; null: the fields are the partial
  const float* beta;      // (rows,) or one value
  const float* scale;     // () the int8 coupling's scale, or null
  const float* uniforms;  // fed: sweep 0's plane; null: Philox
  const int64_t* seed;    // Philox seed (one int64 on the device), or null
  void* spins;            // (rows, ld_s) window in the carry's dtype
  float* delta_e;         // (rows,) accumulator, or null
  long long ld_u;         // uniforms' row stride (floats)
  long long sweep_u;      // uniforms' sweep stride (floats)
  long long ld_s;         // spins' row stride (elements)
  int beta_per_row;
  int spin_type;          // SpinType
  int rows;
  int lo;                 // global column of the window's column 0
  int cols;               // the window's width L
  int u_col0;             // global column of the uniforms' column 0
  int row0;               // global chain row of row 0
  int device;             // CUDA device of every pointer
  void* stream;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kRowsPerBlock = kThreads / kWarp;
constexpr int kChunk = 256;  // columns a warp walks without dE (8 a lane)
constexpr int kDeWarps = 2;  // warps that share one row's columns with dE
static_assert(kRowsPerBlock % kDeWarps == 0, "a block holds whole rows with dE");
constexpr int kMaxChunks = 65535;

enum PartialKind { kNoPartial = 0, kF32Partial = 1, kI32Partial = 2 };
enum SpinType { kSpinF32 = 0, kSpinBF16 = 1, kSpinI8 = 2 };

template <typename S>
struct Spin;

template <>
struct Spin<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, bool up) {
    *p = up ? 1.0f : -1.0f;
  }
};

template <>
struct Spin<bf16_bits> {
  static __device__ __forceinline__ float load(const bf16_bits* p) {
    return __uint_as_float(static_cast<uint32_t>(*p) << 16);
  }
  static __device__ __forceinline__ void store(bf16_bits* p, bool up) {
    *p = up ? static_cast<bf16_bits>(0x3F80u) : static_cast<bf16_bits>(0xBF80u);
  }
};

template <>
struct Spin<int8_t> {
  static __device__ __forceinline__ float load(const int8_t* p) {
    return static_cast<float>(*p);
  }
  static __device__ __forceinline__ void store(int8_t* p, bool up) {
    *p = up ? static_cast<int8_t>(1) : static_cast<int8_t>(-1);
  }
};

template <typename S, bool kFed>
__global__ void __launch_bounds__(kThreads)
span_window_kernel(SpanWindowArgs args, const void* __restrict__ partial,
                   int kind, long long ld_p, int start, int a, int b,
                   int sweep) {
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  float* de = args.delta_e;
  // without dE a warp takes (row, chunk); with dE kDeWarps warps take all
  // of a row's columns, so that the row's sum has one order
  int r, c_begin, c_end, step;
  if (de == nullptr) {
    r = blockIdx.x * kRowsPerBlock + warp;
    c_begin = a + blockIdx.y * kChunk + lane;
    c_end = min(b, a + (static_cast<int>(blockIdx.y) + 1) * kChunk);
    step = kWarp;
  } else {
    r = blockIdx.x * (kRowsPerBlock / kDeWarps) + warp / kDeWarps;
    c_begin = a + (warp % kDeWarps) * kWarp + lane;
    c_end = b;
    step = kWarp * kDeWarps;
  }
  const bool live = r < args.rows;
  if (!live && de == nullptr) return;  // whole warps leave; with dE they reach the barrier

  const float neg2beta = live ? -2.0f * args.beta[args.beta_per_row ? r : 0] : 0.0f;
  const float scale = kind == kI32Partial ? *args.scale : 0.0f;
  const float* __restrict__ h = args.h;
  // row offsets that take global columns (c >= a >= each array's column 0)
  long long u_off = 0;
  uint32_t key0 = 0u, key1 = 0u;
  if (kFed) {
    u_off = static_cast<long long>(sweep) * args.sweep_u +
            static_cast<long long>(r) * args.ld_u - args.u_col0;
  } else {
    const uint64_t s = static_cast<uint64_t>(*args.seed);
    key0 = static_cast<uint32_t>(s);
    key1 = static_cast<uint32_t>(s >> 32);
  }
  const long long p_off = static_cast<long long>(r) * ld_p - start;
  const long long s_off = static_cast<long long>(r) * args.ld_s - args.lo;
  S* __restrict__ spins = static_cast<S*>(args.spins);

  float acc = 0.0f;
  for (int c = c_begin; live && c < c_end; c += step) {
    // the old spin is loaded first, with the partial: loaded where dE uses
    // it, after Philox, its latency stalled every element and a launch took
    // more than twice as long (k4_variants.py, PERF.md section 6)
    S* const slot = spins + (s_off + c);
    const float old = de != nullptr ? Spin<S>::load(slot) : 0.0f;
    float f;
    if (kind == kNoPartial) {
      f = __ldg(h + c);
    } else {
      float q;
      if (kind == kI32Partial) {
        q = __fmul_rn(__int2float_rn(__ldg(static_cast<const int*>(partial) + (p_off + c))),
                      scale);
      } else {
        q = __ldg(static_cast<const float*>(partial) + (p_off + c));
      }
      f = h != nullptr ? __fadd_rn(q, __ldg(h + c)) : q;
    }
    const float x = neg2beta * f;
    const float p = 1.0f / (1.0f + expf(-x));
    float u;
    if (kFed) {
      u = __ldg(args.uniforms + (u_off + c));
    } else {
      const uint32_t bits = philox4x32_10(static_cast<uint32_t>(c),
                                          static_cast<uint32_t>(args.row0 + r),
                                          static_cast<uint32_t>(sweep), 0u,
                                          key0, key1);
      u = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
    }
    const bool up = u < p;
    if (de != nullptr) acc += f * ((up ? 1.0f : -1.0f) - old);
    Spin<S>::store(slot, up);
  }
  if (de != nullptr) {  // uniform across the block: the barrier is safe
#pragma unroll
    for (int o = kWarp / 2; o > 0; o /= 2) acc += __shfl_down_sync(0xffffffffu, acc, o);
    __shared__ float total[kThreads / kWarp];
    if (lane == 0) total[warp] = acc;
    __syncthreads();
    if (live && lane == 0 && warp % kDeWarps == 0) {
      float sum = 0.0f;
      for (int k = 0; k < kDeWarps; ++k) sum += total[warp + k];
      de[r] += sum;  // the row's one writer in this launch
    }
  }
}

template <typename S, bool kFed>
void launch(const SpanWindowArgs& args, dim3 grid, const void* partial,
            int kind, long long ld_p, int start, int a, int b, int sweep) {
  span_window_kernel<S, kFed><<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(args.stream)>>>(
      args, partial, kind, ld_p, start, a, b, sweep);
}

}  // namespace

extern "C" {

const char* span_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int span_update_threads() { return kThreads; }

int span_window_args_size() { return static_cast<int>(sizeof(SpanWindowArgs)); }

// One class span's owned-window update.  args: what is fixed over the run
// (struct above).  partial: the span's all-reduced products, (rows, ld_p)
// with column 0 at global column start: f32 (kind 1), int32 with
// args->scale (kind 2), or null (kind 0: fields = h).  [a, b): the owned
// global columns, inside [start, ...) and the window [lo, lo + cols).
// sweep: the Philox counter's sweep and the fed plane.
int span_window(const SpanWindowArgs* args, const void* partial, int kind,
                long long ld_p, int start, int a, int b, int sweep) {
  const SpanWindowArgs& x = *args;
  const int width = b - a;
  if (x.rows < 1 || width < 1 || start < 0 || a < start || a < x.lo ||
      b > x.lo + x.cols || x.row0 < 0 || sweep < 0 || x.beta == nullptr ||
      x.spins == nullptr || x.ld_s < x.cols ||
      (x.uniforms == nullptr) == (x.seed == nullptr) ||
      (x.uniforms != nullptr && (x.u_col0 > a || x.ld_u < b - x.u_col0)) ||
      (kind == kNoPartial) != (partial == nullptr) ||
      (kind == kNoPartial && x.h == nullptr) ||
      (kind == kI32Partial && x.scale == nullptr) ||
      (kind != kNoPartial && ld_p < b - start) || kind < 0 || kind > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // with dE a block holds whole rows (kDeWarps warps each), one chunk
  const bool whole_rows = x.delta_e != nullptr;
  const int rows_per_block = whole_rows ? kRowsPerBlock / kDeWarps : kRowsPerBlock;
  const int row_groups = (x.rows + rows_per_block - 1) / rows_per_block;
  const int chunks = whole_rows ? 1 : (width + kChunk - 1) / kChunk;
  if (chunks > kMaxChunks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != x.device && (err = cudaSetDevice(x.device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const dim3 grid(row_groups, chunks);
  const bool fed = x.uniforms != nullptr;
  switch (x.spin_type) {
    case kSpinF32:
      fed ? launch<float, true>(x, grid, partial, kind, ld_p, start, a, b, sweep)
          : launch<float, false>(x, grid, partial, kind, ld_p, start, a, b, sweep);
      break;
    case kSpinBF16:
      fed ? launch<bf16_bits, true>(x, grid, partial, kind, ld_p, start, a, b, sweep)
          : launch<bf16_bits, false>(x, grid, partial, kind, ld_p, start, a, b, sweep);
      break;
    case kSpinI8:
      fed ? launch<int8_t, true>(x, grid, partial, kind, ld_p, start, a, b, sweep)
          : launch<int8_t, false>(x, grid, partial, kind, ld_p, start, a, b, sweep);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (current != x.device) cudaSetDevice(current);
  return static_cast<int>(err);
}

}  // extern "C"
