// Pieces the kernels share (the sparse field gather in gibbs_sparse.cu, the
// span update in span_update.cu): the in-kernel Philox generator, the
// uniform draw and the bf16 storage type.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef uint16_t bf16_bits;  // bf16 stored as its 16 bits

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

// The uniform of (column, chain row, sweep): fed ([sweep, row, column] of a
// (n_sweeps, n_chains, n_pad) array) or drawn from Philox with the counter
// (column, row, sweep, 0), u = (bits >> 8) * 2^-24, as on the TPU.
__device__ __forceinline__ float draw_uniform(const float* uniforms, int c,
                                              int row, int sweep, int n_chains,
                                              int n_pad, uint32_t key0,
                                              uint32_t key1) {
  if (uniforms != nullptr) {
    return uniforms[(static_cast<size_t>(sweep) * n_chains + row) * n_pad + c];
  }
  const uint32_t bits = philox4x32_10(static_cast<uint32_t>(c),
                                      static_cast<uint32_t>(row),
                                      static_cast<uint32_t>(sweep), 0u, key0,
                                      key1);
  return static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
}

}  // namespace
