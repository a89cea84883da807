// Dropout keep bits inside the hand-written kernels (flash attention,
// fused add + layer norm).
//
// The TPU kernels draw their mask bits from the TPU's hardware PRNG
// (paddle_tpu/ops/pallas/flash_attention.py _keep_mask :114, fused_ln.py
// _row_keep_mask :72), seeded per block so the backward redraws the
// forward's mask.  Those bits cannot be reproduced here.  Two generators
// take their place, each a pure function of (seed, b, row, col), so a
// backward kernel redraws the forward's mask from the same coordinates
// and the plain PyTorch twin in ops/cuda/dropout.py reproduces every bit:
//
//   mode 1, the card generator: murmur3's fmix32 finaliser chained over
//     the coordinates (card_row_key, card_bits);
//   mode 2, the debug hash: the reference's position hash _hash_bits
//     (flash_attention.py:105), selected by
//     PADDLE_TPU_FLASH_DROPOUT_DEBUG=iota, so CPU tests can hold the
//     dropout arithmetic against the reference package.
//
// b is the batch*head index for attention and 0 for layer norm; row and
// col are global coordinates.  A cell is kept iff its bits >= threshold
// (= min(rate * 2^32, 2^32 - 1), the reference's _rate_threshold) and a
// kept value is scaled by 1 / (1 - rate).  Mode 0 turns dropout off.
#pragma once

#include <stdint.h>

namespace pt {

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

struct Dropout {
  int mode;            // 0 off, 1 card generator, 2 debug hash
  uint32_t seed;
  uint32_t threshold;  // keep iff bits >= threshold
  float scale;         // 1 / (1 - rate)

  // per-(b, row) part of the card generator; unused by the debug hash
  __device__ __forceinline__ uint32_t row_key(uint32_t b, uint32_t row) const {
    return fmix32(fmix32(seed ^ (b * 0x9e3779b9u)) + row * 0x7feb352du);
  }

  __device__ __forceinline__ bool keep(uint32_t key, uint32_t b,
                                       uint32_t row, uint32_t col) const {
    uint32_t bits;
    if (mode == 2) {
      bits = (row * 2654435761u) ^ (col * 97559u + b * 31u);
      bits = (bits ^ seed) * 2246822519u;
    } else {
      bits = fmix32(key ^ (col * 0x846ca68bu));
    }
    return bits >= threshold;
  }

  // x with dropout applied (mode != 0)
  __device__ __forceinline__ float apply(float x, uint32_t key, uint32_t b,
                                         uint32_t row, uint32_t col) const {
    return keep(key, b, row, col) ? x * scale : 0.f;
  }
};

__host__ __forceinline__ Dropout make_dropout(int mode, unsigned seed,
                                              unsigned threshold,
                                              float scale) {
  Dropout d;
  d.mode = mode;
  d.seed = seed;
  d.threshold = threshold;
  d.scale = scale;
  return d;
}

}  // namespace pt
