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
//
// The seed comes from the device: a launch passes a pointer to the
// executor's step (a 1-element int64 tensor) and a per-op salt, and every
// thread derives the seed from both in the kernel's prologue
// (Dropout::load_seed, step_seed), so a launch replayed from a captured
// CUDA graph draws a new mask when the step tensor holds a new step.  The
// seed and the block's per-b key wait in shared memory, not in registers
// held for the kernel's life (the K2 backward kernels have none to
// spare): every thread writes the same values there, so no barrier is
// needed, and a row's key reads them back.  step_seed is mirrored bit for
// bit by ops/cuda/dropout.py step_seed.
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

// the 32-bit seed of (step, salt)
__device__ __forceinline__ uint32_t step_seed(long long step,
                                              uint32_t salt) {
  const unsigned long long s = (unsigned long long)step;
  const uint32_t h =
      fmix32((uint32_t)s ^ ((uint32_t)(s >> 32) * 0x9e3779b9u));
  return fmix32(h + salt * 0x85ebca77u);
}

struct Dropout {
  int mode;            // 0 off, 1 card generator, 2 debug hash
  uint32_t salt;       // the op's draw (ops/cuda/dropout.py op_salt)
  uint32_t threshold;  // keep iff bits >= threshold
  float scale;         // 1 / (1 - rate)
  const long long* step;  // the executor's step on the device

  // the block's words in shared memory: [0] the launch's seed, [1] the
  // card generator's per-b key, fmix32(seed ^ b * 0x9e3779b9)
  __device__ __forceinline__ static volatile uint32_t* slots() {
    __shared__ uint32_t words[2];
    return words;
  }

  // every thread of a kernel that drops calls it once, before any use; b
  // is the block's batch*head index (0 for layer norm)
  __device__ __forceinline__ void load_seed(uint32_t b) const {
    if (mode == 0) return;
    const uint32_t s = step_seed(*step, salt);
    slots()[0] = s;
    slots()[1] = fmix32(s ^ (b * 0x9e3779b9u));
  }

  __device__ __forceinline__ uint32_t seed() const { return slots()[0]; }

  // per-row part of the card generator (b as given to load_seed); unused
  // by the debug hash
  __device__ __forceinline__ uint32_t row_key(uint32_t row) const {
    return fmix32(slots()[1] + row * 0x7feb352du);
  }

  __device__ __forceinline__ bool keep(uint32_t key, uint32_t b,
                                       uint32_t row, uint32_t col) const {
    uint32_t bits;
    if (mode == 2) {
      bits = (row * 2654435761u) ^ (col * 97559u + b * 31u);
      bits = (bits ^ seed()) * 2246822519u;
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

__host__ __forceinline__ Dropout make_dropout(int mode, const void* step,
                                              unsigned salt,
                                              unsigned threshold,
                                              float scale) {
  Dropout d;
  d.mode = mode;
  d.salt = salt;
  d.step = static_cast<const long long*>(step);
  d.threshold = threshold;
  d.scale = scale;
  return d;
}

}  // namespace pt
