// The bundle word: what the bundle flood computes for each cell of a Go
// board, and what the env step (env_step.cu) reads of it.  One definition for
// the bundle flood's kernel (bundle_flood.cu) and the env step's fused kernel,
// which labels the board itself and reads the word from shared memory.
//
//   bits 0-8   OR of the codes idx+1 of the empty cells next to a stone's group
//   bits 9-17  OR of those codes' 9-bit complements
//   bit 18     an empty region touches `mover`
//   bit 19     an empty region touches `opp`
//
// flooded within same-class 4-connected runs (mover-mover, opp-opp,
// empty-empty) to the fixpoint.  The 9-bit code field limits N*N to 511.

#pragma once

#include "board_components.cuh"

namespace board_components {

constexpr int kBundleCells = 511;  // the 9-bit code field
constexpr int kMask9 = (1 << 9) - 1;
constexpr int kBitA = 1 << 18;
constexpr int kBitB = 1 << 19;

// The three classes, the seed word and the OR, as label_board takes them.
struct BundleOp {
  using Out = int32_t*;
  static constexpr int kWords = 1;

  static __device__ __forceinline__ uint8_t cell_class(bool a, bool b) {
    return (a ? kClsA : 0) | (b ? kClsB : 0) | ((a || b) ? 0 : kClsE);
  }

  // A stone's seed: the codes of its empty neighbours, each beside its 9-bit
  // complement; an empty cell's: which colours it touches.
  static __device__ __forceinline__ void seed(uint8_t c, const uint8_t (&nc)[4], const int (&nbr)[4],
                                              int /*m*/, int (&word)[1]) {
    int lib = 0;
    uint8_t touch = 0;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      touch |= nc[d];
      // code | (~code & kMask9) << 9 with code = nbr + 1, in one multiply-add:
      // the fields do not overlap and the complement is kMask9 - code
      if (nc[d] & kClsE) lib |= (kMask9 << 9) - ((1 << 9) - 1) * (nbr[d] + 1);
    }
    word[0] = (c & kClsE) ? ((touch & kClsA) ? kBitA : 0) | ((touch & kClsB) ? kBitB : 0) : lib;
  }

  static __device__ __forceinline__ void reduce(int /*w*/, int* at, int word, int /*m*/) {
    if (word != 0) atomicOr(at, word);
  }

  static __device__ __forceinline__ void store(Out out, size_t i, const int (&word)[1]) {
    out[i] = word[0];
  }
};

}  // namespace board_components
