// Bundle flood: the converged packed OR-flood word of every cell of a batch
// of Go boards.  Hand kernel for Hopper (sm_90a), built with nvcc into a
// shared library with a plain C interface and called through ctypes
// (gymgo_tpu_torch/ops/bundle_flood.py).
//
// Replaces the TPU kernel gymgo_tpu/ops/pallas_flood.py:_bundle_kernel
// (bundle_flood_pallas), and computes the same function bit for bit:
//
//   bits 0-8   OR of the codes idx+1 of the empty cells next to a stone's group
//   bits 9-17  OR of those codes' 9-bit complements
//   bit 18     an empty region touches `mover`
//   bit 19     an empty region touches `opp`
//
// flooded within same-class 4-connected runs (mover-mover, opp-opp,
// empty-empty) to the fixpoint.  The 9-bit code field limits N*N to 511.
//
// What bounds it.  Device-memory traffic is small (2 bytes in, 4 bytes out per
// cell), so the floor is the byte bound, and the kernel's loads and stores
// alone run near it.  What it pays above that is the labelling, which the byte
// bound does not count: integer and shared-memory instructions, a few
// thousand per board, on a multiprocessor that issues two integer and one
// shared-memory warp instruction a clock.  The dearest are the pointer chases
// of the union-find, in which the lanes of a warp run different numbers of
// steps and each step waits for the load before it.
//
// Design (board_components.cuh has the whole of it).  The fixpoint of a cell
// is the OR of the seeds of its connected component, so the kernel labels
// components instead of flooding by rounds: one warp a board, a fixed five
// warp barriers a board and no block-wide one, whatever the length of the
// board's groups.  Horizontal runs cost warp votes and no memory traffic; the
// vertical pairs left to unite go through a dense list, 32 at a time.  Blocks
// of 16 warps stride over the boards, three blocks resident on a
// multiprocessor, so one board's loads overlap 47 others' labelling; staging
// tiles of boards by bulk asynchronous copies measured no faster and is not
// here.  This file holds what is the bundle flood's own: the three classes,
// the seed word and the OR.

#include "board_components.cuh"

namespace {

using namespace board_components;

constexpr int kMaxCells = 511;  // the 9-bit code field
constexpr int kMask9 = (1 << 9) - 1;
constexpr int kBitA = 1 << 18;
constexpr int kBitB = 1 << 19;

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

}  // namespace

extern "C" int bundle_flood_launch(const void* mover, const void* opp, void* out, int batch, int n,
                                   void* stream) {
  if (n < 1 || n * n > kMaxCells) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_components<BundleOp>(mover, opp, static_cast<int32_t*>(out), batch,
                                                      n, static_cast<cudaStream_t>(stream)));
}
