// Claim flood: which colours each empty region of a batch of Go boards
// touches, the Trump-Taylor claims of the minmax route's step and of the area
// score.  Hand kernel for Hopper (sm_90a), built with nvcc into a shared
// library with a plain C interface and called through ctypes
// (gymgo_tpu_torch/ops/claim_flood.py).
//
// It replaces no Pallas kernel: the JAX package computes this function with
// XLA, as the lax.while_loop of gymgo_tpu/core/flood.py:190
// (flood_or_unrolled) on the two-bit touch word that flood_bundle_from_parts
// (flood.py:723-724) and score.areas_planes build.  This kernel is that loop
// kept on the device, and computes the same function bit for bit:
//
//   seed   an empty cell: bit 0 if a 4-neighbour is a `mover` stone, bit 1 if
//          one is an `opp` stone; a stone: 0
//   flood  OR over 4-adjacent empty cells, to the fixpoint
//
// written as one uint8 plane: the OR of the seeds of the cell's empty region
// on empty cells, 0 on stones.  A region is claimed by `mover` alone where
// the word is 1, by `opp` alone where it is 2.
//
// What bounds it.  2 bytes in and 1 byte out per cell make the byte bound the
// floor; what the kernel pays above it is the labelling's integer and
// shared-memory instructions, as for the other two floods.
//
// Design (board_components.cuh has the whole of it).  The fixpoint of an
// empty cell is the OR of the seeds over its empty region, so the kernel
// labels components instead of flooding by rounds: one warp a board up to
// 32x32, one block a board from 33x33 to 181x181 (the minmax route's
// largest board, where the JAX package's int16 indices stop), five barriers
// a board whatever the length of the regions, where the while_loop runs a
// round for every cell of the longest path.  This file holds
// what is the claim flood's own: three classes (stones are labelled too, but
// their seeds are 0, so their components reduce to 0 and they write 0), the
// two-bit seed and the OR.  The border has a class of its own and touches no
// colour, so a cell at the edge seeds only from the board.

#include "board_components.cuh"

namespace {

using namespace board_components;

constexpr int kMaxCells = kBoardCells;  // 181 * 181, as the min/max flood

struct ClaimOp {
  using Out = uint8_t*;
  static constexpr int kWords = 1;

  static __device__ __forceinline__ uint8_t cell_class(bool a, bool b) {
    return (a ? kClsA : 0) | (b ? kClsB : 0) | ((a || b) ? 0 : kClsE);
  }

  // An empty cell's seed: which colours its neighbours are; a stone's: 0.
  static __device__ __forceinline__ void seed(uint8_t c, const uint8_t (&nc)[4], const int (&/*nbr*/)[4],
                                              int /*m*/, int (&word)[1]) {
    const uint8_t touch = nc[0] | nc[1] | nc[2] | nc[3];
    word[0] = (c & kClsE) ? ((touch & kClsA) ? 1 : 0) | ((touch & kClsB) ? 2 : 0) : 0;
  }

  // at: an int32 word, or an int16 one on a board over 160x160 (the header)
  template <class T>
  static __device__ __forceinline__ void reduce(int /*w*/, T* at, int word, int /*m*/) {
    if (word != 0) atomic_or(at, word);
  }

  static __device__ __forceinline__ void store(Out out, size_t i, const int (&word)[1]) {
    out[i] = static_cast<uint8_t>(word[0]);
  }
};

}  // namespace

extern "C" int claim_flood_launch(const void* mover, const void* opp, void* out, int batch, int n,
                                  void* stream) {
  if (n < 1 || n * n > kMaxCells) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_components<ClaimOp, kMaxCells>(mover, opp, static_cast<uint8_t*>(out), batch, n,
                                                     static_cast<cudaStream_t>(stream)));
}
