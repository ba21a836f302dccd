// Min/max liberty flood: per stone, the least and the greatest flat index of
// its group's liberties, for every cell of a batch of Go boards.  Hand kernel
// for Hopper (sm_90a), built with nvcc into a shared library with a plain C
// interface and called through ctypes (gymgo_tpu_torch/ops/minmax_flood.py).
//
// Replaces the TPU kernel gymgo_tpu/ops/pallas_flood.py:_kernel
// (minmax_liberty_flood_pallas), and computes the same function bit for bit:
//
//   seeds  mn = least flat index of an empty 4-neighbour, BIG = N*N if none
//          mx = greatest flat index of an empty 4-neighbour, -1 if none
//   flood  mn = min, mx = max over 4-adjacent stones of the same colour, to
//          the fixpoint; cells that are not stones keep their seeds
//
// written as two int16 planes.  A group has no liberty iff mn == BIG, one iff
// mn == mx < BIG, two or more iff mn < mx (gymgo_tpu_torch.core.flood:
// liberty_classes_from_minmax).
//
// What bounds it.  As for the bundle flood (csrc/bundle_flood.cu): 2 bytes in
// and 4 bytes out per cell make the byte bound the floor, and what the kernel
// pays above it is the labelling's integer and shared-memory instructions,
// here with two seed words, two atomics (a min and a max) per stone into its
// group's root, and two 2-byte stores per cell.
//
// Design (board_components.cuh has the whole of it).  The fixpoint of a stone
// is the min and the max of the seeds over its group, so the kernel labels
// groups instead of flooding by rounds: one warp a board up to 32x32 (32
// cells a lane at N = 32), five warp barriers a board, blocks of 16 warps
// striding over the boards; one block a board from 33x33 to 181x181, the
// largest board whose indices and BIG = N*N int16 holds (the output's type,
// and where the JAX package's int16 indices stop).  This file holds what is the
// min/max flood's own: two classes (a cell that is no stone has none, so it
// is a component of one and keeps its seeds), the two seed words, and the
// two reductions.  The TPU kernel packs (mn, BIG - mx) into one word for its
// lane rotations; here the two lie in arrays of their own, because an atomic
// min on a packed word is not a min of its halves.

#include "board_components.cuh"

namespace {

using namespace board_components;

constexpr int kMaxCells = kBoardCells;  // 181 * 181: the output's int16 holds BIG = N*N

struct MinmaxOp {
  struct Out {
    int16_t* mn;
    int16_t* mx;
  };
  static constexpr int kWords = 2;

  static __device__ __forceinline__ uint8_t cell_class(bool a, bool b) {
    return (a ? kClsA : 0) | (b ? kClsB : 0);
  }

  // The least and the greatest index of the cell's empty neighbours (the
  // border has a class, so a cell of class 0 is an empty cell of the board).
  static __device__ __forceinline__ void seed(uint8_t /*c*/, const uint8_t (&nc)[4],
                                              const int (&nbr)[4], int m, int (&word)[2]) {
    int lo = m, hi = -1;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      if (nc[d] == 0) {
        lo = min(lo, nbr[d]);
        hi = max(hi, nbr[d]);
      }
    }
    word[0] = lo;
    word[1] = hi;
  }

  // at: an int32 word, or an int16 one on a board over 133x133 (the header)
  template <class T>
  static __device__ __forceinline__ void reduce(int w, T* at, int word, int m) {
    if (w == 0) {
      if (word < m) atomic_min(at, word);
    } else {
      if (word >= 0) atomic_max(at, word);
    }
  }

  static __device__ __forceinline__ void store(Out out, size_t i, const int (&word)[2]) {
    out.mn[i] = static_cast<int16_t>(word[0]);
    out.mx[i] = static_cast<int16_t>(word[1]);
  }
};

}  // namespace

extern "C" int minmax_flood_launch(const void* mover, const void* opp, void* mn, void* mx,
                                   int batch, int n, void* stream) {
  if (n < 1 || n * n > kMaxCells) return static_cast<int>(cudaErrorInvalidValue);
  const MinmaxOp::Out out = {static_cast<int16_t*>(mn), static_cast<int16_t*>(mx)};
  return static_cast<int>(launch_components<MinmaxOp, kMaxCells>(mover, opp, out, batch, n,
                                                      static_cast<cudaStream_t>(stream)));
}
