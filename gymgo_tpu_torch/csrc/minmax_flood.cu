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
// What bounds it.  As for the bundle flood (csrc/bundle_flood.cu): the round
// count is set by the longest path inside a group and differs from board to
// board; device-memory traffic is small (2 bytes in, 4 bytes out per cell),
// so the floor is the byte bound, and what a simple kernel pays is latency:
// shared-memory reads and one block-wide barrier per round.
//
// Design.  One thread block per board, one thread per cell (N*N rounded up to
// whole warps), so N*N <= 1024.  Each thread computes its seeds and its four
// same-colour direction gates once, in registers, from the class bytes of its
// neighbours in shared memory; unlike the bundle flood, empty cells never
// propagate.  The pair lives in shared memory as one word,
// (BIG - mx) << 16 | mn: both fields are at most N*N + 1 < 2^16, and BIG - mx
// falls as mx grows, so a per-halfword unsigned min (__vminu2) is the min of
// mn and the max of mx at once, as the TPU kernel's packing is
// (pallas_flood.py:81-94).  Each round a thread takes that min with its gated
// neighbours' words, writes its own back if it fell, and the block votes with
// __syncthreads_or; a block stops after the first round in which no thread
// changed, so each board pays its own round count and nothing goes to the
// host.  Reads inside a round may see a neighbour's word from before or after
// that round's write; the operator is monotone with a unique fixpoint, so
// either is right, and a round with no change saw only final words.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCells = 1024;  // one thread per cell, one block per board
// class bits of a cell: mover, opp (a cell with neither is empty)
constexpr uint8_t kClsA = 1, kClsB = 2;

__global__ void minmax_flood_kernel(const uint8_t* __restrict__ mover,
                                    const uint8_t* __restrict__ opp,
                                    int16_t* __restrict__ mn_out,
                                    int16_t* __restrict__ mx_out, int n) {
  __shared__ uint8_t cls[kMaxCells];
  __shared__ uint32_t word[kMaxCells];

  const int m = n * n;
  const int i = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * m;
  const bool cell = i < m;

  uint8_t c = 0;
  if (cell) {
    c = (mover[base + i] != 0 ? kClsA : 0) | (opp[base + i] != 0 ? kClsB : 0);
    cls[i] = c;
  }
  __syncthreads();

  // Neighbours in the JAX flood's order: from above, below, left, right.
  int nbr[4];
  bool gate[4] = {false, false, false, false};
  uint32_t w = 0;
  if (cell) {
    const int r = i / n, col = i - r * n;
    nbr[0] = r > 0 ? i - n : -1;
    nbr[1] = r < n - 1 ? i + n : -1;
    nbr[2] = col > 0 ? i - 1 : -1;
    nbr[3] = col < n - 1 ? i + 1 : -1;
    int lo = m, hi = -1;
    for (int d = 0; d < 4; ++d) {
      if (nbr[d] < 0) continue;
      const uint8_t nc = cls[nbr[d]];
      gate[d] = (c & nc) != 0;
      if (nc == 0) {
        lo = min(lo, nbr[d]);
        hi = max(hi, nbr[d]);
      }
    }
    w = (static_cast<uint32_t>(m - hi) << 16) | static_cast<uint32_t>(lo);
    word[i] = w;
  }
  __syncthreads();

  bool changed = true;
  while (__syncthreads_or(changed)) {
    changed = false;
    if (cell) {
      uint32_t x = w;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        if (gate[d]) x = __vminu2(x, word[nbr[d]]);
      }
      if (x != w) {
        w = x;
        word[i] = x;
        changed = true;
      }
    }
  }
  if (cell) {
    mn_out[base + i] = static_cast<int16_t>(w & 0xFFFFu);
    mx_out[base + i] = static_cast<int16_t>(m - static_cast<int>(w >> 16));
  }
}

}  // namespace

extern "C" int minmax_flood_launch(const void* mover, const void* opp,
                                   void* mn, void* mx, int batch, int n,
                                   void* stream) {
  const int m = n * n;
  if (batch <= 0) return static_cast<int>(cudaSuccess);
  if (n < 1 || m > kMaxCells) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (m + 31) / 32 * 32;
  minmax_flood_kernel<<<batch, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mover), static_cast<const uint8_t*>(opp),
      static_cast<int16_t*>(mn), static_cast<int16_t*>(mx), n);
  return static_cast<int>(cudaGetLastError());
}
