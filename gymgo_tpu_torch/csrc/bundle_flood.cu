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
// What bounds it.  The work is data dependent: the number of propagation
// rounds is set by the longest path inside a group or empty region, and
// differs from board to board.  The TPU kernel ran a whole tile of boards to
// the tile's slowest fixpoint; a batch-wide loop would pay the batch's
// slowest board on every board.  Device-memory traffic is small (2 bytes in,
// 4 bytes out per cell), so the floor is the byte bound, and what a simple
// kernel actually pays is latency: shared-memory reads and one block-wide
// barrier per round.
//
// Design.  One thread block per board, one thread per cell (N*N rounded up to
// whole warps: 12 warps at 19x19).  Each thread computes its seed word and its
// four same-class direction gates once, in registers, from the class bytes of
// its neighbours in shared memory.  The words live in shared memory; each
// round a thread ORs in its gated neighbours' words, writes its own word back
// if it grew, and the block votes with __syncthreads_or.  A block stops after
// the first round in which no thread changed: each board pays its own round
// count, and nothing goes to the host.  Reads inside a round may see a
// neighbour's word from before or after that round's write; the operator is
// monotone and its fixpoint unique, so either is right, and a round with no
// change saw only final words, so stopping there is exact.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCells = 512;  // N*N <= 511, padded to whole warps
constexpr int kMask9 = (1 << 9) - 1;
constexpr int kBitA = 1 << 18;
constexpr int kBitB = 1 << 19;
// class bits of a cell: mover, opp, empty
constexpr uint8_t kClsA = 1, kClsB = 2, kClsE = 4;

__global__ void bundle_flood_kernel(const uint8_t* __restrict__ mover,
                                    const uint8_t* __restrict__ opp,
                                    int32_t* __restrict__ out, int n) {
  __shared__ uint8_t cls[kMaxCells];
  __shared__ int32_t word[kMaxCells];

  const int m = n * n;
  const int i = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * m;
  const bool cell = i < m;

  uint8_t c = 0;
  if (cell) {
    const bool a = mover[base + i] != 0;
    const bool b = opp[base + i] != 0;
    c = (a ? kClsA : 0) | (b ? kClsB : 0) | ((a || b) ? 0 : kClsE);
    cls[i] = c;
  }
  __syncthreads();

  // Neighbours in the JAX flood's order: from above, below, left, right.
  int nbr[4];
  bool gate[4] = {false, false, false, false};
  int32_t w = 0;
  if (cell) {
    const int r = i / n, col = i - r * n;
    nbr[0] = r > 0 ? i - n : -1;
    nbr[1] = r < n - 1 ? i + n : -1;
    nbr[2] = col > 0 ? i - 1 : -1;
    nbr[3] = col < n - 1 ? i + 1 : -1;
    int32_t lib = 0;
    uint8_t touch = 0;
    for (int d = 0; d < 4; ++d) {
      if (nbr[d] < 0) continue;
      const uint8_t nc = cls[nbr[d]];
      gate[d] = (c & nc) != 0;
      touch |= nc;
      if (nc & kClsE) {
        const int32_t code = nbr[d] + 1;
        lib |= code | ((~code & kMask9) << 9);
      }
    }
    if (c & kClsE) {
      w = ((touch & kClsA) ? kBitA : 0) | ((touch & kClsB) ? kBitB : 0);
    } else {
      w = lib;
    }
    word[i] = w;
  }
  __syncthreads();

  bool changed = true;
  while (__syncthreads_or(changed)) {
    changed = false;
    if (cell) {
      int32_t x = w;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        if (gate[d]) x |= word[nbr[d]];
      }
      if (x != w) {
        w = x;
        word[i] = x;
        changed = true;
      }
    }
  }
  if (cell) out[base + i] = w;
}

}  // namespace

extern "C" int bundle_flood_launch(const void* mover, const void* opp,
                                   void* out, int batch, int n,
                                   void* stream) {
  const int m = n * n;
  if (batch <= 0) return static_cast<int>(cudaSuccess);
  if (n < 1 || m > kMaxCells - 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (m + 31) / 32 * 32;
  bundle_flood_kernel<<<batch, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mover), static_cast<const uint8_t*>(opp),
      static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
