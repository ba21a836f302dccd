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
// here.  What is the bundle flood's own, the three classes, the seed word and
// the OR, is bundle_word.cuh's BundleOp, which the env step's fused kernel
// (env_step.cu) labels its boards with too.

#include "bundle_word.cuh"

extern "C" int bundle_flood_launch(const void* mover, const void* opp, void* out, int batch, int n,
                                   void* stream) {
  using namespace board_components;
  if (n < 1 || n * n > kBundleCells) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_components<BundleOp>(mover, opp, static_cast<int32_t*>(out), batch,
                                                      n, static_cast<cudaStream_t>(stream)));
}
