// Connected-component reductions over batches of Go boards: what the two
// flood kernels (bundle_flood.cu, minmax_flood.cu) share.
//
// Both floods spread a per-cell seed word between 4-adjacent cells of the same
// class until nothing changes.  The gates are symmetric and the operators (OR;
// min and max) associative, commutative and idempotent, so the fixpoint of a
// cell is the reduction of the seeds over its connected component of the
// same-class graph.  This header labels the components with a lock-free
// union-find in shared memory and reduces the seeds into each component's
// root with shared-memory atomics: a fixed number of passes over a board,
// whatever the length of its groups, where a flood by rounds pays one round
// for every cell of the longest path.
//
// label_board<Op> does one board with one warp; lane l owns the cells l,
// l + 32, ...  An Op gives the class of a cell, its seed words, their
// reduction and the output's layout.  Passes, a warp barrier between them:
//
//   1. class byte of every cell, from the two input planes, into a copy of
//      the board with a border of a class of its own, so that no later pass
//      asks whether a neighbour exists;
//   2. horizontal runs by warp votes, with no memory traffic: a vote on
//      "gated to my left" gives every lane the word of run starts among the
//      32 cells of its step; the highest start at or below its own bit (or,
//      where a run crosses into the word, the highest of the word before:
//      N <= 32, so there is one) is the head of its run, which it takes as
//      its parent.  Of the vertical pairs only the first of each stretch of
//      neighbouring pairs that join the same two runs goes into a dense list;
//   3. union of the listed pairs, 32 at a time: chase both cells to their
//      roots, halving the path on the way, and atomicMin the larger root's
//      parent down to the smaller; if another lane moved it first, go on from
//      where it points now;
//   4. seed words into acc[] (the list lay there until now);
//   5. find each cell's root, write it back, and reduce the cell's seed into
//      acc[root] unless it is the reduction's identity;
//   6. every cell writes acc[root] out.
//
// components_kernel<Op> keeps the streaming multiprocessors fed.  A block of
// kWarps warps strides over the boards, one warp a board, so a board needs no
// block-wide barrier and a warp that has a long board holds up no other.
// Three blocks are resident on a multiprocessor at 19x19, so 48 boards are at
// some pass there at any moment and the loads of one overlap the labelling of
// the others.  Pass 1 reads the planes from device memory byte by byte, each
// warp instruction 32 neighbouring bytes; staging whole 16-board tiles in
// shared memory with bulk asynchronous copies (cp.async.bulk on an mbarrier)
// ahead of the labelling was built and measured within 1% of this (PERF.md),
// and was left out.

#pragma once

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace board_components {

constexpr int kWarps = 16;  // warps per block = boards a block labels at once
constexpr int kThreads = kWarps * 32;
// Resident blocks a multiprocessor that the launch bounds hold the registers
// to; its shared memory takes as many at 19x19.
constexpr int kBlocksPerSM = 3;

// class bits of a cell: mover, opp, empty, and the border around the board
constexpr uint8_t kClsA = 1, kClsB = 2, kClsE = 4, kClsBorder = 8;

// ---------------------------------------------------------------- union-find

// parent[] is read while other lanes atomicMin into it: volatile, so that
// every step of a chase is a real load.  parent[x] <= x always, so a chase
// ends, and the root of a component is its least cell.  A chase halves the
// path behind it, with atomicMin: a parent then only ever falls, so once a
// cell has been given its root it keeps it.
__device__ __forceinline__ int find_root(int* parent, int i) {
  const volatile int* at = parent;
  int p = at[i];
  while (p != i) {
    const int above = at[p];
    if (above == p) return p;
    atomicMin(&parent[i], above);
    i = above;
    p = at[i];
  }
  return i;
}

__device__ __forceinline__ void unite(int* parent, int a, int b) {
  a = find_root(parent, a);
  b = find_root(parent, b);
  while (a != b) {
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(&parent[a], b);
    if (old == a) return;  // a was a root and now hangs under b
    // a already hung under old < a, and now hangs under the lesser of old and
    // b: those two still have to be joined.
    a = find_root(parent, old);
    b = find_root(parent, b);
  }
}

// ------------------------------------------------------------- one board

// The board with its border: N + 1 cells a row (one border cell closes a row
// and opens the next), a border row above and one below.
__host__ __device__ __forceinline__ int bordered_cells(int n) { return (n + 2) * (n + 1); }

// where[i]: cell i's place in the bordered board.
__device__ __forceinline__ void fill_places(uint16_t* where, int n, int rank, int size) {
  for (int i = rank; i < n * n; i += size) {
    const int r = i / n;
    where[i] = static_cast<uint16_t>((r + 1) * (n + 1) + (i - r * n));
  }
}

// Pass 1.  src_a/src_b point at this board's N*N bytes of each plane.
template <class Op>
__device__ __forceinline__ void load_classes(const uint8_t* src_a, const uint8_t* src_b, int m,
                                             const uint16_t* where, uint8_t* cls) {
  for (int i = threadIdx.x & 31; i < m; i += 32) {
    cls[where[i]] = Op::cell_class(src_a[i] != 0, src_b[i] != 0);
  }
  __syncwarp();
}

// Passes 2-6.  cls (bordered), parent and acc (Op::kWords arrays of `pitch`
// ints) are this warp's own.
template <class Op>
__device__ __forceinline__ void label_board(int n, int m, int pitch, const uint16_t* where,
                                            const uint8_t* cls, int* parent, int* acc,
                                            typename Op::Out out, size_t out_base) {
  const int lane = threadIdx.x & 31;
  const int row = n + 1;
  const unsigned below = (1u << lane) - 1, at_or_below = below | 1u << lane;

  // 2. runs, and the vertical pairs to unite
  uint16_t* pairs = reinterpret_cast<uint16_t*>(acc);
  int count = 0;
  unsigned starts_before = 0, ups_before = 0;
  for (int first = 0; first < m; first += 32) {
    const int i = first + lane;
    uint8_t c = 0, to_left = 0;
    bool up = false, left = false;
    if (i < m) {
      const int at = where[i];
      c = cls[at];
      to_left = cls[at - 1];
      up = (c & cls[at - row]) != 0;
      left = (c & to_left) != 0;
    }
    const unsigned starts = ~__ballot_sync(0xFFFFFFFFu, left);
    const unsigned ups = __ballot_sync(0xFFFFFFFFu, up);
    bool pair = false;
    if (i < m) {
      const unsigned mine = starts & at_or_below;
      parent[i] = mine ? first + 31 - __clz(mine) : first - 1 - __clz(starts_before);
      // The pair to the left joins the same two runs if it is a pair, this
      // cell is in its run, and the two cells above are in one run: sure
      // where all four are of one single class.
      const bool left_is_pair = lane ? (ups >> (lane - 1) & 1) : (ups_before >> 31);
      const bool same_runs = left && left_is_pair && to_left == c && (c & (c - 1)) == 0;
      pair = up && !same_runs;
    }
    const unsigned listed = __ballot_sync(0xFFFFFFFFu, pair);
    if (pair) pairs[count + __popc(listed & below)] = static_cast<uint16_t>(i);
    count += __popc(listed);
    starts_before = starts;
    ups_before = ups;
  }
  __syncwarp();

  // 3. unions.  A lane takes a stretch of the list, so the pairs united at
  // the same moment lie far apart and those of one neighbourhood one after
  // the other: neighbouring pairs united at once hang each root under the
  // next and leave long chains to chase.
  const int each = (count + 31) >> 5;
  for (int j = lane * each; j < min(count, (lane + 1) * each); ++j) {
    const int i = pairs[j];
    unite(parent, i, i - n);
  }
  __syncwarp();

  // 4. seeds
  for (int i = lane; i < m; i += 32) {
    const int at = where[i];
    // the neighbours above, below, left, right: their classes and cell numbers
    const uint8_t nc[4] = {cls[at - row], cls[at + row], cls[at - 1], cls[at + 1]};
    const int nbr[4] = {i - n, i + n, i - 1, i + 1};
    int seed[Op::kWords];
    Op::seed(cls[at], nc, nbr, m, seed);
#pragma unroll
    for (int w = 0; w < Op::kWords; ++w) acc[w * pitch + i] = seed[w];
  }
  __syncwarp();

  // 5. roots and the reduction into them
  for (int i = lane; i < m; i += 32) {
    const int root = find_root(parent, i);
    if (root != i) {
      atomicMin(&parent[i], root);
#pragma unroll
      for (int w = 0; w < Op::kWords; ++w) Op::reduce(w, &acc[w * pitch + root], acc[w * pitch + i], m);
    }
  }
  __syncwarp();

  // 6. output
  for (int i = lane; i < m; i += 32) {
    const int root = parent[i];
    int word[Op::kWords];
#pragma unroll
    for (int w = 0; w < Op::kWords; ++w) word[w] = acc[w * pitch + root];
    Op::store(out, out_base + i, word);
  }
  // No barrier here: the next board's pass 1 writes cls only, which this pass
  // does not read, and ends on one.
}

// ------------------------------------------------------------ the kernel

// Where things lie in a block's dynamic shared memory: where[], then each
// warp's parent, acc and cls.
struct Layout {
  int per_warp, pitch, cls_bytes, total;
  __host__ __device__ Layout(int n, int words) {
    pitch = (n * n + 31) & ~31;
    cls_bytes = (bordered_cells(n) + 31) & ~31;
    per_warp = 4 * pitch * (1 + words) + cls_bytes;
    total = 2 * pitch + kWarps * per_warp;
  }
};

template <class Op>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    components_kernel(const uint8_t* __restrict__ plane_a, const uint8_t* __restrict__ plane_b,
                      typename Op::Out out, int batch, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m = n * n;
  const Layout at(n, Op::kWords);
  uint16_t* where = reinterpret_cast<uint16_t*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* parent = reinterpret_cast<int*>(smem + 2 * at.pitch + warp * at.per_warp);
  int* acc = parent + at.pitch;
  uint8_t* cls = reinterpret_cast<uint8_t*>(acc + Op::kWords * at.pitch);

  fill_places(where, n, threadIdx.x, kThreads);
  for (int j = lane; j < at.cls_bytes; j += 32) cls[j] = kClsBorder;
  __syncthreads();

  for (int board = blockIdx.x * kWarps + warp; board < batch; board += gridDim.x * kWarps) {
    const size_t base = static_cast<size_t>(board) * m;
    load_classes<Op>(plane_a + base, plane_b + base, m, where, cls);
    label_board<Op>(n, m, at.pitch, where, cls, parent, acc, out, base);
  }
}

// cudaSuccess, or why the kernel could not be launched.  Sizes the grid from
// the card: as many blocks as are resident at once.
template <class Op>
cudaError_t launch_components(const void* plane_a, const void* plane_b, typename Op::Out out,
                              int batch, int n, cudaStream_t stream) {
  if (batch <= 0) return cudaSuccess;
  auto kernel = components_kernel<Op>;
  // What the card offers, asked once for each device.
  static std::mutex lock;
  static int known = -1, sms = 0, block_bytes = 0;
  static int sized_for = -1, resident = 0;
  std::lock_guard<std::mutex> guard(lock);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device != known) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&block_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, block_bytes);
    if (err != cudaSuccess) return err;
    known = device;
    sized_for = -1;
  }

  const Layout at(n, Op::kWords);
  if (at.total > block_bytes) return cudaErrorInvalidValue;
  if (at.total != sized_for) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, kThreads, at.total);
    if (err != cudaSuccess) return err;
    sized_for = at.total;
  }
  if (resident < 1) return cudaErrorInvalidConfiguration;
  const int wanted = (batch + kWarps - 1) / kWarps;
  const int blocks = wanted < sms * resident ? wanted : sms * resident;
  kernel<<<blocks, kThreads, at.total, stream>>>(static_cast<const uint8_t*>(plane_a),
                                                static_cast<const uint8_t*>(plane_b), out, batch, n);
  return cudaGetLastError();
}

}  // namespace board_components
