// Connected-component reductions over batches of Go boards: what the three
// flood kernels (bundle_flood.cu, minmax_flood.cu, claim_flood.cu) share.
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
//      there is one, since at N <= 32 any 32 cells in a row hold a cell of
//      column 0, whose left neighbour is the border) is the head of its run,
//      which it takes as its parent.  Of the vertical pairs only the first of
//      each stretch of neighbouring pairs that join the same two runs goes
//      into a dense list;
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
//
// Boards over 32x32 (board_kernel<Op, T>, which launch_components picks for
// an Op whose launcher allows them): one board to a block of up to 32 warps,
// the same six passes with a block barrier between them.  Pass 2 hands whole
// rows to warps.  A run never leaves its row (a border cell closes each
// row), so a warp carries its row's last run start from one 32-cell step to
// the next, across steps that one run fills and that have no start of their
// own.  The vertical pairs go into the list through a shared counter.  All
// arrays stay in shared memory: int32 where they fit (on an H100 up to
// 133x133 for the min/max flood, 160x160 for the claim flood), else int16
// (T = int16_t), whose atomics are compare-and-swap loops on the 32-bit
// word that holds the cell.  int16 holds every index and word up to 181x181
// (N*N = 32,761 <= 32,767), where the JAX package's int16 indices stop too;
// the min/max flood's arrays then take 229,936 of the 232,448 bytes a block
// may have.  A workspace in device memory would have kept the int32 atomics
// but put every step of the union-find's chases behind the L2 cache's
// latency, and made the wrapper allocate it; the int16 arrays keep every
// access in shared memory.

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

// The largest boards a warp and a block label.
constexpr int kLaneCells = 32 * 32;     // 32 cells a lane
constexpr int kBoardCells = 181 * 181;  // int16 indices and words
static_assert(kBoardCells <= 32767, "int16 holds every cell index and N*N");
static_assert((181 + 2) * (181 + 1) <= 65535, "uint16_t holds every place of a bordered board");
constexpr int kBoardWarps = 32;  // the most warps a block gives one board

// class bits of a cell: mover, opp, empty, and the border around the board
constexpr uint8_t kClsA = 1, kClsB = 2, kClsE = 4, kClsBorder = 8;

// ------------------------------------------------------------------ atomics

// The union-find's links and the reductions, on int32 words (the hardware's
// atomics) and on int16 words (a compare-and-swap loop on the aligned 32-bit
// word that holds the cell, which writes the other half back as it saw it:
// a change to that half makes the swap fail and the loop go round again).
// Each returns the old value, as the hardware's atomics do.
__device__ __forceinline__ int atomic_min(int* at, int v) { return atomicMin(at, v); }
__device__ __forceinline__ int atomic_max(int* at, int v) { return atomicMax(at, v); }
__device__ __forceinline__ int atomic_or(int* at, int v) { return atomicOr(at, v); }

struct Min {
  __device__ __forceinline__ int operator()(int a, int b) const { return a < b ? a : b; }
};
struct Max {
  __device__ __forceinline__ int operator()(int a, int b) const { return a > b ? a : b; }
};

// at - half keeps the pointer's provenance, so a shared-memory cell stays a
// shared-memory access
__device__ __forceinline__ int half_of(const int16_t* at) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(at) >> 1 & 1);
}

template <class F>
__device__ __forceinline__ int atomic16(int16_t* at, int v, F combine) {
  const int half = half_of(at), shift = 16 * half;
  unsigned* word = reinterpret_cast<unsigned*>(at - half);
  unsigned seen = *reinterpret_cast<volatile unsigned*>(word);
  for (;;) {
    const int old = static_cast<int16_t>(seen >> shift);
    const int want = combine(old, v);
    if (want == old) return old;
    const unsigned next = (seen & ~(0xFFFFu << shift)) | (static_cast<unsigned>(want) & 0xFFFFu) << shift;
    const unsigned got = atomicCAS(word, seen, next);
    if (got == seen) return old;
    seen = got;
  }
}

__device__ __forceinline__ int atomic_min(int16_t* at, int v) { return atomic16(at, v, Min()); }
__device__ __forceinline__ int atomic_max(int16_t* at, int v) { return atomic16(at, v, Max()); }
__device__ __forceinline__ int atomic_or(int16_t* at, int v) {
  const int half = half_of(at), shift = 16 * half;
  unsigned* word = reinterpret_cast<unsigned*>(at - half);
  return static_cast<int16_t>(atomicOr(word, (static_cast<unsigned>(v) & 0xFFFFu) << shift) >> shift);
}

// ---------------------------------------------------------------- union-find

// parent[] is read while other lanes atomicMin into it: volatile, so that
// every step of a chase is a real load.  parent[x] <= x always, so a chase
// ends, and the root of a component is its least cell.  A chase halves the
// path behind it, with atomicMin: a parent then only ever falls, so once a
// cell has been given its root it keeps it.  T is int, or int16_t on a
// board whose int32 arrays do not fit in shared memory.
template <class T>
__device__ __forceinline__ int find_root(T* parent, int i) {
  const volatile T* at = parent;
  int p = at[i];
  while (p != i) {
    const int above = at[p];
    if (above == p) return p;
    atomic_min(&parent[i], above);
    i = above;
    p = at[i];
  }
  return i;
}

template <class T>
__device__ __forceinline__ void unite(T* parent, int a, int b) {
  a = find_root(parent, a);
  b = find_root(parent, b);
  while (a != b) {
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomic_min(&parent[a], b);
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

// ------------------------------------------------------- a board to a block

// Where things lie in the dynamic shared memory of a block that labels one
// board at a time: parent, then Op::kWords acc arrays (`pitch` entries of
// `index_bytes` each), the bordered classes, and the pair list's length.
struct BoardLayout {
  int pitch, cls_bytes, count_at, total;
  __host__ __device__ BoardLayout(int n, int words, int index_bytes) {
    pitch = (n * n + 31) & ~31;
    cls_bytes = (bordered_cells(n) + 31) & ~31;
    count_at = index_bytes * pitch * (1 + words) + cls_bytes;
    total = count_at + 16;
  }
};

// The warps a block gives a board of m cells: about 8 cells a thread, 4 warps
// at least, kBoardWarps at most.
inline int board_warps(int m) {
  const int warps = (m + 255) / 256;
  return warps < 4 ? 4 : warps > kBoardWarps ? kBoardWarps : warps;
}

// Cell i's place in the bordered board: i + i / n + n + 1, the quotient by a
// multiply with `inverse` = 2^32 / n rounded up, exact while i * n < 2^32.
__device__ __forceinline__ int place_of(int i, unsigned inverse, int row) {
  return i + static_cast<int>(__umulhi(static_cast<unsigned>(i), inverse)) + row;
}

// The passes of label_board on one board with the whole block; the arrays
// are of T (int or int16_t), the block strides over the boards.
template <class Op, class T>
__global__ void __launch_bounds__(kBoardWarps * 32)
    board_kernel(const uint8_t* __restrict__ plane_a, const uint8_t* __restrict__ plane_b,
                 typename Op::Out out, int batch, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m = n * n, row = n + 1, tid = threadIdx.x, threads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, warps = threads >> 5;
  const unsigned below = (1u << lane) - 1, at_or_below = below | 1u << lane;
  const unsigned inverse = 0xFFFFFFFFu / n + 1;
  const BoardLayout at(n, Op::kWords, sizeof(T));
  T* parent = reinterpret_cast<T*>(smem);
  T* acc = parent + at.pitch;
  uint8_t* cls = reinterpret_cast<uint8_t*>(acc + Op::kWords * at.pitch);
  int* count = reinterpret_cast<int*>(smem + at.count_at);
  uint16_t* pairs = reinterpret_cast<uint16_t*>(acc);  // the list lies in acc until pass 4

  for (int j = tid; j < at.cls_bytes; j += threads) cls[j] = kClsBorder;
  __syncthreads();

  for (int board = blockIdx.x; board < batch; board += gridDim.x) {
    const size_t base = static_cast<size_t>(board) * m;
    // 1. classes.  The last board's pass 6 reads no class and no count.
    for (int i = tid; i < m; i += threads) {
      cls[place_of(i, inverse, row)] = Op::cell_class(plane_a[base + i] != 0, plane_b[base + i] != 0);
    }
    if (tid == 0) *count = 0;
    __syncthreads();

    // 2. runs, a warp a row, and the vertical pairs to unite
    for (int r = warp; r < n; r += warps) {
      int head = 0;  // the column of the row's last run start so far
      unsigned ups_before = 0;
      for (int first = 0; first < n; first += 32) {
        const int col = first + lane, i = r * n + col;
        uint8_t c = 0, to_left = 0;
        bool up = false, left = false;
        if (col < n) {
          const int p = (r + 1) * row + col;
          c = cls[p];
          to_left = cls[p - 1];
          up = (c & cls[p - row]) != 0;
          left = (c & to_left) != 0;
        }
        const unsigned starts = ~__ballot_sync(0xFFFFFFFFu, left);
        const unsigned ups = __ballot_sync(0xFFFFFFFFu, up);
        bool pair = false;
        if (col < n) {
          const unsigned mine = starts & at_or_below;
          parent[i] = static_cast<T>(r * n + (mine ? first + 31 - __clz(mine) : head));
          const bool left_is_pair = lane ? (ups >> (lane - 1) & 1) : (ups_before >> 31);
          const bool same_runs = left && left_is_pair && to_left == c && (c & (c - 1)) == 0;
          pair = up && !same_runs;
        }
        const unsigned listed = __ballot_sync(0xFFFFFFFFu, pair);
        int slot = 0;
        if (lane == 0 && listed) slot = atomicAdd(count, __popc(listed));
        slot = __shfl_sync(0xFFFFFFFFu, slot, 0);
        if (pair) pairs[slot + __popc(listed & below)] = static_cast<uint16_t>(i);
        // only a row's last step has lanes past its end, and no step follows it
        if (starts) head = first + 31 - __clz(starts);
        ups_before = ups;
      }
    }
    __syncthreads();

    // 3. unions, a stretch of the list a thread
    const int listed = *count;
    const int each = (listed + threads - 1) / threads;
    const int end = min(listed, (tid + 1) * each);
    for (int j = tid * each; j < end; ++j) {
      const int i = pairs[j];
      unite(parent, i, i - n);
    }
    __syncthreads();

    // 4. seeds
    for (int i = tid; i < m; i += threads) {
      const int p = place_of(i, inverse, row);
      const uint8_t nc[4] = {cls[p - row], cls[p + row], cls[p - 1], cls[p + 1]};
      const int nbr[4] = {i - n, i + n, i - 1, i + 1};
      int seed[Op::kWords];
      Op::seed(cls[p], nc, nbr, m, seed);
#pragma unroll
      for (int w = 0; w < Op::kWords; ++w) acc[w * at.pitch + i] = static_cast<T>(seed[w]);
    }
    __syncthreads();

    // 5. roots and the reduction into them
    for (int i = tid; i < m; i += threads) {
      const int root = find_root(parent, i);
      if (root != i) {
        atomic_min(&parent[i], root);
#pragma unroll
        for (int w = 0; w < Op::kWords; ++w) Op::reduce(w, &acc[w * at.pitch + root], acc[w * at.pitch + i], m);
      }
    }
    __syncthreads();

    // 6. output.  The next board's pass 1 writes what this pass does not read.
    for (int i = tid; i < m; i += threads) {
      const int root = parent[i];
      int word[Op::kWords];
#pragma unroll
      for (int w = 0; w < Op::kWords; ++w) word[w] = acc[w * at.pitch + root];
      Op::store(out, base + i, word);
    }
  }
}

// ----------------------------------------------------------------- launching

// What the card offers, asked once for each device.
struct Card {
  int device = -1, sms = 0, block_bytes = 0;
};

inline cudaError_t current_card(Card* card) {
  static std::mutex lock;
  static Card known;
  std::lock_guard<std::mutex> guard(lock);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device != known.device) {
    Card asked;
    err = cudaDeviceGetAttribute(&asked.sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&asked.block_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    asked.device = device;
    known = asked;
  }
  *card = known;
  return cudaSuccess;
}

// One kernel's set-up on the current device: its opt-in shared memory, and
// the blocks of a given size that a multiprocessor holds at once.
struct Sizing {
  std::mutex lock;
  int device = -1, threads = -1, bytes = -1, resident = 0;
};

// cudaSuccess, or why the kernel could not be launched.  Launches as many
// blocks as are resident at once, `wanted` at most.
template <class Kernel, class... Args>
cudaError_t launch_resident(Sizing& sizing, const Card& card, Kernel kernel, int threads, int bytes,
                            int wanted, cudaStream_t stream, Args... args) {
  std::lock_guard<std::mutex> guard(sizing.lock);
  cudaError_t err;
  if (sizing.device != card.device) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, card.block_bytes);
    if (err != cudaSuccess) return err;
    sizing.device = card.device;
    sizing.threads = -1;
  }
  if (bytes > card.block_bytes) return cudaErrorInvalidValue;
  if (threads != sizing.threads || bytes != sizing.bytes) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&sizing.resident, kernel, threads, bytes);
    if (err != cudaSuccess) return err;
    sizing.threads = threads;
    sizing.bytes = bytes;
  }
  if (sizing.resident < 1) return cudaErrorInvalidConfiguration;
  const int blocks = wanted < card.sms * sizing.resident ? wanted : card.sms * sizing.resident;
  kernel<<<blocks, threads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

// Labels boards of N*N <= kMaxCells cells, which the caller has checked: a
// warp a board up to 32x32, beyond that (where kMaxCells allows) a block a
// board, with int32 arrays where they fit in a block's shared memory and
// int16 ones where they do not.
template <class Op, int kMaxCells = kLaneCells>
cudaError_t launch_components(const void* plane_a, const void* plane_b, typename Op::Out out,
                              int batch, int n, cudaStream_t stream) {
  static_assert(kMaxCells <= kBoardCells, "int16 holds no larger board");
  if (batch <= 0) return cudaSuccess;
  Card card;
  const cudaError_t err = current_card(&card);
  if (err != cudaSuccess) return err;
  const auto a = static_cast<const uint8_t*>(plane_a);
  const auto b = static_cast<const uint8_t*>(plane_b);
  if constexpr (kMaxCells > kLaneCells) {
    if (n * n > kLaneCells) {
      static Sizing wide_sizing, narrow_sizing;
      const int threads = 32 * board_warps(n * n);
      const BoardLayout wide(n, Op::kWords, sizeof(int)), narrow(n, Op::kWords, sizeof(int16_t));
      if (wide.total <= card.block_bytes) {
        return launch_resident(wide_sizing, card, board_kernel<Op, int>, threads, wide.total, batch, stream,
                               a, b, out, batch, n);
      }
      return launch_resident(narrow_sizing, card, board_kernel<Op, int16_t>, threads, narrow.total, batch,
                             stream, a, b, out, batch, n);
    }
  }
  static Sizing sizing;
  const Layout at(n, Op::kWords);
  return launch_resident(sizing, card, components_kernel<Op>, kThreads, at.total, (batch + kWarps - 1) / kWarps,
                         stream, a, b, out, batch, n);
}

}  // namespace board_components
