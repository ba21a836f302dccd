// The env step: the sampler with the auto-reset, the rules, the bundle flood's
// labelling, the unpacking, area sums, reward and invalid-move dilation.
// Hand kernels for Hopper (sm_90a), built with nvcc into a shared library with
// a plain C interface and called through ctypes (gymgo_tpu_torch/ops/env_step.py).
//
// No TPU kernel is replaced: these kernels stand for the fusion XLA makes of
// the elementwise chain of gymgo_tpu/core/step.py (next_states_planes and its
// helpers) and of the rollout's sampler and auto-reset
// (gymgo_tpu/core/actions.py, gymgo_tpu/env/batch_env.py).  They compute what
// gymgo_tpu_torch/core/step.py:step_planes_plain computes, bit for bit: every
// plane, every per-board flag, the captures, the areas and the float32
// reward.
//
// The carried path (bool planes with the carried atari plane: the rollout's
// step) is one launch a step:
//
//   env_fused   a warp a board: the auto-reset (a finished board reads as the
//               empty board) and the sampler, the rules, the bundle flood's
//               labelling of the board after the move (board_components.cuh,
//               bundle_word.cuh) and everything after it; the board's class
//               bytes and bundle words stay in shared memory in between
//
// The stateless path (int8 (B, 6, N, N) states, or planes without the
// carried atari plane: the search's and GTP's step) has no carried atari
// plane, so its captures come from a labelling of the board before the move
// as well; it keeps the five launches of a chain:
//
//   env_split   the two contiguous stone planes of the states
//   bundle      the flood of the board before the move (bundle_flood.cu)
//   env_rules   the rules before the flood: the action's range and the
//               invalid plane, placement, the ko probe (from the carried
//               ko_surr, or from the opponent's 4-neighbourhood), the
//               captures (from the carried atari plane, or from the bundle
//               word of the board before the move), the capture count and
//               the captured cell, frozen boards; writes the two uint8 stone
//               planes the bundle flood takes and one int32 word a board
//   bundle      the flood of the board after the move
//   env_score   the word unpacked, both areas, the reward, the next invalid
//               mask (suicide rule and ko), the next ko-surround map and
//               atari plane, every output plane and flag
//
// and env_sample zeroes finished boards in place (reset_finished) and, given
// random words, turns each into its action: k = word * (valid + 1) >> 31, and
// the k-th valid point in row-major order, pass when k is the count
// (core/actions.py: scale_words, kth_valid_actions).  Each rule is one
// __device__ function below, which env_fused and the chain's kernels share.
//
// What bounds it.  Every rule is elementwise over a board but for per-board
// sums and the dilation's neighbours, so the floor is the bytes of the planes
// read and written: at 19x19, 12 bytes a cell (the carried path's bool
// black, white, invalid and ko planes and its int16 atari plane, each read
// once and written once; the stateless path's six int8 planes in and out)
// and ~24 bytes a board of flags, actions and reward, 4,356 bytes a board at
// 3.35 TB/s: 16 us at B = 12288.  Above that the labelling's integer and
// shared-memory instructions and the latency of a warp's dependent loads.
// The chain hands its intermediates through device memory (two uint8 planes
// and an int32 word a cell, written and read back: 14 bytes a cell) and pays
// each launch's ramp and tail; env_fused writes nothing in between.
//
// Design.  One warp a board: N*N <= 511, so a lane holds at most 16 cells
// (l, l + 32, ...), and neighbouring lanes touch neighbouring bytes.
// Per-board scalars (the action, the flags) stay in registers, sums are warp
// reductions (no packed words that could spill into each other), and the
// sampler's rank-select is a ballot and a popcount over 32 cells at a time.
// The dilation reads its neighbours from a bordered board of packed classes
// in shared memory.  env_fused is the bundle kernel's components_kernel with
// the rules in place of its pass 1 and the score in place of its pass 6: the
// rules write each cell's class byte into the warp's bordered board, the
// labelling leaves each cell's root in parent[] and its component's word in
// acc[root], and the score writes the packed classes over the class bytes.
// Its shared memory is the bundle kernel's, a warp a board; its blocks stride
// over the boards.

#include <cstdint>

#include <cuda_runtime.h>

#include "bundle_word.cuh"

namespace {

using board_components::BundleOp;
using board_components::kBitA;
using board_components::kBitB;
using board_components::kClsA;
using board_components::kClsB;
using board_components::kClsBorder;
using board_components::kMask9;

constexpr int kMaxCells = board_components::kBundleCells;
constexpr int kMaxN = 22;       // the largest board of kMaxCells cells
constexpr int kWarps = 8;       // boards a block of the chain's kernels
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kAll = 0xFFFFFFFFu;
static_assert(kMaxN * kMaxN <= kMaxCells && (kMaxN + 1) * (kMaxN + 1) > kMaxCells, "kMaxN");

// env_fused: warps a block (at most; fewer where the batch leaves SMs idle)
// and the blocks an SM that its launch bounds hold the registers to.
constexpr int kFusedWarps = 16;
constexpr int kFusedBlocksPerSM = 3;

// The word env_rules hands env_score for each board (env_fused keeps it in
// registers)
constexpr int kNoKo = kMask9;  // bits 0-8: the ko point, or no cell
constexpr int kCountShift = 9;  // bits 9-18: stones captured (0 on a frozen board)
constexpr int kInvalid = 1 << 19;
constexpr int kFrozen = 1 << 20;
constexpr int kMoverWhite = 1 << 21;
constexpr int kWhiteNext = 1 << 22;
constexpr int kPassedNext = 1 << 23;
constexpr int kDoneNext = 1 << 24;
constexpr int kWasDone = 1 << 25;
constexpr int kFresh = 1 << 26;  // env_fused's own: the board restarted

// The packed class of a cell after the move, which the dilation ORs over its
// neighbours: bits 0 atari mover, 1 multi mover, 2 atari opp, 7 multi opp, 4
// empty, 5 not mover, 6 not opp.  Bit 3 is the border's (kClsBorder), which
// no rule reads: the border counts as no neighbour.
constexpr int kAtariMover = 1, kMultiMover = 2, kAtariOpp = 4, kMultiOpp = 128;
constexpr int kEmpty = 16, kNotMover = 32, kNotOpp = 64;
static_assert(kClsBorder == 8, "the packed classes leave bit 3 to the border");

// reward methods of env_score
constexpr long long kNoReward = 0, kReal = 1, kHeuristic = 2;

__device__ __forceinline__ int board_of_warp() { return blockIdx.x * kWarps + (threadIdx.x >> 5); }

// ----------------------------------------------------------------- the rules

// The sampler's rank-select: bit j of `mine` says that the lane's cell
// lane + 32 j is a valid move; the action is the k-th valid point in
// row-major order, k = word * (valid + 1) >> 31, and pass (m) when k is the
// count.  Every lane returns it.
__device__ __forceinline__ int kth_valid(unsigned mine, int m, long long word) {
  const int lane = threadIdx.x & 31;
  const int valid = __reduce_add_sync(kAll, __popc(mine));
  const long long k = (word * (valid + 1LL)) >> 31;
  const unsigned below = (1u << lane) - 1;
  int before = 0;
  for (int j = 0, first = 0; first < m; ++j, first += 32) {
    const bool v = mine >> j & 1;
    const unsigned mask = __ballot_sync(kAll, v);
    const unsigned hits = __ballot_sync(kAll, v && before + __popc(mask & below) == k);
    if (hits) return first + __ffs(hits) - 1;
    before += __popc(mask);
  }
  return m;
}

// One board's move and what the rules decide before they look at its cells,
// the same in every lane.
struct Move {
  int at;  // the point played: the action clamped to the board
  bool is_pass, invalid, frozen, wtm, passed, done;
  bool surrounded;  // the ko probe
};

// The action's range and the invalid plane, frozen boards, and the ko probe,
// before the captures: every in-bounds neighbour of the move is an opponent
// stone.  invd(i), surr(i) and opp(i) read cell i of the board before the
// move: its invalid plane, its carried ko-surround map (when `carried_surr`)
// and the opponent's stones.
template <class Invd, class Surr, class Opp>
__device__ __forceinline__ Move read_move(long long action, int n, bool wtm, bool passed, bool done, Invd invd,
                                          bool carried_surr, Surr surr, Opp opp) {
  const int m = n * n;
  Move v;
  v.is_pass = action == m;
  const bool oob = action < 0 || action > m;
  v.at = static_cast<int>(action < 0 ? 0 : action > m - 1 ? m - 1 : action);
  v.wtm = wtm;
  v.passed = passed;
  v.done = done;
  v.invalid = oob || (!v.is_pass && invd(v.at));
  v.frozen = done || v.invalid;
  bool surrounded = !v.is_pass;
  if (carried_surr) {
    surrounded = surrounded && surr(v.at);
  } else {
    const int at = v.at, r = at / n, c = at - r * n;
    if (r > 0) surrounded = surrounded && opp(at - n);
    if (r < n - 1) surrounded = surrounded && opp(at + n);
    if (c > 0) surrounded = surrounded && opp(at - 1);
    if (c < n - 1) surrounded = surrounded && opp(at + 1);
  }
  v.surrounded = surrounded;
  return v;
}

// Whether the opponent group of a stone dies when the move is played: from
// the carried atari plane, iff its sole liberty is the point played ...
__device__ __forceinline__ bool dies_by_atari(int atari, const Move& v) { return atari == v.at + 1; }

// ... or, from the bundle word of the board before the move, also when it
// stands without a liberty already (a hand-made board).
__device__ __forceinline__ bool dies_by_word(int word, const Move& v) {
  const int any = word & kMask9, all = ~(word >> 9) & kMask9;
  return any == 0 || (any == all && any == v.at + 1);
}

// Cell i after the move: bit 0 a mover stone, bit 1 an opponent stone (a
// frozen board's stones as they were); its capture counted into the lane's
// sums.  `dies`: dies_by_atari or dies_by_word of the cell.
__device__ __forceinline__ int rules_cell(bool b, bool w, bool dies, int i, const Move& v, int& captured,
                                          int& captured_at) {
  const bool own = v.wtm ? w : b, theirs = v.wtm ? b : w;
  const bool killed = theirs && dies && !v.is_pass;
  captured += killed;
  captured_at += killed ? i : 0;
  const bool mover = v.frozen ? b : (own || (!v.is_pass && i == v.at));
  const bool opp = v.frozen ? w : (theirs && !killed);
  return mover | opp << 1;
}

// The board's word for the score, from the move and the warp's capture sums.
__device__ __forceinline__ int info_word(const Move& v, int captured, int captured_at) {
  const bool ko = captured == 1 && v.surrounded;
  return (ko ? captured_at : kNoKo) | (v.frozen ? 0 : captured << kCountShift) | (v.invalid ? kInvalid : 0) |
         (v.frozen ? kFrozen : 0) | (v.wtm && !v.frozen ? kMoverWhite : 0) | (v.wtm != !v.frozen ? kWhiteNext : 0) |
         ((v.frozen ? v.passed : v.is_pass) ? kPassedNext : 0) |
         ((v.frozen ? v.done : v.passed && v.is_pass) ? kDoneNext : 0) | (v.done ? kWasDone : 0);
}

// ----------------------------------------------------------------- the score

// The outputs of a step; each may be null.
struct ScoreOut {
  uint8_t* black;  // (B, N, N)
  uint8_t* white;
  uint8_t* invd;
  int16_t* atari;
  uint8_t* ko_surr;
  uint8_t* states;  // (B, 6, N, N)
  uint8_t* wtm;     // (B,)
  uint8_t* passed;
  uint8_t* done;
  uint8_t* done_row;  // a second copy of done
  uint8_t* was_done;
  uint8_t* invalid;
  int32_t* captured;
  int32_t* black_area;
  int32_t* white_area;
  float* reward;
  double komi;
  long long reward_method;
};

// The board after the move, from its info word: the same in every lane.
struct Outcome {
  int info, ko;
  bool frozen, mover_white, white_next, passed_next, done_next;
  __device__ __forceinline__ explicit Outcome(int word)
      : info(word),
        ko(word & kMask9),
        frozen(word & kFrozen),
        mover_white(word & kMoverWhite),
        white_next(word & kWhiteNext),
        passed_next(word & kPassedNext),
        done_next(word & kDoneNext) {}
};

// The word of a cell after the move unpacked (one distinct liberty iff the
// OR of the liberty codes equals their AND): the cell's atari code (its
// group's sole liberty + 1, or 0) into `atari`, its area counted, and its
// packed class returned.
__device__ __forceinline__ uint8_t unpack_cell(bool mv, bool op, int word, int& atari, int& mover_area,
                                               int& opp_area) {
  const int any = word & kMask9, all = ~(word >> 9) & kMask9;
  const bool stones = mv || op, has = any != 0;
  const bool one = stones && has && any == all, multi = stones && has && any != all;
  const bool got_a = word & kBitA, got_b = word & kBitB;
  mover_area += mv || (!stones && got_a && !got_b);
  opp_area += op || (!stones && got_b && !got_a);
  atari = one ? any : 0;
  const int cls = mv ? (one ? kAtariMover : 0) | (multi ? kMultiMover : 0)
                     : op ? (one ? kAtariOpp : 0) | (multi ? kMultiOpp : 0) : kEmpty;
  return static_cast<uint8_t>(cls | (mv ? 0 : kNotMover) | (op ? 0 : kNotOpp));
}

// The 4-neighbour OR of the packed classes at place p of a bordered board
// (board_components.cuh's: N + 1 places a row, a border row above and below).
__device__ __forceinline__ int dilated(const uint8_t* packed, int p, int row) {
  return packed[p - row] | packed[p + row] | packed[p - 1] | packed[p + 1];
}

// Cell i's outputs from its packed class p and its neighbours' OR.  No empty
// neighbour means surrounded (the edge is a wall); no neighbour that is not a
// mover stone means every in-bounds neighbour is one.  `invd_in`: the cell's
// invalid bit before the move, which a frozen board keeps.
__device__ __forceinline__ void score_cell(const ScoreOut& o, size_t base, int m, int i, int p, int dil,
                                           const Outcome& s, bool invd_in) {
  const bool mv = !(p & kNotMover), op = !(p & kNotOpp), stones = mv || op;
  const bool possible = !stones && (dil & (kMultiMover | kAtariOpp));  // next to a multi mover or an atari opp group
  const bool definite = dil & (kAtariMover | kMultiOpp);                // next to an atari mover or a multi opp group
  bool inv = stones || (possible && !definite && !(dil & kEmpty)) || i == s.ko;
  if (s.frozen) inv = invd_in;
  const bool all_mover = !(dil & kNotMover), all_opp = !(dil & kNotOpp);
  const bool all_black = s.mover_white ? all_opp : all_mover, all_white = s.mover_white ? all_mover : all_opp;
  const bool b = s.mover_white ? op : mv, w = s.mover_white ? mv : op;
  if (o.black) o.black[base + i] = b;
  if (o.white) o.white[base + i] = w;
  if (o.invd) o.invd[base + i] = inv;
  // the next step's opponent is black iff white moves next
  if (o.ko_surr) o.ko_surr[base + i] = s.white_next ? all_black : all_white;
  if (o.states) {
    uint8_t* states = o.states + base * 6;
    states[i] = b;
    states[m + i] = w;
    states[2 * m + i] = s.white_next;
    states[3 * m + i] = inv;
    states[4 * m + i] = s.passed_next;
    states[5 * m + i] = s.done_next;
  }
}

// The board's flags, captures, areas and reward (one lane).
__device__ __forceinline__ void score_board(const ScoreOut& o, int board, int m, const Outcome& s, int mover_area,
                                            int opp_area) {
  const int black_area = s.mover_white ? opp_area : mover_area;
  const int white_area = s.mover_white ? mover_area : opp_area;
  if (o.wtm) o.wtm[board] = s.white_next;
  if (o.passed) o.passed[board] = s.passed_next;
  if (o.done) o.done[board] = s.done_next;
  if (o.done_row) o.done_row[board] = s.done_next;
  if (o.was_done) o.was_done[board] = (s.info & kWasDone) != 0;
  if (o.invalid) o.invalid[board] = (s.info & kInvalid) != 0;
  if (o.captured) o.captured[board] = s.info >> kCountShift & 1023;
  if (o.black_area) o.black_area[board] = black_area;
  if (o.white_area) o.white_area[board] = white_area;
  if (o.reward) {
    // core/score.py:reward_from_areas: two float32 subtractions in its order
    const float kc = __fsub_rn(__fsub_rn(__int2float_rn(black_area), __int2float_rn(white_area)),
                               __double2float_rn(o.komi));
    float reward;
    if (o.reward_method == kReal) {
      reward = s.done_next ? static_cast<float>((kc > 0.0f) - (kc < 0.0f)) : 0.0f;
    } else {
      reward = s.done_next ? (kc > 0.0f ? 1.0f : -1.0f) * static_cast<float>(m) : kc;
    }
    o.reward[board] = reward;
  }
}

// ------------------------------------------------------------------ sample

struct SampleArgs {
  uint8_t* black;
  uint8_t* white;
  uint8_t* invd;
  int16_t* atari;    // may be null
  uint8_t* ko_surr;  // may be null
  uint8_t* wtm;
  uint8_t* passed;
  uint8_t* done;
  const int64_t* words;  // null: reset only
  int32_t* actions;
  long long batch, n, reset;
};

__global__ void __launch_bounds__(kThreads) sample_kernel(SampleArgs a) {
  const int board = board_of_warp();
  if (board >= a.batch) return;  // the whole warp leaves
  const int lane = threadIdx.x & 31, m = static_cast<int>(a.n * a.n);
  const size_t base = static_cast<size_t>(board) * m;
  const bool fresh = a.reset && a.done[board] != 0;
  __syncwarp();  // every lane has read done before lane 0 clears it
  if (fresh) {
    for (int i = lane; i < m; i += 32) {
      a.black[base + i] = 0;
      a.white[base + i] = 0;
      a.invd[base + i] = 0;
      if (a.atari) a.atari[base + i] = 0;
      if (a.ko_surr) a.ko_surr[base + i] = 0;
    }
    if (lane == 0) a.wtm[board] = a.passed[board] = a.done[board] = 0;
  }
  if (!a.words) return;
  unsigned mine = 0;
  for (int j = 0, i = lane; i < m; ++j, i += 32) {
    if (fresh || a.invd[base + i] == 0) mine |= 1u << j;
  }
  const int action = kth_valid(mine, m, a.words[board]);
  if (lane == 0) a.actions[board] = action;
}

// ------------------------------------------------------------------- split

struct SplitArgs {
  const uint8_t* states;  // (B, 6, N, N), one byte a value
  uint8_t* black;         // (B, N, N) out
  uint8_t* white;
  long long batch, n;
};

__global__ void __launch_bounds__(kThreads) split_kernel(SplitArgs a) {
  const int board = board_of_warp();
  if (board >= a.batch) return;
  const int lane = threadIdx.x & 31, m = static_cast<int>(a.n * a.n);
  const uint8_t* s = a.states + static_cast<size_t>(board) * 6 * m;
  const size_t base = static_cast<size_t>(board) * m;
  for (int i = lane; i < m; i += 32) {
    a.black[base + i] = s[i] != 0;
    a.white[base + i] = s[m + i] != 0;
  }
}

// ------------------------------------------------------------------- rules

struct RulesArgs {
  const uint8_t* black;  // board b's plane at black + b * plane_stride
  const uint8_t* white;
  const uint8_t* invd;
  long long plane_stride;
  const uint8_t* wtm;  // board b's flag at wtm[b * flag_stride]
  const uint8_t* passed;
  const uint8_t* done;
  long long flag_stride;
  const int16_t* atari;    // (B, N, N): the carried path
  const uint8_t* ko_surr;  // (B, N, N), may be null
  const int32_t* word;     // (B, N, N): the bundle word of the board before the move (stateless path)
  const void* actions;
  long long action_bytes;  // 4 or 8
  int32_t* actions_out;    // may be null: the actions as int32
  uint8_t* mover;          // (B, N, N) out
  uint8_t* opp;
  int32_t* info;  // (B,) out
  long long batch, n;
};

__device__ __forceinline__ long long action_of(const void* actions, long long action_bytes, int board) {
  return action_bytes == 8 ? static_cast<const int64_t*>(actions)[board] : static_cast<const int32_t*>(actions)[board];
}

template <bool kCarried>
__global__ void __launch_bounds__(kThreads) rules_kernel(RulesArgs a) {
  const int board = board_of_warp();
  if (board >= a.batch) return;
  const int lane = threadIdx.x & 31, n = static_cast<int>(a.n), m = n * n;
  const size_t base = static_cast<size_t>(board) * m;
  const size_t pb = static_cast<size_t>(board) * a.plane_stride;
  const size_t fb = static_cast<size_t>(board) * a.flag_stride;
  const uint8_t* black = a.black + pb;
  const uint8_t* white = a.white + pb;
  const uint8_t* invd = a.invd + pb;
  const uint8_t* ko_surr = a.ko_surr ? a.ko_surr + base : nullptr;
  const bool wtm = a.wtm[fb] != 0;
  const uint8_t* opp_in = wtm ? black : white;
  const long long action = action_of(a.actions, a.action_bytes, board);
  const Move v = read_move(
      action, n, wtm, a.passed[fb] != 0, a.done[fb] != 0, [=](int i) { return invd[i] != 0; }, a.ko_surr != nullptr,
      [=](int i) { return ko_surr[i] != 0; }, [=](int i) { return opp_in[i] != 0; });

  int captured = 0, captured_at = 0;
  for (int i = lane; i < m; i += 32) {
    bool dies;
    if constexpr (kCarried) {
      dies = dies_by_atari(a.atari[base + i], v);
    } else {
      dies = dies_by_word(a.word[base + i], v);
    }
    const int stones = rules_cell(black[i] != 0, white[i] != 0, dies, i, v, captured, captured_at);
    a.mover[base + i] = stones & 1;
    a.opp[base + i] = stones >> 1;
  }
  captured = __reduce_add_sync(kAll, captured);
  captured_at = __reduce_add_sync(kAll, captured_at);
  if (lane == 0) {
    a.info[board] = info_word(v, captured, captured_at);
    if (a.actions_out) a.actions_out[board] = static_cast<int32_t>(action);
  }
}

// ------------------------------------------------------------------- score

struct ScoreArgs {
  const uint8_t* mover;  // (B, N, N): env_rules' planes, the bundle kernel's inputs
  const uint8_t* opp;
  const int32_t* word;  // (B, N, N): the bundle word of the board after the move
  const int32_t* info;  // (B,): env_rules' word
  const uint8_t* invd_in;  // a frozen board keeps it: board b's at invd_in + b * invd_stride
  long long invd_stride;
  ScoreOut out;
  long long batch, n;
};

__global__ void __launch_bounds__(kThreads) score_kernel(ScoreArgs a) {
  // each warp's board of packed classes, bordered
  __shared__ uint8_t packed_of[kWarps][(kMaxN + 2) * (kMaxN + 1)];
  const int board = board_of_warp();
  if (board >= a.batch) return;
  const int lane = threadIdx.x & 31, n = static_cast<int>(a.n), m = n * n, row = n + 1;
  const size_t base = static_cast<size_t>(board) * m;
  uint8_t* packed = packed_of[threadIdx.x >> 5];
  for (int j = lane; j < board_components::bordered_cells(n); j += 32) packed[j] = kClsBorder;
  __syncwarp();
  const Outcome s(a.info[board]);

  int mover_area = 0, opp_area = 0;
  for (int i = lane; i < m; i += 32) {
    int atari;
    packed[i + i / n + row] = unpack_cell(a.mover[base + i] != 0, a.opp[base + i] != 0, a.word[base + i], atari,
                                          mover_area, opp_area);
    if (a.out.atari) a.out.atari[base + i] = static_cast<int16_t>(atari);
  }
  mover_area = __reduce_add_sync(kAll, mover_area);
  opp_area = __reduce_add_sync(kAll, opp_area);
  __syncwarp();

  const uint8_t* invd_in = a.invd_in + static_cast<size_t>(board) * a.invd_stride;
  for (int i = lane; i < m; i += 32) {
    const int p = i + i / n + row;
    score_cell(a.out, base, m, i, packed[p], dilated(packed, p, row), s, s.frozen && invd_in[i] != 0);
  }
  if (lane == 0) score_board(a.out, board, m, s, mover_area, opp_area);
}

// ------------------------------------------------------------------- fused

struct FusedArgs {
  const uint8_t* black;  // board b's plane at black + b * plane_stride
  const uint8_t* white;
  const uint8_t* invd;
  long long plane_stride;
  const uint8_t* wtm;  // board b's flag at wtm[b * flag_stride]
  const uint8_t* passed;
  const uint8_t* done;
  long long flag_stride;
  const int16_t* atari;    // (B, N, N)
  const uint8_t* ko_surr;  // (B, N, N), may be null
  const int64_t* words;    // (B,): the sampler's words; null: the actions are given
  const void* actions;     // (B,) int32 or int64, when there are no words
  long long action_bytes;  // 4 or 8
  int32_t* actions_out;    // may be null: the actions played, as int32
  long long reset;         // a finished board restarts as the empty board
  ScoreOut out;
  long long batch, n;
};

__global__ void __launch_bounds__(kFusedWarps * 32, kFusedBlocksPerSM) fused_kernel(FusedArgs a) {
  using board_components::Layout;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = static_cast<int>(a.n), m = n * n, row = n + 1;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Layout at(n, BundleOp::kWords);
  uint16_t* where = reinterpret_cast<uint16_t*>(smem);
  int* parent = reinterpret_cast<int*>(smem + 2 * at.pitch + warp * at.per_warp);
  int* acc = parent + at.pitch;
  uint8_t* cls = reinterpret_cast<uint8_t*>(acc + BundleOp::kWords * at.pitch);

  board_components::fill_places(where, n, threadIdx.x, blockDim.x);
  for (int j = lane; j < at.cls_bytes; j += 32) cls[j] = kClsBorder;
  __syncthreads();

  // Across the labelling a board keeps two registers, its number and its info
  // word (kFresh beside it): the labelling needs the rest of them.
  for (int board = blockIdx.x * warps + warp; board < a.batch; board += gridDim.x * warps) {
    int info;
    {
      const size_t base = static_cast<size_t>(board) * m;
      const size_t pb = static_cast<size_t>(board) * a.plane_stride;
      const size_t fb = static_cast<size_t>(board) * a.flag_stride;
      const uint8_t* black = a.black + pb;
      const uint8_t* white = a.white + pb;
      const uint8_t* invd = a.invd + pb;
      const uint8_t* ko_surr = a.ko_surr ? a.ko_surr + base : nullptr;
      const int16_t* atari = a.atari + base;
      // A finished board restarts: it reads as the empty board, nothing zeroed
      const bool fresh = a.reset && a.done[fb] != 0;
      const bool wtm = !fresh && a.wtm[fb] != 0;
      const uint8_t* opp_in = wtm ? black : white;

      long long action;
      if (a.words) {
        unsigned mine = 0;
#pragma unroll 1
        for (int j = 0, i = lane; i < m; ++j, i += 32) {
          if (fresh || invd[i] == 0) mine |= 1u << j;
        }
        action = kth_valid(mine, m, a.words[board]);
      } else {
        action = action_of(a.actions, a.action_bytes, board);
      }
      if (a.actions_out && lane == 0) a.actions_out[board] = static_cast<int32_t>(action);
      const Move v = read_move(
          action, n, wtm, !fresh && a.passed[fb] != 0, !fresh && a.done[fb] != 0,
          [=](int i) { return !fresh && invd[i] != 0; }, a.ko_surr != nullptr,
          [=](int i) { return !fresh && ko_surr[i] != 0; }, [=](int i) { return !fresh && opp_in[i] != 0; });

      // the rules: each cell's class byte into the bordered board
      int captured = 0, captured_at = 0;
#pragma unroll 1
      for (int i = lane; i < m; i += 32) {
        bool b = false, w = false, dies = false;
        if (!fresh) {
          b = black[i] != 0;
          w = white[i] != 0;
          dies = dies_by_atari(atari[i], v);
        }
        const int stones = rules_cell(b, w, dies, i, v, captured, captured_at);
        cls[where[i]] = BundleOp::cell_class(stones & 1, stones >> 1);
      }
      info = info_word(v, __reduce_add_sync(kAll, captured), __reduce_add_sync(kAll, captured_at)) |
             (fresh ? kFresh : 0);
    }
    __syncwarp();

    // the labelling: parent[i] is cell i's root, acc[root] its bundle word
    board_components::label_components<BundleOp>(n, m, at.pitch, where, cls, parent, acc);

    // the score: the packed classes over the class bytes, each lane its own
    // cells, then the dilation and the outputs; a frozen board keeps its
    // invalid plane (a restarted one is empty)
    const Outcome s(info);
    const size_t base = static_cast<size_t>(board) * m;
    const uint8_t* invd_in = s.frozen && !(info & kFresh) ? a.invd + static_cast<size_t>(board) * a.plane_stride
                                                          : nullptr;
    int mover_area = 0, opp_area = 0;
#pragma unroll 1
    for (int i = lane; i < m; i += 32) {
      const int p = where[i];
      const uint8_t c = cls[p];
      int atari;
      cls[p] = unpack_cell(c & kClsA, c & kClsB, acc[parent[i]], atari, mover_area, opp_area);
      if (a.out.atari) a.out.atari[base + i] = static_cast<int16_t>(atari);
    }
    mover_area = __reduce_add_sync(kAll, mover_area);
    opp_area = __reduce_add_sync(kAll, opp_area);
    __syncwarp();
#pragma unroll 1
    for (int i = lane; i < m; i += 32) {
      const int p = where[i];
      score_cell(a.out, base, m, i, cls[p], dilated(cls, p, row), s, invd_in && invd_in[i] != 0);
    }
    if (lane == 0) score_board(a.out, board, m, s, mover_area, opp_area);
    __syncwarp();  // the next board's rules overwrite what this board's dilation reads
  }
}

int blocks_for(long long batch) { return static_cast<int>((batch + kWarps - 1) / kWarps); }

bool board_ok(long long n) { return n >= 1 && n * n <= kMaxCells; }

bool reward_ok(long long method) { return method >= kNoReward && method <= kHeuristic; }

}  // namespace

// Each launcher takes its arguments' struct from the host (copied into the
// launch) and the stream; returns a cudaError_t.

extern "C" int env_sample_launch(const void* arguments, void* stream) {
  const auto* args = static_cast<const SampleArgs*>(arguments);
  if (!board_ok(args->n)) return static_cast<int>(cudaErrorInvalidValue);
  if (args->batch <= 0) return static_cast<int>(cudaSuccess);
  sample_kernel<<<blocks_for(args->batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int env_split_launch(const void* arguments, void* stream) {
  const auto* args = static_cast<const SplitArgs*>(arguments);
  if (!board_ok(args->n)) return static_cast<int>(cudaErrorInvalidValue);
  if (args->batch <= 0) return static_cast<int>(cudaSuccess);
  split_kernel<<<blocks_for(args->batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int env_rules_launch(const void* arguments, void* stream) {
  const auto* args = static_cast<const RulesArgs*>(arguments);
  if (!board_ok(args->n) || (args->action_bytes != 4 && args->action_bytes != 8) ||
      (args->atari == nullptr) == (args->word == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (args->batch <= 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  if (args->atari) {
    rules_kernel<true><<<blocks_for(args->batch), kThreads, 0, s>>>(*args);
  } else {
    rules_kernel<false><<<blocks_for(args->batch), kThreads, 0, s>>>(*args);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int env_score_launch(const void* arguments, void* stream) {
  const auto* args = static_cast<const ScoreArgs*>(arguments);
  if (!board_ok(args->n) || !reward_ok(args->out.reward_method)) return static_cast<int>(cudaErrorInvalidValue);
  if (args->batch <= 0) return static_cast<int>(cudaSuccess);
  score_kernel<<<blocks_for(args->batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// env_fused's blocks: kFusedWarps warps, or fewer where the batch would leave
// multiprocessors without a board (at B = 512 on 132 of them, 4 warps a
// block), as many blocks as are resident at once and the batch needs.
extern "C" int env_fused_launch(const void* arguments, void* stream) {
  using namespace board_components;
  const auto* args = static_cast<const FusedArgs*>(arguments);
  if (!board_ok(args->n) || args->atari == nullptr || (args->action_bytes != 4 && args->action_bytes != 8) ||
      (args->words == nullptr && args->actions == nullptr) || !reward_ok(args->out.reward_method)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (args->batch <= 0) return static_cast<int>(cudaSuccess);
  Card card;
  const cudaError_t err = current_card(&card);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = static_cast<int>(args->n);
  const long long per_sm = (args->batch + card.sms - 1) / card.sms;
  const int warps = per_sm < kFusedWarps ? static_cast<int>(per_sm) : kFusedWarps;
  const Layout at(n, BundleOp::kWords);
  const int bytes = 2 * at.pitch + warps * at.per_warp;
  static Sizing sizing;
  return static_cast<int>(launch_resident(sizing, card, fused_kernel, 32 * warps, bytes,
                                          static_cast<int>((args->batch + warps - 1) / warps),
                                          static_cast<cudaStream_t>(stream), *args));
}
