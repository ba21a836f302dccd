// The env step around the bundle flood: the sampler with the auto-reset, the
// rules before the flood, and the unpacking, area sums, reward and
// invalid-move dilation after it.  Hand kernels for Hopper (sm_90a), built
// with nvcc into a shared library with a plain C interface and called through
// ctypes (gymgo_tpu_torch/ops/env_step.py).
//
// No TPU kernel is replaced: these kernels stand for the fusion XLA makes of
// the elementwise chain of gymgo_tpu/core/step.py (next_states_planes and its
// helpers) and of the rollout's sampler and auto-reset
// (gymgo_tpu/core/actions.py, gymgo_tpu/env/batch_env.py).  They compute what
// gymgo_tpu_torch/core/step.py:step_planes_plain computes, bit for bit: every
// plane, every per-board flag, the captures, the areas and the float32
// reward.  The bundle flood between them is csrc/bundle_flood.cu, unchanged.
//
// A step is four launches, five with the random words' draw:
//
//   env_sample  zero the finished boards in place (every plane, the carried
//               atari and ko planes, the flags), then turn each board's
//               random word into its action: k = word * (valid + 1) >> 31,
//               and the k-th valid point in row-major order, pass when k is
//               the count (core/actions.py: scale_words, kth_valid_actions)
//   env_rules   the rules before the flood: the action's range and the
//               invalid plane, placement, the ko probe (from the carried
//               ko_surr, or from the opponent's 4-neighbourhood), the
//               captures (from the carried atari plane, or from the bundle
//               word of the board before the move), the capture count and
//               the captured cell, frozen boards; writes the two uint8 stone
//               planes the bundle flood takes and one int32 word a board
//   bundle      the flood (bundle_flood.cu)
//   env_score   the word unpacked, both areas, the reward, the next invalid
//               mask (suicide rule and ko), the next ko-surround map and
//               atari plane, every output plane and flag
//
// The stateless path (int8 (B, 6, N, N) states, no carried planes) adds
// env_split before a first bundle launch on the board before the move; it
// writes the two contiguous stone planes the bundle flood takes.  env_rules
// then reads the states themselves through their strides, and env_score
// writes the int8 states.  One template (kCarried) serves both paths: they
// differ only in where the capture classes come from.
//
// What bounds it.  Every kernel is elementwise over a board but for per-board
// sums and the dilation's neighbours, so the floor is the bytes of the planes
// read and written: at 19x19, 12 bytes a cell (the carried path's bool
// black, white, invalid and ko planes and its int16 atari plane, each read
// once and written once; the stateless path's six int8 planes in and out)
// and ~24 bytes a board of flags, actions and reward, 4,356 bytes a board at
// 3.35 TB/s: 16 us at B = 12288.  The op-by-op PyTorch chain this replaces
// was ~190 launches a step, each a round trip of an intermediate plane
// through device memory, ~1 ms at B = 12288 and ~1.8 us a launch at B = 512.
//
// Design.  One warp a board, as the bundle kernel's warp path: N*N <= 511,
// so a lane holds at most 16 cells (l, l + 32, ...), and neighbouring lanes
// touch neighbouring bytes.  Per-board scalars (the action, the flags) stay
// in registers, sums are warp reductions (no packed words that could spill
// into each other), and the sampler's rank-select is a ballot and a popcount
// over 32 cells at a time.  Only env_score reads neighbours: the warp writes
// its board's packed classes into shared memory and the dilation reads them
// from there.  What remains in device memory between launches is what the
// unchanged bundle kernel takes and gives: two stone planes and its word.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCells = 511;  // the bundle word's 9-bit code field
constexpr int kWarps = 8;       // boards a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kAll = 0xFFFFFFFFu;

// The bundle word (bundle_flood.cu)
constexpr int kMask9 = (1 << 9) - 1;
constexpr int kBitA = 1 << 18;
constexpr int kBitB = 1 << 19;

// The word env_rules hands env_score for each board
constexpr int kNoKo = kMask9;  // bits 0-8: the ko point, or no cell
constexpr int kCountShift = 9;  // bits 9-18: stones captured (0 on a frozen board)
constexpr int kInvalid = 1 << 19;
constexpr int kFrozen = 1 << 20;
constexpr int kMoverWhite = 1 << 21;
constexpr int kWhiteNext = 1 << 22;
constexpr int kPassedNext = 1 << 23;
constexpr int kDoneNext = 1 << 24;
constexpr int kWasDone = 1 << 25;

// reward methods of env_score
constexpr long long kNoReward = 0, kReal = 1, kHeuristic = 2;

__device__ __forceinline__ int board_of_warp() { return blockIdx.x * kWarps + (threadIdx.x >> 5); }

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

  // bit j of `mine`: cell lane + 32 j is a valid move
  unsigned mine = 0;
  for (int j = 0, i = lane; i < m; ++j, i += 32) {
    if (fresh || a.invd[base + i] == 0) mine |= 1u << j;
  }
  const int valid = __reduce_add_sync(kAll, __popc(mine));
  const long long k = (a.words[board] * (valid + 1LL)) >> 31;
  const unsigned below = (1u << lane) - 1;
  int action = m;  // pass, when k is the count of valid points
  int before = 0;
  for (int j = 0, first = 0; first < m; ++j, first += 32) {
    const bool v = mine >> j & 1;
    const unsigned mask = __ballot_sync(kAll, v);
    const unsigned hits = __ballot_sync(kAll, v && before + __popc(mask & below) == k);
    if (hits) {
      action = first + __ffs(hits) - 1;
      break;
    }
    before += __popc(mask);
  }
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

  const long long action = a.action_bytes == 8 ? static_cast<const int64_t*>(a.actions)[board]
                                                : static_cast<const int32_t*>(a.actions)[board];
  const bool is_pass = action == m, oob = action < 0 || action > m;
  const int at = static_cast<int>(action < 0 ? 0 : action > m - 1 ? m - 1 : action);
  const bool wtm = a.wtm[fb] != 0, passed = a.passed[fb] != 0, done = a.done[fb] != 0;
  const bool invalid = oob || (!is_pass && a.invd[pb + at] != 0);
  const bool frozen = done || invalid;
  const uint8_t* opp_in = wtm ? black : white;

  // Ko probe, before the captures: every in-bounds neighbour of the move is
  // an opponent stone.
  bool surrounded = !is_pass;
  if (a.ko_surr) {
    surrounded = surrounded && a.ko_surr[base + at] != 0;
  } else {
    const int r = at / n, c = at - r * n;
    if (r > 0) surrounded = surrounded && opp_in[at - n] != 0;
    if (r < n - 1) surrounded = surrounded && opp_in[at + n] != 0;
    if (c > 0) surrounded = surrounded && opp_in[at - 1] != 0;
    if (c < n - 1) surrounded = surrounded && opp_in[at + 1] != 0;
  }

  int captured = 0, captured_at = 0;
  for (int i = lane; i < m; i += 32) {
    const bool b = black[i] != 0, w = white[i] != 0;
    const bool own = wtm ? w : b, theirs = wtm ? b : w;
    bool killed;
    if constexpr (kCarried) {
      // an opponent group dies iff its sole liberty is the point played
      killed = theirs && a.atari[base + i] == at + 1;
    } else {
      // ... or it stands without a liberty already (a hand-made board)
      const int word = a.word[base + i];
      const int any = word & kMask9, all = ~(word >> 9) & kMask9;
      killed = theirs && (any == 0 || (any == all && any == at + 1));
    }
    killed = killed && !is_pass;
    captured += killed;
    captured_at += killed ? i : 0;
    a.mover[base + i] = frozen ? b : (own || (!is_pass && i == at));
    a.opp[base + i] = frozen ? w : (theirs && !killed);
  }
  captured = __reduce_add_sync(kAll, captured);
  captured_at = __reduce_add_sync(kAll, captured_at);
  if (lane == 0) {
    const bool ko = captured == 1 && surrounded;
    a.info[board] = (ko ? captured_at : kNoKo) | (frozen ? 0 : captured << kCountShift) | (invalid ? kInvalid : 0) |
                    (frozen ? kFrozen : 0) | (wtm && !frozen ? kMoverWhite : 0) | (wtm != !frozen ? kWhiteNext : 0) |
                    ((frozen ? passed : is_pass) ? kPassedNext : 0) |
                    ((frozen ? done : passed && is_pass) ? kDoneNext : 0) | (done ? kWasDone : 0);
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
  // each output may be null
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
  long long reward_method, batch, n;
};

__global__ void __launch_bounds__(kThreads) score_kernel(ScoreArgs a) {
  __shared__ uint8_t packed_of[kWarps][kMaxCells + 1];
  const int board = board_of_warp();
  if (board >= a.batch) return;
  const int lane = threadIdx.x & 31, n = static_cast<int>(a.n), m = n * n;
  const size_t base = static_cast<size_t>(board) * m;
  uint8_t* packed = packed_of[threadIdx.x >> 5];
  const int info = a.info[board];
  const bool frozen = info & kFrozen, mover_white = info & kMoverWhite, white_next = info & kWhiteNext;
  const int ko = info & kMask9;

  // The word unpacked: one distinct liberty iff the OR of the liberty codes
  // equals their AND.  Per cell into shared memory, the packed classes of
  // step_planes_plain's dilation: bits 0 atari mover, 1 multi mover, 2 atari
  // opp, 3 multi opp, 4 empty, 5 not mover, 6 not opp.
  int mover_area = 0, opp_area = 0;
  for (int i = lane; i < m; i += 32) {
    const bool mv = a.mover[base + i] != 0, op = a.opp[base + i] != 0;
    const int word = a.word[base + i];
    const int any = word & kMask9, all = ~(word >> 9) & kMask9;
    const bool stones = mv || op, has = any != 0;
    const bool one = stones && has && any == all, multi = stones && has && any != all;
    const bool got_a = word & kBitA, got_b = word & kBitB;
    mover_area += mv || (!stones && got_a && !got_b);
    opp_area += op || (!stones && got_b && !got_a);
    if (a.atari) a.atari[base + i] = static_cast<int16_t>(one ? any : 0);
    const int cls = one | multi << 1;
    packed[i] = static_cast<uint8_t>((mv ? cls : op ? cls << 2 : 16) | !mv << 5 | !op << 6);
  }
  mover_area = __reduce_add_sync(kAll, mover_area);
  opp_area = __reduce_add_sync(kAll, opp_area);
  __syncwarp();

  // The 4-neighbour OR of the packed classes (off the board: 0).  No empty
  // neighbour means surrounded (the edge is a wall); no neighbour that is
  // not a mover stone means every in-bounds neighbour is one.
  const bool passed_next = info & kPassedNext, done_next = info & kDoneNext;
  const uint8_t* invd_in = a.invd_in + static_cast<size_t>(board) * a.invd_stride;
  uint8_t* states = a.states ? a.states + base * 6 : nullptr;
  int r = lane / n, c = lane - r * n;
  const int step_r = 32 / n, step_c = 32 - step_r * n;
  for (int i = lane; i < m; i += 32) {
    const int p = packed[i];
    const bool mv = !(p & 32), op = !(p & 64), stones = mv || op;
    const int dil = (r > 0 ? packed[i - n] : 0) | (r < n - 1 ? packed[i + n] : 0) | (c > 0 ? packed[i - 1] : 0) |
                    (c < n - 1 ? packed[i + 1] : 0);
    const bool possible = !stones && (dil & 6);  // next to a multi mover or an atari opp group
    const bool definite = dil & 9;               // next to an atari mover or a multi opp group
    bool inv = stones || (possible && !definite && !(dil & 16)) || i == ko;
    if (frozen) inv = invd_in[i] != 0;
    const bool all_mover = !(dil & 32), all_opp = !(dil & 64);
    const bool all_black = mover_white ? all_opp : all_mover, all_white = mover_white ? all_mover : all_opp;
    const bool b = mover_white ? op : mv, w = mover_white ? mv : op;
    if (a.black) a.black[base + i] = b;
    if (a.white) a.white[base + i] = w;
    if (a.invd) a.invd[base + i] = inv;
    // the next step's opponent is black iff white moves next
    if (a.ko_surr) a.ko_surr[base + i] = white_next ? all_black : all_white;
    if (states) {
      states[i] = b;
      states[m + i] = w;
      states[2 * m + i] = white_next;
      states[3 * m + i] = inv;
      states[4 * m + i] = passed_next;
      states[5 * m + i] = done_next;
    }
    c += step_c;
    r += step_r;
    if (c >= n) {
      c -= n;
      ++r;
    }
  }

  if (lane == 0) {
    const int black_area = mover_white ? opp_area : mover_area;
    const int white_area = mover_white ? mover_area : opp_area;
    if (a.wtm) a.wtm[board] = white_next;
    if (a.passed) a.passed[board] = passed_next;
    if (a.done) a.done[board] = done_next;
    if (a.done_row) a.done_row[board] = done_next;
    if (a.was_done) a.was_done[board] = (info & kWasDone) != 0;
    if (a.invalid) a.invalid[board] = (info & kInvalid) != 0;
    if (a.captured) a.captured[board] = info >> kCountShift & 1023;
    if (a.black_area) a.black_area[board] = black_area;
    if (a.white_area) a.white_area[board] = white_area;
    if (a.reward) {
      // core/score.py:reward_from_areas: two float32 subtractions in its order
      const float kc = __fsub_rn(__fsub_rn(__int2float_rn(black_area), __int2float_rn(white_area)),
                                 __double2float_rn(a.komi));
      float reward;
      if (a.reward_method == kReal) {
        reward = done_next ? static_cast<float>((kc > 0.0f) - (kc < 0.0f)) : 0.0f;
      } else {
        reward = done_next ? (kc > 0.0f ? 1.0f : -1.0f) * static_cast<float>(m) : kc;
      }
      a.reward[board] = reward;
    }
  }
}

int blocks_for(long long batch) { return static_cast<int>((batch + kWarps - 1) / kWarps); }

bool board_ok(long long n) { return n >= 1 && n * n <= kMaxCells; }

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
  if (!board_ok(args->n) || args->reward_method < kNoReward || args->reward_method > kHeuristic) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (args->batch <= 0) return static_cast<int>(cudaSuccess);
  score_kernel<<<blocks_for(args->batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}
