// Native (C++) host-side Go engine with the exact semantics of the
// reference's single-state path (gym_go/gogame.py:34-87 and
// state_utils.py) and of the JAX kernel in gymgo_tpu/core/step.py.
//
// Purpose in the framework (the reference itself is pure Python):
//   * microsecond-latency single-game stepping for interactive use
//     (GUI/demo/MCTS probes) where device dispatch overhead dominates;
//   * an independent second oracle for cross-checking the TPU kernels.
//
// State layout: int8[6*N*N], channels as in govars (BLACK, WHITE, TURN,
// INVD, PASS, DONE), row-major boards, 0/1 values.  C ABI, loaded via
// ctypes (no pybind11 dependency).

#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int BLACK = 0;
constexpr int WHITE = 1;
constexpr int TURN = 2;
constexpr int INVD = 3;
constexpr int PASS = 4;
constexpr int DONE = 5;
constexpr int MAXN = 32;
constexpr int MAXC = MAXN * MAXN;

struct Board {
  int n;
  int m;  // n*n
  const int8_t* chan(const int8_t* s, int c) const { return s + c * m; }
  int8_t* chan(int8_t* s, int c) const { return s + c * m; }
};

// Flood-fills the 4-connected group of `color` containing `start` on
// `stones`; records member cells in group[] (size out) and counts distinct
// liberty cells (via seen[] scratch marking).  Returns liberty count.
struct GroupInfo {
  int size = 0;
  int libs = 0;
  int cells[MAXC];
  int lib_cell[2];  // first up-to-2 distinct liberty cells
};

class Engine {
 public:
  explicit Engine(int n) : n_(n), m_(n * n) {}

  // Collect the group containing `start` within `color_mask` (1 = stone of
  // that color).  `occupied` marks any stone.  Liberties counted distinct.
  void group_at(const int8_t* color_mask, const int8_t* occupied, int start,
                GroupInfo* out, uint16_t* visited_stamp, uint16_t stamp,
                uint16_t* lib_stamp, uint16_t lstamp) {
    out->size = 0;
    out->libs = 0;
    int stack[MAXC];
    int sp = 0;
    stack[sp++] = start;
    visited_stamp[start] = stamp;
    while (sp) {
      int c = stack[--sp];
      out->cells[out->size++] = c;
      int r = c / n_, col = c % n_;
      const int nbrs[4] = {c - n_, c + n_, c - 1, c + 1};
      const bool ok[4] = {r > 0, r < n_ - 1, col > 0, col < n_ - 1};
      for (int k = 0; k < 4; ++k) {
        if (!ok[k]) continue;
        int q = nbrs[k];
        if (color_mask[q]) {
          if (visited_stamp[q] != stamp) {
            visited_stamp[q] = stamp;
            stack[sp++] = q;
          }
        } else if (!occupied[q]) {
          if (lib_stamp[q] != lstamp) {
            lib_stamp[q] = lstamp;
            if (out->libs < 2) out->lib_cell[out->libs] = q;
            out->libs++;
          }
        }
      }
    }
  }

  // Mirrors state_utils.compute_invalid_moves(state, player, ko) exactly
  // (the possible/definite/surrounded algebra, booleanized — see
  // gymgo_tpu/core/step.py docstring for the equivalence argument).
  void invalid_mask(const int8_t* black, const int8_t* white, int mover,
                    int ko_cell, int8_t* out) {
    int8_t occupied[MAXC];
    for (int i = 0; i < m_; ++i) occupied[i] = black[i] | white[i];

    // Per-stone group liberty class: 0 none, 1 exactly-one, 2 multi.
    uint8_t lib_class[MAXC];
    std::memset(lib_class, 0, m_);
    uint16_t visited[MAXC], libst[MAXC];
    std::memset(visited, 0, m_ * sizeof(uint16_t));
    std::memset(libst, 0, m_ * sizeof(uint16_t));
    uint16_t stamp = 0;
    GroupInfo g;
    for (int i = 0; i < m_; ++i) {
      if (!occupied[i] || visited[i]) continue;
      const int8_t* cm = black[i] ? black : white;
      ++stamp;
      group_at(cm, occupied, i, &g, visited, 1, libst, stamp);
      uint8_t cls = g.libs >= 2 ? 2 : (g.libs == 1 ? 1 : 0);
      for (int k = 0; k < g.size; ++k) lib_class[g.cells[k]] = cls;
    }
    // visited[] was stamped with 1s; reuse is done, no reset needed below.

    const int8_t* mover_mask = mover == BLACK ? black : white;
    const int8_t* opp_mask = mover == BLACK ? white : black;
    for (int c = 0; c < m_; ++c) {
      if (occupied[c]) {
        out[c] = 1;
        continue;
      }
      int r = c / n_, col = c % n_;
      const int nbrs[4] = {c - n_, c + n_, c - 1, c + 1};
      const bool ok[4] = {r > 0, r < n_ - 1, col > 0, col < n_ - 1};
      bool possible = false, definite = false, surrounded = true;
      for (int k = 0; k < 4; ++k) {
        if (!ok[k]) continue;  // board edge counts as occupied (cval=1)
        int q = nbrs[k];
        if (!occupied[q]) {
          surrounded = false;
          continue;
        }
        bool q_mover = mover_mask[q];
        uint8_t cls = lib_class[q];
        if (q_mover) {
          if (cls == 2) possible = true;
          if (cls == 1) definite = true;
        } else {
          if (cls == 1) possible = true;
          if (cls == 2) definite = true;
        }
        (void)opp_mask;
      }
      out[c] = (possible && !definite && surrounded) ? 1 : 0;
    }
    if (ko_cell >= 0) out[ko_cell] = 1;
  }

  // Full transition; returns 0 = ok, 1 = invalid move, 2 = game over.
  int next_state(const int8_t* state, int action, int8_t* out) {
    std::memcpy(out, state, 6 * m_);
    const Board b{n_, m_};
    int8_t* black = b.chan(out, BLACK);
    int8_t* white = b.chan(out, WHITE);
    int8_t* turn = b.chan(out, TURN);
    int8_t* invd = b.chan(out, INVD);
    int8_t* pass = b.chan(out, PASS);
    int8_t* done = b.chan(out, DONE);

    if (done[0]) return 2;
    const int mover = turn[0] ? WHITE : BLACK;
    const bool prev_passed = pass[0] != 0;
    int ko_cell = -1;

    if (action == m_) {  // pass
      std::memset(pass, 1, m_);
      if (prev_passed) std::memset(done, 1, m_);
    } else {
      if (action < 0 || action > m_ || invd[action]) return 1;
      std::memset(pass, 0, m_);
      int8_t* mine = mover == BLACK ? black : white;
      int8_t* theirs = mover == BLACK ? white : black;
      mine[action] = 1;

      // Ko probe: all in-bounds neighbors held opponent stones pre-capture.
      int r = action / n_, col = action % n_;
      const int nbrs[4] = {action - n_, action + n_, action - 1, action + 1};
      const bool ok[4] = {r > 0, r < n_ - 1, col > 0, col < n_ - 1};
      bool surrounded = true;
      for (int k = 0; k < 4; ++k)
        if (ok[k] && !theirs[nbrs[k]]) surrounded = false;

      // Capture: adjacent opponent groups with zero liberties die.
      int8_t occupied[MAXC];
      for (int i = 0; i < m_; ++i) occupied[i] = black[i] | white[i];
      uint16_t visited[MAXC], libst[MAXC];
      std::memset(visited, 0, m_ * sizeof(uint16_t));
      std::memset(libst, 0, m_ * sizeof(uint16_t));
      GroupInfo g;
      int killed_stones = 0, killed_groups = 0, last_killed_cell = -1;
      uint16_t stamp = 0;
      for (int k = 0; k < 4; ++k) {
        if (!ok[k]) continue;
        int q = nbrs[k];
        if (!theirs[q] || visited[q]) continue;
        ++stamp;
        group_at(theirs, occupied, q, &g, visited, 1, libst, stamp);
        if (g.libs == 0) {
          ++killed_groups;
          killed_stones += g.size;
          for (int t = 0; t < g.size; ++t) {
            theirs[g.cells[t]] = 0;
            occupied[g.cells[t]] = 0;
            last_killed_cell = g.cells[t];
          }
        }
      }
      if (killed_groups == 1 && killed_stones == 1 && surrounded)
        ko_cell = last_killed_cell;
    }

    invalid_mask(black, white, mover, ko_cell, invd);
    int8_t next_turn = turn[0] ? 0 : 1;
    std::memset(turn, next_turn, m_);
    return 0;
  }

  void areas(const int8_t* state, int* black_area, int* white_area) {
    const Board b{n_, m_};
    const int8_t* black = b.chan(state, BLACK);
    const int8_t* white = b.chan(state, WHITE);
    int ba = 0, wa = 0;
    uint8_t visited[MAXC];
    std::memset(visited, 0, m_);
    for (int i = 0; i < m_; ++i) {
      ba += black[i];
      wa += white[i];
    }
    for (int i = 0; i < m_; ++i) {
      if (black[i] || white[i] || visited[i]) continue;
      // Flood this empty region; track which colors it touches.
      int stack[MAXC], sp = 0, size = 0;
      bool tb = false, tw = false;
      stack[sp++] = i;
      visited[i] = 1;
      while (sp) {
        int c = stack[--sp];
        ++size;
        int r = c / n_, col = c % n_;
        const int nbrs[4] = {c - n_, c + n_, c - 1, c + 1};
        const bool ok[4] = {r > 0, r < n_ - 1, col > 0, col < n_ - 1};
        for (int k = 0; k < 4; ++k) {
          if (!ok[k]) continue;
          int q = nbrs[k];
          if (black[q]) tb = true;
          else if (white[q]) tw = true;
          else if (!visited[q]) {
            visited[q] = 1;
            stack[sp++] = q;
          }
        }
      }
      if (tb && !tw) ba += size;
      if (tw && !tb) wa += size;
    }
    *black_area = ba;
    *white_area = wa;
  }

 private:
  int n_;
  int m_;
};

}  // namespace

extern "C" {

// Returns 0 ok, 1 invalid move, 2 game already over, -1 bad size.
int gogo_next_state(const int8_t* state, int n, int action, int8_t* out) {
  if (n < 2 || n > MAXN) return -1;
  Engine e(n);
  return e.next_state(state, action, out);
}

int gogo_areas(const int8_t* state, int n, int* black_area, int* white_area) {
  if (n < 2 || n > MAXN) return -1;
  Engine e(n);
  e.areas(state, black_area, white_area);
  return 0;
}

// Batched stepping; envs are independent, so the loop parallelizes over
// host cores when built with OpenMP (CPU-farm path; the guard keeps tiny
// batches on one thread where fork/join overhead would dominate).
// status[i] as in gogo_next_state.
int gogo_batch_next_states(const int8_t* states, int batch, int n,
                           const int* actions, int8_t* out, int* status) {
  if (n < 2 || n > MAXN) return -1;
  const int stride = 6 * n * n;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (batch >= 32)
#endif
  for (int i = 0; i < batch; ++i) {
    Engine e(n);  // stateless apart from the size; scratch is stack-local
    status[i] = e.next_state(states + i * stride, actions[i], out + i * stride);
    if (status[i] != 0)  // frozen env: copy through unchanged
      std::memcpy(out + i * stride, states + i * stride, stride);
  }
  return 0;
}

// Batched Trump-Taylor scoring (parallel like batch stepping).
int gogo_batch_areas(const int8_t* states, int batch, int n,
                     int* black_areas, int* white_areas) {
  if (n < 2 || n > MAXN) return -1;
  const int stride = 6 * n * n;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (batch >= 32)
#endif
  for (int i = 0; i < batch; ++i) {
    Engine e(n);
    e.areas(states + i * stride, black_areas + i, white_areas + i);
  }
  return 0;
}

// Thread-control/observability for the OpenMP path; no-ops without OpenMP.
int gogo_max_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

void gogo_set_threads(int k) {
#ifdef _OPENMP
  if (k > 0) omp_set_num_threads(k);
#else
  (void)k;
#endif
}

}  // extern "C"
