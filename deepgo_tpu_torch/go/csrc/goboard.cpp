// Native Go rules engine: full-game transcription to packed feature planes.
//
// C++ twin of deepgo_tpu/go/{board,ladders,summarize,replay}.py with
// identical semantics (golden-tested against the same reference records,
// and cross-tested against the Python engine). One call transcribes an
// entire game, so Python pays a single FFI crossing per game.
//
// The reference's equivalent of this layer is its external Torch C/threads
// stack driving makedata.lua; here the whole rules+features hot path is
// native and the algorithm is group-label + bitset-union based rather than
// the reference's per-query re-flood-fill (makedata.lua:122-479).
//
// Build: make -C native   (produces native/build/libgoboard.so)

#include <atomic>
#include <bitset>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int N = 19;
constexpr int NN = N * N;
constexpr int PACKED_CHANNELS = 9;
constexpr uint8_t EMPTY = 0;

using Mask = std::bitset<NN>;

// Precomputed neighbor lists (flat indices).
struct Adjacency {
  int nbr[NN][4];
  int cnt[NN];
  Adjacency() {
    for (int x = 0; x < N; ++x)
      for (int y = 0; y < N; ++y) {
        int p = x * N + y, c = 0;
        if (x > 0) nbr[p][c++] = p - N;
        if (x < N - 1) nbr[p][c++] = p + N;
        if (y > 0) nbr[p][c++] = p - 1;
        if (y < N - 1) nbr[p][c++] = p + 1;
        cnt[p] = c;
      }
  }
};
const Adjacency ADJ;

struct Board {
  uint8_t stones[NN];
  int32_t age[NN];
};

// Flood-fill the chain containing p; fills group/libs masks.
void group_and_libs(const uint8_t* stones, int p, Mask& group, Mask& libs) {
  group.reset();
  libs.reset();
  uint8_t player = stones[p];
  if (player == EMPTY) return;
  int stack[NN];
  int top = 0;
  stack[top++] = p;
  group.set(p);
  while (top) {
    int a = stack[--top];
    for (int i = 0; i < ADJ.cnt[a]; ++i) {
      int n = ADJ.nbr[a][i];
      if (stones[n] == player) {
        if (!group.test(n)) {
          group.set(n);
          stack[top++] = n;
        }
      } else if (stones[n] == EMPTY) {
        libs.set(n);
      }
    }
  }
}

using Undo = std::vector<std::pair<int, uint8_t>>;

// Remove dead opposing chains around p, then p's own chain if dead
// (suicide). Returns opposing stones removed. age/undo optional.
int remove_dead_neighbors(uint8_t* stones, int32_t* age, int p, Undo* undo) {
  uint8_t player = stones[p];
  uint8_t opp = 3 - player;
  int kills = 0;
  Mask checked, group, libs;
  for (int i = 0; i < ADJ.cnt[p]; ++i) {
    int n = ADJ.nbr[p][i];
    if (stones[n] == opp && !checked.test(n)) {
      group_and_libs(stones, n, group, libs);
      checked |= group;
      if (libs.none()) {
        for (int q = 0; q < NN; ++q)
          if (group.test(q)) {
            if (undo) undo->push_back({q, stones[q]});
            stones[q] = EMPTY;
            if (age) age[q] = 1;
            ++kills;
          }
      }
    }
  }
  group_and_libs(stones, p, group, libs);
  if (stones[p] != EMPTY && libs.none()) {
    for (int q = 0; q < NN; ++q)
      if (group.test(q)) {
        if (undo) undo->push_back({q, stones[q]});
        stones[q] = EMPTY;
        if (age) age[q] = 1;
      }
  }
  return kills;
}

// Real move with aging (deepgo_tpu.go.board.play). Returns kills, or -1 if
// the point is occupied.
int play(Board& b, int p, uint8_t player) {
  if (b.stones[p] != EMPTY) return -1;
  for (int q = 0; q < NN; ++q)
    if (b.age[q] > 0 && b.age[q] < 255) ++b.age[q];
  b.stones[p] = player;
  b.age[p] = 1;
  return remove_dead_neighbors(b.stones, b.age, p, nullptr);
}

void play_with_undo(uint8_t* stones, int p, uint8_t player, Undo& undo) {
  undo.push_back({p, stones[p]});
  stones[p] = player;
  remove_dead_neighbors(stones, nullptr, p, &undo);
}

void unwind(uint8_t* stones, Undo& undo, size_t from) {
  for (size_t i = undo.size(); i-- > from;) stones[undo[i].first] = undo[i].second;
  undo.resize(from);
}

// Hypothetical play at empty p: kills + liberties of the new chain
// (deepgo_tpu.go.board.simulate_play).
void simulate_play(uint8_t* stones, int p, uint8_t player, int* kills,
                   int* libs_after) {
  Undo undo;
  undo.push_back({p, stones[p]});
  stones[p] = player;
  *kills = remove_dead_neighbors(stones, nullptr, p, &undo);
  Mask group, libs;
  group_and_libs(stones, p, group, libs);
  *libs_after = static_cast<int>(libs.count());
  unwind(stones, undo, 0);
}

// Recursive ladder search (deepgo_tpu.go.ladders.ladder_moves): for the
// 2-liberty chain at p, which liberties let the opponent capture it in a
// ladder? Results pushed onto out.
void ladder_moves(uint8_t* stones, int p, const Mask& liberties,
                  std::vector<int>& out) {
  uint8_t player = stones[p];
  uint8_t opp = 3 - player;
  int libs[2], nl = 0;
  for (int q = 0; q < NN && nl < 2; ++q)
    if (liberties.test(q)) libs[nl++] = q;

  Undo undo;
  Mask group, glibs;
  for (int i = 0; i < 2; ++i) {
    int chase = libs[i], escape = libs[1 - i];
    size_t mark = undo.size();
    play_with_undo(stones, chase, opp, undo);
    group_and_libs(stones, chase, group, glibs);
    if (glibs.count() > 2) {
      play_with_undo(stones, escape, player, undo);
      group_and_libs(stones, escape, group, glibs);
      size_t n = glibs.count();
      if (n == 1) {
        out.push_back(chase);
      } else if (n == 2) {
        Mask escaped_libs = glibs;
        group_and_libs(stones, chase, group, glibs);
        if (glibs.count() > 1) {
          std::vector<int> sub;
          ladder_moves(stones, p, escaped_libs, sub);
          if (!sub.empty()) out.push_back(chase);
        }
      }
    }
    unwind(stones, undo, mark);
  }
}

inline uint8_t clip255(size_t v) { return v > 255 ? 255 : static_cast<uint8_t>(v); }

// Fan `worker(i)` over [0, n) with up to n_threads std::threads
// (work-stealing via an atomic counter). Small batches run serially: the
// per-board work is a few µs, so thread create/join would dominate.
template <typename F>
void run_batch(int n, int n_threads, F&& body) {
  if (n_threads <= 0) {
    unsigned hw = std::thread::hardware_concurrency();
    n_threads = hw ? static_cast<int>(hw) : 1;
  }
  if (n_threads > n) n_threads = n > 0 ? n : 1;
  constexpr int SERIAL_CUTOFF = 16;
  if (n_threads == 1 || n < SERIAL_CUTOFF) {
    for (int i = 0; i < n; ++i) body(i);
    return;
  }
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) body(i);
  };
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// Full position summary -> packed (9, 19, 19) record
// (deepgo_tpu.go.summarize.summarize).
void summarize(Board& b, uint8_t* out) {
  uint8_t* stones = b.stones;
  uint8_t* o_stones = out + 0 * NN;
  uint8_t* o_libs = out + 1 * NN;
  uint8_t* o_la = out + 2 * NN;    // 2 channels
  uint8_t* o_kills = out + 4 * NN; // 2 channels
  uint8_t* o_age = out + 6 * NN;
  uint8_t* o_ladd = out + 7 * NN;  // 2 channels
  std::memset(out, 0, PACKED_CHANNELS * NN);

  for (int q = 0; q < NN; ++q) {
    o_stones[q] = stones[q];
    o_age[q] = clip255(static_cast<size_t>(b.age[q]));
  }

  // One labeling pass: liberties plane, group label + lib masks for reuse.
  std::vector<Mask> group_libs;
  int label[NN];
  for (int q = 0; q < NN; ++q) label[q] = -1;
  Mask group, libs;
  std::vector<int> lmoves;
  for (int q = 0; q < NN; ++q) {
    if (stones[q] != EMPTY && label[q] < 0) {
      group_and_libs(stones, q, group, libs);
      int idx = static_cast<int>(group_libs.size());
      size_t nlibs = libs.count();
      size_t gsize = group.count();
      for (int r = 0; r < NN; ++r)
        if (group.test(r)) {
          label[r] = idx;
          o_libs[r] = clip255(nlibs);
        }
      group_libs.push_back(libs);
      if (nlibs == 2) {
        lmoves.clear();
        ladder_moves(stones, q, libs, lmoves);
        uint8_t chaser = 3 - stones[q];  // the capturing player
        for (int mv : lmoves) o_ladd[(chaser - 1) * NN + mv] = clip255(gsize);
      }
    }
  }

  // kills / liberties-after per empty point per player: bitset-union fast
  // path, simulation only when a capture occurs.
  for (int q = 0; q < NN; ++q) {
    if (stones[q] != EMPTY) continue;
    for (uint8_t player = 1; player <= 2; ++player) {
      uint8_t opp = 3 - player;
      bool captures = false;
      Mask lib_union;
      lib_union.set(q);
      int own[4], n_own = 0;
      for (int i = 0; i < ADJ.cnt[q]; ++i) {
        int n = ADJ.nbr[q][i];
        if (stones[n] == EMPTY) {
          lib_union.set(n);
        } else if (stones[n] == opp) {
          if (group_libs[label[n]].count() == 1) captures = true;
        } else {
          bool seen = false;
          for (int j = 0; j < n_own; ++j) seen |= (own[j] == label[n]);
          if (!seen) own[n_own++] = label[n];
        }
      }
      int kills = 0, la = 0;
      if (captures) {
        simulate_play(stones, q, player, &kills, &la);
      } else {
        for (int j = 0; j < n_own; ++j) lib_union |= group_libs[own[j]];
        la = static_cast<int>(lib_union.count()) - 1;
      }
      o_kills[(player - 1) * NN + q] = clip255(static_cast<size_t>(kills));
      o_la[(player - 1) * NN + q] = clip255(static_cast<size_t>(la));
    }
  }
}

}  // namespace

extern "C" {

// Transcribe one game. moves/handicaps are flat (player, x, y) int32
// triples with 0-based coordinates. out must hold n_moves*9*19*19 bytes:
// the packed record of the board *before* each move. Returns 0, or
// -(1+move_index) if a placement was illegal (occupied point).
int goboard_transcribe(const int32_t* handicaps, int n_handicaps,
                       const int32_t* moves, int n_moves, uint8_t* out) {
  Board b;
  std::memset(b.stones, 0, sizeof(b.stones));
  std::memset(b.age, 0, sizeof(b.age));
  for (int i = 0; i < n_handicaps; ++i) {
    int p = handicaps[i * 3 + 1] * N + handicaps[i * 3 + 2];
    if (play(b, p, static_cast<uint8_t>(handicaps[i * 3])) < 0) return -(1 + i) - 1000000;
  }
  for (int i = 0; i < n_moves; ++i) {
    summarize(b, out + static_cast<size_t>(i) * PACKED_CHANNELS * NN);
    int p = moves[i * 3 + 1] * N + moves[i * 3 + 2];
    if (play(b, p, static_cast<uint8_t>(moves[i * 3])) < 0) return -(1 + i);
  }
  return 0;
}

// Single-position summary for tests/tools: stones (361 bytes), age
// (361 int32) -> packed record.
void goboard_summarize(const uint8_t* stones, const int32_t* age, uint8_t* out) {
  Board b;
  std::memcpy(b.stones, stones, sizeof(b.stones));
  std::memcpy(b.age, age, sizeof(b.age));
  summarize(b, out);
}

// Batch move application for the self-play/arena hot path: board i plays
// moves[i] (flat index, or -1 = pass: board untouched) for players[i],
// with full capture resolution and aging, plus simple-ko detection
// (deepgo_tpu.selfplay.apply_move): when the move captures exactly one
// stone and the new stone sits as a lone chain with exactly one liberty,
// ko_out[i] = that captured point, else -1. Returns 0, or -(1+i) for the
// first board whose move landed on an occupied point.
int goboard_play_batch(uint8_t* stones, int32_t* age, const int32_t* moves,
                       const int32_t* players, int n, int32_t* ko_out,
                       int n_threads) {
  std::atomic<int> err(0);
  run_batch(n, n_threads, [&](int i) {
    Mask checked, group, libs, would_die;
    Board b;
    ko_out[i] = -1;
    int p = moves[i];
    if (p < 0) return;
    uint8_t player = static_cast<uint8_t>(players[i]);
    uint8_t opp = 3 - player;
    uint8_t* st = stones + static_cast<size_t>(i) * NN;
    int32_t* ag = age + static_cast<size_t>(i) * NN;
    if (st[p] != EMPTY) {
      int expect = 0;
      err.compare_exchange_strong(expect, i + 1);
      return;
    }
    // opposing chains whose sole liberty is p die with this move
    for (int k = 0; k < ADJ.cnt[p]; ++k) {
      int nb = ADJ.nbr[p][k];
      if (st[nb] == opp && !checked.test(nb)) {
        group_and_libs(st, nb, group, libs);
        checked |= group;
        if (libs.count() == 1 && libs.test(p)) would_die |= group;
      }
    }
    std::memcpy(b.stones, st, sizeof(b.stones));
    std::memcpy(b.age, ag, sizeof(b.age));
    play(b, p, player);
    std::memcpy(st, b.stones, sizeof(b.stones));
    std::memcpy(ag, b.age, sizeof(b.age));
    if (would_die.count() == 1) {
      group_and_libs(st, p, group, libs);
      if (group.count() == 1 && libs.count() == 1)
        for (int q = 0; q < NN; ++q)
          if (would_die.test(q)) {
            ko_out[i] = q;
            break;
          }
    }
  });
  return err.load() ? -err.load() : 0;
}

// Batch summary for the self-play/arena hot path: n boards (stones
// n*361 bytes, age n*361 int32) -> n packed records, one FFI crossing for
// the whole fleet of live games instead of one per board. Boards are
// independent, so a work-stealing counter fans them across n_threads
// std::threads (<=0 picks hardware_concurrency).
void goboard_summarize_batch(const uint8_t* stones, const int32_t* age,
                             int n, uint8_t* out, int n_threads) {
  run_batch(n, n_threads, [&](int i) {
    Board b;
    std::memcpy(b.stones, stones + static_cast<size_t>(i) * NN, sizeof(b.stones));
    std::memcpy(b.age, age + static_cast<size_t>(i) * NN, sizeof(b.age));
    summarize(b, out + static_cast<size_t>(i) * PACKED_CHANNELS * NN);
  });
}

}  // extern "C"
