// The launch plans of the scoring kernels, in plain C++ (no CUDA, no torch):
// the twins of ops/kernels/cross.py::cross_plan and
// ops/kernels/din_attention.py::tile_plan for the Python-free server's ops
// library (serving_ops.cpp). A plan that differs from Python's would sum in
// another order than the scorer that recorded a bundle's expected scores, so
// tests/test_torch_serving_ops.py builds a small program from this header
// and holds its plans equal to Python's over a grid of shapes.
#pragma once

#include <algorithm>
#include <vector>

namespace pytorchrec_serving {

inline long long CeilDiv(long long a, long long b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------- B1 (cross)

// cross.py: FUSED_MAX_WIDTH, FUSED_MIN_ROWS, TILES, ROW_TILE, ROWS_MAX,
// K_TILE, MAX_SLICES, SPLIT_MAX_WAVES
constexpr int kFusedMaxWidth = 512;
constexpr long long kFusedMinRows = 8192;
constexpr int kTiles[7][2] = {{8, 8}, {8, 64}, {32, 64}, {64, 64}, {64, 128}, {128, 128}, {1, 8}};
constexpr int kRowTile = 6;
constexpr long long kRowsMax = 8;
constexpr int kKTile = 16;
constexpr int kMaxSlices = 16;
constexpr double kSplitMaxWaves = 1.5;

struct CrossPlan {
  bool fused;   // the fused form, else the tiled form
  int tile;     // the tiled form's tile (index into kTiles); -1 when fused
  int slice_k;  // k a slice
};

// cross_plan(batch, d, sm_count): the same rule, line for line. d >= 1,
// batch >= 1, sm_count >= 1.
inline CrossPlan PlanCross(long long batch, int d, int sm_count) {
  const int one_slice = static_cast<int>(CeilDiv(d, kKTile) * kKTile);
  if (d <= kFusedMaxWidth && batch >= kFusedMinRows) return {true, -1, one_slice};
  if (batch <= kRowsMax) return {false, batch == 1 ? kRowTile : 0, one_slice};
  auto blocks = [&](int t) { return CeilDiv(batch, kTiles[t][0]) * CeilDiv(d, kTiles[t][1]); };
  int tile = 1;
  if (blocks(5) >= 8LL * sm_count) {
    tile = 5;
  } else {
    for (int t : {4, 3, 2}) {
      if (2 * blocks(t) >= sm_count) {
        tile = t;
        break;
      }
    }
  }
  if (static_cast<double>(blocks(3)) > kSplitMaxWaves * sm_count &&
      (d <= kFusedMaxWidth || tile == 5))
    return {false, tile, one_slice};
  return {false, tile, static_cast<int>(CeilDiv(CeilDiv(d, kMaxSlices), kKTile) * kKTile)};
}

// The tiled form copies W 16 bytes at a time: every tile but the rows tile
// reads W rows padded to a multiple of 4 floats (cross.py's _launch).
inline bool RowsTile(int tile) { return tile == 0 || tile == kRowTile; }

// ------------------------------------------------------------ B5 (DIN pool)

// din_attention.py: CHUNK, MAX_HIDDEN, MAX_STEPS
constexpr long long kChunk = 128;
constexpr int kMaxHidden = 7;
constexpr int kMaxSteps = 8192;

// smem_bytes(e, s, hidden, rows)
inline long long DinSmemBytes(int e, int s, const std::vector<int>& hidden, long long rows) {
  std::vector<long long> dims = {4LL * e};
  for (int h : hidden) dims.push_back(h);
  dims.push_back(1);
  long long weights = 3LL * e * dims[1];
  for (size_t i = 1; i + 1 < dims.size(); ++i) weights += dims[i] * dims[i + 1];
  long long biases = 0;
  for (size_t i = 1; i < dims.size(); ++i) biases += dims[i];
  weights = CeilDiv(weights + biases, 4) * 4;
  const long long widest = *std::max_element(hidden.begin(), hidden.end());
  return 4 * (weights + kChunk * e + rows * (e + dims[1]) + 2 * kChunk * widest + rows * s);
}

// tile_plan(e, s, hidden, limit).rows, or 0 where Python's raises.
inline long long PlanDinRows(int e, int s, const std::vector<int>& hidden, long long limit) {
  if (hidden.empty() || static_cast<int>(hidden.size()) > kMaxHidden || s < 1 || s > kMaxSteps)
    return 0;
  const long long base = DinSmemBytes(e, s, hidden, 0);
  const long long per_row = DinSmemBytes(e, s, hidden, 1) - base;
  if (limit < base) return 0;
  const long long fit = (limit - base) / per_row;
  const long long rows = std::min(s < kChunk ? kChunk / s : 1LL, fit);
  return rows < 1 ? 0 : rows;
}

}  // namespace pytorchrec_serving
