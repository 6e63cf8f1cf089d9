// Treelet SAH restructuring of a flat binary BVH (Karras & Aila, HPG 2013),
// in place.  Host code, C ABI for ctypes; built with g++ by
// mcpt_torch/kernels/_build.py (build_host) at first use.
//
// The port's own copy of mcpt_treelet_optimize in mcpt/native/src/
// mcpt_native.cpp, which mcpt uses to optimise the cluster top tree and the
// tree the DP cluster cut is planned on.  It must stay that code, with the
// same constants and the same compiler flags (-O3 -march=native -fPIC
// -std=c++17): its topology is not the numpy optimiser's (their SAH agrees
// only to ~1e-3), so any other optimiser gives other cluster tables.
//
// Algorithm: bottom-up sweep in height order; per treelet root, greedy
// max-area expansion to <= 7 leaves; optimal re-partition by DP over all
// subsets; reconstruction reusing the freed internal nodes.
//
// Layout contract (BVH/hlbvh.cpp:164-193): 2N-1 nodes, internals [0, N-2],
// leaves [N-1, 2N-2], leaf.left == leaf.right == triangle id, root parent -1.

#include <algorithm>
#include <numeric>
#include <vector>

extern "C" {

static const float C_INN = 1.2f, C_TRI = 1.0f;

void mcpt_treelet_optimize(int n, float* bbmin, float* bbmax, int* left,
                           int* right, int* parent) {
  if (n < 4) return;
  const int n_nodes = 2 * n - 1;
  const int leaf_base = n - 1;
  auto area = [&](int i) {
    float dx = std::max(bbmax[i * 3] - bbmin[i * 3], 0.0f);
    float dy = std::max(bbmax[i * 3 + 1] - bbmin[i * 3 + 1], 0.0f);
    float dz = std::max(bbmax[i * 3 + 2] - bbmin[i * 3 + 2], 0.0f);
    return 2.0f * (dx * dy + dy * dz + dz * dx);
  };

  std::vector<int> height(n_nodes, 0);
  bool changed = true;
  while (changed) {
    changed = false;
    for (int i = n - 2; i >= 0; --i) {
      int h = 1 + std::max(height[left[i]], height[right[i]]);
      if (h != height[i]) { height[i] = h; changed = true; }
    }
  }
  std::vector<int> order(n - 1);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return height[a] < height[b]; });

  std::vector<double> cost(n_nodes);
  for (int i = leaf_base; i < n_nodes; ++i) cost[i] = C_TRI * area(i);
  for (int r : order) cost[r] = C_INN * area(r) + cost[left[r]] + cost[right[r]];

  constexpr int MAXL = 7;
  int leaves[MAXL];
  int internals[MAXL - 1];
  float smin[1 << MAXL][3], smax[1 << MAXL][3];
  double sarea[1 << MAXL], csub[1 << MAXL];
  int part[1 << MAXL];

  for (int r : order) {
    int nl = 2, ni_ = 1;
    leaves[0] = left[r];
    leaves[1] = right[r];
    internals[0] = r;
    while (nl < MAXL) {
      int best = -1;
      float best_a = -1.0f;
      for (int i = 0; i < nl; ++i)
        if (leaves[i] < leaf_base && area(leaves[i]) > best_a) {
          best = i;
          best_a = area(leaves[i]);
        }
      if (best < 0) break;
      int x = leaves[best];
      internals[ni_++] = x;
      leaves[best] = left[x];
      leaves[nl++] = right[x];
    }
    if (nl < 3) continue;
    const int full = (1 << nl) - 1;

    for (int s = 1; s <= full; ++s) {
      int low = s & (-s);
      int bit = __builtin_ctz(low);
      int rest = s ^ low;
      for (int j = 0; j < 3; ++j) {
        float lo = bbmin[leaves[bit] * 3 + j];
        float hi = bbmax[leaves[bit] * 3 + j];
        smin[s][j] = rest ? std::min(smin[rest][j], lo) : lo;
        smax[s][j] = rest ? std::max(smax[rest][j], hi) : hi;
      }
      float dx = std::max(smax[s][0] - smin[s][0], 0.0f);
      float dy = std::max(smax[s][1] - smin[s][1], 0.0f);
      float dz = std::max(smax[s][2] - smin[s][2], 0.0f);
      sarea[s] = 2.0 * (dx * dy + dy * dz + dz * dx);
    }

    for (int i = 0; i < nl; ++i) csub[1 << i] = cost[leaves[i]];
    for (int s = 1; s <= full; ++s) {
      if ((s & (s - 1)) == 0) continue;
      double best = 1e300;
      int bestp = 0;
      for (int p = (s - 1) & s; p; p = (p - 1) & s) {
        if (p < (s ^ p)) {
          double c = csub[p] + csub[s ^ p];
          if (c < best) { best = c; bestp = p; }
        }
      }
      csub[s] = best + C_INN * sarea[s];
      part[s] = bestp;
    }
    if (csub[full] >= cost[r] - 1e-7) continue;

    int pool[MAXL];  // stack; r on top so the rebuilt root is r
    int np = 0;
    for (int i = 1; i < ni_; ++i) pool[np++] = internals[i];
    pool[np++] = r;

    // iterative reconstruction (explicit stack of subsets)
    struct Item { int s, node; };
    Item stack[2 * MAXL];
    int sp = 0;
    int root_id = pool[--np];
    stack[sp++] = {full, root_id};
    while (sp) {
      Item it = stack[--sp];
      int s = it.s, nid = it.node;
      int p = part[s], c = s ^ p;
      int lch = ((p & (p - 1)) == 0) ? leaves[__builtin_ctz(p)] : pool[--np];
      int rch = ((c & (c - 1)) == 0) ? leaves[__builtin_ctz(c)] : pool[--np];
      left[nid] = lch;
      right[nid] = rch;
      parent[lch] = nid;
      parent[rch] = nid;
      for (int j = 0; j < 3; ++j) {
        bbmin[nid * 3 + j] = smin[s][j];
        bbmax[nid * 3 + j] = smax[s][j];
      }
      if ((p & (p - 1)) != 0) stack[sp++] = {p, lch};
      if ((c & (c - 1)) != 0) stack[sp++] = {c, rch};
    }
    // the reused internals' costs, recomputed in one local pass per level
    for (int pass = 0; pass < ni_; ++pass)
      for (int i = 0; i < ni_; ++i) {
        int nid = internals[i];
        cost[nid] = C_INN * area(nid) + cost[left[nid]] + cost[right[nid]];
      }
  }
}

}  // extern "C"
