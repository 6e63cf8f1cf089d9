// Expected Projected Overlap (EPO, Aila et al. 2013) of a flat binary BVH.
// Host code, C ABI for ctypes; built with g++ by mcpt_torch/kernels/_build.py
// (load_host) at first use.
//
// The port's own copy of mcpt_epo in mcpt/native/src/mcpt_native.cpp, which
// mcpt's EPO (mcpt/bvh/metrics.py epo) dispatches to by default.  It must
// stay that code, with the same compiler flags: the same leaves in the same
// thread ranges give the same double sum, bit for bit.
//
// Definition (reference bvhtest.cpp:221-284, GPU clip kernel EPO.cl:133-197):
// for every leaf's triangle, walk the tree from the root; non-ancestor nodes
// whose box clips a positive area of the triangle contribute
// area x (c_inn | c_tri), descending only while the clip stays positive.
// Ancestry is an interval test over subtree leaf ranges.  Parallel over
// leaves with std::thread; the result is normalised by the total triangle
// area.
//
// Layout contract (BVH/hlbvh.cpp:164-193): 2N-1 nodes, internals [0, N-2],
// leaves [N-1, 2N-2], leaf.left == leaf.right == triangle id.

#include <algorithm>
#include <cmath>
#include <numeric>
#include <thread>
#include <vector>

extern "C" {

double mcpt_epo(const float* verts, int n, const float* bbmin,
                const float* bbmax, const int* left, const int* right,
                double c_inn, double c_tri, int n_threads) {
  if (n <= 1) return 0.0;
  const int leaf_base = n - 1;
  const int n_nodes = 2 * n - 1;

  // subtree leaf ranges, bottom-up over a height ordering
  std::vector<int> lo(n_nodes), hi(n_nodes), height(n_nodes, 0);
  for (int i = 0; i < n; ++i) lo[leaf_base + i] = hi[leaf_base + i] = i;
  std::vector<int> order(leaf_base);
  {
    bool changed = true;
    while (changed) {
      changed = false;
      for (int v = leaf_base - 1; v >= 0; --v) {
        int h = 1 + std::max(height[left[v]], height[right[v]]);
        if (h != height[v]) { height[v] = h; changed = true; }
      }
    }
    std::iota(order.begin(), order.end(), 0);
    std::sort(order.begin(), order.end(),
              [&](int a, int b) { return height[a] < height[b]; });
    for (int v : order) {
      lo[v] = std::min(lo[left[v]], lo[right[v]]);
      hi[v] = std::max(hi[left[v]], hi[right[v]]);
    }
  }

  // Sutherland-Hodgman triangle-vs-AABB clip area
  auto clip_area = [&](const double tri[3][3], const float* bmin,
                       const float* bmax) -> double {
    double poly[16][3], tmp[16][3];
    int np = 3;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) poly[i][j] = tri[i][j];
    for (int axis = 0; axis < 3 && np >= 3; ++axis) {
      for (int side = 0; side < 2 && np >= 3; ++side) {
        const double plane = side ? bmax[axis] : bmin[axis];
        const double sgn = side ? -1.0 : 1.0;
        int m = 0;
        for (int i = 0; i < np; ++i) {
          const double* a = poly[i];
          const double* b = poly[(i + 1) % np];
          double da = sgn * (a[axis] - plane);
          double db = sgn * (b[axis] - plane);
          if (da >= 0.0) {
            for (int j = 0; j < 3; ++j) tmp[m][j] = a[j];
            ++m;
          }
          if ((da >= 0.0) != (db >= 0.0)) {
            double t = da / (da - db);
            for (int j = 0; j < 3; ++j) tmp[m][j] = a[j] + t * (b[j] - a[j]);
            ++m;
          }
        }
        np = m;
        for (int i = 0; i < np; ++i)
          for (int j = 0; j < 3; ++j) poly[i][j] = tmp[i][j];
      }
    }
    if (np < 3) return 0.0;
    double cx = 0, cy = 0, cz = 0;
    for (int i = 1; i + 1 < np; ++i) {
      double u[3], w[3];
      for (int j = 0; j < 3; ++j) {
        u[j] = poly[i][j] - poly[0][j];
        w[j] = poly[i + 1][j] - poly[0][j];
      }
      cx += u[1] * w[2] - u[2] * w[1];
      cy += u[2] * w[0] - u[0] * w[2];
      cz += u[0] * w[1] - u[1] * w[0];
    }
    return 0.5 * std::sqrt(cx * cx + cy * cy + cz * cz);
  };

  auto walk_range = [&](int p0, int p1) -> double {
    double acc = 0.0;
    std::vector<int> stack(128);
    for (int pos = p0; pos < p1; ++pos) {
      const int tri = left[leaf_base + pos];
      double tv[3][3];
      float tmin[3], tmax[3];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) tv[i][j] = verts[tri * 9 + i * 3 + j];
      for (int j = 0; j < 3; ++j) {
        tmin[j] = (float)std::min({tv[0][j], tv[1][j], tv[2][j]});
        tmax[j] = (float)std::max({tv[0][j], tv[1][j], tv[2][j]});
      }
      int sp = 0;
      stack[sp++] = 0;
      while (sp) {
        const int node = stack[--sp];
        const bool anc = lo[node] <= pos && pos <= hi[node];
        if (!anc) {
          bool overlap = true;
          for (int j = 0; j < 3 && overlap; ++j)
            overlap = tmin[j] <= bbmax[node * 3 + j] &&
                      tmax[j] >= bbmin[node * 3 + j];
          if (!overlap) continue;
          double a = clip_area(tv, bbmin + node * 3, bbmax + node * 3);
          if (a <= 0.0) continue;
          acc += a * (node >= leaf_base ? c_tri : c_inn);
        }
        if (node < leaf_base) {
          stack[sp++] = left[node];
          stack[sp++] = right[node];
          if (sp + 2 > (int)stack.size()) stack.resize(stack.size() * 2);
        }
      }
    }
    return acc;
  };

  double total = 0.0;
  if (n_threads <= 1) {
    total = walk_range(0, n);
  } else {
    std::vector<std::thread> threads;
    std::vector<double> partial(n_threads, 0.0);
    const int per = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      int p0 = t * per, p1 = std::min(n, p0 + per);
      if (p0 >= p1) break;
      threads.emplace_back(
          [&, t, p0, p1]() { partial[t] = walk_range(p0, p1); });
    }
    for (auto& th : threads) th.join();
    for (double p : partial) total += p;
  }

  double tarea = 0.0;
  for (int t = 0; t < n; ++t) {
    double e1[3], e2[3];
    for (int j = 0; j < 3; ++j) {
      e1[j] = (double)verts[t * 9 + 3 + j] - verts[t * 9 + j];
      e2[j] = (double)verts[t * 9 + 6 + j] - verts[t * 9 + j];
    }
    double cx = e1[1] * e2[2] - e1[2] * e2[1];
    double cy = e1[2] * e2[0] - e1[0] * e2[2];
    double cz = e1[0] * e2[1] - e1[1] * e2[0];
    tarea += 0.5 * std::sqrt(cx * cx + cy * cy + cz * cz);
  }
  return total / std::max(tarea, 1e-30);
}

}  // extern "C"
