// Keypoint quadtree balancer (host code, built with g++).
//
// The port's own copy of the JAX package's native balancer, the role of
// ORB-SLAM3's ORBextractor::DistributeOctTree: split the most populous
// node into four until the node count reaches the level's feature budget,
// then keep the best-response corner of each node. Ties follow this exact
// order: the first most populous node is split, a node's first strictly
// best corner wins, and the selected indices come back sorted. A point on
// a split line goes to the right / lower child.
//
// Plain C ABI, loaded with ctypes (models/orb.py).

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct Node {
  float x0, y0, x1, y1;
  std::vector<int32_t> idx;
};

}  // namespace

extern "C" {

// kpts: (n,2) float32 xy; scores: (n,) float32.
// out_idx: caller-allocated buffer of max_out >= n_target*4 entries.
// Returns the number of selected indices.
int quadtree_select(const float* kpts, const float* scores, int n,
                    int n_target, float x0, float y0, float x1, float y1,
                    int32_t* out_idx, int max_out) {
  if (n <= n_target) {
    int m = n < max_out ? n : max_out;
    for (int i = 0; i < m; ++i) out_idx[i] = i;
    return m;
  }
  std::vector<Node> nodes;
  std::vector<Node> final_nodes;
  nodes.push_back({x0, y0, x1, y1, {}});
  nodes[0].idx.resize(n);
  for (int i = 0; i < n; ++i) nodes[0].idx[i] = i;

  while (!nodes.empty() &&
         (int)(nodes.size() + final_nodes.size()) < n_target) {
    // split the most populous node first
    size_t big = 0;
    for (size_t k = 1; k < nodes.size(); ++k)
      if (nodes[k].idx.size() > nodes[big].idx.size()) big = k;
    Node node = std::move(nodes[big]);
    nodes.erase(nodes.begin() + big);
    if (node.idx.size() == 1) {
      final_nodes.push_back(std::move(node));
      continue;
    }
    const float mx = 0.5f * (node.x0 + node.x1);
    const float my = 0.5f * (node.y0 + node.y1);
    Node q[4] = {{node.x0, node.y0, mx, my, {}},
                 {mx, node.y0, node.x1, my, {}},
                 {node.x0, my, mx, node.y1, {}},
                 {mx, my, node.x1, node.y1, {}}};
    for (int32_t i : node.idx) {
      const float px = kpts[2 * i];
      const float py = kpts[2 * i + 1];
      const int qi = (px >= mx ? 1 : 0) + (py >= my ? 2 : 0);
      q[qi].idx.push_back(i);
    }
    for (auto& qq : q) {
      if (qq.idx.size() == 1)
        final_nodes.push_back(std::move(qq));
      else if (qq.idx.size() > 1)
        nodes.push_back(std::move(qq));
    }
  }

  int m = 0;
  auto emit = [&](const Node& nd) {
    if (nd.idx.empty() || m >= max_out) return;
    int32_t best = nd.idx[0];
    for (int32_t i : nd.idx)
      if (scores[i] > scores[best]) best = i;
    out_idx[m++] = best;
  };
  for (const auto& nd : final_nodes) emit(nd);
  for (const auto& nd : nodes) emit(nd);
  std::sort(out_idx, out_idx + m);
  return m;
}

}  // extern "C"
