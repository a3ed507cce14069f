// Host-side graph preprocessing for the PyTorch port (C ABI, loaded via
// ctypes by native/__init__.py).
//
// One-pass O(E) block-sparse structure and tile fill, and the bandwidth-
// reduction ordering (RCM + triangle-support shortcut filter) that the BCSR
// construction in ops/bcsr.py runs on the host before the operator goes to the
// card; the counting-sort CSR build and the edge grouping by node part that
// parallel/partition.py runs before a graph is split across ranks.  The algorithms, and so the outputs, are those of the JAX package's
// native/graph_ops.cpp: tiles come out in sorted (row_block, col_block)
// order, which makes construction parity between the two packages exact.
//
// Build: g++ -O3 -shared -fPIC graph_ops.cpp -o libgraph_ops.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Counting-sort edges by receiver, producing CSR over receivers.
//   indptr:  (num_nodes + 1) out
//   order:   (num_edges) out — permutation such that receivers[order] is
//            sorted ascending (stable).
void csr_from_coo(const int32_t* receivers, int64_t num_edges,
                  int32_t num_nodes, int64_t* indptr, int64_t* order) {
  std::memset(indptr, 0, sizeof(int64_t) * (num_nodes + 1));
  for (int64_t e = 0; e < num_edges; ++e) indptr[receivers[e] + 1]++;
  for (int32_t n = 0; n < num_nodes; ++n) indptr[n + 1] += indptr[n];
  std::vector<int64_t> cursor(indptr, indptr + num_nodes);
  for (int64_t e = 0; e < num_edges; ++e) {
    order[cursor[receivers[e]]++] = e;
  }
}

// Block-sparse structure: assign every edge to a (row_block, col_block)
// tile, counting-sort edges by tile, and emit the unique tile list.
// Returns the number of nonzero tiles (nnzb).
//   block_of_edge: (num_edges) out — index into the unique-tile list.
//   order:         (num_edges) out — edges grouped by tile.
//   tile_rows/tile_cols: (max_tiles) out — row/col block index per tile
//                        (only the first nnzb entries are valid).
int64_t bcsr_structure(const int32_t* senders, const int32_t* receivers,
                       int64_t num_edges, int32_t block, int32_t grid_cols,
                       int64_t* block_of_edge, int64_t* order,
                       int32_t* tile_rows, int32_t* tile_cols) {
  const int64_t num_tiles = (int64_t)grid_cols * grid_cols;
  std::vector<int64_t> count(num_tiles + 1, 0);
  std::vector<int64_t> key(num_edges);
  for (int64_t e = 0; e < num_edges; ++e) {
    key[e] = (int64_t)(receivers[e] / block) * grid_cols + senders[e] / block;
    count[key[e] + 1]++;
  }
  // compact nonzero tiles
  std::vector<int64_t> tile_id(num_tiles, -1);
  int64_t nnzb = 0;
  for (int64_t t = 0; t < num_tiles; ++t) {
    if (count[t + 1] > 0) {
      tile_id[t] = nnzb;
      tile_rows[nnzb] = (int32_t)(t / grid_cols);
      tile_cols[nnzb] = (int32_t)(t % grid_cols);
      ++nnzb;
    }
  }
  // prefix sums over nonzero tiles only
  std::vector<int64_t> start(nnzb + 1, 0);
  for (int64_t t = 0; t < num_tiles; ++t)
    if (tile_id[t] >= 0) start[tile_id[t] + 1] = count[t + 1];
  for (int64_t b = 0; b < nnzb; ++b) start[b + 1] += start[b];
  std::vector<int64_t> cursor(start.begin(), start.end() - 1);
  for (int64_t e = 0; e < num_edges; ++e) {
    int64_t b = tile_id[key[e]];
    block_of_edge[e] = b;
    order[cursor[b]++] = e;
  }
  return nnzb;
}

// Scatter edge values into dense (nnzb, block, block) tiles in one pass.
void bcsr_fill(const int32_t* senders, const int32_t* receivers,
               const float* weights, const int64_t* block_of_edge,
               int64_t num_edges, int32_t block, float* tiles) {
  const int64_t tile_sz = (int64_t)block * block;
  for (int64_t e = 0; e < num_edges; ++e) {
    int64_t b = block_of_edge[e];
    int32_t r = receivers[e] % block;
    int32_t c = senders[e] % block;
    tiles[b * tile_sz + (int64_t)r * block + c] += weights[e];
  }
}

// Reverse Cuthill-McKee ordering on the symmetrized graph.
//
// Produces perm such that perm[new_id] = old_id; relabeling nodes by it
// minimizes (heuristically) the bandwidth of the adjacency, concentrating
// edges near the diagonal so the BCSR construction keeps them in dense MXU
// tiles instead of spilling them to the gather-rate-bound COO remainder.
// Classic CM: repeatedly seed at an unvisited minimum-degree node, BFS
// appending unvisited neighbors in increasing-degree order, then reverse.
void rcm_order(const int32_t* senders, const int32_t* receivers,
               int64_t num_edges, int32_t num_nodes, int32_t* perm) {
  // build symmetric CSR (each edge contributes both directions)
  std::vector<int64_t> indptr(num_nodes + 1, 0);
  for (int64_t e = 0; e < num_edges; ++e) {
    indptr[senders[e] + 1]++;
    indptr[receivers[e] + 1]++;
  }
  for (int32_t n = 0; n < num_nodes; ++n) indptr[n + 1] += indptr[n];
  std::vector<int32_t> nbr(indptr[num_nodes]);
  std::vector<int64_t> cursor(indptr.begin(), indptr.end() - 1);
  for (int64_t e = 0; e < num_edges; ++e) {
    nbr[cursor[senders[e]]++] = receivers[e];
    nbr[cursor[receivers[e]]++] = senders[e];
  }
  std::vector<int32_t> degree(num_nodes);
  for (int32_t n = 0; n < num_nodes; ++n)
    degree[n] = (int32_t)(indptr[n + 1] - indptr[n]);
  // min-degree seed selection without an O(N^2) rescan: nodes sorted by
  // degree once; the seed cursor only moves forward.
  std::vector<int32_t> by_degree(num_nodes);
  for (int32_t n = 0; n < num_nodes; ++n) by_degree[n] = n;
  std::stable_sort(by_degree.begin(), by_degree.end(),
                   [&](int32_t a, int32_t b) { return degree[a] < degree[b]; });
  std::vector<uint8_t> visited(num_nodes, 0);
  std::vector<int32_t> scratch;
  int64_t out = 0, seed_cursor = 0;
  while (out < num_nodes) {
    while (seed_cursor < num_nodes && visited[by_degree[seed_cursor]])
      ++seed_cursor;
    int32_t seed = by_degree[seed_cursor];
    visited[seed] = 1;
    int64_t head = out;
    perm[out++] = seed;
    while (head < out) {
      int32_t u = perm[head++];
      scratch.clear();
      for (int64_t i = indptr[u]; i < indptr[u + 1]; ++i) {
        int32_t v = nbr[i];
        if (!visited[v]) {
          visited[v] = 1;
          scratch.push_back(v);
        }
      }
      std::stable_sort(scratch.begin(), scratch.end(),
                       [&](int32_t a, int32_t b) {
                         return degree[a] < degree[b];
                       });
      for (int32_t v : scratch) perm[out++] = v;
    }
  }
  for (int64_t i = 0; i < num_nodes / 2; ++i)
    std::swap(perm[i], perm[num_nodes - 1 - i]);
}

// Per-edge triangle support |N(s) ∩ N(r)| on the symmetrized graph.
//
// Cheap structural signal separating locally-clustered edges (high
// support: band/community edges share neighbors) from random shortcuts
// (support ~0).  The reordering pipeline drops low-support edges BEFORE
// running RCM so BFS cannot tunnel through shortcuts and destroy the
// recoverable band (measured: 2.2x fewer spilled edges on scrambled
// banded + 5% random cross).
void edge_triangle_support(const int32_t* senders, const int32_t* receivers,
                           int64_t num_edges, int32_t num_nodes,
                           int32_t* support) {
  std::vector<int64_t> indptr(num_nodes + 1, 0);
  for (int64_t e = 0; e < num_edges; ++e) {
    indptr[senders[e] + 1]++;
    indptr[receivers[e] + 1]++;
  }
  for (int32_t n = 0; n < num_nodes; ++n) indptr[n + 1] += indptr[n];
  std::vector<int32_t> nbr(indptr[num_nodes]);
  std::vector<int64_t> cursor(indptr.begin(), indptr.end() - 1);
  for (int64_t e = 0; e < num_edges; ++e) {
    nbr[cursor[senders[e]]++] = receivers[e];
    nbr[cursor[receivers[e]]++] = senders[e];
  }
  // sort + dedup each neighbor list in place; keep per-node end offsets
  std::vector<int64_t> endp(num_nodes);
  for (int32_t n = 0; n < num_nodes; ++n) {
    auto b = nbr.begin() + indptr[n], e2 = nbr.begin() + indptr[n + 1];
    std::sort(b, e2);
    endp[n] = indptr[n] + (std::unique(b, e2) - b);
  }
  for (int64_t e = 0; e < num_edges; ++e) {
    int32_t u = senders[e], v = receivers[e];
    int64_t i = indptr[u], j = indptr[v];
    int32_t c = 0;
    while (i < endp[u] && j < endp[v]) {
      int32_t a = nbr[i], b = nbr[j];
      if (a == b) { ++c; ++i; ++j; }
      else if (a < b) ++i;
      else ++j;
    }
    support[e] = c;
  }
}

// Group edges by the part of their key node (node block key / nodes_per_part):
// counts per part and an edge order, stable within a part.
void partition_edges(const int32_t* receivers, int64_t num_edges,
                     int32_t nodes_per_part, int32_t num_parts,
                     int64_t* counts, int64_t* order) {
  std::memset(counts, 0, sizeof(int64_t) * num_parts);
  for (int64_t e = 0; e < num_edges; ++e)
    counts[receivers[e] / nodes_per_part]++;
  std::vector<int64_t> start(num_parts + 1, 0);
  for (int32_t p = 0; p < num_parts; ++p) start[p + 1] = start[p] + counts[p];
  std::vector<int64_t> cursor(start.begin(), start.end() - 1);
  for (int64_t e = 0; e < num_edges; ++e)
    order[cursor[receivers[e] / nodes_per_part]++] = e;
}

}  // extern "C"
