// Native host-side setup kernels of the PyTorch port (a copy of the JAX
// package's native tier, so both packages build identical hierarchies).
//
// The sequential graph algorithms of the setup run here at C speed for
// multi-million-row problems; they run once per level, off the device.
// Exact-semantics ports of AlgebraicMultigrid.jl:
//   * rs_cf_splitting  — bucket-queue Ruge-Stuben first pass
//                        (src/splitting.jl:25-159)
//   * standard_aggregation — Vanek/Mandel/Brezina Alg. 5.1 passes 1-3
//                        (src/aggregate.jl:12-134)
//   * greedy_coloring  — natural-order greedy graph coloring for the
//                        multicolor smoothers (no reference counterpart)
//
// All index arrays are int64, 0-based.  Build: see build.py (g++ -O3).

#include <cstdint>
#include <vector>

extern "C" {

// Classical RS splitting. S is the strength graph in CSC (diag removed),
// T = S^T.  Output: splitting[n] with F=0, C=1.
void rs_cf_splitting(int64_t n, const int64_t *Sp, const int64_t *Sj,
                     const int64_t *Tp, const int64_t *Tj, int64_t *splitting) {
  const int64_t F_NODE = 0, C_NODE = 1, U_NODE = 2;
  if (n == 0) return;

  std::vector<int64_t> lam(n), interval_ptr(n + 1, 0), interval_count(n + 1, 0);
  std::vector<int64_t> index_to_node(n), node_to_index(n);

  for (int64_t i = 0; i < n; ++i) {
    lam[i] = Sp[i + 1] - Sp[i];
    interval_count[lam[i]]++;
  }
  for (int64_t k = 1; k <= n; ++k)
    interval_ptr[k] = interval_ptr[k - 1] + interval_count[k - 1];

  // stable bucket insertion in node-index order
  std::vector<int64_t> fill(n + 1, 0);
  for (int64_t i = 0; i < n; ++i) {
    int64_t idx = interval_ptr[lam[i]] + fill[lam[i]]++;
    index_to_node[idx] = i;
    node_to_index[i] = idx;
  }

  for (int64_t i = 0; i < n; ++i) splitting[i] = U_NODE;
  for (int64_t i = 0; i < n; ++i)
    if (lam[i] == 0) splitting[i] = F_NODE;

  for (int64_t top = n - 1; top >= 0; --top) {
    int64_t i = index_to_node[top];
    int64_t lam_i = lam[i];
    interval_count[lam_i]--;

    if (splitting[i] == F_NODE) continue;
    splitting[i] = C_NODE;

    for (int64_t j = Sp[i]; j < Sp[i + 1]; ++j) {
      int64_t row = Sj[j];
      if (splitting[row] != U_NODE) continue;
      splitting[row] = F_NODE;

      for (int64_t k = Tp[row]; k < Tp[row + 1]; ++k) {
        int64_t rowk = Tj[k];
        if (splitting[rowk] != U_NODE) continue;
        if (lam[rowk] >= n - 1) continue;
        int64_t lam_k = lam[rowk];
        int64_t old_pos = node_to_index[rowk];
        int64_t new_pos = interval_ptr[lam_k] + interval_count[lam_k] - 1;

        int64_t swap_node = index_to_node[new_pos];
        index_to_node[old_pos] = swap_node;
        index_to_node[new_pos] = rowk;
        node_to_index[rowk] = new_pos;
        node_to_index[swap_node] = old_pos;

        lam[rowk]++;
        interval_count[lam_k]--;
        interval_count[lam_k + 1]++;
        interval_ptr[lam_k + 1] = new_pos;
      }
    }

    for (int64_t j = Tp[i]; j < Tp[i + 1]; ++j) {
      int64_t row = Tj[j];
      if (splitting[row] != U_NODE) continue;
      if (lam[row] == 0) continue;
      int64_t lam_j = lam[row];
      int64_t old_pos = node_to_index[row];
      int64_t new_pos = interval_ptr[lam_j];

      int64_t swap_node = index_to_node[new_pos];
      index_to_node[old_pos] = swap_node;
      index_to_node[new_pos] = row;
      node_to_index[row] = new_pos;
      node_to_index[swap_node] = old_pos;

      lam[row]--;
      interval_count[lam_j]--;
      interval_count[lam_j - 1]++;
      interval_ptr[lam_j]++;
    }
  }
}

// Standard aggregation passes 1-3 on strength graph S (CSC).
// Output: x[n] = 0-based aggregate id, or -1 for isolated nodes.
// Returns the number of aggregates.
int64_t standard_aggregation(int64_t n, const int64_t *Sp, const int64_t *Sj,
                             const double *Sx, int64_t *x) {
  for (int64_t i = 0; i < n; ++i) x[i] = 0;
  int64_t next_aggregate = 1;

  // Pass 1
  for (int64_t i = 0; i < n; ++i) {
    if (x[i] != 0) continue;
    bool has_agg = false, has_nbr = false;
    for (int64_t j = Sp[i]; j < Sp[i + 1]; ++j) {
      int64_t row = Sj[j];
      if (row != i) {
        has_nbr = true;
        if (x[row] != 0) { has_agg = true; break; }
      }
    }
    if (!has_nbr) {
      x[i] = -n;
    } else if (!has_agg) {
      x[i] = next_aggregate;
      for (int64_t j = Sp[i]; j < Sp[i + 1]; ++j)
        if (Sj[j] != i) x[Sj[j]] = next_aggregate;
      next_aggregate++;
    }
  }

  // Pass 2: strongest assigned neighbour, negative-recorded
  for (int64_t i = 0; i < n; ++i) {
    if (x[i] != 0) continue;
    double s_best = 0.0;
    int64_t x_best = 0;
    for (int64_t j = Sp[i]; j < Sp[i + 1]; ++j) {
      int64_t row = Sj[j];
      if (x[row] > 0 && Sx[j] > s_best) { s_best = Sx[j]; x_best = x[row]; }
    }
    if (x_best > 0) x[i] = -x_best;
  }

  std::vector<char> unagg(n);
  for (int64_t i = 0; i < n; ++i) unagg[i] = (x[i] == 0);

  next_aggregate -= 1;
  for (int64_t i = 0; i < n; ++i) {
    if (x[i] > 0) x[i] -= 1;
    else if (x[i] == -n && n > 0) x[i] = -1;
    else if (x[i] < 0) x[i] = -x[i] - 1;
  }

  // Pass 3: leftovers
  for (int64_t i = 0; i < n; ++i) {
    if (!unagg[i]) continue;
    x[i] = next_aggregate;
    for (int64_t j = Sp[i]; j < Sp[i + 1]; ++j) {
      int64_t row = Sj[j];
      if (unagg[row]) { x[row] = next_aggregate; unagg[row] = 0; }
    }
    unagg[i] = 0;
    next_aggregate++;
  }
  return next_aggregate;
}

// Natural-order greedy coloring of the symmetrised adjacency (diag ignored).
// Gp/Gj: CSR of A+A^T.  Output colors[n] (int32).  Returns color count.
int32_t greedy_coloring(int64_t n, const int64_t *Gp, const int64_t *Gj,
                        int32_t *colors) {
  std::vector<int64_t> mark(n + 1, -1);
  int32_t n_colors = 0;
  for (int64_t i = 0; i < n; ++i) colors[i] = -1;
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = Gp[i]; j < Gp[i + 1]; ++j) {
      int64_t nb = Gj[j];
      if (nb != i && colors[nb] >= 0) mark[colors[nb]] = i;
    }
    int32_t c = 0;
    while (mark[c] == i) ++c;
    colors[i] = c;
    if (c + 1 > n_colors) n_colors = c + 1;
  }
  return n_colors;
}

}  // extern "C"
