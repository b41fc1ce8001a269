"""Non-IID data allocation across nodes (paper §V-3); a numpy copy of the
JAX package's `data/allocation.py`.

Class images are assigned to nodes via a **Truncated Zipf** distribution with
exponent alpha_zipf = 1.26: for each class we draw one Zipf share per node (the
node ranking is a per-class random permutation, so different nodes dominate
different classes), producing a highly skewed allocation where typically one
node holds the majority of a class.  Every node is guaranteed a minimum number
of samples per class to avoid boundary effects (paper: "all nodes see at
least some images for each class, however few").

Skew is quantified with the **Gini index** over per-node sample counts; the
paper works in the [0.7, 0.85] range and reports the GI of each run.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

PAPER_ZIPF_ALPHA = 1.26


def gini_index(counts) -> float:
    """Gini index of a non-negative allocation (0 = equal, 1 = one-holds-all)."""
    x = np.asarray(counts, np.float64).ravel()
    if x.size == 0 or x.sum() == 0:
        return 0.0
    x = np.sort(x)
    n = x.size
    cum = np.cumsum(x)
    # standard formula: G = (2 * sum_i i*x_i) / (n * sum x) - (n + 1) / n
    g = (2.0 * np.sum((np.arange(1, n + 1)) * x)) / (n * cum[-1]) - (n + 1.0) / n
    return float(max(0.0, min(1.0, g)))


def zipf_allocation(labels: np.ndarray, num_nodes: int, alpha: float = PAPER_ZIPF_ALPHA,
                    min_per_class: int = 2, seed: int = 0,
                    rank_correlation: float = 0.0) -> List[np.ndarray]:
    """Assign sample indices to nodes with per-class truncated-Zipf skew.

    Args:
      labels: [N] int labels of the training set.
      num_nodes: number of FL nodes.
      alpha: Zipf exponent (paper: 1.26).
      min_per_class: guaranteed per-node per-class floor.
      seed: rng seed.
      rank_correlation: in [0, 1].  0 = independent per-class node rankings
        (pure label-distribution skew; per-node totals stay balanced);
        1 = one global ranking for all classes (adds quantity skew: the same
        nodes dominate every class).  Intermediate values mix the two, letting
        experiments dial the run-level Gini into the paper's [0.7, 0.85] band.

    Returns:
      list of index arrays, one per node (disjoint, covering all samples).
    """
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    classes = np.unique(labels)
    node_indices: List[List[int]] = [[] for _ in range(num_nodes)]
    global_ranks = rng.permutation(num_nodes)
    for c in classes:
        idx = np.nonzero(labels == c)[0]
        rng.shuffle(idx)
        n_c = len(idx)
        # Zipf shares over a (possibly globally-correlated) node ranking.
        if rank_correlation >= 1.0:
            ranks = global_ranks.copy()
        elif rank_correlation <= 0.0:
            ranks = rng.permutation(num_nodes)
        else:
            # keep each node's global rank with prob rank_correlation,
            # shuffle the rest among themselves.
            ranks = global_ranks.copy()
            move = np.nonzero(rng.random(num_nodes) > rank_correlation)[0]
            ranks[move] = ranks[rng.permutation(move)] if len(move) else ranks[move]
        shares = 1.0 / np.power(np.arange(1, num_nodes + 1, dtype=np.float64), alpha)
        shares = shares / shares.sum()
        floor = min(min_per_class, max(n_c // num_nodes, 1))
        remaining = n_c - floor * num_nodes
        if remaining < 0:
            floor, remaining = 0, n_c
        counts = np.full(num_nodes, floor, np.int64)
        extra = np.floor(shares * remaining).astype(np.int64)
        counts[ranks] += extra
        # distribute the rounding remainder to the highest-share nodes
        leftover = n_c - counts.sum()
        order = ranks[np.argsort(-shares)]
        for k in range(int(leftover)):
            counts[order[k % num_nodes]] += 1
        # hand out slices
        off = 0
        for node in range(num_nodes):
            take = int(counts[node])
            node_indices[node].extend(idx[off : off + take].tolist())
            off += take
    return [np.asarray(sorted(ix), np.int64) for ix in node_indices]


def split_by_allocation(x: np.ndarray, y: np.ndarray, allocation: List[np.ndarray]
                        ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    xs = [x[ix] for ix in allocation]
    ys = [y[ix] for ix in allocation]
    return xs, ys


def allocation_gini(allocation: List[np.ndarray], labels: np.ndarray = None) -> float:
    """Run-level Gini index of the data allocation.

    Without labels: Gini over per-node totals (quantity skew only).  With
    labels: Gini over the flattened node x class count matrix, capturing the
    label-distribution skew the paper's heterogeneity targets (this is the
    quantity that lands in the paper's [0.7, 0.85] operating band for
    alpha_zipf = 1.26)."""
    if labels is None:
        return gini_index([len(ix) for ix in allocation])
    labels = np.asarray(labels)
    classes = np.unique(labels)
    counts = np.zeros((len(allocation), len(classes)), np.int64)
    class_pos = {c: k for k, c in enumerate(classes)}
    for i, ix in enumerate(allocation):
        for c, n in zip(*np.unique(labels[ix], return_counts=True)):
            counts[i, class_pos[c]] = n
    return gini_index(counts.ravel())


def pad_node_datasets(xs: List[np.ndarray], ys: List[np.ndarray]
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad per-node datasets to a common length for vmapped training.

    Returns (x_pad [N, M, ...], y_pad [N, M], counts [N]).  Padding samples
    repeat real ones (so they're harmless) but training draws minibatches
    only from the first `counts[i]` entries via modular indexing.
    """
    n = len(xs)
    m = max(len(x) for x in xs)
    x_pad = np.zeros((n, m) + xs[0].shape[1:], xs[0].dtype)
    y_pad = np.zeros((n, m), ys[0].dtype)
    counts = np.zeros(n, np.int64)
    for i, (x, y) in enumerate(zip(xs, ys)):
        k = len(x)
        counts[i] = k
        reps = -(-m // k)
        x_pad[i] = np.concatenate([x] * reps)[:m]
        y_pad[i] = np.concatenate([y] * reps)[:m]
    return x_pad, y_pad, counts
