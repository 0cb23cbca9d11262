"""Random-forest image classification (paper pipeline P4).

The paper classifies with an OTB random-forest model.  A numpy CART/forest
*trainer* (gini, feature subsampling, bootstrap) — a copy of
``repro.filters.classify``'s, unchanged in arithmetic, so the same data and
seed give the same arrays — and a torch *inference* path: trees are flat
node arrays, and every pixel walks them level by level with gathers, so
classification is tensor math with no data-dependent control flow.

Pointwise per pixel → zero halo → embarrassingly parallel.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.process_object import Filter, ImageInfo
from repro_torch.core.region import ImageRegion


# ---------------------------------------------------------------------------
# training (host, numpy) — produces flat node arrays
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Tree:
    feature: np.ndarray  # (n_nodes,) int32, -1 for leaves
    threshold: np.ndarray  # (n_nodes,) float32
    left: np.ndarray  # (n_nodes,) int32 child index (self-loop on leaves)
    right: np.ndarray  # (n_nodes,) int32
    leaf_class: np.ndarray  # (n_nodes,) int32 (valid everywhere; argmax class)


@dataclasses.dataclass
class Forest:
    trees: List[Tree]
    n_classes: int
    max_depth: int

    def stacked(self) -> Tuple[np.ndarray, ...]:
        """Pad trees to the same node count and stack: (T, n_nodes) arrays."""
        n = max(t.feature.size for t in self.trees)

        def pad(a, fill):
            return np.stack(
                [np.pad(x, (0, n - x.size), constant_values=fill) for x in a]
            )

        return (
            pad([t.feature for t in self.trees], -1).astype(np.int32),
            pad([t.threshold for t in self.trees], 0.0).astype(np.float32),
            pad([t.left for t in self.trees], 0).astype(np.int32),
            pad([t.right for t in self.trees], 0).astype(np.int32),
            pad([t.leaf_class for t in self.trees], 0).astype(np.int32),
        )


def _gini_best_split(X, y, n_classes, feat_ids, rng):
    best = (None, None, np.inf)  # (feat, thr, impurity)
    n = y.size
    for f in feat_ids:
        order = np.argsort(X[:, f], kind="stable")
        xs, ys = X[order, f], y[order]
        counts_left = np.zeros(n_classes)
        counts_right = np.bincount(ys, minlength=n_classes).astype(np.float64)
        for i in range(n - 1):
            counts_left[ys[i]] += 1
            counts_right[ys[i]] -= 1
            if xs[i + 1] <= xs[i]:
                continue
            nl, nr = i + 1.0, n - i - 1.0
            gl = 1.0 - ((counts_left / nl) ** 2).sum()
            gr = 1.0 - ((counts_right / nr) ** 2).sum()
            imp = (nl * gl + nr * gr) / n
            if imp < best[2]:
                best = (f, 0.5 * (xs[i] + xs[i + 1]), imp)
    return best


def _build_tree(X, y, n_classes, max_depth, rng, max_features):
    feature, threshold, left, right, leaf = [], [], [], [], []

    def new_node():
        feature.append(-1)
        threshold.append(0.0)
        left.append(0)
        right.append(0)
        leaf.append(0)
        return len(feature) - 1

    def grow(idx, depth):
        node = new_node()
        counts = np.bincount(y[idx], minlength=n_classes)
        leaf[node] = int(counts.argmax())
        if depth >= max_depth or idx.size < 4 or counts.max() == idx.size:
            left[node] = right[node] = node
            return node
        feats = rng.choice(X.shape[1], size=min(max_features, X.shape[1]), replace=False)
        f, thr, _ = _gini_best_split(X[idx], y[idx], n_classes, feats, rng)
        if f is None:
            left[node] = right[node] = node
            return node
        mask = X[idx, f] <= thr
        if mask.all() or not mask.any():
            left[node] = right[node] = node
            return node
        feature[node] = int(f)
        threshold[node] = float(thr)
        left[node] = grow(idx[mask], depth + 1)
        right[node] = grow(idx[~mask], depth + 1)
        return node

    grow(np.arange(y.size), 0)
    return Tree(
        np.array(feature, np.int32),
        np.array(threshold, np.float32),
        np.array(left, np.int32),
        np.array(right, np.int32),
        np.array(leaf, np.int32),
    )


def train_forest(
    X: np.ndarray,
    y: np.ndarray,
    n_trees: int = 8,
    max_depth: int = 8,
    seed: int = 0,
) -> Forest:
    """Bootstrap-aggregated CART forest on (N, F) features / (N,) int labels."""
    rng = np.random.default_rng(seed)
    n_classes = int(y.max()) + 1
    max_features = max(1, int(np.sqrt(X.shape[1])))
    trees = []
    for _ in range(n_trees):
        boot = rng.integers(0, y.size, size=y.size)
        trees.append(
            _build_tree(X[boot], y[boot], n_classes, max_depth, rng, max_features)
        )
    return Forest(trees, n_classes, max_depth)


# ---------------------------------------------------------------------------
# inference (torch) — level-synchronous tree walk
# ---------------------------------------------------------------------------
def forest_predict(forest_arrays, n_classes: int, max_depth: int, X: torch.Tensor):
    """X: (N, F) float32 → (N,) int32 predicted class, on X's device.
    ``forest_arrays`` = :meth:`Forest.stacked`.  Ties in the vote go to the
    lowest class, as ``jnp.argmax`` breaks them."""
    dev = X.device
    feat, thr, left, right, leaf = (torch.from_numpy(np.asarray(a)).to(dev)
                                    for a in forest_arrays)
    N = X.shape[0]
    rows = torch.arange(N, device=dev)
    votes = torch.zeros((N, n_classes), dtype=torch.float32, device=dev)
    for t in range(feat.shape[0]):
        node = torch.zeros(N, dtype=torch.int64, device=dev)
        for _ in range(max_depth + 1):
            f = feat[t][node]
            th = thr[t][node]
            xval = X.gather(1, torch.clamp(f, min=0).to(torch.int64)[:, None])[:, 0]
            nxt = torch.where(xval <= th, left[t][node], right[t][node]).to(torch.int64)
            node = torch.where(f < 0, node, nxt)
        votes[rows, leaf[t][node].to(torch.int64)] += 1.0
    # the first class holding the most votes
    classes = torch.arange(n_classes, dtype=torch.int32, device=dev)
    top = votes.amax(dim=-1, keepdim=True)
    return torch.where(votes == top, classes, n_classes).amin(dim=-1)


class RandomForestClassify(Filter):
    """Per-pixel classification from band values (+ optional normalization)."""

    def __init__(
        self,
        forest: Forest,
        mean: Optional[np.ndarray] = None,
        std: Optional[np.ndarray] = None,
        name=None,
    ):
        super().__init__(name)
        self.forest = forest
        self.arrays = forest.stacked()
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        self.std = None if std is None else np.asarray(std, np.float32)

    def output_info(self, info: ImageInfo) -> ImageInfo:
        return ImageInfo(info.rows, info.cols, 1, np.int32, info.geo)

    def generate(self, out_region: ImageRegion, x: torch.Tensor) -> torch.Tensor:
        H, W, B = x.shape
        feats = x.reshape(-1, B).to(torch.float32)
        if self.mean is not None:
            mean = torch.from_numpy(self.mean).to(x.device)
            std = torch.from_numpy(self.std).to(x.device)
            feats = (feats - mean) / torch.clamp(std, min=1e-6)
        cls = forest_predict(
            self.arrays, self.forest.n_classes, self.forest.max_depth, feats
        )
        return cls.reshape(H, W, 1)
