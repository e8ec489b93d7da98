"""Nearest-neighbour search for VNNGP.  Counterpart of
``gpytorch_tpu/utils/nearest_neighbors.py``.

``NNUtil`` is exact: the k nearest points of a fixed set by a brute-force distance product
and ``torch.topk`` on the set's device, and the sequential structure (the k nearest
*preceding* points of each point, built once) by exact float64 differences, blocks of 512
rows at a time.

``IVFNNUtil`` is approximate, the inverted-file index of faiss: a k-means coarse quantiser
(Lloyd iterations from a random subset of the points, drawn from an explicit
``torch.Generator``), inverted lists of fixed length (the points of each cluster, padded
with −1) and a search over the ``nprobe`` nearest lists, for the queries and for the
sequential build alike: O(N·nprobe·N/C) in place of O(N²).
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., n, d) × (..., m, d) → (..., n, m) squared distances, by the expansion."""
    d2 = a.pow(2).sum(-1, keepdim=True) - 2.0 * a @ b.mT + b.pow(2).sum(-1).unsqueeze(-2)
    return d2.clamp_min(0.0)


def _nearest(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k smallest entries of each row, nearest first."""
    return torch.topk(d2, k, dim=-1, largest=False, sorted=True).indices


class NNUtil:
    """Exact k-NN search over a fixed set of ``dim``-dimensional points."""

    def __init__(self, k: int, dim: int, batch_shape=()):
        if k <= 0:
            raise ValueError(f"k must be greater than 0, but got k = {k}")
        self.k, self.dim, self.batch_shape = int(k), int(dim), tuple(batch_shape)
        self.train_x = None

    def set_nn_idx(self, train_x: torch.Tensor) -> None:
        if train_x.shape[-1] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {train_x.shape[-1]}")
        self.train_x = train_x

    def find_nn_idx(self, test_x: torch.Tensor, k: Optional[int] = None) -> torch.Tensor:
        """(..., n_test, k) indices of each test point's k nearest set points."""
        if self.train_x is None:
            raise RuntimeError("Call set_nn_idx(train_x) before find_nn_idx")
        return _nearest(_sq_dist(test_x, self.train_x), self.k if k is None else int(k))

    def build_sequential_nn_idx(self, x: torch.Tensor) -> torch.Tensor:
        """(N − k, k): for i = k … N − 1 the k nearest of x_0 … x_{i−1} to x_i, nearest first."""
        x = x.to(torch.float64)
        N, k = x.shape[-2], self.k
        if k >= N:
            raise ValueError(f"k should be smaller than number of data, got k={k}, N={N}")
        out = torch.empty((N - k, k), dtype=torch.long, device=x.device)
        for start in range(k, N, 512):
            end = min(start + 512, N)
            d2 = (x[start:end, None, :] - x[None, :end, :]).pow(2).sum(-1)
            rows = torch.arange(start, end, device=x.device).unsqueeze(-1)
            d2 = d2.masked_fill(torch.arange(end, device=x.device) >= rows, math.inf)  # only j < i
            out[start - k:end - k] = _nearest(d2, k)
        return out


def _kmeans_fit(x: torch.Tensor, num_clusters: int, generator: torch.Generator, iters: int = 8,
                chunk: int = 65536):
    """(centroids (C, d), assignment (n,)): ``iters`` Lloyd iterations from C distinct points
    drawn with ``generator``; an empty cluster keeps its centroid."""
    n = x.shape[0]
    init = torch.randperm(n, generator=generator, device=generator.device)[:num_clusters].to(x.device)
    centroids = x[init]

    def assign(cents):
        return torch.cat([_sq_dist(x[s:s + chunk], cents).argmin(-1) for s in range(0, n, chunk)])

    for _ in range(iters):
        a = assign(centroids)
        sums = torch.zeros_like(centroids).index_add_(0, a, x)
        counts = torch.zeros(num_clusters, dtype=x.dtype, device=x.device).index_add_(0, a, torch.ones_like(x[:, 0]))
        centroids = torch.where((counts > 0).unsqueeze(-1), sums / counts.clamp_min(1.0).unsqueeze(-1), centroids)
    return centroids, assign(centroids)


class IVFNNUtil(NNUtil):
    """Approximate k-NN by an inverted-file index.  ``set_nn_idx`` fits ``num_clusters``
    (default max(8, √n)) k-means clusters in float32 and holds each cluster's points in a
    list of ``max_list`` entries (default 2⌈n/C⌉ + k); a query searches the points of its
    ``nprobe`` nearest clusters exactly.  ``generator`` seeds the k-means start (default:
    a CPU generator seeded with 0)."""

    def __init__(self, k: int, dim: int, batch_shape=(), num_clusters: Optional[int] = None, nprobe: int = 8,
                 max_list: Optional[int] = None, generator: Optional[torch.Generator] = None):
        super().__init__(k, dim, batch_shape)
        self.num_clusters, self.nprobe, self.max_list = num_clusters, int(nprobe), max_list
        self.generator = torch.Generator().manual_seed(0) if generator is None else generator
        self._index = None

    def set_nn_idx(self, train_x: torch.Tensor) -> None:
        super().set_nn_idx(train_x)
        x = train_x.to(torch.float32)
        n = x.shape[0]
        C = min(self.num_clusters or max(8, int(math.sqrt(n))), n)
        centroids, assignment = _kmeans_fit(x, C, self.generator)
        order = torch.argsort(assignment, stable=True)  # the points, cluster by cluster
        counts = torch.bincount(assignment, minlength=C)
        starts = torch.cumsum(counts, 0) - counts
        L = int(self.max_list or min(n, 2 * math.ceil(n / C) + self.k))
        offs = torch.arange(L, device=x.device).unsqueeze(0)
        pos = (starts.unsqueeze(-1) + offs).clamp_max(n - 1)
        lists = torch.where(offs < counts.unsqueeze(-1), order[pos], torch.full_like(pos, -1))  # (C, L)
        self._index = {"centroids": centroids, "lists": lists}

    def _candidates(self, q: torch.Tensor) -> torch.Tensor:
        """(b, nprobe·L) indices of the points in each query's nprobe nearest lists (−1 pads)."""
        cents, lists = self._index["centroids"], self._index["lists"]
        probe = _nearest(_sq_dist(q.to(cents.dtype), cents), min(self.nprobe, cents.shape[0]))
        return lists[probe].reshape(q.shape[0], -1)

    def build_sequential_nn_idx(self, x: torch.Tensor) -> torch.Tensor:
        """The sequential structure of ``NNUtil`` over the candidates of each point's nprobe
        lists and its k immediate predecessors (so that each row has k valid candidates),
        those at or after the point and duplicates masked; by blocks of 4,096 rows."""
        x = x.to(torch.float32)
        if self._index is None or self.train_x is None or self.train_x.shape != x.shape:
            self.set_nn_idx(x)
        N, k = x.shape[0], self.k
        if k >= N:
            raise ValueError(f"k should be smaller than number of data, got k={k}, N={N}")
        parts = []
        for start in range(k, N, 4096):
            rows = torch.arange(start, min(start + 4096, N), device=x.device)
            pts = x[rows]
            cand = torch.cat([self._candidates(pts), rows.unsqueeze(-1) - 1 - torch.arange(k, device=x.device)], -1)
            d2 = (pts.unsqueeze(-2) - x[cand.clamp(0, N - 1)]).pow(2).sum(-1)
            invalid = (cand < 0) | (cand >= rows.unsqueeze(-1))
            # sort by index (invalid last) to mask repeated candidates, keeping the first
            cand_s, order = torch.sort(torch.where(invalid, torch.full_like(cand, N), cand), dim=-1, stable=True)
            dup = torch.cat([torch.zeros_like(cand_s[:, :1], dtype=torch.bool), cand_s[:, 1:] == cand_s[:, :-1]], -1)
            d2_s = torch.where(invalid.gather(-1, order) | dup, math.inf, d2.gather(-1, order))
            parts.append(cand_s.gather(-1, _nearest(d2_s, k)))
        return torch.cat(parts, 0)

    def find_nn_idx(self, test_x: torch.Tensor, k: Optional[int] = None) -> torch.Tensor:
        if self._index is None:
            raise RuntimeError("Call set_nn_idx(train_x) before find_nn_idx")
        k = self.k if k is None else int(k)
        q = test_x.to(torch.float32)
        squeeze = q.ndim == 1
        if squeeze:
            q = q.unsqueeze(0)
        cand = self._candidates(q)
        d2 = (q.unsqueeze(-2) - self.train_x.to(torch.float32)[cand.clamp_min(0)]).pow(2).sum(-1)
        idx = cand.gather(-1, _nearest(d2.masked_fill(cand < 0, math.inf), k))
        return idx[0] if squeeze else idx
