"""K-means clustering by Lloyd's algorithm on a torch device (port of
``speechbrain_tpu/utils/kmeans.py``): the spectral clustering of
diarization runs its k-means here.
"""

import numpy as np
import torch


def _initial_indices(N, n_clusters, rng):
    """``n_clusters`` distinct row indices: ``rng.choice(N, n_clusters,
    replace=False)`` of a numpy ``Generator`` (``default_rng(0)`` when
    None), or the first ``n_clusters`` of ``torch.randperm(N)`` drawn from
    a ``torch.Generator``."""
    if rng is None:
        rng = np.random.default_rng(0)
    if isinstance(rng, torch.Generator):
        return torch.randperm(N, generator=rng, device=rng.device)[
            :n_clusters].cpu()
    return torch.as_tensor(rng.choice(N, size=n_clusters, replace=False))


def kmeans_fit(x, n_clusters, n_iters=50, rng=None, device=None):
    """Lloyd's algorithm on (N, D) data in float32: ``n_iters`` rounds of
    nearest-centroid assignment and mean update; a cluster left empty
    keeps its centroid. Runs on ``device`` (the tensor's own device, or
    ``"cuda"`` for an array, when None). Returns ``(centroids,
    assignments)`` as numpy arrays, those of the last round.

    Example
    -------
    >>> pts = np.concatenate([np.zeros((10, 2)), np.ones((10, 2)) * 5])
    >>> cents, assign = kmeans_fit(pts, 2, rng=np.random.default_rng(0),
    ...                            device="cpu")
    >>> len(set(assign[:10].tolist())), len(set(assign[10:].tolist()))
    (1, 1)
    """
    if device is None:
        device = x.device if torch.is_tensor(x) else "cuda"
    x = torch.as_tensor(x).to(device=device, dtype=torch.float32)
    N = x.shape[0]
    init_idx = _initial_indices(N, n_clusters, rng).to(device)
    centroids = x[init_idx]
    assign = torch.zeros(N, dtype=torch.long, device=device)
    for _ in range(n_iters):
        d = ((x[:, None, :] - centroids[None]) ** 2).sum(dim=-1)
        assign = d.argmin(dim=-1)
        counts = torch.bincount(assign, minlength=n_clusters).to(x.dtype)
        sums = torch.zeros_like(centroids).index_add_(0, assign, x)
        centroids = torch.where(counts[:, None] > 0,
                                sums / counts.clamp(min=1)[:, None],
                                centroids)
    return centroids.cpu().numpy(), assign.cpu().numpy()


def kmeans_predict(x, centroids):
    """Index of the nearest centroid of each row of ``x`` (one product
    with the centroids), on ``x``'s device."""
    x = torch.as_tensor(x)
    c = torch.as_tensor(centroids, device=x.device, dtype=x.dtype)
    d = (x ** 2).sum(-1, keepdim=True) - 2 * x @ c.T + (c ** 2).sum(-1)[None]
    return d.argmin(dim=-1)
