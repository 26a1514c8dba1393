"""Speaker diarization by spectral clustering (port of
``speechbrain_tpu/alignment/diarization.py``): a cosine affinity of the
segment embeddings, p-percentile pruning, the unnormalised Laplacian, the
eigengap estimate of the number of speakers, the spectral embedding, and
k-means on it; then adjacent segments merged and RTTM written.

The affinity and the Laplacian's eigen-decomposition run in numpy float64
on the host, as in JAX; only the k-means runs on the device
(``utils/kmeans.py``).
"""

import numpy as np

from speechbrain_tpu_torch.utils.kmeans import kmeans_fit


def get_affinity(embeddings):
    """Cosine affinity matrix of (N, D) embeddings, float64."""
    emb = np.asarray(embeddings, np.float64)
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
    return emb @ emb.T


def p_pruning(A, pval=0.3):
    """Keep the ``round(pval * N)`` largest affinities of each row (at
    least one), zero the rest, and symmetrise."""
    A = np.array(A)
    n = A.shape[0]
    keep = max(1, int(round(pval * n)))
    for i in range(n):
        idx = np.argsort(A[i])[: n - keep]
        A[i, idx] = 0.0
    return (A + A.T) / 2.0


def estimate_num_speakers(A, max_speakers=10):
    """The eigengap heuristic on the Laplacian's spectrum: 2 plus the
    index of the largest gap after the first, so never one speaker (the
    JAX package's policy); 1 only for a matrix of fewer than 3 rows."""
    D = np.diag(A.sum(axis=1))
    L = D - A
    evals = np.linalg.eigvalsh(L)
    evals = np.sort(evals)[: max_speakers + 1]
    gaps = np.diff(evals)
    return int(np.argmax(gaps[1:]) + 2) if len(gaps) > 1 else 1


def spectral_embedding(A, k):
    """The first ``k`` eigenvectors of the unnormalised Laplacian."""
    D = np.diag(A.sum(axis=1))
    L = D - A
    _evals, evecs = np.linalg.eigh(L)
    return evecs[:, :k]


def do_spec_clustering(embeddings, n_speakers=None, pval=0.3, max_speakers=10,
                       rng=None, device="cuda"):
    """Speaker labels (a list of ints) of (N, D) segment embeddings:
    affinity, pruning, the number of speakers (estimated when None), the
    spectral embedding, then k-means on ``device`` seeded by ``rng``
    (``np.random.default_rng(0)`` when None).

    Example
    -------
    >>> rng = np.random.default_rng(0)
    >>> a = rng.standard_normal((10, 8)) * 0.05 + np.array([1.0] * 8)
    >>> b = rng.standard_normal((10, 8)) * 0.05 - np.array([1.0] * 8)
    >>> labels = do_spec_clustering(np.concatenate([a, b]), n_speakers=2,
    ...                             device="cpu")
    >>> len(set(labels[:10])) == 1 and len(set(labels[10:])) == 1
    True
    """
    A = get_affinity(embeddings)
    A = p_pruning(A, pval)
    if n_speakers is None:
        n_speakers = estimate_num_speakers(A, max_speakers)
    emb = spectral_embedding(A, n_speakers)
    if rng is None:
        rng = np.random.default_rng(0)
    _, labels = kmeans_fit(emb, n_speakers, rng=rng, device=device)
    return np.asarray(labels).tolist()


def merge_ssegs_same_speaker(segments):
    """Merge adjacent ``(start, end, label)`` sub-segments of one label
    that touch or overlap."""
    if not segments:
        return []
    out = [list(segments[0])]
    for s, e, lab in segments[1:]:
        if lab == out[-1][2] and s <= out[-1][1] + 1e-6:
            out[-1][1] = e
        else:
            out.append([s, e, lab])
    return [tuple(x) for x in out]


def write_rttm(segments, rec_id, out_file):
    """Write ``(start, end, label)`` segments as RTTM lines."""
    with open(out_file, "w", encoding="utf-8") as f:
        for start, end, label in segments:
            f.write(
                f"SPEAKER {rec_id} 0 {start:.3f} {end - start:.3f} "
                f"<NA> <NA> spk_{label} <NA> <NA>\n"
            )
