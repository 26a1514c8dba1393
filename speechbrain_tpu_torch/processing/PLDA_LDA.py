"""PLDA and LDA speaker-verification back end (the port's own copy of
``speechbrain_tpu/processing/PLDA_LDA.py``, which is numpy: ``StatObject``,
``LDA``, two-covariance ``PLDA`` trained by EM, and ``fast_PLDA_scoring``).

Everything here computes on the host in numpy (float64 for PLDA), as in
the JAX package; embeddings made on the card come over as numpy arrays.
"""

import numpy as np


class StatObject:
    """Container of first/second-order statistics per segment
    (reference PLDA_LDA.py StatObject_SB)."""

    def __init__(self, modelset, segset, stat0=None, stat1=None):
        self.modelset = np.asarray(modelset)
        self.segset = np.asarray(segset)
        n = len(self.segset)
        self.stat0 = stat0 if stat0 is not None else np.ones((n, 1))
        self.stat1 = np.asarray(stat1)

    def get_mean_stat1(self):
        return self.stat1.mean(axis=0)

    def center_stat1(self, mu):
        self.stat1 = self.stat1 - mu

    def get_total_covariance_stat1(self):
        centered = self.stat1 - self.get_mean_stat1()
        return centered.T @ centered / self.stat1.shape[0]

    def get_model_stat1_means(self):
        """Per-model mean vectors and counts."""
        models = np.unique(self.modelset)
        means = np.zeros((len(models), self.stat1.shape[1]))
        counts = np.zeros(len(models))
        for i, m in enumerate(models):
            mask = self.modelset == m
            means[i] = self.stat1[mask].mean(axis=0)
            counts[i] = mask.sum()
        return models, means, counts


class LDA:
    """Linear discriminant analysis projection (reference PLDA_LDA.py LDA)."""

    def __init__(self):
        self.transform_mat = None

    def fit(self, stat_obj, reduced_dim=None):
        X = stat_obj.stat1
        y = stat_obj.modelset
        classes = np.unique(y)
        mu = X.mean(axis=0)
        Sw = np.zeros((X.shape[1], X.shape[1]))
        Sb = np.zeros_like(Sw)
        for c in classes:
            Xc = X[y == c]
            mu_c = Xc.mean(axis=0)
            Sw += (Xc - mu_c).T @ (Xc - mu_c)
            Sb += len(Xc) * np.outer(mu_c - mu, mu_c - mu)
        evals, evecs = np.linalg.eigh(np.linalg.pinv(Sw) @ Sb + 1e-9 * np.eye(X.shape[1]))
        order = np.argsort(evals)[::-1]
        k = reduced_dim or (len(classes) - 1)
        self.transform_mat = evecs[:, order[:k]]
        return self

    def do_lda(self, stat_obj, reduced_dim=None):
        if self.transform_mat is None:
            self.fit(stat_obj, reduced_dim)
        out = StatObject(
            stat_obj.modelset, stat_obj.segset, stat_obj.stat0,
            stat_obj.stat1 @ self.transform_mat,
        )
        return out


class PLDA:
    """Two-covariance PLDA with EM training and trial scoring
    (reference PLDA_LDA.py PLDA).

    Example
    -------
    >>> import numpy as np
    >>> rng = np.random.default_rng(0)
    >>> spk_means = rng.standard_normal((5, 8)) * 3
    >>> X, y = [], []
    >>> for s in range(5):
    ...     for _ in range(20):
    ...         X.append(spk_means[s] + rng.standard_normal(8))
    ...         y.append(s)
    >>> stats = StatObject(np.asarray(y), np.arange(100), stat1=np.asarray(X))
    >>> plda = PLDA(rank_f=4).plda(stats)
    >>> # same-speaker trial scores higher than different-speaker
    >>> s_same = plda.score_pair(spk_means[0], spk_means[0] + 0.1)
    >>> s_diff = plda.score_pair(spk_means[0], spk_means[1])
    >>> bool(s_same > s_diff)
    True
    """

    def __init__(self, mean=None, F=None, Sigma=None, rank_f=100, nb_iter=10,
                 scaling_factor=1.0):
        self.mean = mean
        self.F = F
        self.Sigma = Sigma
        self.rank_f = rank_f
        self.nb_iter = nb_iter

    def plda(self, stat_obj):
        """EM-train the PLDA model (reference PLDA_LDA.py plda)."""
        X = np.asarray(stat_obj.stat1, np.float64)
        N, dim = X.shape
        self.mean = X.mean(axis=0)
        Xc = X - self.mean
        models, means, counts = stat_obj.get_model_stat1_means()
        means = means - self.mean
        rank = min(self.rank_f, dim)
        # init F from PCA of class means, Sigma from residual
        U, s, _ = np.linalg.svd(means.T @ (means * counts[:, None]) / counts.sum())
        self.F = U[:, :rank] * np.sqrt(np.maximum(s[:rank], 1e-6))
        self.Sigma = np.eye(dim)
        for _ in range(self.nb_iter):
            # E-step: posterior of latent speaker factor per model
            Sigma_inv = np.linalg.pinv(self.Sigma)
            FtSi = self.F.T @ Sigma_inv
            E_h = np.zeros((len(models), rank))
            E_hh_sum = np.zeros((rank, rank))
            R = np.zeros((rank, rank))
            T = np.zeros((dim, rank))
            for i, m in enumerate(models):
                n_i = counts[i]
                M_i = np.linalg.pinv(n_i * (FtSi @ self.F) + np.eye(rank))
                first = stat_obj.stat1[stat_obj.modelset == m] - self.mean
                f_i = first.sum(axis=0)
                E_h[i] = M_i @ (FtSi @ f_i)
                E_hh = M_i + np.outer(E_h[i], E_h[i])
                E_hh_sum += n_i * E_hh
                R += n_i * E_hh
                T += np.outer(f_i, E_h[i])
            # M-step
            self.F = T @ np.linalg.pinv(R)
            resid = Xc.T @ Xc
            self.Sigma = (resid - self.F @ T.T) / N
            self.Sigma = (self.Sigma + self.Sigma.T) / 2 + 1e-6 * np.eye(dim)
        return self

    def score_pair(self, enrol_vec, test_vec):
        """Log-likelihood ratio for one trial."""
        return float(
            self.scoring(
                np.asarray(enrol_vec)[None], np.asarray(test_vec)[None]
            )[0, 0]
        )

    def scoring(self, enrol, test):
        """Batch LLR scores (n_enrol, n_test)
        (reference fast_PLDA_scoring)."""
        enrol = np.asarray(enrol, np.float64) - self.mean
        test = np.asarray(test, np.float64) - self.mean
        Phi = self.F @ self.F.T  # between-speaker cov
        Sigma = self.Sigma  # within
        tot = Phi + Sigma
        # two-covariance scoring
        Sigma_tot_inv = np.linalg.pinv(tot)
        Sigma_ac = Phi
        # Use the standard formulation:
        # score = u^T Q u + v^T Q v + 2 u^T P v + const terms absorbed
        inv_within = np.linalg.pinv(tot - Sigma_ac @ Sigma_tot_inv @ Sigma_ac)
        Q = Sigma_tot_inv - inv_within
        P = Sigma_tot_inv @ Sigma_ac @ inv_within
        s_enrol = ((enrol @ Q) * enrol).sum(axis=1)
        s_test = ((test @ Q) * test).sum(axis=1)
        cross = 2.0 * enrol @ P @ test.T
        return s_enrol[:, None] + s_test[None, :] + cross


def fast_PLDA_scoring(enrol, test, ndx, mean, F, Sigma, scaling_factor=1.0):
    """Functional scoring API matching the reference's signature."""
    plda = PLDA(mean=mean, F=F, Sigma=Sigma)
    return plda.scoring(enrol.stat1, test.stat1)
