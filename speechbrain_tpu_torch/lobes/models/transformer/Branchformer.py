"""Branchformer (port of
``speechbrain_tpu/lobes/models/transformer/Branchformer.py``). The
implementation lives in :mod:`speechbrain_tpu_torch.lobes.models.Branchformer`;
re-exported here to mirror the reference layout."""

from speechbrain_tpu_torch.lobes.models.Branchformer import *  # noqa: F401,F403
