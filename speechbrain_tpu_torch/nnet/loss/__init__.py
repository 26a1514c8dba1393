"""Losses kept one a module (port of ``speechbrain_tpu/nnet/loss``)."""
