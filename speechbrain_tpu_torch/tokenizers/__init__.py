"""Tokenizers (port of ``speechbrain_tpu/tokenizers``)."""
