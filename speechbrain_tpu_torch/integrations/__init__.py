"""Integrations (port of ``speechbrain_tpu/integrations``): so far only
``numba``, where the transducer loss is found under the reference's
name."""
