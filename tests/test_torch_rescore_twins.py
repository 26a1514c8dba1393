"""The LibriSpeech wav2vec CTC rescoring twins
(``train_hf_wav2vec_{rnn,transformer}_rescoring.yaml`` under
``speechbrain_tpu_torch/recipes/LibriSpeech/ASR/CTC``) on the CPU: each
YAML's values against the JAX YAML's, read as text; then each through its
CLI in this process at a cut width with ``--debug``: one training batch,
then the valid stage through the rescoring ``evaluate_batch`` (the host CTC
beam search's top 4, reranked by the YAML's LM), whose CER the log
records. The decoding and rescoring themselves are held against the JAX
package in ``test_torch_ctc_search.py`` and ``test_torch_rescore.py``."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import re

import pytest

from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.CTC import (
    train_with_wav2vec as ft_w2v,
)
from speechbrain_tpu_torch.decoders.ctc import CTCBeamSearcher
from speechbrain_tpu_torch.decoders.scorer import (
    RescorerBuilder,
    RNNLMRescorer,
    TransformerLMRescorer,
)
from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml
from test_torch_frame_recipes import _blocks, _main, _scalars
from test_torch_ssl_recipes import ADDED_ARGS, LS_CTC, PORT, ROOT, _small_text

YAMLS = {kind: f"{LS_CTC}/hparams/train_hf_wav2vec_{kind}_rescoring.yaml"
         for kind in ("rnn", "transformer")}
RESCORERS = {"rnn": RNNLMRescorer, "transformer": TransformerLMRescorer}


@pytest.mark.parametrize("kind", list(YAMLS))
def test_twin_yaml_values_are_the_jax_yamls(kind):
    """Scalars and blocks as in the JAX YAML; the twin adds ``device``,
    the seed's draw and the lines of ``ADDED_ARGS``."""
    jpath, tpath = ROOT / YAMLS[kind], PORT / YAMLS[kind]
    j, t = _scalars(jpath), _scalars(tpath)
    assert t.pop("device") == "cuda"
    assert t.pop("__set_seed").startswith("!apply:")
    j.pop("__set_seed", None)
    assert t == j
    jb, tb = _blocks(jpath), _blocks(tpath)
    assert sorted(jb) == sorted(tb)
    for key, (jtag, jargs) in jb.items():
        ttag, targs = tb[key]
        assert ttag == jtag, key
        assert targs[:len(jargs)] == jargs, key
        for line in targs[len(jargs):]:
            assert any(re.fullmatch(p, line) for p in ADDED_ARGS), (key, line)


@pytest.mark.parametrize("kind", list(YAMLS))
def test_rescoring_twin_trains_and_rescores_its_valid_stage(kind, tmp_path):
    yaml = tmp_path / "hparams.yaml"
    yaml.write_text(_small_text(PORT / YAMLS[kind]))
    out = tmp_path / "out"
    argv = [str(yaml), f"--data_folder={tmp_path / 'data'}",
            f"--output_folder={out}", "--device=cpu", "--debug",
            "--debug_batches=1", "--debug_epochs=1", "--noprogressbar"]
    brain, _ = _main(ft_w2v.main, argv)
    hparams = brain.hparams
    assert isinstance(hparams.test_beam_searcher, CTCBeamSearcher)
    builder = hparams.rescorer
    assert isinstance(builder, RescorerBuilder)
    assert builder.weights == {"lm": 0.5}
    assert isinstance(builder.rescorers["lm"], RESCORERS[kind])
    assert not hparams.rescorer_lm.training
    # the valid stage went through the rescoring: its CER is logged
    assert brain.cer_metric.ids
    log = (out / "train_log.txt").read_text()
    assert re.search(r"valid CER: [0-9.]+", log), log


def test_build_rescorer_defaults():
    """``rescorer_type`` unset reads as ``rnn`` and ``rescorer_weight`` as
    0.5, as in the JAX script."""
    hparams = load_hyperpyyaml(
        "lm: !new:speechbrain_tpu_torch.lobes.models.RNNLM.RNNLM\n"
        "  output_neurons: 7\n  embedding_dim: 4\n  rnn_neurons: 8\n"
        "  dnn_neurons: 8\n  device: cpu\n")
    builder = ft_w2v.build_rescorer({"rescorer_lm": hparams["lm"],
                                     "bos_index": 1, "eos_index": 2})
    assert isinstance(builder.rescorers["lm"], RNNLMRescorer)
    assert builder.weights == {"lm": 0.5}
