"""``chip_smoke.py``'s ``rescore_path`` on the CPU at a cut size, its CUDA
timing calls stubbed and each kernel's plain version counted as its
launches: every phase's checks hold (the n-best reranks against numpy's
argsort and the step-by-step LM sums, the host CTC searches, the two
rescoring twins, the buffer LM scorer against the KV-cached one, the
front end's deltas and context), and the path's launches are what its
phases predict: B3 once a feature call, B1 in the ancestry search, B4 on
the permuting search's caches, B2 never."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import logging

import torch

import chip_smoke
from speechbrain_tpu_torch.ops import beam_attention, gather, mel_frontend
from speechbrain_tpu_torch.ops.gather import refuse_autograd
from test_torch_speaker_recipe import _Event
from test_torch_ssl_recipes import SMALL as SSL_SMALL

NORTH = dict(
    batch=2, seconds=0.5, vocab=24, n_mels=20, fe_channels=(8, 4),
    d_model=16, nhead=4, enc_layers=1, dec_layers=2, d_ffn=32, kernel_size=5,
    lm_d_model=16, lm_nhead=4, lm_layers=2, lm_d_ffn=32, beam=3,
    lm_weight=0.6, ctc_weight=0.4, temperature=1.15, max_decode_ratio=1.0,
    bos=1, eos=2, blank=0, pad_multiple=8,
)
TLM = dict(chip_smoke.TLM_CFG, vocab=24, d_model=16, nhead=2, layers=1,
           d_ffn=32)
CRDNN = dict(chip_smoke.CRDNN_CFG, n_mels=16, cnn_channels=(4, 8),
             rnn_layers=1, rnn_neurons=8, dnn_blocks=1, dnn_neurons=12,
             emb_size=8, dec_neurons=10, attn_dim=6, location_channels=3,
             location_kernel=5, vocab=20, lm_emb_size=6, lm_rnn_neurons=12,
             lm_rnn_layers=1, lm_dnn_neurons=8)
CRDNN_DECODE = dict(chip_smoke.CRDNN_DECODE, beam_size=3, max_attn_shift=6)
CTC = dict(chip_smoke.CTC_CFG, n_mels=16, fe_channels=(4, 4), kernel_size=3)
CTC_FAMILIES = {"conformer_large": dict(
    chip_smoke.CTC_FAMILIES["conformer_large"], d_model=16, nhead=2,
    enc_layers=1, d_ffn=32)}


def _counted(monkeypatch, module, name):
    plain = getattr(module, name)

    def counted(x, *args, **kwargs):
        refuse_autograd(name, x)
        module.launches += 1
        return plain(x, *args, **kwargs)

    monkeypatch.setattr(module, name, counted)


def test_run_rescore_path_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "gpu_name_power_limit", lambda: "cpu")
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    for name, value in (("NORTH", NORTH), ("TLM_CFG", TLM),
                        ("CRDNN_CFG", CRDNN), ("CRDNN_DECODE", CRDNN_DECODE),
                        ("CTC_CFG", CTC), ("CTC_FAMILIES", CTC_FAMILIES),
                        ("RESCORE_TOPK", NORTH["beam"]),
                        ("SSL_YAML_EDITS", SSL_SMALL),
                        ("RESCORE_TWIN_CORPUS", dict(
                            chip_smoke.RESCORE_TWIN_CORPUS, utterances=2,
                            seconds=(0.3, 0.35), valid_seconds=0.35,
                            char_s=0.02))):
        monkeypatch.setattr(chip_smoke, name, value)
    _counted(monkeypatch, mel_frontend, "fused_fbank_reference")
    _counted(monkeypatch, beam_attention, "ancestry_attention_reference")
    _counted(monkeypatch, gather, "row_gather_reference")
    handlers = list(logging.getLogger().handlers)
    try:
        launches = chip_smoke.run_rescore_path(str(tmp_path), device="cpu")
    finally:
        for h in logging.getLogger().handlers:
            if h not in handlers:
                logging.getLogger().removeHandler(h)
    by_phase = {line["phase"]: line for line in lines}
    twins = [f"rescore_path/w2v_rescoring_twins/{y}"
             for y in chip_smoke.RESCORE_TWINS]
    assert list(by_phase) == [
        "rescore_path/nbest_transformer", "rescore_path/nbest_rnn",
        "rescore_path/ctc_beam", *twins, "rescore_path/buffer_lm_scorer",
        "rescore_path/frontend", "rescore_path_summary"]
    for phase, line in by_phase.items():
        assert line["ok"], (phase, line)
    n = by_phase["rescore_path/nbest_transformer"]
    assert n["hypotheses"] == NORTH["batch"] * NORTH["beam"]
    assert by_phase["rescore_path/buffer_lm_scorer"]["tokens_equal"]
    for twin in twins:
        assert by_phase[twin]["rescored_utterances"] == 2
    # B3: the n-best search, the CRDNN serve, the CTC posteriors in bf16
    # and float32, the buffer and KV searches, the fused Fbank
    assert launches["fused_fbank"] == 7
    assert launches["ancestry_attention"] > 0
    assert launches["row_gather"] > 0
    assert launches["flash_attention"] == 0
