"""The twin recipe's hparams for the LibriSpeech transformer recipe's other
encoder families: each YAML loads through the port's ``utils/hyperyaml.py``
on the CPU and builds modules with the widths and depths of the JAX YAML of
the same name, which is read here as text (nothing of JAX is imported)."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import os
import re

import pytest
import torch

from speechbrain_tpu_torch.lobes.models.Branchformer import (
    BranchformerEncoder,
)
from speechbrain_tpu_torch.lobes.models.transformer.Conformer import (
    ConformerEncoder,
)
from speechbrain_tpu_torch.lobes.models.transformer.Transformer import (
    TransformerEncoder,
)
from speechbrain_tpu_torch.nnet.attention import (
    MultiheadAttention,
    RelPosMHAXL,
    RoPEMHA,
)
from speechbrain_tpu_torch.nnet.hypermixing import HyperMixing
from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HPARAMS = "recipes/LibriSpeech/ASR/transformer/hparams"
FAMILY_YAMLS = ["transformer", "conformer_large_rope", "branchformer_large",
                "hyperconformer_22M", "hyperconformer_8M",
                "hyperbranchformer_25M", "hyperbranchformer_13M"]
ENCODERS = {"transformer": TransformerEncoder,
            "conformer": ConformerEncoder,
            "branchformer": BranchformerEncoder}
ATTENTIONS = {"regularMHA": MultiheadAttention, "RelPosMHAXL": RelPosMHAXL,
              "RoPEMHA": RoPEMHA, "hypermixing": HyperMixing}


def _jax_values(name):
    """The JAX YAML's scalars and the model's two string arguments."""
    with open(os.path.join(ROOT, HPARAMS, f"{name}.yaml")) as f:
        text = f.read()
    out = {}
    for key in ("seed", "vocab_size", "n_mels", "d_model", "nhead",
                "num_encoder_layers", "num_decoder_layers", "d_ffn",
                "kernel_size", "transformer_dropout", "ctc_weight",
                "ctc_weight_decode", "beam_size", "lr_adam",
                "n_warmup_steps", "batch_size", "grad_accumulation_factor"):
        out[key] = float(re.search(rf"^{key}: (\S+)", text, re.M).group(1))
    for key in ("encoder_module", "attention_type"):
        out[key] = re.search(rf"^  {key}: (\S+)", text, re.M).group(1)
    return out


@pytest.mark.parametrize("name", FAMILY_YAMLS)
def test_twin_yaml_builds_the_jax_yamls_model(name, tmp_path):
    want = _jax_values(name)
    path = os.path.join(ROOT, "speechbrain_tpu_torch", HPARAMS,
                        f"{name}.yaml")
    with open(path) as f:
        hp = load_hyperpyyaml(f, {"device": "cpu",
                                  "data_folder": str(tmp_path / "data"),
                                  "output_folder": str(tmp_path / "out")})
    for key, value in want.items():
        if not isinstance(value, str):  # the strings are the model's
            assert hp[key] == type(hp[key])(value), key
    model = hp["modules"]["model"]
    enc, dec = model.encoder, model.decoder
    d, heads = int(want["d_model"]), int(want["nhead"])
    assert type(enc) is ENCODERS[want["encoder_module"]]
    assert len(enc.layers) == want["num_encoder_layers"]
    assert len(dec.layers) == want["num_decoder_layers"]
    layer = enc.layers[0]
    attn = getattr(layer, "self_attn", None) or layer.attn
    assert type(attn) is ATTENTIONS[want["attention_type"]]
    if isinstance(attn, HyperMixing):
        assert attn.num_heads == heads
        assert attn.hyper.hypernet_size == 4 * d
    else:
        assert getattr(attn, "nhead", getattr(attn, "num_heads", None)) \
            == heads
    # d_ffn: the FFN width, or the CSGU's linear units in a branchformer
    if isinstance(enc, BranchformerEncoder):
        assert layer.cgmlp.up.n_neurons == want["d_ffn"]
        assert layer.cgmlp.csgu.dw_conv.kernel_size == want["kernel_size"]
    elif isinstance(enc, ConformerEncoder):
        assert layer.ffn1.ffn1.n_neurons == want["d_ffn"]
        assert layer.conv.kernel_size == want["kernel_size"]
    else:
        assert layer.ffn.ffn1.n_neurons == want["d_ffn"]
    assert dec.layers[0].self_attn.nhead == heads
    assert dec.layers[0].ffn.ffn1.n_neurons == want["d_ffn"]
    assert model.d_model == d and dec.d_model == d
    assert hp["modules"]["seq_head"].n_neurons == want["vocab_size"]
    assert hp["compute_features"].fused
    assert all(p.device.type == "cpu" for m in hp["modules"].values()
               for p in m.parameters())
    assert not any(torch.isnan(p).any() for p in model.parameters())
