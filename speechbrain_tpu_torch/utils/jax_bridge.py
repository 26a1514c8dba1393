"""Carry the JAX package's weights into the port's modules.

The inverse of ``speechbrain_tpu/utils/torch_convert.py``: every function
takes flax ``variables`` (or their ``"params"`` entry) as a nested dict of
**numpy** arrays — a caller that holds JAX arrays converts them first with
``jax.tree_util.tree_map(np.asarray, variables)``; nothing here imports
JAX — and copies them into a module of this package, changing layouts on
the way:

* ``Linear``: kernel ``(in, out)`` -> weight ``(out, in)``;
* ``Conv1d``: kernel ``WIO`` -> ``OIW``; ``Conv2d``: ``HWIO`` -> ``OIHW``
  (depthwise included: flax already stores ``I = in/groups``);
* ``LayerNorm``: ``scale``/``bias``, found inside flax's nested
  ``LayerNorm_0`` scope where the JAX module wraps ``nn.LayerNorm``;
* attention blocks: ``q_proj/k_proj/v_proj/out_proj`` (+ ``pos_proj``,
  ``pos_bias_u/v``), kept as separate projections; ``HyperMixing``:
  ``hyper/w1_gen``, ``hyper/w2_gen``, ``out_proj``;
* Branchformer layers: ``norm_attn``, the attention, ``norm_conv``,
  ``cgmlp/up``, ``cgmlp/csgu/norm``, ``cgmlp/csgu/dw_conv``, ``cgmlp/down``,
  ``merge``; the stack's ``norm_out``;
* ``BatchNorm1d``/``BatchNorm2d``: ``scale``/``bias`` inside flax's
  ``BatchNorm_0`` scope, and from the ``batch_stats`` collection its
  ``mean``/``var`` into the running buffers;
* recurrent layers: per layer ``i`` and direction ``d`` the input
  projection ``wx_l{i}_d{d}``, the recurrent matrix ``wh_l{i}_d{d}``
  (flax's ``(H, gates*H)`` -> ``(gates*H, H)``), the GRU's ``bh_l{i}_d{d}``,
  the LiGRU's ``norm_l{i}_d{d}``; ``QuasiRNN``'s ``conv_l{i}_d{d}``; the
  ``AttentionalRNNDecoder``'s ``attn``, ``proj``, ``wx_{l}``, ``wh_{l}``,
  ``bh_{l}``; ``CRDNN`` and ``RNNLM`` by their flax names;
* ``TransducerJoint``: ``enc_proj``/``dec_proj`` (sum) or ``proj``
  (concat);
* the speaker family (``ECAPA_TDNN``, ``Xvector``, ``ResNet``, their
  classifiers, ``Leaf``), whose submodules carry the flax scopes' names
  and load child by child; of their own parameters the ECAPA
  ``Classifier``'s ``weight`` stays ``(in, out)`` (it is normalised over
  axis 0), ``AttentionPooling``'s ``query`` ``(dim, 1)``,
  ``GaborConv1d``'s ``kernel_params``, ``GaussianLowpassPooling``'s and
  the EMA's ``weights`` and ``PCEN``'s ``alpha``/``delta``/``root`` go
  over as they are; ``BatchNorm1d`` on the ResNet's 4-D maps loads as on
  3-D ones;
* the audio classifiers (``Cnn14``, the PIQ encoder, ``ViTEncoder``, the
  focal-modulation stacks), whose submodules carry the flax scopes' names
  as well (``block_{b}/conv1``, ``conv{i}``/``bn{i}``, PIQ's auto-named
  ``Conv_0``/``BatchNorm_0``, ``patch_embed``/``encoder``,
  ``stage_proj_{i}``, ``focal_conv_{level}``, ``f``, ``h``, ``proj``,
  ``mlp_in``, ``mlp_out``, flax's own ``norm1``/``norm2`` with no
  ``LayerNorm_0`` scope); ``cls_token``, ``pos_embed``, the layer scales
  ``gamma1``/``gamma2`` and ``tanh_scale`` go over as they are, and a
  flax depthwise kernel ``(k, 1, dim)`` becomes ``(dim, 1, k)``;
* ``SincConv``: ``low_hz``/``band_hz`` ``(out, 1)`` as they are;
  ``InstanceNorm2d``: ``scale``/``bias`` in its own scope, as
  ``InstanceNorm1d``'s; a one-hot ``Embedding`` takes no key;
  ``ConvolutionFrontEnd(norm="batchnorm")``: each ``norm_{b}`` as a
  ``BatchNorm1d``, its ``mean``/``var`` from ``batch_stats``;
* ``GroupNorm``: ``scale``/``bias`` inside flax's ``GroupNorm_0`` scope;
  ``ConvTranspose1d``: kernel ``(K, out, in/groups)`` -> weight ``(in,
  out/groups, K)``, group by group, with no flip (both hold the same
  convolution's gradient);
* the separation models (``dual_path``, ``resepformer``, ``conv_tasnet``),
  whose submodules carry the flax scopes' names (``encoder/conv``,
  ``decoder/deconv``, ``masknet/dual_{i}/intra_mdl/enc``, ``seg_{i}``,
  ``mem_{i}``, ``tcn_{r}_{b}``, ``basis_signals``, ``ild_proj``); the
  PReLU slopes (``prelu1``, ``prelu``, ``prelu2``, ``prelu_out``), the
  segment norms' ``scale``/``bias`` and gLN's ``gamma``/``beta`` go over
  as they are;
* the enhancement models (``MaskingSE``'s ``WaveFCNMapper``,
  ``BLSTMMasker``, ``FCN2DMasker`` and ``FCN2DBLSTMMasker``,
  ``CNNTransformerSE``, ``EnhanceResnet``), whose submodules carry the
  flax scopes' names; ``InstanceNorm1d``'s ``scale``/``bias`` sit in its
  own scope;
* the GAN models (``segan_model``'s ``Generator`` and ``Discriminator``,
  MetricGAN's ``EnhancementGenerator`` and both ``MetricDiscriminator``
  classes), child by child by the flax scopes' names;
  ``LearnableSigmoid``'s ``slope`` goes over as it is; the BLSTM loads as
  every ``LSTM`` does, the convolutions as ``Conv1d``/``Conv2d``/
  ``ConvTranspose1d``;
* the SSL modules: ``W2VLatentExtractor`` child by child (``conv_{i}``
  as ``Conv1d``, ``norm_{i}``, the final ``norm``, flax's own LayerNorm
  with no ``LayerNorm_0`` scope); ``GumbelVectorQuantizer``'s
  ``weight_proj`` and its ``codebook`` as it is; ``W2VTargetQuantiser``'s
  ``quantiser`` and ``proj``; ``RandomProjectionQuantizer``'s ``P`` and
  ``CB`` as they are, into its buffers; a whole SSL recipe's modules
  through :func:`load_modules`;
* a variational posterior (BayesSpeech): ``{"mu": ..., "rho": ...}``, each
  a tree of the recipe's modules, into the modules and their
  ``PosteriorRho`` (:func:`load_posterior`).

Variables that hold a ``"batch_stats"`` collection beside ``"params"`` load
both; given ``"params"`` alone, running statistics keep their values.

A key that a module needs and the tree lacks, or one the tree holds and no
module takes, raises ``KeyError``.
"""

import copy

import numpy as np
import torch

from speechbrain_tpu_torch.lobes.models.Branchformer import (
    BranchformerEncoder,
    BranchformerEncoderLayer,
    ConvolutionalSpatialGatingUnit,
    ConvolutionBranch,
)
from speechbrain_tpu_torch.lobes.features import Leaf
from speechbrain_tpu_torch.lobes.models import Cnn14 as cnn14
from speechbrain_tpu_torch.lobes.models import conv_tasnet
from speechbrain_tpu_torch.lobes.models import dual_path
from speechbrain_tpu_torch.lobes.models import ECAPA_TDNN as ecapa
from speechbrain_tpu_torch.lobes.models import MaskingSE as masking_se
from speechbrain_tpu_torch.lobes.models import MetricGAN as metricgan
from speechbrain_tpu_torch.lobes.models import MetricGAN_U as metricgan_u
from speechbrain_tpu_torch.lobes.models.EnhanceResnet import EnhanceResnet
from speechbrain_tpu_torch.lobes.models import PIQ as piq
from speechbrain_tpu_torch.lobes.models import focalnet
from speechbrain_tpu_torch.lobes.models import ResNet as resnet
from speechbrain_tpu_torch.lobes.models import resepformer
from speechbrain_tpu_torch.lobes.models import segan_model
from speechbrain_tpu_torch.lobes.models import wav2vec
from speechbrain_tpu_torch.lobes.models import Xvector as xvector
from speechbrain_tpu_torch.lobes.models.convolution import ConvolutionFrontEnd
from speechbrain_tpu_torch.lobes.models.CRDNN import CRDNN, FeatureChannelNorm
from speechbrain_tpu_torch.lobes.models.RNNLM import RNNLM
from speechbrain_tpu_torch.lobes.models.transformer.Conformer import (
    ConformerDecoder,
    ConformerEncoder,
    ConformerEncoderLayer,
    ConvolutionModule,
)
from speechbrain_tpu_torch.lobes.models.transformer.Transformer import (
    NormalizedEmbedding,
    TransformerDecoder,
    TransformerDecoderLayer,
    TransformerEncoder,
    TransformerEncoderLayer,
)
from speechbrain_tpu_torch.lobes.models.transformer.TransformerASR import (
    TransformerASR,
)
from speechbrain_tpu_torch.lobes.models.transformer.TransformerLM import (
    TransformerLM,
)
from speechbrain_tpu_torch.lobes.models.transformer.TransformerSE import (
    CNNTransformerSE,
)
from speechbrain_tpu_torch.lobes.models.vit import ViTEncoder
from speechbrain_tpu_torch.nnet.attention import (
    ContentBasedAttention,
    KeyValueAttention,
    LocationAwareAttention,
    MultiheadAttention,
    PositionalwiseFeedForward,
    RelPosMHAXL,
    RoPEMHA,
)
from speechbrain_tpu_torch.nnet.CNN import (
    Conv1d,
    Conv2d,
    ConvTranspose1d,
    GaborConv1d,
    SincConv,
)
from speechbrain_tpu_torch.nnet.embedding import Embedding
from speechbrain_tpu_torch.nnet.hypermixing import HyperMixing, HyperNetwork
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.nnet.normalization import (
    PCEN,
    BatchNorm1d,
    BatchNorm2d,
    ExponentialMovingAverage,
    GroupNorm,
    InstanceNorm1d,
    InstanceNorm2d,
    LayerNorm,
)
from speechbrain_tpu_torch.nnet.pooling import (
    AttentionPooling,
    GaussianLowpassPooling,
)
from speechbrain_tpu_torch.nnet.quantisers import (
    GumbelVectorQuantizer,
    RandomProjectionQuantizer,
)
from speechbrain_tpu_torch.nnet.RNN import (
    GRU,
    LSTM,
    RNN,
    AttentionalRNNDecoder,
    LiGRU,
    QuasiRNN,
    SLiGRU,
)
from speechbrain_tpu_torch.nnet.transducer_joint import TransducerJoint

# names flax gives the unnamed attention submodule of a compact layer
_FLAX_ATTENTION_SCOPES = ("MultiheadAttention_0", "RelPosMHAXL_0",
                          "RoPEMHA_0", "HyperMixing_0")


class _Scope:
    """A flax parameter sub-tree that remembers which keys were taken, with
    the same sub-tree of the ``batch_stats`` collection beside it (None
    where the variables hold no such collection)."""

    def __init__(self, tree, path="params", stats=None):
        if not isinstance(tree, dict):
            raise KeyError(f"{path}: expected a dict of parameters")
        self.tree = dict(tree)
        self.path = path
        self.stats = None if stats is None else dict(stats)

    def has(self, key):
        return key in self.tree or bool(self.stats and key in self.stats)

    def take(self, key):
        if key not in self.tree:
            raise KeyError(f"missing parameter {self.path}/{key}")
        return self.tree.pop(key)

    def take_stat(self, key):
        if key not in self.stats:
            raise KeyError(f"missing batch statistic {self.path}/{key}")
        return self.stats.pop(key)

    def sub(self, key):
        stats = None if self.stats is None else self.stats.pop(key, {})
        tree = self.tree.pop(key, {}) if stats else self.take(key)
        return _Scope(tree, f"{self.path}/{key}", stats)

    def done(self):
        if self.tree:
            raise KeyError(
                f"unused parameters under {self.path}: {sorted(self.tree)}"
            )
        if self.stats:
            raise KeyError(
                f"unused batch statistics under {self.path}: "
                f"{sorted(self.stats)}"
            )


def _copy(param, array, name):
    array = np.array(array, dtype=np.float32)  # a writable copy
    if tuple(array.shape) != tuple(param.shape):
        raise ValueError(
            f"{name}: shape {tuple(array.shape)} does not fit "
            f"{tuple(param.shape)}"
        )
    with torch.no_grad():
        param.copy_(torch.from_numpy(array))


def _load_kernel_bias(module, scope, perm):
    _copy(
        module.weight, np.transpose(np.asarray(scope.take("kernel")), perm),
        f"{scope.path}/kernel",
    )
    if module.bias is not None:
        _copy(module.bias, scope.take("bias"), f"{scope.path}/bias")
    scope.done()


def load_linear(module, scope):
    _load_kernel_bias(module, scope, (1, 0))


def load_conv1d(module, scope):
    _load_kernel_bias(module, scope, (2, 1, 0))


def load_conv2d(module, scope):
    _load_kernel_bias(module, scope, (3, 2, 0, 1))


def _load_scale_bias(module, scope, flax_scope):
    inner = scope.sub(flax_scope) if scope.has(flax_scope) else scope
    if module.weight is not None:
        _copy(module.weight, inner.take("scale"), f"{inner.path}/scale")
        _copy(module.bias, inner.take("bias"), f"{inner.path}/bias")
    inner.done()
    scope.done()


def load_layernorm(module, scope):
    _load_scale_bias(module, scope, "LayerNorm_0")


def load_groupnorm(module, scope):
    _load_scale_bias(module, scope, "GroupNorm_0")


def load_conv_transpose1d(module, scope):
    kernel = np.asarray(scope.take("kernel"))
    K, out, in_g = kernel.shape
    G = module.groups
    weight = kernel.reshape(K, G, out // G, in_g).transpose(1, 3, 2, 0)
    _copy(module.weight, weight.reshape(G * in_g, out // G, K),
          f"{scope.path}/kernel")
    if module.bias is not None:
        _copy(module.bias, scope.take("bias"), f"{scope.path}/bias")
    scope.done()


def load_embedding(module, scope):
    # a one-hot Embedding holds no weight, and flax no table for it
    if module.weight is not None:
        _copy(module.weight, scope.take("embedding"),
              f"{scope.path}/embedding")
    scope.done()


def load_normalized_embedding(module, scope):
    load_embedding(module.emb, scope.sub("emb"))
    scope.done()


def _load_children(module, scope, names):
    for name in names:
        load(getattr(module, name), scope.sub(name))


def load_mha(module, scope):
    _load_children(module, scope, ("q_proj", "k_proj", "v_proj", "out_proj"))
    scope.done()


def load_relpos_mha(module, scope):
    _load_children(
        module, scope, ("q_proj", "k_proj", "v_proj", "pos_proj", "out_proj")
    )
    for name in ("pos_bias_u", "pos_bias_v"):
        _copy(getattr(module, name), scope.take(name), f"{scope.path}/{name}")
    scope.done()


def load_hypernetwork(module, scope):
    load(module.w1_gen, scope.sub("w1_gen"))
    if module.w2_gen is not None:
        load(module.w2_gen, scope.sub("w2_gen"))
    scope.done()


def load_hypermixing(module, scope):
    _load_children(module, scope, ("hyper", "out_proj"))
    scope.done()


def load_ffn(module, scope):
    _load_children(module, scope, ("ffn1", "ffn2"))
    scope.done()


def _take_attention_scope(scope):
    for name in _FLAX_ATTENTION_SCOPES:
        if scope.has(name):
            return scope.sub(name)
    raise KeyError(
        f"missing parameter {scope.path}/{{{'|'.join(_FLAX_ATTENTION_SCOPES)}}}"
    )


def load_transformer_encoder_layer(module, scope):
    load(module.self_attn, _take_attention_scope(scope))
    ffn = ("ffn",) if module.ffn is not None else ("ffn_conv1", "ffn_conv2")
    _load_children(module, scope, (*ffn, "norm1", "norm2"))
    scope.done()


def load_transformer_decoder_layer(module, scope):
    load(module.self_attn, _take_attention_scope(scope))
    _load_children(
        module, scope, ("cross_attn", "ffn", "norm1", "norm2", "norm3")
    )
    scope.done()


def load_layer_stack(module, scope):
    """Encoder/decoder stacks: ``layer_{i}`` scopes plus the final norm."""
    for i, layer in enumerate(module.layers):
        load(layer, scope.sub(f"layer_{i}"))
    load(module.norm, scope.sub("norm"))
    scope.done()


def load_csgu(module, scope):
    _load_children(module, scope, ("norm", "dw_conv"))
    scope.done()


def load_convolution_branch(module, scope):
    _load_children(module, scope, ("up", "csgu", "down"))
    scope.done()


def load_branchformer_layer(module, scope):
    load(module.attn, _take_attention_scope(scope))
    _load_children(module, scope, ("norm_attn", "norm_conv", "cgmlp", "merge"))
    scope.done()


def load_branchformer_encoder(module, scope):
    for i, layer in enumerate(module.layers):
        load(layer, scope.sub(f"layer_{i}"))
    load(module.norm_out, scope.sub("norm_out"))
    scope.done()


def load_conformer_decoder(module, scope):
    load(module.dec, scope.sub("dec"))
    scope.done()


def load_convolution_module(module, scope):
    _load_children(
        module, scope, ("layer_norm", "pw1", "dw", "mid_norm", "pw2")
    )
    scope.done()


def load_conformer_encoder_layer(module, scope):
    _load_children(
        module, scope,
        ("norm_ff1", "ffn1", "norm_mha", "attn", "conv", "norm_ff2", "ffn2",
         "norm_out"),
    )
    scope.done()


def load_convolution_frontend(module, scope):
    for name, conv in module.convs.items():
        load(conv, scope.sub(name))
    for name, norm in module.norms.items():
        load(norm, scope.sub(name))
    scope.done()


def load_transformer_asr(module, scope):
    load(module.custom_src_module, scope.sub("src_proj"))
    if module.custom_tgt_module is not None:
        load(module.custom_tgt_module, scope.sub("tgt_emb"))
    load(module.encoder, scope.sub("encoder"))
    if module.decoder is not None:
        load(module.decoder, scope.sub("decoder"))
    scope.done()


def load_transformer_lm(module, scope):
    load(module.emb, scope.sub("emb"))
    if module.emb_proj is not None:
        load(module.emb_proj, scope.sub("emb_proj"))
    _load_children(module, scope, ("encoder", "out_proj", "out_norm", "out"))
    scope.done()


def load_batchnorm(module, scope):
    inner = scope.sub("BatchNorm_0") if scope.has("BatchNorm_0") else scope
    if module.weight is not None:
        _copy(module.weight, inner.take("scale"), f"{inner.path}/scale")
        _copy(module.bias, inner.take("bias"), f"{inner.path}/bias")
    if inner.stats is not None:
        _copy(module.running_mean, inner.take_stat("mean"),
              f"{inner.path}/mean")
        _copy(module.running_var, inner.take_stat("var"),
              f"{inner.path}/var")
    inner.done()
    scope.done()


def _load_transposed(param, scope, key):
    _copy(param, np.transpose(np.asarray(scope.take(key))),
          f"{scope.path}/{key}")


def load_rnn(module, scope):
    for layer in range(module.num_layers):
        for d in range(module.dirs):
            i, tag = module.index(layer, d), f"l{layer}_d{d}"
            load(module.wx[i], scope.sub(f"wx_{tag}"))
            _load_transposed(module.wh[i], scope, f"wh_{tag}")
            if getattr(module, "recurrent_bias", False):
                _copy(module.bh[i], scope.take(f"bh_{tag}"),
                      f"{scope.path}/bh_{tag}")
            if len(getattr(module, "norm", ())):
                load(module.norm[i], scope.sub(f"norm_{tag}"))
    scope.done()


def load_quasi_rnn(module, scope):
    for layer in range(module.num_layers):
        for d in range(module.dirs):
            load(module.conv[layer * module.dirs + d],
                 scope.sub(f"conv_l{layer}_d{d}"))
    scope.done()


def load_content_attention(module, scope):
    _load_children(module, scope,
                   ("mlp_enc", "mlp_dec", "mlp_attn", "mlp_out"))
    scope.done()


def load_location_attention(module, scope):
    _load_children(module, scope, ("mlp_enc", "mlp_dec", "conv_loc",
                                   "mlp_loc", "mlp_attn", "mlp_out"))
    scope.done()


def load_keyvalue_attention(module, scope):
    _load_children(module, scope,
                   ("key_linear", "value_linear", "query_linear"))
    scope.done()


def load_attentional_rnn_decoder(module, scope):
    _load_children(module, scope, ("attn", "proj"))
    for layer in range(module.num_layers):
        load(module.wx[layer], scope.sub(f"wx_{layer}"))
        _load_transposed(module.wh[layer], scope, f"wh_{layer}")
        _copy(module.bh[layer], scope.take(f"bh_{layer}"),
              f"{scope.path}/bh_{layer}")
    scope.done()


def load_crdnn(module, scope):
    for b in range(module.cnn_blocks):
        for k in range(2):
            load(module.convs[2 * b + k], scope.sub(f"conv_{b}_{k}"))
            load(module.cnn_norms[2 * b + k], scope.sub(f"cnn_norm_{b}_{k}"))
    if module.proj is not None:
        load(module.proj, scope.sub("proj"))
    load(module.rnn, scope.sub("rnn"))
    for b, (lin, norm) in enumerate(zip(module.dnn, module.dnn_norms)):
        load(lin, scope.sub(f"dnn_{b}"))
        load(norm, scope.sub(f"dnn_norm_{b}"))
    scope.done()


def load_rnnlm(module, scope):
    _load_children(module, scope, ("emb", "rnn"))
    for i, (lin, norm) in enumerate(zip(module.dnn, module.norm)):
        load(lin, scope.sub(f"dnn_{i}"))
        load(norm, scope.sub(f"norm_{i}"))
    load(module.out, scope.sub("out"))
    scope.done()


def load_transducer_joint(module, scope):
    _load_children(module, scope, ("enc_proj", "dec_proj")
                   if module.joint == "sum" else ("proj",))
    scope.done()


def load_named_children(module, scope, own=()):
    """Each child module that holds parameters or saved buffers from the
    scope of its own name, then each parameter named in ``own`` as it is.
    A child whose state dict is empty (a positional encoding's constant
    table) has no scope."""
    for name, child in module.named_children():
        if child.state_dict():
            load(child, scope.sub(name))
    for name in own:
        _copy(getattr(module, name), scope.take(name),
              f"{scope.path}/{name}")
    scope.done()


def _own(*names):
    return lambda module, scope: load_named_children(module, scope, names)


def load_focal_block(module, scope):
    load_named_children(module, scope, () if module.gamma1 is None
                        else ("gamma1", "gamma2"))


_LOADERS = {
    Linear: load_linear,
    Conv1d: load_conv1d,
    Conv2d: load_conv2d,
    LayerNorm: load_layernorm,
    GroupNorm: load_groupnorm,
    ConvTranspose1d: load_conv_transpose1d,
    Embedding: load_embedding,
    NormalizedEmbedding: load_normalized_embedding,
    MultiheadAttention: load_mha,
    RelPosMHAXL: load_relpos_mha,
    RoPEMHA: load_mha,
    HyperNetwork: load_hypernetwork,
    HyperMixing: load_hypermixing,
    PositionalwiseFeedForward: load_ffn,
    TransformerEncoderLayer: load_transformer_encoder_layer,
    TransformerDecoderLayer: load_transformer_decoder_layer,
    TransformerEncoder: load_layer_stack,
    TransformerDecoder: load_layer_stack,
    ConvolutionModule: load_convolution_module,
    ConformerEncoderLayer: load_conformer_encoder_layer,
    ConformerEncoder: load_layer_stack,
    ConformerDecoder: load_conformer_decoder,
    ConvolutionalSpatialGatingUnit: load_csgu,
    ConvolutionBranch: load_convolution_branch,
    BranchformerEncoderLayer: load_branchformer_layer,
    BranchformerEncoder: load_branchformer_encoder,
    ConvolutionFrontEnd: load_convolution_frontend,
    TransformerASR: load_transformer_asr,
    TransformerLM: load_transformer_lm,
    BatchNorm1d: load_batchnorm,
    BatchNorm2d: load_batchnorm,
    FeatureChannelNorm: load_layernorm,
    LSTM: load_rnn,
    GRU: load_rnn,
    RNN: load_rnn,
    LiGRU: load_rnn,
    SLiGRU: load_rnn,
    QuasiRNN: load_quasi_rnn,
    ContentBasedAttention: load_content_attention,
    LocationAwareAttention: load_location_attention,
    KeyValueAttention: load_keyvalue_attention,
    AttentionalRNNDecoder: load_attentional_rnn_decoder,
    CRDNN: load_crdnn,
    RNNLM: load_rnnlm,
    TransducerJoint: load_transducer_joint,
    ecapa.TDNNBlock: load_named_children,
    ecapa.Res2NetBlock: load_named_children,
    ecapa.SEBlock: load_named_children,
    ecapa.AttentiveStatisticsPooling: load_named_children,
    ecapa.SERes2NetBlock: load_named_children,
    ecapa.ECAPA_TDNN: load_named_children,
    ecapa.Classifier: _own("weight"),
    xvector.Xvector: load_named_children,
    xvector.Classifier: load_named_children,
    xvector.Discriminator: load_named_children,
    resnet.SEBlock2d: load_named_children,
    resnet.PreActBlock: load_named_children,
    resnet.ResNet: load_named_children,
    AttentionPooling: _own("query"),
    GaussianLowpassPooling: _own("weights"),
    ExponentialMovingAverage: _own("weights"),
    PCEN: _own("alpha", "delta", "root"),
    GaborConv1d: _own("kernel_params"),
    Leaf: load_named_children,
    cnn14.ConvBlock: load_named_children,
    cnn14.Cnn14: load_named_children,
    piq.ResBlockAudio: load_named_children,
    piq.Conv2dEncoder_v2: load_named_children,
    ViTEncoder: _own("cls_token", "pos_embed"),
    focalnet.FlaxConv1d: load_conv1d,
    focalnet.FocalModulation1d: load_named_children,
    focalnet.FocalBlock1d: load_focal_block,
    focalnet._FocalStack: load_named_children,
    focalnet.FocalEncoder: _own("tanh_scale"),
    focalnet.FocalDecoder: load_named_children,
    focalnet.FocalNetEncoder: load_named_children,
    dual_path.Encoder: load_named_children,
    dual_path.Decoder: load_named_children,
    dual_path.SBTransformerBlock: load_named_children,
    dual_path.SBConformerEncoderBlock: load_named_children,
    dual_path.SBRNNBlock: load_named_children,
    dual_path.DualComputationBlock: load_named_children,
    dual_path.DualPathModel: _own("prelu1"),
    dual_path.SepformerWrapper: load_named_children,
    resepformer._SepNorm: _own("scale", "bias"),
    resepformer.SBTransformerBlockWNormAndSkip: load_named_children,
    resepformer.SegLSTM: load_named_children,
    resepformer.MemLSTM: load_named_children,
    resepformer.ResourceEfficientSeparationPipeline: load_named_children,
    resepformer.ResourceEfficientSeparator: load_named_children,
    resepformer.RESepformerWrapper: load_named_children,
    conv_tasnet.ChannelwiseLayerNorm: load_named_children,
    conv_tasnet.GlobalLayerNorm: _own("gamma", "beta"),
    conv_tasnet.TemporalBlock: _own("prelu", "prelu2"),
    conv_tasnet.MaskNet: _own("prelu_out"),
    conv_tasnet.Encoder: load_named_children,
    conv_tasnet.Decoder: load_named_children,
    conv_tasnet.ConvTasNetWrapper: load_named_children,
    conv_tasnet.BinauralConvTasNetWrapper: load_named_children,
    InstanceNorm1d: lambda module, scope: _load_scale_bias(module, scope,
                                                           None),
    InstanceNorm2d: lambda module, scope: _load_scale_bias(module, scope,
                                                           None),
    SincConv: _own("low_hz", "band_hz"),
    masking_se.WaveFCNMapper: load_named_children,
    masking_se.BLSTMMasker: load_named_children,
    masking_se.FCN2DMasker: load_named_children,
    masking_se.FCN2DBLSTMMasker: load_named_children,
    CNNTransformerSE: load_named_children,
    EnhanceResnet: load_named_children,
    segan_model.Generator: load_named_children,
    segan_model.Discriminator: load_named_children,
    metricgan.LearnableSigmoid: _own("slope"),
    metricgan.EnhancementGenerator: load_named_children,
    metricgan.MetricDiscriminator: load_named_children,
    metricgan_u.MetricDiscriminator: load_named_children,
    wav2vec.W2VLatentExtractor: load_named_children,
    wav2vec.W2VTargetQuantiser: load_named_children,
    GumbelVectorQuantizer: _own("codebook"),
    RandomProjectionQuantizer: _own("P", "CB"),
}


def load_modules(modules, variables):
    """Load a parameter tree with one top-level key a module — the JAX
    recipes' ``{"frontend": ..., "model": ..., "ctc_head": ...,
    "seq_head": ...}`` — into the same-named entries of ``modules`` (a
    dict or ``nn.ModuleDict``), in place; returns ``modules``. A module
    the tree lacks, or a key no module takes, raises ``KeyError``. With a
    ``"batch_stats"`` collection beside ``"params"`` (keyed by module the
    same way), the running statistics load too."""
    variables, stats = _split_collections(variables)
    missing = sorted(set(modules.keys()) - set(variables))
    unused = sorted(set(variables) - set(modules.keys()))
    if missing:
        raise KeyError(f"missing parameters of modules {missing}")
    if unused:
        raise KeyError(f"unused parameters of modules {unused}")
    for name in modules.keys():
        load(modules[name], _Scope(
            variables[name], f"params/{name}",
            None if stats is None else stats.get(name, {}),
        ))
    return modules


def load_posterior(modules, variables):
    """Load a variational posterior's ``{"mu": tree, "rho": tree}`` (each
    keyed by module, as :func:`load_modules` takes it): ``mu`` into the
    modules of ``modules`` other than ``"rho"``, ``rho`` into
    ``modules["rho"]``, an object whose ``get(module, parameter name)``
    returns the ``rho`` of that parameter. Returns ``modules``."""
    params, _ = _split_collections(variables)
    if set(params) != {"mu", "rho"}:
        raise KeyError(f"expected mu and rho, got {sorted(params)}")
    means = {name: m for name, m in modules.items() if name != "rho"}
    load_modules(means, params["mu"])
    # rho has the means' tree: load it into a copy of them, then carry it
    shadow = load_modules(copy.deepcopy(means), params["rho"])
    rho = modules["rho"]
    for name, module in shadow.items():
        for pname, value in module.named_parameters():
            _copy(rho.get(name, pname), value.detach().cpu().numpy(),
                  f"params/rho/{name}/{pname}")
    return modules


def _split_collections(variables):
    """(params, batch_stats or None) of flax variables given with their
    collections, or of a bare parameter tree."""
    if "params" in variables and set(variables) <= {"params",
                                                    "batch_stats"}:
        return variables["params"], variables.get("batch_stats")
    return variables, None


def load(module, variables):
    """Load flax ``variables`` (numpy leaves; with or without the
    top-level ``"params"`` key) into ``module``, in place, and return the
    module. Dispatches on the module's type."""
    loader = _LOADERS.get(type(module))
    if loader is None:
        raise TypeError(
            f"no loader for {type(module).__name__}; known: "
            f"{sorted(t.__name__ for t in _LOADERS)}"
        )
    if isinstance(variables, _Scope):
        scope = variables
    else:
        params, stats = _split_collections(variables)
        scope = _Scope(params, "params", stats)
    loader(module, scope)
    return module
