"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

builds the hand-written kernels of ``speechbrain_tpu_torch/csrc`` with
``nvcc`` (at first use), holds each kernel against its plain PyTorch version
on the card, checks that no kernel's wrapper lets a graph through
(``grad_guard``), and drives twenty paths at full width with random weights
made from a seed, the first seven at that of the conformer-large
LibriSpeech recipe:

- ``main_path``: batched ``transcribe`` — waveform -> fused Fbank ->
  convolutional front end -> 12-layer Conformer encoder -> ancestry KV beam
  search fused with a KV-cached TransformerLM and a CTC prefix scorer
  (kernels ``fused_fbank`` and ``ancestry_attention``);
- ``permute_path``: the same ``transcribe`` with ``ancestry_kv=False``, the
  classic beam search that permutes its KV caches after every step
  (kernels ``fused_fbank`` and ``row_gather``);
- ``flash_path``: ``MultiheadAttention(use_pallas=True)`` over the main
  path's encoder output and at (16, 4, 1024, 64) (kernel
  ``flash_attention``);
- ``train_path``: the recipe's ``Brain.fit`` (``ASR``, a twin of
  ``recipes/LibriSpeech/ASR/transformer/train.py``) on synthetic WAV
  files through a JSON manifest, dataset and loader: 30 epochs of two
  bf16 micro-batches of 16 utterances, accumulation 2, clip 5, AdamW,
  Noam (kernel ``fused_fbank`` on every batch); then ``train_checks``:
  the loss fell, a checkpoint recovers bit for bit, and one float32 step
  through the kernel agrees with its plain version;
- ``recipe_path``: the twin recipe's own chain
  (``speechbrain_tpu_torch/recipes/LibriSpeech/ASR/transformer/train.py``
  ``run``) with ``conformer_large.yaml``'s hyperparameters built in Python:
  a synthetic corpus, the BPE tokenizer, ``dataio_prepare``, three shuffled
  bf16 epochs with a checkpoint after each valid stage, then the test
  split's loss and greedy-CTC WER (kernel ``fused_fbank`` on every train,
  valid and test batch);
- ``serve_path``: ``main_path``'s model served through the port's entry
  point: its modules' state dicts and a 5000-piece tokenizer written as a
  model source directory, loaded into fresh modules by a ``Pretrainer``,
  then ``EncoderDecoderASR.transcribe_batch`` (bf16, ancestry and
  permuting search: kernels ``fused_fbank`` with ``ancestry_attention``,
  then with ``row_gather``), the same in float32 against
  ``Pipeline.transcribe``, ``transcribe_file`` of a WAV, and
  ``EncoderASR`` with greedy CTC (kernel ``fused_fbank``);
- ``host_path``: ``train_path``'s training through the loop's host side:
  ``DynamicBatchSampler`` batches of at most 160 s from four length
  buckets, four read-ahead threads, the native WAV reader and the loss
  read every four micro-batches, two epochs (kernel ``fused_fbank`` on
  every batch);
  then float32 checks of the windowed loss reads against the per-step
  ones, of a window of NaN micro-batches (nothing changes, bit for bit),
  of a threaded mid-epoch resume, of averaged checkpoints, and of the
  native WAV reader and edit distance against their plain versions;
- ``family_path``: the recipe's seven other hparams files (transformer,
  conformer_large_rope, branchformer_large, hyperconformer_22M and _8M,
  hyperbranchformer_25M and _13M) at their full width and depth: bf16
  ``transcribe`` (ancestry search, CTC at 0.3, no LM: kernel
  ``ancestry_attention`` in every decoder layer at every step, head dims 128,
  64, 32 and 18, and ``fused_fbank`` once), the same in float32 through the
  kernels and their plain versions, one bf16 training step of the twin
  ``ASR`` (``fused_fbank`` on every micro-batch), and branchformer_large's
  float32 step with ``encoder_remat`` against without;
- ``crdnn_path``: recurrent seq2seq ASR, the LibriSpeech CRDNN recipe
  (``train_BPE_1000.yaml``: 2 CNN blocks, a 4-layer bi-LSTM of 1024, 2 DNN
  blocks of 512, a GRU decoder of 1024 with location-aware attention, 1000
  outputs) with its RNNLM (2 x 2048 LSTM): NORTH's batch through
  ``EncoderDecoderASR.transcribe_batch``, encoder ``Fbank(fused=True)``
  at 40 mels -> ``InputNormalization`` -> CRDNN, decoder an
  ``S2SRNNBeamSearcher`` at beam 16 fused with CTC 0.4, the RNNLM 0.5 and
  coverage 1.5 (bf16, then float32 through the kernel and its plain
  version: encoder states within 1e-5, tokens equal over 50 steps); one
  float32 ``transcribe`` of the sligru
  variant; two bf16 Adadelta steps of the twin ``ASR`` on TRAIN's WAV
  corpus and its valid stage (``fused_fbank`` on every batch), one
  float32 step through the kernel against its plain version; two AdamW
  steps of the LM twin at batch 80;
- ``transducer_path``: the LibriSpeech Conformer transducer recipe
  (``conformer_transducer.yaml``: 12 Conformer layers of 512, an LSTM
  prediction network of 512, an additive joint of 640, 1000 outputs):
  NORTH's batch through the twin's ``transcribe_batch`` in bf16, greedy,
  and its first two utterances by beam search (beam 4) and by beam search
  fused with the RNNLM of ``crdnn_path`` at 0.5 (``fused_fbank`` once
  each); greedy in float32
  through the kernel and its plain version (encoder states within 1e-5,
  tokens equal over 50 frames); two bf16 AdamW steps of the twin on
  TRAIN's WAV corpus and its valid stage (``fused_fbank`` on every batch),
  the transducer loss's own forward and backward timed, and a float32 step
  through the kernel against its plain version;
- ``ctc_path``: the LibriSpeech CTC twin's three hparams files at full
  width (``conformer_large`` served through ``transcribe_batch`` and
  trained two steps, ``train`` and ``branchformer_large`` one step each),
  BayesSpeech two steps with every weight drawn from its posterior and a
  float32 evaluation forward through the kernel and its plain version,
  and the Transformer LM two steps (``fused_fbank`` on every batch of the
  ASR twins);
- ``streaming_path``: the streaming Conformer transducer
  (``conformer_transducer_streaming.yaml``: ``transducer_path``'s model
  with dynamic chunk training) served chunk by chunk through
  ``StreamingASR`` over ``StreamingServe`` (``StreamingFeatureWrapper``
  over the fused Fbank, the encoder's ``encode_streaming``, streaming
  greedy) at the YAML's test configuration (chunks of 24 encoder frames,
  0.96 s, left context 4 chunks): NORTH's batch in bf16 (per-chunk ms,
  ``fused_fbank`` once a chunk), the same in float32 through the kernel
  and its plain version (the streamed states against the chunked offline
  encode, the streaming greedy against greedy over the streamed states),
  and one WAV through ``transcribe_file_streaming``; two bf16 training
  steps with the chunk configurations the YAML's sampler draws, one with
  a chunked configuration forced, the valid stage, a float32 step through
  the kernel against its plain version; then the TIMIT transducer twin's
  chain.
- ``speaker_path``: speaker recognition and classification: B3 against
  its plain version at 80 mels on (32, 48000) and at 24 mels on (16,
  16000); the VoxCeleb ECAPA-TDNN twin (channels 1024 x 4 and 3072,
  192-dim embeddings, 7205 classes) served through
  ``SpeakerRecognition.verify_batch`` on 32 pairs of 3-8 s and
  ``EncoderClassifier.classify_batch`` (``fused_fbank`` once an encode),
  float32 embeddings and scores through the kernel and its plain version;
  two bf16 steps of each VoxCeleb twin (ECAPA, x-vector, ResNet) from its
  YAML at batch 32 of 3 s crops, AAM-softmax, Adam, the cyclic rate, the
  valid stage and a checkpoint (``fused_fbank`` on every batch), a float32
  loss through the kernel against its plain version; the verification
  script's cosine (ECAPA) and PLDA (x-vector) scoring to an EER; the
  speech-commands ECAPA and LEAF twins one epoch each; the speaker_id
  template one epoch, exported and served through
  ``EncoderClassifier.from_hparams``.
- ``classify_path``: the audio classifiers: B3 against its plain version
  at 80 mels on (8, 80000) and (8, 64000); the ESC50 CNN14 (2048, base
  64, 50 classes) and ViT (d 256, 6 layers, 8 heads) twins served through
  ``AudioClassifier.classify_batch`` on 8 clips of 5 s (the encoder with
  the recipe's pooling; ``fused_fbank`` once a call), float32 through the
  kernel and its plain version; two bf16 steps of each ESC50 twin (CNN14,
  ViT, the PIQ encoder, FocalNet) at batch 8 of 5 s with the valid stage
  and a checkpoint (``fused_fbank`` on every batch), a float32 loss
  through the kernel against its plain version; one epoch each of the
  UrbanSound8k (CNN14, ECAPA), CommonLanguage, VoxLingua107 and IEMOCAP
  (ECAPA, x-vector) twins, VoxLingua107's export served through
  ``EncoderClassifier.from_hparams``.
- ``recurrent_twins_path``: the CommonVoice, TIMIT and Switchboard CRDNN
  seq2seq twins (a 4-layer bi-LSTM of 1024) and the SLURP direct twin
  (512, 58 BPE tokens), two bf16 steps each with the valid stage
  (``fused_fbank`` at 40 mels on every batch); SLURP's model served
  through ``EndToEndSLU.decode_batch`` on 8 utterances, its float32
  tokens through the kernel and its plain version equal at a short
  decode.
- ``separation_path``: source separation, which runs none of the kernels:
  the WSJ0Mix SepFormer twin (``sepformer.yaml``: N 256, kernel 16,
  chunks of 250, 2 dual stages of 8 + 8 Transformer layers, 8 heads,
  d_ffn 1024) two bf16 steps on 4 s crops at 8 kHz, its valid batch, a
  checkpoint and its export, served through
  ``SepformerSeparation.from_hparams`` (the whole wrapper, then the three
  modules) in float32 on 4 mixtures of 4 s: bit for bit the trained
  model's output, within ``SEPARATION_CPU_RTOL`` of the port on the CPU,
  the PIT loss unchanged by swapping the targets; then one bf16 step and
  one valid batch of each of the 20 other separation twin YAMLs
  (WSJ0Mix, LibriMix, WHAM!/WHAMR!, Aishell1Mix, BinauralWSJ0Mix) at
  full width.
- ``enhancement_path``: speech enhancement, which runs none of the kernels:
  the VoiceBank spectral-mask twin (a CNN-Transformer masker: d_model 256,
  8 layers, 16 heads, d_ffn 512, over a 512-point STFT at 16 kHz) and the
  waveform-map twin (an FCN of 80 channels, kernel 55, 8 blocks), two bf16
  steps each on 4 s utterances, the valid batch, a checkpoint and its
  export, served through ``SpectralMaskEnhancement`` and
  ``WaveformEnhancement.from_hparams`` in float32 on 4 utterances of 4 s:
  bit for bit the same arithmetic on the trained module, within
  ``ENHANCEMENT_CPU_RTOL`` of the port on the CPU, the STOI printed; the
  ISTFT round trips at 8 and 16 kHz; then one bf16 step and one valid
  batch of each other enhancement twin YAML (WHAM!/WHAMR!, DNS,
  dereverberation, the template, the spectral-mask twin's other maskers)
  at full width.
- ``gan_path``: GAN training and the GAN recipes: B3 against its plain
  version at 40 mels on (4, 65536) and (4, 64000); the VoiceBank
  MetricGAN+ twin (a 2-layer BLSTM of 200, DNN 300, n_fft 512) three
  alternating float32 D/G steps, each group with its own Adam, on batches
  of 4 utterances of 4 s with the host STOI target, a checkpoint, the
  generator restored from it and served through
  ``SpectralMaskEnhancement.enhance_batch`` on 4 utterances of 4 s (bit
  for bit the same arithmetic on the trained module), the two-step
  semantics checked (a G step leaves the discriminator's parameters,
  optimizer state and BatchNorm buffers bit for bit, a D step the
  generator's); SEGAN (channels 16 ... 128, kernel 32) two steps on
  batches of 8 segments of 16384 samples; the MTL chain: the perceptual
  CRDNN pre-trained with ``fused_fbank`` at 40 mels on every train and
  valid batch, the robust ASR stage with the unfused Fbank, and the
  fused Fbank refused under its gradient; one step of every other GAN
  twin (MetricGAN-U with SRMR and with SRMR standing in for DNSMOS,
  dereverberation, the band-correlation MetricGAN, the mimic stage,
  RescueSpeech's noise-robust Conformer CTC).
- ``frame_path``: the frame-level tasks: B3 against its plain version at
  40 mels on (30, 160000) and at 80 mels on (1, 24000); the LibriParty VAD
  twin (a CRDNN of 16 and 32 channels, a 2-layer LSTM of 64, one DNN block
  of 64, ``out_lin``) trained float32 with Adam on its tone-burst parties,
  exported and served through ``VAD.from_hparams`` (``fused_fbank`` at 40
  mels once for a file's chunks and once a double-checked segment) on a
  300 s two-tone meeting, in both chunk modes, each stage timed, the
  boundary errors against the meeting's turns, the posteriors and
  boundaries held against the unfused Fbank's; speaker diarization of the
  VAD's segments by ``SpeakerDiarization`` with the AMI ECAPA embedder
  (channels 256 x 4 and 768, ``fused_fbank`` at 80 mels once a segment),
  RTTM and DER, its labels against the unfused Fbank's; the AMI twin's
  ``experiment.py`` with the ECAPA and x-vector YAMLs on its own meeting
  and the 300 s one (``fused_fbank`` once a window); the ZED twin two
  steps, exported and served through
  ``Speech_Emotion_Diarization.diarize_file`` on a 60 s file, every
  window with its last, and EDER.
- ``ssl_path``: self-supervised learning: B3 against its plain version at
  80 mels on (8, 256000); the LibriSpeech wav2vec 2.0 twin
  (``train_sb_wav2vec2.yaml``: a 7 x 512 convolutional extractor, a
  12-layer Transformer of 768, 8 heads, FFN 3072, a 2 x 320 Gumbel
  codebook, 100 negatives) three AdamW steps in float32 and three in bf16
  on batches of 8 utterances of 15-16 s, the contrastive and diversity
  loss and ``prob_perplexity`` of each, a checkpoint recovered bit for
  bit; the BEST-RQ twin (``bestrq.yaml``: 80 mels, a Conformer of 576 x
  12, 8192 codewords) three bf16 steps (``fused_fbank`` once a batch),
  its random-projection buffers bit for bit after them, the front end and
  encoder exported; ``train_with_bestrq`` fine-tuned from that export
  three bf16 steps and served by greedy CTC (``fused_fbank`` once a
  batch and a call); ``train_with_wav2vec`` the same without a kernel;
  one bf16 step of every other twin (Libri-Light wav2vec 2.0 and BEST-RQ,
  CommonVoice wav2vec 2.0, DVoice's seven YAMLs).
- ``rescore_path``: n-best decoding and second-pass rescoring: NORTH's
  bf16 ancestry search with its 10 best an utterance (kernels
  ``fused_fbank`` and ``ancestry_attention``) reranked by
  ``RescorerBuilder`` over the LibriSpeech Transformer LM (768 x 12), the
  LM's float32 scores against a step-by-step sum and the order against
  numpy's argsort; the CRDNN serve's 16 best reranked through
  ``RNNLMRescorer`` over ``RNNLM.yaml``'s LM (``fused_fbank``); the CTC
  twin's ``conformer_large`` posteriors of NORTH's batch decoded on the
  host by ``CTCBeamSearcher`` and ``CTCPrefixBeamSearcher`` at beam 8 and
  100, host ms an utterance and a frame, and the float32 top-1 through
  ``fused_fbank`` against its plain version; the two wav2vec rescoring
  twin YAMLs one bf16 step and a rescored valid stage each; NORTH's
  float32 permuting search with the buffer ``TransformerLMScorer``
  against ``KVTransformerLMScorer`` (``row_gather``), step ms of each;
  ``Fbank(deltas=True, context=True, fused=True)`` on NORTH's batch
  against the unfused one, and ``MFCC``.

Then it times the kernels. It prints one JSON object a line and exits
non-zero as soon as a phase fails. It needs one CUDA device and does not
run without one; there is no CPU mode.

The assemblies (``Pipeline`` and its served form ``served_asr``, the twin
recipe's ``ASR`` with its helpers, ``recipe_hparams``) take a ``device`` so
that the CPU tests can hold them against the JAX package at a small size.
"""

import argparse
import contextlib
import copy
import ctypes
import functools
import gc
import importlib
import itertools
import json
import os
import shutil
import struct
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from speechbrain_tpu_torch.core import Brain, Stage
from speechbrain_tpu_torch.dataio.dataio import read_audio, write_audio
from speechbrain_tpu_torch.dataio.dataloader import make_dataloader
from speechbrain_tpu_torch.dataio.dataset import DynamicItemDataset
from speechbrain_tpu_torch.dataio.sampler import DynamicBatchSampler
from speechbrain_tpu_torch.decoders.ctc import ctc_greedy_decode
from speechbrain_tpu_torch.decoders.ctc import (
    CTCBeamSearcher,
    CTCPrefixBeamSearcher,
)
from speechbrain_tpu_torch.decoders.scorer import (
    BaseRescorerInterface,
    CTCScorer,
    KVTransformerLMScorer,
    RescorerBuilder,
    RNNLMRescorer,
    ScorerBuilder,
    TransformerLMRescorer,
    TransformerLMScorer,
)
from speechbrain_tpu_torch.decoders.seq2seq import S2SKVBeamSearcher
from speechbrain_tpu_torch.decoders.transducer import (
    TransducerGreedySearcherStreamingContext,
)
from speechbrain_tpu_torch.inference.ASR import EncoderASR, EncoderDecoderASR
from speechbrain_tpu_torch.alignment.diarization import (
    do_spec_clustering,
    write_rttm,
)
from speechbrain_tpu_torch.inference.classifiers import (
    AudioClassifier,
    EncoderClassifier,
)
from speechbrain_tpu_torch.inference.diarization import (
    SpeakerDiarization,
    Speech_Emotion_Diarization,
)
from speechbrain_tpu_torch.inference.enhancement import (
    SpectralMaskEnhancement,
    WaveformEnhancement,
)
from speechbrain_tpu_torch.inference.separation import SepformerSeparation
from speechbrain_tpu_torch.inference.SLU import EndToEndSLU
from speechbrain_tpu_torch.inference.speaker import SpeakerRecognition
from speechbrain_tpu_torch.inference.streaming import StreamingASR
from speechbrain_tpu_torch.inference.VAD import VAD
from speechbrain_tpu_torch.lobes.features import (
    MFCC,
    Fbank,
    StreamingFeatureWrapper,
)
from speechbrain_tpu_torch.lobes.models.convolution import ConvolutionFrontEnd
from speechbrain_tpu_torch.lobes.models.CRDNN import CRDNN as CRDNNEncoder
from speechbrain_tpu_torch.lobes.models.RNNLM import RNNLM
from speechbrain_tpu_torch.lobes.models.transformer.Transformer import (
    CACHE_LENGTH_MULTIPLE,
    get_key_padding_mask,
    get_lookahead_mask,
)
from speechbrain_tpu_torch.lobes.models.transformer.TransformerASR import (
    EncoderWrapper,
    TransformerASR,
)
from speechbrain_tpu_torch.lobes.models.transformer.TransformerLM import (
    TransformerLM,
)
from speechbrain_tpu_torch.nnet.attention import (
    NEG_INF,
    MultiheadAttention,
    make_mask_bias,
)
from speechbrain_tpu_torch.nnet.containers import LengthsCapableSequential
from speechbrain_tpu_torch.nnet.embedding import Embedding
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.nnet.loss.stoi_loss import stoi_loss
from speechbrain_tpu_torch.nnet.losses import get_si_snr_with_pitwrapper
from speechbrain_tpu_torch.nnet.normalization import BatchNorm1d
from speechbrain_tpu_torch.nnet.RNN import LSTM, AttentionalRNNDecoder
from speechbrain_tpu_torch.nnet.schedulers import (
    NewBobScheduler,
    NoamScheduler,
)
from speechbrain_tpu_torch.nnet.transducer_joint import TransducerJoint
from speechbrain_tpu_torch.nnet.transducer_loss import transducer_loss
from speechbrain_tpu_torch.ops import (
    _build,
    attention,
    beam_attention,
    gather,
    mel_frontend,
)
from speechbrain_tpu_torch.processing.features import (
    STFT,
    InputNormalization,
)
from speechbrain_tpu_torch.processing.signal_processing import resynthesize
from speechbrain_tpu_torch.recipes.AMI.Diarization import (
    experiment as ami_recipe,
)
from speechbrain_tpu_torch.recipes.BinauralWSJ0Mix.separation import (
    train as binaural_recipe,
)
from speechbrain_tpu_torch.recipes.CommonLanguage.lang_id import (
    train as cl_recipe,
)
from speechbrain_tpu_torch.recipes.CommonVoice import commonvoice_prepare
from speechbrain_tpu_torch.recipes.CommonVoice.ASR.seq2seq import (
    train as cv_seq2seq_recipe,
)
from speechbrain_tpu_torch.recipes.ESC50.classification import (
    prepare as esc50_prepare,
)
from speechbrain_tpu_torch.recipes.ESC50.classification import (
    train as esc50_recipe,
)
from speechbrain_tpu_torch.recipes.Google_speech_commands.command_recognition import (  # noqa: E501
    prepare as gsc_prepare,
)
from speechbrain_tpu_torch.recipes.Google_speech_commands.command_recognition import (  # noqa: E501
    train as gsc_recipe,
)
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.CTC import (
    train as ctc_recipe,
)
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.seq2seq import (
    train as seq2seq_recipe,
)
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.transducer import (
    train as transducer_recipe,
)
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.transformer import (
    train as recipe,
)
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.transformer import (
    train_bayesspeech as bayes_recipe,
)
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.transformer.train import (
    ASR,
)
from speechbrain_tpu_torch.recipes.IEMOCAP.emotion_recognition import (
    train as iemocap_recipe,
)
from speechbrain_tpu_torch.recipes.LibriParty.VAD import (
    prepare as vad_prepare,
)
from speechbrain_tpu_torch.recipes.LibriParty.VAD import train as vad_recipe
from speechbrain_tpu_torch.recipes.LibriMix.separation import (
    train as librimix_recipe,
)
from speechbrain_tpu_torch.recipes.LibriSpeech.LM import train as lm_recipe
from speechbrain_tpu_torch.recipes.LibriSpeech.librispeech_prepare import (
    prepare_synthetic,
)
from speechbrain_tpu_torch.recipes.SLURP.direct import (
    prepare as slurp_prepare,
)
from speechbrain_tpu_torch.recipes.SLURP.direct import train as slurp_recipe
from speechbrain_tpu_torch.recipes.Switchboard.ASR.CTC import (
    prepare as swbd_prepare,
)
from speechbrain_tpu_torch.recipes.Switchboard.ASR.seq2seq import (
    train as swbd_seq2seq_recipe,
)
from speechbrain_tpu_torch.recipes.TIMIT import timit_prepare
from speechbrain_tpu_torch.recipes.TIMIT.ASR.seq2seq import (
    train as timit_seq2seq_recipe,
)
from speechbrain_tpu_torch.recipes.TIMIT.ASR.transducer import (
    train as timit_recipe,
)
from speechbrain_tpu_torch.recipes.UrbanSound8k.SoundClassification import (
    train as us8k_recipe,
)
from speechbrain_tpu_torch.recipes.VoxCeleb.SpeakerRec import (
    prepare as speaker_prepare,
)
from speechbrain_tpu_torch.recipes.VoxCeleb.SpeakerRec import (
    speaker_verification_cosine as verify_recipe,
)
from speechbrain_tpu_torch.recipes.VoxCeleb.SpeakerRec import (
    train_speaker_embeddings as speaker_recipe,
)
from speechbrain_tpu_torch.recipes.VoxLingua107.lang_id import (
    train as vl_recipe,
)
from speechbrain_tpu_torch.recipes.WSJ0Mix.separation import (
    train as wsj0mix_recipe,
)
from speechbrain_tpu_torch.recipes.ZaionEmotionDataset.emotion_diarization import (  # noqa: E501
    prepare as zed_prepare,
)
from speechbrain_tpu_torch.recipes.ZaionEmotionDataset.emotion_diarization import (  # noqa: E501
    train as zed_recipe,
)
from speechbrain_tpu_torch.templates.speaker_id import (
    train as speaker_id_template,
)
from speechbrain_tpu_torch.tokenizers.SentencePiece import (
    WORD_BOUNDARY,
    SentencePiece,
)
from speechbrain_tpu_torch.utils.checkpoints import (
    DEFAULT_SAVE_HOOKS,
    Checkpointer,
    get_default_hook,
)
from speechbrain_tpu_torch.utils.DER import DER
from speechbrain_tpu_torch.utils.data_utils import pad_time_to_multiple
from speechbrain_tpu_torch.utils.dynamic_chunk_training import (
    DynChunkTrainConfig,
    DynChunkTrainConfigRandomSampler,
)
from speechbrain_tpu_torch.utils.edit_distance import (
    accumulatable_wer_stats,
    count_ops,
    op_table,
)
from speechbrain_tpu_torch.utils.EDER import EDER
from speechbrain_tpu_torch.utils.epoch_loop import EpochCounter
from speechbrain_tpu_torch.utils.parameter_transfer import Pretrainer
from speechbrain_tpu_torch.utils.pretrained import export_separator
from speechbrain_tpu_torch.utils.seed import seed_everything
from speechbrain_tpu_torch.utils.signals import make_check_signal
from speechbrain_tpu_torch.utils.train_logger import FileTrainLogger

# the wav2vec 2.0 pretraining twin (its folder's name holds hyphens)
w2v_pretrain_recipe = importlib.import_module(
    "speechbrain_tpu_torch.recipes.LibriSpeech.self-supervised-learning."
    "wav2vec2.train_sb_wav2vec2")

SR = 16000

# The main path's configuration: conformer-large encoder-decoder +
# TransformerLM-fused joint CTC/attention beam search (the LibriSpeech
# conformer_large recipe), with beam and max_decode_ratio scaled down from
# the recipe's test setting (66 / 1.0).
NORTH = dict(
    batch=8, seconds=10.0, vocab=5000, n_mels=80, fe_channels=(64, 32),
    d_model=512, nhead=8, enc_layers=12, dec_layers=6, d_ffn=2048,
    kernel_size=31, lm_d_model=768, lm_nhead=12, lm_layers=12, lm_d_ffn=3072,
    beam=10, lm_weight=0.60, ctc_weight=0.40, temperature=1.15,
    max_decode_ratio=0.2, bos=1, eos=2, blank=0, pad_multiple=128,
)

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate,
# the float32 rate outside the tensor cores, which is the type of arithmetic
# B1 and B3 do, and the dense bfloat16 tensor-core rate, at which the card
# could do flash attention's products in bfloat16.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_TENSOR_FLOPS = 989e12
# the dense TF32 tensor-core rate (same data sheet), at which B3 does its
# DFT (each of its three TF32 passes; the bound counts the DFT's work once)
PEAK_TF32_TENSOR_FLOPS = 495e12

# Tolerances of kernel against plain version. float32: both accumulate in
# float32 in another order. bfloat16: both round the float32 result once to
# bfloat16 (8 bits of mantissa) and may land on neighbouring values.
B1_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# dB; the tolerance of the JAX package's own test of its fused kernel
B3_ATOL = 5e-3
# flash attention against its plain version (float32 throughout): the same
# reasons as B1's
B2_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

# each kernel: (wrapper module, name of its CUDA arm, plain version)
KERNELS = {
    "ancestry_attention": (beam_attention, "_ancestry_attention_cuda",
                           beam_attention.ancestry_attention_reference),
    "fused_fbank": (mel_frontend, "_fused_fbank_cuda",
                    lambda *args, operands=None:
                    mel_frontend.fused_fbank_reference(*args)),
    "flash_attention": (attention, "_flash_attention_cuda",
                        attention.flash_attention_reference),
    "row_gather": (gather, "_row_gather_cuda", gather.row_gather_reference),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


class Pipeline:
    """waveform -> hypotheses, assembled from the port's public modules.

    The encoder family, its attention and the decoder's norm placement come
    from ``cfg`` (``encoder_module``, ``attention_type``,
    ``normalize_before``; NORTH's conformer, ``RelPosMHAXL`` and pre-norm
    where it names none), and ``cfg["lm"] = False`` leaves the LM out of the
    search (CTC alone is fused then). ``cfg["topk"]`` above 1 returns that
    many hypotheses an utterance (``return_topk``);
    ``cfg["buffer_lm_length"]`` fuses the LM through the buffer
    ``TransformerLMScorer`` of that length, which re-reads each hypothesis
    every step, in place of the KV-cached one."""

    def __init__(self, cfg, device="cuda", dtype=torch.float32, seed=0,
                 ancestry=True):
        C = dict(cfg)
        self.cfg = C
        self.device = torch.device(device)
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed)
        kw = dict(device=device, dtype=dtype, generator=gen)
        self.fbank = Fbank(n_mels=C["n_mels"], fused=True, device=device)
        self.frontend = ConvolutionFrontEnd(
            num_blocks=2, out_channels=C["fe_channels"], kernel_sizes=(3, 3),
            strides=(2, 2), **kw,
        ).eval()
        # two stride-2 blocks leave ceil(ceil(n_mels / 2) / 2) mel bins
        n_feat = (C["n_mels"] + 3) // 4 * C["fe_channels"][-1]
        self.net = TransformerASR(
            tgt_vocab=C["vocab"], input_size=n_feat, d_model=C["d_model"],
            nhead=C["nhead"], num_encoder_layers=C["enc_layers"],
            num_decoder_layers=C["dec_layers"], d_ffn=C["d_ffn"],
            encoder_module=C.get("encoder_module", "conformer"),
            attention_type=C.get("attention_type", "RelPosMHAXL"),
            kernel_size=C["kernel_size"],
            normalize_before=C.get("normalize_before", True), **kw,
        ).eval()
        self.ctc_lin = Linear(C["vocab"], C["d_model"], **kw)
        self.seq_lin = Linear(C["vocab"], C["d_model"], **kw)
        self.lm = TransformerLM(
            vocab=C["vocab"], d_model=C["lm_d_model"], nhead=C["lm_nhead"],
            num_encoder_layers=C["lm_layers"], d_ffn=C["lm_d_ffn"],
            dropout=0.0, activation="gelu", normalize_before=False, **kw,
        ).eval() if C.get("lm", True) else None
        self.ancestry = ancestry
        self.fbank_calls = 0
        self.searcher = None
        self.last_max_steps = None
        self.last_encode_ms = None
        self.last_decode_ms = None

    def _build_searcher(self, max_steps):
        C = self.cfg
        net, lm = self.net, self.lm

        def decode_step_fn(toks, cache, enc_states, enc_lens, step, anc=None):
            out, cache, attn = net.decode_step(
                toks, enc_states, cache, step, anc=anc
            )
            logits = self.seq_lin(out).float()
            # temperature on LOGITS; the searcher applies none itself
            return (
                torch.log_softmax(logits / C["temperature"], dim=-1),
                cache, attn,
            )

        weights, full_scorers = {"ctc": C["ctc_weight"]}, {}
        if lm is not None and C.get("buffer_lm_length"):
            weights["transformerlm"] = C["lm_weight"]
            full_scorers["transformerlm"] = TransformerLMScorer(
                lm, bos_index=C["bos"], max_length=C["buffer_lm_length"],
                temperature=C["temperature"], eos_index=C["eos"],
            )
        elif lm is not None:
            weights["transformerlm"] = C["lm_weight"]
            full_scorers["transformerlm"] = KVTransformerLMScorer(
                step_fn=lm.score_step,
                init_cache_fn=lm.init_cache,
                max_length=max_steps + 1,
                temperature=C["temperature"],
                # ancestry beam decoding: LM cache rows never move
                ancestry=self.ancestry,
            )
        scorer = ScorerBuilder(
            weights=weights,
            full_scorers=full_scorers,
            partial_scorers={
                "ctc": CTCScorer(
                    ctc_fn=lambda enc: torch.log_softmax(
                        self.ctc_lin(enc).float(), dim=-1
                    ),
                    blank_index=C["blank"], eos_index=C["eos"],
                )
            },
        )
        return S2SKVBeamSearcher(
            decode_step_fn,
            # precomputed cross-attention K/V, kept per utterance and
            # broadcast over the beams inside the attention
            lambda n, enc, lens: net.init_decoder_cache_with_cross(
                enc, max_steps + 1, n
            ),
            shared_cross_kv=True, ancestry_kv=self.ancestry,
            bos_index=C["bos"], eos_index=C["eos"], min_decode_ratio=0.0,
            max_decode_ratio=C["max_decode_ratio"], beam_size=C["beam"],
            using_eos_threshold=False, length_normalization=True,
            temperature=C["temperature"], scorer=scorer, device=self.device,
            topk=C.get("topk", 1), return_topk=C.get("topk", 1) > 1,
        )

    @torch.no_grad()
    def encode(self, wavs, lens):
        feats = self.fbank(wavs)
        self.fbank_calls += 1
        sub = self.frontend(feats.to(self.dtype))
        sub, lens_p = pad_time_to_multiple(
            sub, lens, multiple=self.cfg["pad_multiple"]
        )
        return self.net.encode(sub, wav_len=lens_p), lens_p

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def transcribe(self, wavs, lens):
        """(B, T) waveforms and relative lengths -> (hyps, lengths,
        scores, topk), as the searcher returns them."""
        self._sync()
        t0 = time.perf_counter()
        enc, lens_p = self.encode(wavs, lens)
        self._sync()
        t1 = time.perf_counter()
        max_steps = max(1, int(enc.shape[1] * self.cfg["max_decode_ratio"]))
        self.last_max_steps = max_steps
        self.searcher = self._build_searcher(max_steps)
        result = self.searcher(enc, lens_p)
        self._sync()
        t2 = time.perf_counter()
        self.last_encode_ms = (t1 - t0) * 1e3
        self.last_decode_ms = (t2 - t1) * 1e3
        return result


# -- the serving entry point over the same modules --------------------------

def serve_modules(pipe):
    """A pipeline's modules by the names of their files in a model source
    directory (``<name>.ckpt``)."""
    return {"frontend": pipe.frontend, "asr": pipe.net,
            "ctc_lin": pipe.ctc_lin, "seq_lin": pipe.seq_lin, "lm": pipe.lm}


class ServedDecoder(torch.nn.Module):
    """``Pipeline``'s beam search as the ``decoder`` of an
    ``EncoderDecoderASR``: ``(encoder states, relative lengths) -> (hyps,
    lengths, scores, topk)``, the searcher built for each batch as
    ``Pipeline.transcribe`` builds it (its caches sized by the batch's
    encoder length). The decoder's, the heads' and the LM's modules are
    its children, so that the interface puts them in ``eval()`` without
    gradients. ``pipe.ancestry`` picks the search's mode. The card is
    synchronised around the search (which syncs the host every step
    anyway) and its wall time kept in ``last_ms``."""

    def __init__(self, pipe):
        super().__init__()
        self.pipe = pipe
        self.net, self.ctc_lin = pipe.net, pipe.ctc_lin
        self.seq_lin, self.lm = pipe.seq_lin, pipe.lm
        self.searcher = self.last_result = self.last_ms = None

    def forward(self, enc_states, enc_lens):
        self.pipe._sync()
        t0 = time.perf_counter()
        max_steps = max(1, int(enc_states.shape[1]
                               * self.pipe.cfg["max_decode_ratio"]))
        self.searcher = self.pipe._build_searcher(max_steps)
        self.last_result = self.searcher(enc_states, enc_lens)
        self.pipe._sync()
        self.last_ms = (time.perf_counter() - t0) * 1e3
        return self.last_result


def served_encoder(pipe, ctc=False):
    """``Pipeline.encode`` as a ``LengthsCapableSequential``: fused
    Fbank, cast to the pipeline's dtype, front end, time padded to a
    multiple (which rescales the lengths), the encoder alone; with
    ``ctc``, then the CTC head and log-softmax (``EncoderASR``'s
    encoder)."""
    layers = [
        pipe.fbank, lambda x: x.to(pipe.dtype), pipe.frontend,
        functools.partial(pad_time_to_multiple,
                          multiple=pipe.cfg["pad_multiple"]),
        EncoderWrapper(pipe.net),
    ]
    if ctc:
        layers += [pipe.ctc_lin, lambda x: torch.log_softmax(x.float(), -1)]
    return LengthsCapableSequential(layers)


class TimedEncoderDecoderASR(EncoderDecoderASR):
    """``EncoderDecoderASR`` that synchronises the card around its encoder
    and around its whole call, as ``Pipeline.transcribe`` does, and keeps
    the encode's wall time and the rest of the call's (the decode's)."""

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def encode_batch(self, wavs, wav_lens):
        self._sync()
        t0 = time.perf_counter()
        out = super().encode_batch(wavs, wav_lens)
        self._sync()
        self.last_encode_ms = (time.perf_counter() - t0) * 1e3
        return out

    def transcribe_batch(self, wavs, wav_lens):
        self._sync()
        t0 = time.perf_counter()
        out = super().transcribe_batch(wavs, wav_lens)
        self._sync()
        total_ms = (time.perf_counter() - t0) * 1e3
        self.last_decode_ms = total_ms - self.last_encode_ms
        return out


def served_asr(pipe, tokenizer):
    """An ``EncoderDecoderASR`` built from hparams in Python (the card's
    machine has no YAML loader) over ``pipe``'s modules: the entry point
    a user serves through, holding the same weights as ``pipe``."""
    return TimedEncoderDecoderASR(
        hparams={"encoder": served_encoder(pipe),
                 "decoder": ServedDecoder(pipe),
                 "tokenizer": tokenizer, "sample_rate": SR},
        run_opts={"device": str(pipe.device)})


class MarkedFeatureWrapper(StreamingFeatureWrapper):
    """A ``StreamingFeatureWrapper`` that lets ``on_chunk`` note each
    chunk's start before its features."""

    def __init__(self, module, on_chunk):
        super().__init__(module)
        self.on_chunk = on_chunk

    def __call__(self, chunk, context):
        self.on_chunk()
        return super().__call__(chunk, context)


class StreamingServe:
    """The streaming serving assembly over a transducer twin's modules
    (``brain``, a ``TransducerASR``): ``StreamingASR``'s hparams, built in
    Python. The JAX package has no such assembly for the recipe, only
    ``StreamingASR``'s hparams contract, which this fills:

    - ``fea_streaming_extractor``: ``StreamingFeatureWrapper(Fbank(fused=
      True))`` (kernel B3 once a chunk);
    - ``make_streaming_context``: the encoder's;
    - ``encode_chunk``: the recipe's ``encode`` order over one chunk:
      sentence normalisation (over the chunk's frames), the front end
      (zero padding at the chunk's edges), ``encode_streaming``,
      ``enc_proj``;
    - ``decode_chunk``: the searcher's streaming greedy;
    - ``frontend_stride`` 4, ``tokenizer``, ``sample_rate``.

    ``keep`` (a list, or None) collects each chunk's features, normalised
    features, front-end output and states; ``marks`` (a list, or None)
    collects CUDA events at each chunk's start, after its encode and after
    its decode; ``tokens`` (a list a row, or None) the emitted tokens."""

    def __init__(self, brain, cfg, device, max_symbols_per_step=10):
        self.brain = brain
        self.searcher = brain.make_searcher(
            beam_size=1, max_symbols_per_step=max_symbols_per_step)
        self.fea = MarkedFeatureWrapper(
            Fbank(n_fft=cfg["n_fft"], n_mels=cfg["n_mels"], fused=True,
                  device=device), self._mark)
        self.device = device
        self.keep = self.marks = self.tokens = None

    def _mark(self):
        if self.marks is not None:
            self.marks.append([torch.cuda.Event(enable_timing=True)])
            self.marks[-1][0].record()

    def _mark_end(self):
        if self.marks is not None:
            self.marks[-1].append(torch.cuda.Event(enable_timing=True))
            self.marks[-1][-1].record()

    def encode_chunk(self, feats, context):
        modules = self.brain.modules
        normed = self.brain.hparams.normalize(
            feats, torch.ones(feats.shape[0], device=feats.device))
        front = modules.frontend(normed)
        enc, context = modules.encoder.encode_streaming(front, context)
        enc = modules.enc_proj(enc)
        if self.keep is not None:
            self.keep.append((feats, normed, front, enc))
        self._mark_end()
        return enc, context

    def decode_chunk(self, enc, context):
        if context is None:
            context = TransducerGreedySearcherStreamingContext()
        hyps = self.searcher.transducer_greedy_decode_streaming(enc, context)
        if self.tokens is not None:
            for row, new in zip(self.tokens, hyps):
                row.extend(new)
        self._mark_end()
        return hyps, context

    def asr(self, tokenizer):
        """The ``StreamingASR`` a user calls, over this assembly (its
        modules in ``eval()`` without gradients)."""
        self.brain.modules.eval()
        return StreamingASR(
            hparams={"fea_streaming_extractor": self.fea,
                     "make_streaming_context":
                     self.brain.modules.encoder.make_streaming_context,
                     "encode_chunk": self.encode_chunk,
                     "decode_chunk": self.decode_chunk,
                     "frontend_stride": STREAMING_FRONTEND_STRIDE,
                     "tokenizer": tokenizer, "sample_rate": SR},
            run_opts={"device": str(self.device)})


def write_covering_bpe(model_dir, n_pieces):
    """A BPE model of exactly ``n_pieces`` pieces in the port's own
    ``<n_pieces>_bpe.model.json`` format, made by construction: ``<unk>``,
    the word boundary and the letters, then pairs of those and triples
    of a pair and a symbol, each with its merge. It covers every class of
    a head of ``n_pieces`` classes, where BPE trained on a small corpus
    stops far short (``ROADMAP.md`` C19). Returns the file's path."""
    letters = [chr(c) for c in range(ord("a"), ord("z") + 1)]
    pieces, merges = (["<unk>", WORD_BOUNDARY] + letters)[:n_pieces], []
    symbols = pieces[1:]
    pairs = [(a, b) for a in symbols for b in symbols]
    triples = [(a + b, c) for a, b in pairs for c in symbols]
    for left, right in itertools.chain(pairs, triples):
        if len(pieces) == n_pieces:
            break
        pieces.append(left + right)
        merges.append([left, right])
    if len(pieces) != n_pieces:
        raise ValueError(f"cannot construct {n_pieces} pieces")
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, f"{n_pieces}_bpe.model.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"pieces": pieces, "merges": merges, "unk": "<unk>"}, f,
                  ensure_ascii=False)
    return path


# The training path's configuration: the LibriSpeech conformer_large
# CTC/attention recipe (recipes/LibriSpeech/ASR/transformer/hparams/
# conformer_large.yaml) at full width and depth, random weights from a
# seed, synthetic utterances and token ids (no tokenizer), Noam's warm-up
# cut from 25000 to 10 steps so that 30 steps move the loss.
TRAIN = dict(
    vocab=5000, n_mels=80, fe_channels=(64, 32), d_model=512, nhead=8,
    enc_layers=12, dec_layers=6, d_ffn=2048, kernel_size=31, dropout=0.1,
    ctc_weight=0.3, label_smoothing=0.1, lr_adam=8e-4, n_warmup_steps=10,
    grad_accumulation_factor=2, max_grad_norm=5.0, batch_size=16,
    epochs=30, n_train=32, n_valid=16, seconds=(8.0, 12.0),
    n_tokens=(30, 60), bos=1, eos=2, blank=0, sig_multiple=16000,
    precision="bf16",
)
TRAIN_REDUCED = {
    "n_warmup_steps": "25000 -> 10",
    "number_of_epochs": "120 -> 30 epochs of 2 micro-batches",
    "data": "LibriSpeech 960 h -> 32 train and 16 valid synthetic "
            "utterances of 8-12 s; token ids in place of BPE pieces",
}


def make_asr_modules(cfg, device="cuda", seed=0, dropout=None,
                     encoder_remat=False):
    """The recipe's four modules, random weights from ``seed``; the encoder
    family and its attention from ``cfg`` (the conformer and
    ``RelPosMHAXL`` where it names none)."""
    gen = torch.Generator().manual_seed(seed)
    drop = cfg["dropout"] if dropout is None else dropout
    kw = dict(device=device, generator=gen)
    n_feat = (cfg["n_mels"] + 3) // 4 * cfg["fe_channels"][-1]
    return {
        "frontend": ConvolutionFrontEnd(
            num_blocks=2, out_channels=cfg["fe_channels"],
            kernel_sizes=(3, 3), strides=(2, 2), dropout=drop, **kw,
        ),
        "model": TransformerASR(
            tgt_vocab=cfg["vocab"], input_size=n_feat,
            d_model=cfg["d_model"], nhead=cfg["nhead"],
            num_encoder_layers=cfg["enc_layers"],
            num_decoder_layers=cfg["dec_layers"], d_ffn=cfg["d_ffn"],
            dropout=drop,
            encoder_module=cfg.get("encoder_module", "conformer"),
            attention_type=cfg.get("attention_type", "RelPosMHAXL"),
            kernel_size=cfg["kernel_size"], encoder_remat=encoder_remat,
            **kw,
        ),
        "ctc_head": Linear(cfg["vocab"], cfg["d_model"], **kw),
        "seq_head": Linear(cfg["vocab"], cfg["d_model"], **kw),
    }


def make_asr_hparams(cfg, out_dir=None, device="cuda"):
    """The recipe's hparams that the Brain reads, built in Python (the
    train logger writes into ``out_dir``, where one is given)."""
    hparams = {
        "compute_features": Fbank(n_mels=cfg["n_mels"], fused=True,
                                  device=device),
        "normalize": InputNormalization(norm_type="sentence"),
        "ctc_weight": cfg["ctc_weight"],
        "label_smoothing": cfg["label_smoothing"],
        "blank_index": cfg["blank"],
        "noam_scheduler": NoamScheduler(
            lr_initial=cfg["lr_adam"], n_warmup_steps=cfg["n_warmup_steps"]
        ),
        "epoch_counter": EpochCounter(cfg["epochs"]),
    }
    if out_dir is not None:
        hparams["train_logger"] = FileTrainLogger(
            os.path.join(out_dir, "train_log.txt")
        )
    return hparams


def adamw(cfg):
    """The recipe's optimizer at ``cfg["lr_adam"]`` (the twin's
    ``adamw``: ``optax.adamw``'s defaults, weight decay 1e-4)."""
    return recipe.adamw(cfg["lr_adam"])


def write_asr_corpus(cfg, out_dir, seed=0):
    """Synthetic utterances as 16-bit PCM WAV files and JSON manifests
    (``train.json``, ``valid.json``): each utterance holds one tone a
    token, in equal segments, over noise 26 dB down, so that the targets
    can be learnt. Returns the manifests' paths."""
    rng = np.random.default_rng(seed)
    paths = {}
    for split, n in (("train", cfg["n_train"]), ("valid", cfg["n_valid"])):
        manifest = {}
        for i in range(n):
            secs = float(rng.uniform(*cfg["seconds"]))
            T = int(SR * secs)
            n_tok = int(rng.integers(cfg["n_tokens"][0],
                                     cfg["n_tokens"][1] + 1))
            tokens = rng.integers(3, cfg["vocab"], n_tok)
            seg = np.arange(T) * n_tok // T
            freq = 100.0 + 13.0 * (tokens[seg] % 500)
            phase = 2 * np.pi * np.cumsum(freq) / SR
            wav = 0.3 * np.sin(phase) + 0.015 * rng.standard_normal(T)
            path = os.path.join(out_dir, f"{split}_{i:03d}.wav")
            write_audio(path, wav.astype(np.float32), SR)
            manifest[f"{split}_{i:03d}"] = {
                "wav": path, "length": secs,
                "tokens": " ".join(str(int(t)) for t in tokens),
            }
        paths[split] = os.path.join(out_dir, f"{split}.json")
        with open(paths[split], "w") as f:
            json.dump(manifest, f)
    return paths


def asr_dataset(manifest, cfg, train, fold=False):
    """The recipe's data pipeline (``train.py:126-164``) over a manifest
    whose ``tokens`` entry holds the ids in place of words: audio read
    from the WAV file, and the ids as tokens, BOS + tokens, tokens +
    EOS. With ``fold`` the ids are folded into ``1 .. cfg["vocab"] - 1``
    (a head narrower than the corpus's ids, whose id 0 is bos, eos and
    blank)."""
    ds = DynamicItemDataset.from_json(manifest)
    if train:
        ds = ds.filtered_sorted(sort_key="length")
    ds.add_dynamic_item(read_audio, takes="wav", provides="sig")

    def tokens_pipeline(text):
        ids = [int(t) for t in text.split()]
        if fold:
            ids = [1 + i % (cfg["vocab"] - 1) for i in ids]
        yield np.asarray(ids, np.int32)
        yield np.asarray([cfg["bos"]] + ids, np.int32)
        yield np.asarray(ids + [cfg["eos"]], np.int32)

    ds.add_dynamic_item(tokens_pipeline, takes="tokens",
                        provides=["tokens_ids", "tokens_bos", "tokens_eos"])
    ds.set_output_keys({"id": "id", "sig": "sig", "tokens": "tokens_ids",
                        "tokens_bos": "tokens_bos",
                        "tokens_eos": "tokens_eos"})
    return ds


def asr_loader_kwargs(cfg, shuffle):
    """The recipe's loader arguments (``train.py:206-209``)."""
    return {"batch_size": cfg["batch_size"], "shuffle": shuffle,
            "pad_to_multiple": {"sig": cfg["sig_multiple"]}}


@contextlib.contextmanager
def plain_versions(*names):
    """Route the wrappers' CUDA arm of the named kernels (all four when
    none is named) to the kernels' plain PyTorch versions (same
    signatures), for the comparison phases only. The package itself has no
    such switch: on a CUDA tensor its wrappers launch the kernel or
    raise."""
    names = names or tuple(KERNELS)
    saved = {n: getattr(KERNELS[n][0], KERNELS[n][1]) for n in names}
    for n in names:
        module, arm, plain = KERNELS[n]
        setattr(module, arm, plain)
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(KERNELS[n][0], KERNELS[n][1], fn)


def reset_launch_counts():
    for module, _, _ in KERNELS.values():
        module.launches = 0


def launch_counts():
    return {n: module.launches for n, (module, _, _) in KERNELS.items()}


def time_eager_ms(fn, n_variants, iters=50, warmup=5):
    """Mean milliseconds of ``fn(i)`` called back to back from Python, by
    CUDA events: the rate at which an eager loop can issue the call, host
    overhead included. ``i`` cycles through ``n_variants`` input sets so
    that each launch finds its inputs out of the L2 cache, as the main
    path's launches do."""
    for i in range(warmup):
        fn(i % n_variants)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_variants)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, n_variants, iters=48):
    """Mean milliseconds of ``fn(i)`` on the device: ``iters`` calls are
    captured into one CUDA graph and the graph's replay is timed by CUDA
    events, so the host's time to issue each call is left out. Inputs
    cycle as in :func:`time_eager_ms`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i % n_variants)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i % n_variants)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    torch.cuda.empty_cache()
    return ms


# -- phase 2: each kernel against its plain version ------------------------

def make_b1_inputs(B, K, H, hd, L, dtype, seed, device="cuda"):
    rng = np.random.default_rng(seed)
    D = H * hd
    q = torch.from_numpy(
        rng.standard_normal((B, K, H, hd)).astype(np.float32)
    ).to(device=device, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    k = torch.randn((B, K, L, D), generator=gen, device=device).to(dtype)
    v = torch.randn((B, K, L, D), generator=gen, device=device).to(dtype)
    anc = torch.from_numpy(
        rng.integers(0, K, (B, K, L)).astype(np.int32)
    ).to(device)
    return q, k, v, anc


def check_b1():
    """Kernel against plain version, float32 and bfloat16:

    - the main path's two head counts (8, 12) at steps 0, 31, 32 and L - 1,
      and at the seams of the kernel's batches of positions (one batch
      - 1, + 0, + 1, and the same about two batches);
    - a cache length (100) that is not a multiple of a batch, at the seams
      of one, two and three batches;
    - a history longer than one chunk of staged ancestry entries (steps
      1023 to 1025 of 1100);
    - the published decode's shape, beam 66 and 288 positions with the
      LM's 12 heads, at steps 0, 143 and 287;
    - head dim 18 (the general instantiation) at the seams of its
      batches."""
    results = []
    worst = 0.0

    def run(B, K, H, hd, L, dtype, steps, seed):
        nonlocal worst
        q, k, v, anc = make_b1_inputs(B, K, H, hd, L, dtype, seed=seed)
        for step in steps:
            out = beam_attention.ancestry_attention(q, k, v, anc, step)
            torch.cuda.synchronize()
            ref = beam_attention.ancestry_attention_reference(
                q, k, v, anc, step
            )
            err = (out.float() - ref.float()).abs().max().item()
            if not (err <= B1_ATOL[dtype]) or out.shape != ref.shape:
                raise AssertionError(
                    f"ancestry_attention disagrees: shape {(B, K, H, hd, L)}"
                    f" {dtype} step {step}: max abs err {err}"
                )
            worst = max(worst, err)
            results.append([[B, K, H, hd, L], str(dtype), step, err])

    def seams(P, n_batches, L):
        return [s for i in range(1, n_batches + 1)
                for s in (i * P - 1, i * P, i * P + 1) if s < L]

    for H, dtype in ((8, torch.float32), (8, torch.bfloat16),
                     (12, torch.float32), (12, torch.bfloat16)):
        P = beam_attention.kernel_batch_positions(64, dtype)
        L = 64
        steps = sorted({0, 31, 32, L - 1, *seams(P, 2, L)})
        run(8, 10, H, 64, L, dtype, steps, seed=H + L)
    chunk = beam_attention.ANCESTRY_CHUNK
    for dtype in (torch.float32, torch.bfloat16):
        P = beam_attention.kernel_batch_positions(64, dtype)
        run(2, 5, 3, 64, 100, dtype, sorted({*seams(P, 3, 100), 99}),
            seed=100)
        run(1, 2, 1, 64, chunk + 76, dtype,
            (chunk - 1, chunk, chunk + 1, chunk + 75), seed=chunk)
    for dtype in (torch.float32, torch.bfloat16):
        run(8, 66, 12, 64, 288, dtype, (0, 143, 287), seed=66)
        torch.cuda.empty_cache()
    # head dim 18 (the d-144, 8-head families' decoder): the general
    # instantiation, at the seams of its batches
    for dtype in (torch.float32, torch.bfloat16):
        P = beam_attention.kernel_batch_positions(18, dtype)
        run(8, 10, 8, 18, 64, dtype, sorted({0, 63, *seams(P, 3, 64)}),
            seed=18)
        run(2, 5, 3, 18, 100, dtype, sorted({*seams(P, 6, 100), 99}),
            seed=118)
    emit({"phase": "kernel_check", "kernel": "ancestry_attention",
          "atol": {str(k_): v_ for k_, v_ in B1_ATOL.items()},
          "cases_BKHhdL_dtype_step_err": results, "max_abs_err": worst})
    return worst


def b3_layout(fbank):
    """(shared-memory bytes, ring stages, frames a block) of the B3 kernel
    for ``fbank``'s sizes, as the kernel chooses them."""
    ops = fbank._operands
    n_fft, hop = fbank.compute_STFT.n_fft, fbank.compute_STFT.hop_length
    stages, fpb = ctypes.c_int(0), ctypes.c_int(0)
    smem = _build.load_library().sb_fused_fbank_smem(
        n_fft, ops.mel_ranges.shape[0], ops.mel_weights.shape[1], hop,
        mel_frontend.span_skew(hop), ctypes.byref(stages), ctypes.byref(fpb),
    )
    return smem, stages.value, fpb.value


def check_b3():
    """Kernel against its plain version and against the unfused ``Fbank``
    (rfft on cuFFT), at most ``B3_ATOL`` dB each: white noise at three
    hops; the two signals that show a DFT scheme's precision
    (:func:`make_check_signal`), the chirp with noise 60 dB down at the main
    path's shape from eight seeds and noise bursts with digital silence,
    also at n_fft 512; noise and bursts at BEST-RQ's (8, 256000); hops
    whose 64 frames do not fit a block (320 at 16 kHz; 441 at 44.1 kHz and
    n_fft 2048); and the three signals at the CRDNN recipe's 40 mels (80
    elsewhere)."""
    worst = 0.0
    rows = []
    cases = [
        # (signal, batch, seconds, hop ms, n_fft, sample rate, seed[, mels])
        ("noise", 8, 10.0, 10, 400, SR, 10),
        ("noise", 2, 4.0, 8, 400, SR, 8),
        ("noise", 2, 4.0, 16, 400, SR, 16),
        *[("chirp", 8, 10.0, 10, 400, SR, seed) for seed in range(10, 18)],
        ("bursts", 8, 10.0, 10, 400, SR, 10),
        ("bursts", 2, 4.0, 10, 512, SR, 10),
        ("chirp", 2, 4.0, 20, 400, SR, 20),
        ("noise", 2, 4.0, 10, 2048, 44100, 44),
        # BEST-RQ's batches: 8 utterances of 16 s. Noise and bursts: the
        # two float32 references part by up to 5e-3 on long chirps (C15; a
        # 16 s chirp at seed 21 put the kernel 0.0059 dB from the unfused
        # Fbank and 0.0023 from its plain version); ssl_path holds the
        # chirp at this shape against the plain version
        ("noise", 8, 16.0, 10, 400, SR, 19),
        ("bursts", 8, 16.0, 10, 400, SR, 21),
        # the CRDNN recipe's 40 mels
        ("noise", 8, 10.0, 10, 400, SR, 40, 40),
        ("chirp", 8, 10.0, 10, 400, SR, 41, 40),
        ("bursts", 8, 10.0, 10, 400, SR, 42, 40),
    ]
    for kind, batch, seconds, hop_ms, n_fft, sr, seed, *mels in cases:
        n_mels = mels[0] if mels else 80
        wav = torch.from_numpy(make_check_signal(
            kind, batch, int(sr * seconds), seed=seed, sample_rate=sr
        )).cuda()
        fused = Fbank(sample_rate=sr, n_mels=n_mels, hop_length=hop_ms,
                      n_fft=n_fft, fused=True)
        unfused = Fbank(sample_rate=sr, n_mels=n_mels, hop_length=hop_ms,
                        n_fft=n_fft, fused=False)
        out = fused(wav)
        torch.cuda.synchronize()
        with plain_versions():
            plain = fused(wav)
        ref = unfused(wav)
        err_plain = (out - plain).abs().max().item()
        err_unfused = (out - ref).abs().max().item()
        hop = fused.compute_STFT.hop_length
        if out.shape != ref.shape or not (
            err_plain <= B3_ATOL and err_unfused <= B3_ATOL
        ):
            raise AssertionError(
                f"fused_fbank disagrees on {kind} (seed {seed}) at hop {hop}, "
                f"n_fft {n_fft}: vs plain {err_plain}, vs unfused Fbank "
                f"{err_unfused} dB"
            )
        worst = max(worst, err_plain, err_unfused)
        rows.append({"signal": kind, "seed": seed, "shape": list(wav.shape),
                     "hop": hop, "n_fft": n_fft, "n_mels": n_mels,
                     "frames_a_block": b3_layout(fused)[2],
                     "frames": out.shape[1], "err_vs_plain": err_plain,
                     "err_vs_unfused_fbank": err_unfused,
                     "plain_vs_unfused_fbank":
                         (plain - ref).abs().max().item()})
    emit({"phase": "kernel_check", "kernel": "fused_fbank",
          "atol_db": B3_ATOL, "cases": rows, "max_abs_err": worst})
    return worst


def make_heads(B, T, H, hd, dtype, gen):
    """(B, H, T, hd) head-major view of a (B, T, H*hd) tensor, strided as
    ``MultiheadAttention._heads`` makes it."""
    x = torch.randn((B, T, H * hd), generator=gen, device="cuda").to(dtype)
    return x.reshape(B, T, H, hd).transpose(1, 2)


def make_b2_bias(form, B, H, Tq, Tk, dtype, gen):
    """The bias forms the kernel takes: none, (Tq, Tk), (B, H, Tq, Tk),
    (B, 1, 1, Tk) key padding and (1, 1, Tq, Tk) causal. No query row is
    masked in full."""
    if form == "none":
        return None
    if form == "tq_tk":
        return torch.randn((Tq, Tk), generator=gen, device="cuda").to(dtype)
    if form == "full":
        return torch.randn((B, H, Tq, Tk), generator=gen,
                           device="cuda").to(dtype)
    if form == "key_padding":
        kpm = torch.zeros((B, Tk), dtype=torch.bool, device="cuda")
        kpm[B // 2:, Tk - Tk // 3:] = True
        return make_mask_bias(key_padding_mask=kpm, dtype=dtype)
    causal = torch.ones((Tq, Tk), dtype=torch.bool, device="cuda").triu(
        max(1, Tk - Tq + 1)
    )
    return make_mask_bias(attn_mask=causal, dtype=dtype)


B2_FORMS = ("none", "tq_tk", "full", "key_padding", "causal")
# sequence lengths about the bf16 kernel's 128-row query tile and its 64-key
# tiles
B2_EDGE_T = (1, 63, 64, 65, 127, 128, 129)


def check_b2():
    """Kernel against plain version:

    - float32 and bfloat16, head dims 32/64/128, every bias form, Tq != Tk
      and neither a multiple of a tile, on strided ``_heads`` views;
    - bfloat16, each head dim and bias form, Tq x Tk over ``B2_EDGE_T``
      (where Tk * 2 bytes is a multiple of 16 the bias goes through the
      kernel's shared-memory ring, elsewhere each thread reads it from
      device memory);
    - a query row, and a whole batch, whose every key is masked by -1e30:
      all of that row's scores are equal, so the plain version gives the
      mean of V there, and so must the kernel;
    - the three shapes of the flash path."""
    worst = {str(d): 0.0 for d in B2_ATOL}
    rows = []
    edge_worst = {}
    gen = torch.Generator(device="cuda").manual_seed(5)

    def run(B, H, Tq, Tk, hd, form, dtype, mask_all=False):
        q = make_heads(B, Tq, H, hd, dtype, gen)
        k = make_heads(B, Tk, H, hd, dtype, gen)
        v = make_heads(B, Tk, H, hd, dtype, gen)
        bias = make_b2_bias(form, B, H, Tq, Tk, dtype, gen)
        if mask_all and form == "key_padding":  # every key of batch 0
            bias[0] = NEG_INF
        elif mask_all:  # "full", "tq_tk": one query row
            bias[(0,) * (bias.ndim - 2) + (Tq // 2,)] = NEG_INF
        out, w = attention.flash_attention(q, k, v, bias)
        torch.cuda.synchronize()
        ref = attention.flash_attention_reference(q, k, v, bias)
        err = (out.float() - ref.float()).abs().max().item()
        if not (err <= B2_ATOL[dtype]) or out.shape != ref.shape or w:
            raise AssertionError(
                f"flash_attention disagrees: {(B, H, Tq, Tk, hd)} {form} "
                f"{dtype}{' masked row' if mask_all else ''}: max abs err "
                f"{err}"
            )
        worst[str(dtype)] = max(worst[str(dtype)], err)
        return err

    cases = [
        (2, 3, 77, 130, hd, form, dtype)
        for dtype in B2_ATOL for hd in (32, 64, 128) for form in B2_FORMS
    ] + [
        (8, 8, 256, 256, 64, "key_padding", torch.bfloat16),
        (16, 4, 1024, 1024, 64, "none", torch.bfloat16),
        (16, 4, 1024, 1024, 64, "causal", torch.bfloat16),
        (16, 4, 1024, 1024, 64, "causal", torch.float32),
    ]
    for case in cases:
        rows.append([list(case[:5]), case[5], str(case[6]), run(*case)])
    for hd in (32, 64, 128):
        for Tq in B2_EDGE_T:
            for Tk in B2_EDGE_T:
                for form in B2_FORMS:
                    err = run(1, 2, Tq, Tk, hd, form, torch.bfloat16)
                    edge_worst[hd] = max(edge_worst.get(hd, 0.0), err)
    masked = []
    for dtype in B2_ATOL:
        for hd in (32, 64, 128):
            for Tk in (130, 128):
                for form in ("full", "tq_tk", "key_padding"):
                    masked.append([hd, Tk, form, str(dtype),
                                   run(2, 3, 77, Tk, hd, form, dtype, True)])
    emit({"phase": "kernel_check", "kernel": "flash_attention",
          "atol": {str(k_): v_ for k_, v_ in B2_ATOL.items()},
          "cases_shape_bias_dtype_err": rows,
          "edge_cases_bf16": len(B2_EDGE_T) ** 2 * 3 * len(B2_FORMS),
          "edge_T": list(B2_EDGE_T), "edge_worst_err_by_hd": edge_worst,
          "masked_rows_hd_Tk_bias_dtype_err": masked,
          "max_abs_err": worst})
    return worst[str(torch.bfloat16)]


def check_b4():
    """Kernel against plain version, bitwise: float32 and bfloat16, int32
    and int64 indices, repeated indices, n_out != N, 1-D to 3-D, a row of
    60 bytes (not a multiple of 16) and the two cache shapes of the
    permuting search."""
    rows = []
    rng = np.random.default_rng(4)
    shapes = [(9,), (9, 40), (9, 5, 3), (80, 64, 512), (80, 64, 768)]
    for dtype in (torch.float32, torch.bfloat16):
        for shape in shapes:
            x = torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32)
            ).cuda().to(dtype)
            N = shape[0]
            for n_out in (N, N + 3, N // 2):
                idx_np = rng.integers(0, N, n_out)
                idx_np[:2] = idx_np[0]  # a repeated index
                for index_dtype in (torch.int32, torch.int64):
                    idx = torch.from_numpy(idx_np).cuda().to(index_dtype)
                    out = gather.row_gather(x, idx)
                    torch.cuda.synchronize()
                    equal = torch.equal(
                        out, gather.row_gather_reference(x, idx)
                    )
                    rows.append([list(shape), n_out, str(dtype),
                                 str(index_dtype), equal])
                    if not equal:
                        raise AssertionError(
                            f"row_gather differs from index_select: {rows[-1]}"
                        )
    try:
        gather.row_gather(x, torch.zeros(2, dtype=torch.int64))
    except ValueError:
        pass
    else:
        raise AssertionError("row_gather took a CPU index for a CUDA x")
    emit({"phase": "kernel_check", "kernel": "row_gather",
          "bitwise_equal_cases": len(rows),
          "cases_shape_nout_dtype_index": rows,
          "raises_on_cpu_index": True, "max_abs_err": 0.0})
    return 0.0


# -- phase 3: the main path -------------------------------------------------

def make_waveforms(cfg, device):
    wavs = np.random.default_rng(0).standard_normal(
        (cfg["batch"], int(SR * cfg["seconds"]))
    ).astype(np.float32)
    return (
        torch.from_numpy(wavs).to(device),
        torch.ones(cfg["batch"], device=device),
    )


def expected_launches(cfg, ancestry, steps, fbank_calls):
    """Launches each kernel must make in one ``transcribe`` of ``steps``
    decode steps: the ancestry path attends through B1 in every decoder and
    LM layer; the permuting path gathers each layer's K and V buffers
    through B4 once a step (the searcher permutes its memory and the LM
    scorer's once after every step). Both run B3 once an ``Fbank`` call."""
    counts = dict.fromkeys(KERNELS, 0)
    counts["fused_fbank"] = fbank_calls
    layers = cfg["dec_layers"] + (
        cfg["lm_layers"] if cfg.get("lm", True) else 0
    )
    if ancestry:
        counts["ancestry_attention"] = layers * steps
    else:
        counts["row_gather"] = 2 * layers * steps
    return counts


def run_transcribe_path(cfg, ancestry):
    """One bf16 ``transcribe`` at full width after a warm-up; the launch
    counts of the measured run must be exactly those of
    :func:`expected_launches`."""
    phase = "main_path" if ancestry else "permute_path"
    wavs, lens = make_waveforms(cfg, "cuda")
    pipe = Pipeline(cfg, device="cuda", dtype=torch.bfloat16, seed=0,
                    ancestry=ancestry)
    pipe.transcribe(wavs, lens)  # warm-up: cuDNN/cuBLAS set-up, allocator
    reset_launch_counts()
    pipe.fbank_calls = 0
    hyps, lengths, scores, _ = pipe.transcribe(wavs, lens)
    counts = launch_counts()
    steps = pipe.searcher.last_steps
    expected = expected_launches(cfg, ancestry, steps, pipe.fbank_calls)
    ok = (
        len(hyps) == cfg["batch"]
        and np.all(np.isfinite(scores))
        and all(0 <= t < cfg["vocab"] for h in hyps for t in h)
        and steps >= 1 and pipe.fbank_calls >= 1
        and counts == expected
    )
    audio_s = cfg["batch"] * cfg["seconds"]
    total_ms = pipe.last_encode_ms + pipe.last_decode_ms
    emit({
        "phase": phase, "dtype": "bfloat16", "ok": bool(ok),
        "config": {**cfg, "ctc_scorer": True,
                   "fused_fbank": True, "ancestry_kv": ancestry},
        "hypotheses": len(hyps), "hyp_lengths": [int(x) for x in lengths],
        "scores": [float(s) for s in scores], "steps": steps,
        **{f"{name}_launches": n for name, n in counts.items()},
        "expected_launches": expected,
        "encode_ms": pipe.last_encode_ms, "decode_ms": pipe.last_decode_ms,
        "audio_seconds_per_second": audio_s / (total_ms / 1e3),
    })
    if not ok:
        raise AssertionError(f"{phase}: a check on the bf16 run failed")
    return pipe, {"steps": steps, "max_steps": pipe.last_max_steps,
                  "decode_ms": pipe.last_decode_ms, "launches": counts}


def run_fp32_comparison(cfg, ancestry, score_atol=1e-3, phase=None):
    """The same transcribe in float32, through the kernels and through the
    plain versions: tokens equal, scores within ``score_atol`` (the two
    differ by float32 summation order only; the slack is for its growth
    through 18 layers and up to 51 steps). On the permuting path the run
    is made once more with only B4 on its plain version: a row copy is
    exact, so its scores must equal the kernels' bit for bit."""
    phase = phase or "fp32_kernel_vs_plain" + ("" if ancestry else
                                                "_permute")
    wavs, lens = make_waveforms(cfg, "cuda")
    pipe = Pipeline(cfg, device="cuda", dtype=torch.float32, seed=0,
                    ancestry=ancestry)
    reset_launch_counts()
    hyps_k, _, scores_k, _ = pipe.transcribe(wavs, lens)
    path = [n for n, c in expected_launches(cfg, ancestry, 1, 1).items()
            if c]
    used_kernels = all(launch_counts()[n] > 0 for n in path)
    reset_launch_counts()
    with plain_versions():
        hyps_p, _, scores_p, _ = pipe.transcribe(wavs, lens)
    plain_clean = not any(launch_counts().values())
    diff = float(np.max(np.abs(scores_k - scores_p)))
    ok = (
        used_kernels and plain_clean and hyps_k == hyps_p
        and diff <= score_atol
    )
    line = {"phase": phase, "ok": bool(ok), "kernels": path,
            "tokens_equal": hyps_k == hyps_p, "max_score_diff": diff,
            "score_atol": score_atol,
            "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                           "cudnn": torch.backends.cudnn.allow_tf32}}
    if not ancestry:
        with plain_versions("row_gather"):
            hyps_g, _, scores_g, _ = pipe.transcribe(wavs, lens)
        line["b4_only_plain_tokens_equal"] = hyps_g == hyps_k
        line["b4_only_plain_max_score_diff"] = float(
            np.max(np.abs(scores_k - scores_g))
        )
        line["b4_only_plain_scores_bitwise_equal"] = bool(
            np.array_equal(scores_k, scores_g)
        )
        ok = ok and hyps_g == hyps_k
        line["ok"] = bool(ok)
    emit(line)
    if not ok:
        raise AssertionError(f"{phase}: kernel path and plain path disagree")
    del pipe
    torch.cuda.empty_cache()


def make_relative_lengths(batch, seed=1):
    """Relative lengths from 1.0 down to 0.55, the ones between drawn from
    the seed: utterances of different lengths in one padded batch."""
    rel = np.sort(np.random.default_rng(seed).uniform(0.55, 1.0, batch))
    rel = rel[::-1].copy()
    rel[0], rel[-1] = 1.0, 0.55
    return rel.astype(np.float32)


def run_flash_path(cfg, pipe):
    """``MultiheadAttention(use_pallas=True)`` self-attention, each call
    held against the same module with ``use_pallas=False`` in bf16:

    - over the main path's encoder output of a batch with utterances of
      different lengths, with their key-padding mask;
    - at the shape the JAX package measured its kernel at, (B 16, H 4,
      T 1024, D 64), with no mask and with a causal mask.

    The tolerance of each output element is the larger of ``B2_ATOL`` and
    two bf16 steps at the reference's magnitude, so that it holds at any
    output scale. Both bf16 outputs are also held up against the module in
    float32, for the record.

    Returns the inputs of each launch as the kernel saw them (q, k, v in
    ``_heads`` layout, bias) for the timing phase, and the B2 launches
    counted over the path's runs."""
    gen = torch.Generator().manual_seed(2)
    B = cfg["batch"]
    wavs, _ = make_waveforms(cfg, "cuda")
    lens = torch.from_numpy(make_relative_lengths(B)).cuda()
    with torch.no_grad():
        enc, lens_p = pipe.encode(wavs, lens)
    kpm = get_key_padding_mask(lens_p, enc.shape[1])
    g16 = torch.Generator(device="cuda").manual_seed(3)
    x16 = torch.randn((16, 1024, 256), generator=g16, device="cuda").to(
        torch.bfloat16
    )
    runs = [
        ("encoder_key_padding", cfg["nhead"], cfg["d_model"], enc,
         {"key_padding_mask": kpm}),
        ("jax_shape_no_mask", 4, 256, x16, {}),
        ("jax_shape_causal", 4, 256, x16,
         {"attn_mask": get_lookahead_mask(1024, "cuda")}),
    ]
    rows, shapes, launches = [], [], 0
    atol = B2_ATOL[torch.bfloat16]
    for name, nhead, d_model, x, masks in runs:
        bias = mask_bias(x, masks)
        mha = MultiheadAttention(
            nhead=nhead, d_model=d_model, use_pallas=True, device="cuda",
            dtype=torch.bfloat16, generator=gen,
        ).eval()
        reset_launch_counts()
        with torch.no_grad():
            out, w = mha(x, x, x, **masks)
            torch.cuda.synchronize()
            counts = launch_counts()
            launches += counts["flash_attention"]
            mha.use_pallas = False
            ref, ref_w = mha(x, x, x, **masks)
            mha32 = copy.deepcopy(mha).float()
            ref32 = mha32(x.float(), x.float(), x.float(), **masks)[0]
        diff = (out.float() - ref.float()).abs()
        tol = torch.clamp(2 * bf16_step(ref.float()), min=atol)
        err = diff.max().item()
        ok = (
            counts == {**{n: 0 for n in KERNELS}, "flash_attention": 1}
            and w is None and ref_w is not None
            and out.shape == x.shape and bool(torch.isfinite(out).all())
            and bool((diff <= tol).all())
        )
        rows.append({"run": name, "B_H_T_D": [x.shape[0], nhead, x.shape[1],
                                              d_model // nhead],
                     "bias": None if bias is None else list(bias.shape),
                     "flash_attention_launches": counts["flash_attention"],
                     "max_abs_err_vs_use_pallas_false": err,
                     "max_err_over_tol": (diff / tol).max().item(),
                     "max_abs_out": ref.float().abs().max().item(),
                     "max_abs_err_vs_fp32": {
                         "use_pallas_true":
                             (out.float() - ref32).abs().max().item(),
                         "use_pallas_false":
                             (ref.float() - ref32).abs().max().item()},
                     "ok": bool(ok)})
        del mha32, ref32
        if not ok:
            emit({"phase": "flash_path", "ok": False, "runs": rows})
            raise AssertionError(f"flash path: run {name} failed")
        with torch.no_grad():
            qkv = [mha._heads(proj(x)) for proj in
                   (mha.q_proj, mha.k_proj, mha.v_proj)]
        shapes.append((name, *qkv, bias))
    emit({"phase": "flash_path", "ok": True, "dtype": "bfloat16",
          "tol": f"max({atol}, 2 bf16 steps of |reference|) an element",
          "relative_lengths": lens.tolist(),
          "lens_p": lens_p.tolist(), "runs": rows})
    return shapes, launches


def bf16_step(x):
    """The gap between neighbouring bf16 values at each element's
    magnitude (8 significant bits); float32 ``x``."""
    _, exp = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), exp - 8)


def mask_bias(x, masks):
    """The additive bias ``MultiheadAttention`` hands to the kernel."""
    return make_mask_bias(masks.get("key_padding_mask"),
                          masks.get("attn_mask"), x.dtype)


# -- phase 4: times and bounds ---------------------------------------------

def b1_work(sets, n_pos, D, itemsize):
    """Bytes and operations of one ancestry attention launch that attends
    over ``n_pos`` positions, for these input sets (q, k, v, anc) (the mean
    over them): each cache row that some hypothesis' ancestry points to read
    once (hypotheses that share an ancestor share its row), the ancestry
    entries read, q read and out written; 4 flops per element of K/V a
    hypothesis attends over. Also the bytes if no row were shared."""
    rows = 0
    for _, _, _, anc in sets:
        B, K, _ = anc.shape
        present = torch.zeros((B, K, n_pos), dtype=torch.bool,
                              device=anc.device)
        present.scatter_(1, anc[:, :, :n_pos].long(), True)
        rows += int(present.sum())
    rows /= len(sets)
    rest = B * K * n_pos * 4 + 2 * B * K * D * itemsize
    return (2 * rows * D * itemsize + rest, 4 * B * K * n_pos * D,
            2 * B * K * n_pos * D * itemsize + rest)


def b1_sets(B, K, H, L, hd=64):
    """bf16 input sets of one ancestry attention shape, enough to pass 2x
    the 50 MB L2 when cycled."""
    set_bytes = 2 * B * K * L * H * hd * 2
    n_sets = max(2, -(-120_000_000 // set_bytes))
    return [make_b1_inputs(B, K, H, hd, L, torch.bfloat16, seed=i)
            for i in range(n_sets)]


def measure_b1_at(cfg, steps, max_steps):
    """B1's general instantiation at a family's decoder shape (head dim
    ``d_model / nhead``), bfloat16, at the last step that ran: kernel and
    plain ms, and the bound by the same count as :func:`b1_work`."""
    B, K, H = cfg["batch"], cfg["beam"], cfg["nhead"]
    hd = cfg["d_model"] // H
    L = -(-(max_steps + 1) // CACHE_LENGTH_MULTIPLE) * CACHE_LENGTH_MULTIPLE
    last = steps - 1
    sets = b1_sets(B, K, H, L, hd)
    ms = time_ms(lambda i: beam_attention.ancestry_attention(
        *sets[i], last), len(sets))
    plain_ms = time_ms(lambda i: beam_attention.ancestry_attention_reference(
        *sets[i], last), len(sets), iters=8)
    nbytes, flops, unshared = b1_work(sets, last + 1, H * hd, 2)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bound = max(bytes_ms, flops_ms)
    del sets
    torch.cuda.empty_cache()
    return {"B_K_H_hd_L_step": [B, K, H, hd, L, last], "dtype": "bfloat16",
            "batch_positions":
                beam_attention.kernel_batch_positions(hd, torch.bfloat16),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "ms_over_bound": ms / bound, "bytes": nbytes,
            "bytes_if_no_row_shared": unshared, "flops": flops}


def measure_b1(cfg, steps, max_steps, launches, err):
    """Per-launch time at the main path's two shapes (decoder and LM
    heads), bfloat16, at the last step that ran (the longest history).
    The line's numbers are the mean over one decode step's launches.
    Beside them, and outside the mean, the published decode's shape: beam
    66 over 288 positions with the LM's 12 heads, at its last step."""
    B, K = cfg["batch"], cfg["beam"]
    L = -(-(max_steps + 1) // CACHE_LENGTH_MULTIPLE) * CACHE_LENGTH_MULTIPLE
    last = steps - 1
    shapes = [(cfg["nhead"], cfg["dec_layers"]),
              (cfg["lm_nhead"], cfg["lm_layers"])]
    per_shape = []
    for H, n_layers in shapes:
        D = H * 64
        sets = b1_sets(B, K, H, L)
        n_sets = len(sets)

        def kernel(i, step=last):
            return beam_attention.ancestry_attention(*sets[i], step)

        def plain(i):
            return beam_attention.ancestry_attention_reference(
                *sets[i], last
            )

        nbytes, flops, unshared = b1_work(sets, last + 1, D, 2)
        by_step = {}
        for step in sorted({0, last // 2, last}):
            step_bytes, _, _ = b1_work(sets, step + 1, D, 2)
            step_ms = time_ms(lambda i, s_=step: kernel(i, s_), n_sets)
            bound = step_bytes / PEAK_BYTES_PER_S * 1e3
            by_step[str(step)] = {"ms": step_ms, "bound_ms": bound,
                                  "ms_over_bound": step_ms / bound}
        per_shape.append({
            "H": H, "layers": n_layers,
            "ms": by_step[str(last)]["ms"],
            "ms_over_bound": by_step[str(last)]["ms_over_bound"],
            "eager_call_ms": time_eager_ms(kernel, n_sets),
            "plain_ms": time_ms(plain, n_sets, iters=8),
            "plain_eager_call_ms": time_eager_ms(plain, n_sets, iters=10,
                                                 warmup=2),
            "bytes": nbytes, "bytes_if_no_row_shared": unshared,
            "flops": flops,
            "bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "flops_ms": flops / PEAK_FP32_FLOPS * 1e3,
            "ms_by_step": by_step,
        })
        del sets
        torch.cuda.empty_cache()
    n = sum(s["layers"] for s in per_shape)

    def mean(key):
        return sum(s[key] * s["layers"] for s in per_shape) / n

    bytes_ms, flops_ms = mean("bytes_ms"), mean("flops_ms")
    ms = mean("ms")
    B66, K66, H66, L66 = B, 66, cfg["lm_nhead"], 288
    sets = b1_sets(B66, K66, H66, L66)
    ms66 = time_ms(lambda i: beam_attention.ancestry_attention(
        *sets[i], L66 - 1), len(sets), iters=16)
    bytes66, _, unshared66 = b1_work(sets, L66, H66 * 64, 2)
    bound66 = bytes66 / PEAK_BYTES_PER_S * 1e3
    del sets
    torch.cuda.empty_cache()
    return {
        "name": "ancestry_attention", "route": "cuda",
        "source": "speechbrain_tpu_torch/csrc/beam_attention.cu",
        "replaces": "speechbrain_tpu/ops/beam_attention.py:212",
        "launches": launches, "max_abs_err": err, "ms": ms, "kernel_ms": ms,
        "plain_ms": mean("plain_ms"), "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": None, "ms_over_bound": ms / max(bytes_ms, flops_ms),
        "eager_call_ms": mean("eager_call_ms"),
        "plain_eager_call_ms": mean("plain_eager_call_ms"),
        "timed_at_step": last, "dtype": "bfloat16", "per_shape": per_shape,
        "beam66": {"B_K_H_L_step": [B66, K66, H66, L66, L66 - 1],
                   "ms": ms66, "bytes": bytes66,
                   "bytes_if_no_row_shared": unshared66, "bound_ms": bound66,
                   "bound_by": "bytes", "ms_over_bound": ms66 / bound66},
    }


def ptxas_report(kernel):
    """ptxas's registers and spill line for ``kernel`` from the last build
    of the kernels' library (``-Xptxas -v``), one entry an instantiation;
    empty when this process found the library already built."""
    log = _build.BUILD_DIR / "build.log"
    if not log.exists():
        return []
    lines = log.read_text().splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Function properties for" in line and kernel in line:
            out.append(" ".join(x.strip() for x in lines[i + 1:i + 3]))
    return out


def b3_bound(fused, B, T):
    """The least time ``fused`` (a fused ``Fbank``) could take on (B, T)
    waveforms: the larger of its bytes (waveform, window and mel matrix
    read once, output written once) at the memory's rate, and the least
    arithmetic it needs at the float32 CUDA-core peak: a real FFT a frame
    (2.5 n_fft log2 n_fft, half the usual count of a complex FFT), the
    power and the mel projection's non-zero multiply-adds."""
    hop = fused.compute_STFT.hop_length
    n_fft = fused.compute_STFT.n_fft
    n_freq = n_fft // 2 + 1
    n_mels = fused.compute_fbanks.fbank_matrix.shape[1]
    frames = B * (1 + T // hop)
    mel_nnz = int(torch.count_nonzero(fused.compute_fbanks.fbank_matrix))
    nbytes = 4 * (B * T + frames * n_mels + n_fft + n_freq * n_mels)
    least_flops = frames * (2.5 * n_fft * np.log2(n_fft) + 3 * n_freq
                            + 2 * mel_nnz)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = least_flops / PEAK_FP32_FLOPS * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "least_flops": least_flops,
            "mel_nonzeros": mel_nnz, "frames": frames}


def time_b3(fused, B, T, iters=32):
    """B3 on (B, T) waveforms by CUDA-graph replay, waveforms cycled past
    the L2 cache (at least 16 sets and 80 MB), beside its plain version
    and the port's unfused ``Fbank`` (rfft on cuFFT, a product and a log:
    a yardstick, not a library call computing the same function)."""
    unfused = Fbank(n_mels=fused.compute_fbanks.fbank_matrix.shape[1],
                    fused=False)
    n_sets = max(16, -(-80_000_000 // (4 * B * T)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    wavs = [torch.randn((B, T), generator=gen, device="cuda")
            for _ in range(n_sets)]
    ms = time_ms(lambda i: fused(wavs[i]), n_sets, iters=iters)
    eager_ms = time_eager_ms(lambda i: fused(wavs[i]), n_sets, iters=iters)
    with plain_versions():
        plain_ms = time_ms(lambda i: fused(wavs[i]), n_sets, iters=16)
    unfused_ms = time_ms(lambda i: unfused(wavs[i]), n_sets, iters=16)
    return {"ms": ms, "plain_ms": plain_ms, "unfused_ms": unfused_ms,
            "eager_call_ms": eager_ms}


def measure_b3(cfg, launches, err):
    """B3 at the main path's shape, (8, 160000) at hop 160 (``time_b3``;
    ``bound_ms`` from ``b3_bound``). ``design_dft_tf32_ms`` is the dense
    DFT this design computes, counted once at the TF32 tensor-core peak
    (its three passes take three times that), with the mel projection: a
    figure for the design, not a bound. ``bound_fp32_cuda_core_ms`` is
    the bound of the earlier CUDA-core design, kept so that its readings
    stay comparable: the dense work at the float32 CUDA-core peak.
    ``l2_table_bytes`` is computed (blocks x the kernel's table bytes),
    not measured."""
    B, T = cfg["batch"], int(SR * cfg["seconds"])
    fused = Fbank(n_mels=cfg["n_mels"], fused=True)
    times = time_b3(fused, B, T)
    ms = times["ms"]
    bound = b3_bound(fused, B, T)

    n_fft = fused.compute_STFT.n_fft
    n_freq = n_fft // 2 + 1
    n_mels = cfg["n_mels"]
    frames = bound["frames"]
    n_frames = frames // B
    ops = fused._operands
    mel_nnz = bound["mel_nonzeros"]
    dft_flops = 2 * frames * n_fft * 2 * n_freq
    mel_flops = 2 * frames * mel_nnz
    design_ms = (dft_flops / PEAK_TF32_TENSOR_FLOPS
                 + mel_flops / PEAK_FP32_FLOPS) * 1e3
    # the earlier design's bound: every multiply-add of the dense DFT and
    # mel product on the float32 CUDA cores
    fp32_flops = frames * (2 * 2 * n_fft * n_freq + 2 * n_freq * n_mels)
    fp32_bytes = (B * T * 4 + frames * n_mels * 4
                  + 2 * n_fft * n_freq * 4 + n_freq * n_mels * 4)
    bound_fp32 = max(fp32_flops / PEAK_FP32_FLOPS,
                     fp32_bytes / PEAK_BYTES_PER_S) * 1e3
    smem, stages, fpb = b3_layout(fused)
    blocks = B * -(-n_frames // fpb)
    table_bytes = 4 * (ops.tables.numel() + ops.mel_ranges.numel()
                       + ops.mel_weights.numel())
    return {
        "name": "fused_fbank", "route": "cuda",
        "source": "speechbrain_tpu_torch/csrc/mel_frontend.cu",
        "replaces": "speechbrain_tpu/ops/mel_frontend.py:187",
        "launches": launches, "max_abs_err": err, "ms": ms, "kernel_ms": ms,
        "plain_ms": times["plain_ms"], "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"],
        "library_ms": None, "unfused_ms": times["unfused_ms"],
        "ms_over_bound": ms / bound["bound_ms"],
        "design_dft_tf32_ms": design_ms,
        "bound_fp32_cuda_core_ms": bound_fp32,
        "eager_call_ms": times["eager_call_ms"],
        "bytes": bound["bytes"], "least_flops": bound["least_flops"],
        "dft_flops": dft_flops, "mel_flops": mel_flops,
        "mel_nonzeros": mel_nnz, "tf32_passes": 3,
        "l2_table_bytes": blocks * table_bytes,
        "l2_table_bytes_is": "computed: blocks x table bytes, not measured",
        "table_bytes": table_bytes, "blocks": blocks, "frames_a_block": fpb,
        "smem_bytes": smem, "ring_stages": stages,
        "ptxas": ptxas_report("fused_fbank_kernel"),
        "note": "ms, plain_ms and unfused_ms include the top_db clamp",
    }


def measure_b3_at(B, T, n_mels=80):
    """B3 at another shape (``recipe_path``'s batches), with its bound."""
    fused = Fbank(n_mels=n_mels, fused=True)
    out = {"shape": [B, T], **time_b3(fused, B, T), **b3_bound(fused, B, T)}
    out["ms_over_bound"] = out["ms"] / out["bound_ms"]
    return out


def cycled_sets(tensors, min_bytes=120_000_000):
    """Copies of ``tensors`` (same strides) enough to pass 2x the 50 MB L2
    when cycled, so that each timed launch finds its inputs in device
    memory; returns the list of sets."""
    set_bytes = sum(t.numel() * t.element_size() for t in tensors
                    if t is not None)
    n_sets = max(2, -(-min_bytes // set_bytes))
    return [tensors] + [
        [None if t is None else t.clone() for t in tensors]
        for _ in range(n_sets - 1)
    ]


def misaligned_copy(bias):
    """The same bias with its rows 4 elements apart more, so that no row
    after the first starts 16-byte aligned: the kernel then reads it from
    device memory, each thread its own elements, instead of through its
    ring."""
    shape = (*bias.shape[:-1], bias.shape[-1] + 4)
    padded = torch.empty(shape, dtype=bias.dtype, device=bias.device)
    padded = padded[..., :bias.shape[-1]]
    padded.copy_(bias)
    return padded


def measure_b2(shapes, launches, err):
    """Per-launch time at the flash path's three shapes, bfloat16, with the
    bias each run gave the kernel (and, where there is one, with the same
    bias read by each thread from device memory instead of through the
    kernel's ring). The line's numbers are the mean over the path's
    launches (one at each shape)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    per_shape = []
    for name, q, k, v, bias in shapes:
        sets = cycled_sets([q, k, v, bias])
        n = len(sets)

        def kernel(i):
            return attention.flash_attention(*sets[i])

        def plain(i):
            return attention.flash_attention_reference(*sets[i])

        def library(i):
            q_, k_, v_, b_ = sets[i]
            return sdpa(q_, k_, v_, attn_mask=b_)

        B, H, Tq, D = q.shape
        Tk = k.shape[2]
        item = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * item + (
            0 if bias is None else bias.numel() * bias.element_size()
        )
        flops = 4 * B * H * Tq * Tk * D
        direct_ms = None
        if bias is not None:
            direct = cycled_sets([q, k, v, misaligned_copy(bias)])
            direct_ms = time_ms(
                lambda i: attention.flash_attention(*direct[i]), len(direct),
                iters=24,
            )
            del direct
        ms = time_ms(kernel, n, iters=24)
        library_ms = time_ms(library, n, iters=24)
        per_shape.append({
            "run": name, "B_H_Tq_Tk_D": [B, H, Tq, Tk, D],
            "bias": None if bias is None else list(bias.shape),
            "ms": ms, "tflops": flops / ms / 1e9,
            "ms_over_library": ms / library_ms,
            "bias_read_direct_ms": direct_ms,
            "eager_call_ms": time_eager_ms(kernel, n, iters=24),
            "plain_ms": time_ms(plain, n, iters=8),
            "library_ms": library_ms,
            "bytes": nbytes, "flops": flops,
            "bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "flops_ms": flops / PEAK_BF16_TENSOR_FLOPS * 1e3,
        })
        del sets
        torch.cuda.empty_cache()

    for row in per_shape:
        row["bound_ms"] = max(row["bytes_ms"], row["flops_ms"])
        row["bound_by"] = (
            "bytes" if row["bytes_ms"] >= row["flops_ms"] else "operations"
        )
        row["ms_over_bound"] = row["ms"] / row["bound_ms"]

    def mean(key):
        return sum(s[key] for s in per_shape) / len(per_shape)

    # the line's bound is the mean of the launches' own bounds; it is "by"
    # what bounds the larger part of their sum
    total = sum(s["bound_ms"] for s in per_shape)
    by_ops = sum(s["bound_ms"] for s in per_shape
                 if s["bound_by"] == "operations")
    bound_ms = total / len(per_shape)
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "speechbrain_tpu_torch/csrc/flash_attention.cu",
        "replaces": "speechbrain_tpu/ops/attention.py:111",
        "launches": launches, "max_abs_err": err, "ms": mean("ms"),
        "plain_ms": mean("plain_ms"), "bound_ms": bound_ms,
        "bound_by": "operations" if 2 * by_ops >= total else "bytes",
        "library_ms": mean("library_ms"),
        "ms_over_bound": mean("ms") / bound_ms,
        "ms_over_library": mean("ms") / mean("library_ms"),
        "library_call": "torch.nn.functional.scaled_dot_product_attention "
                        "with the same float bias (timed only)",
        "eager_call_ms": mean("eager_call_ms"), "dtype": "bfloat16",
        "peak_for_bound": "989 TFLOP/s bf16 dense tensor cores, 3.35 TB/s",
        "per_shape": per_shape,
    }


def measure_b4(cfg, perm, err):
    """Per-launch time at the permuting search's two cache shapes (decoder
    and LM self-attention K/V buffers, bf16), gathered by int64
    predecessors that stay within each utterance's beams, as the search's
    are. The line's numbers are the mean over one decode step's 36
    launches."""
    B, K = cfg["batch"], cfg["beam"]
    L = -(-(perm["max_steps"] + 1) // CACHE_LENGTH_MULTIPLE) * (
        CACHE_LENGTH_MULTIPLE
    )
    rng = np.random.default_rng(6)
    shapes = [(cfg["d_model"], 2 * cfg["dec_layers"]),
              (cfg["lm_d_model"], 2 * cfg["lm_layers"])]
    per_shape = []
    for D, per_step in shapes:
        gen = torch.Generator(device="cuda").manual_seed(D)
        x = torch.randn((B * K, L, D), generator=gen, device="cuda").to(
            torch.bfloat16
        )
        idx = torch.from_numpy(
            (rng.integers(0, K, (B, K)) + np.arange(B)[:, None] * K)
            .reshape(-1)
        ).cuda()
        sets = cycled_sets([x, idx])
        n = len(sets)
        nbytes = 2 * x.numel() * x.element_size() + idx.numel() * 8
        per_shape.append({
            "shape": [B * K, L, D], "launches_per_step": per_step,
            "ms": time_ms(lambda i: gather.row_gather(*sets[i]), n),
            "eager_call_ms": time_eager_ms(
                lambda i: gather.row_gather(*sets[i]), n
            ),
            "plain_ms": time_ms(
                lambda i: gather.row_gather_reference(*sets[i]), n
            ),
            "library_ms": time_ms(
                lambda i: torch.index_select(sets[i][0], 0, sets[i][1]), n
            ),
            "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
        })
        del sets, x
        torch.cuda.empty_cache()
    n = sum(s["launches_per_step"] for s in per_shape)

    def mean(key):
        return sum(s[key] * s["launches_per_step"] for s in per_shape) / n

    launches = perm["launches"]["row_gather"]
    return {
        "name": "row_gather", "route": "cuda",
        "source": "speechbrain_tpu_torch/csrc/row_gather.cu",
        "replaces": "speechbrain_tpu/ops/gather.py:88",
        "launches": launches, "max_abs_err": err, "ms": mean("ms"),
        "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
        "bound_by": "bytes", "library_ms": mean("library_ms"),
        "library_call": "torch.index_select (timed only; the plain version "
                        "is the same call)",
        "eager_call_ms": mean("eager_call_ms"), "dtype": "bfloat16",
        "permute_decode_ms": perm["decode_ms"],
        "share_of_permute_decode": launches * mean("ms") / perm["decode_ms"],
        "per_shape": per_shape,
    }


def profile_decode(cfg):
    """``--profile`` only: one encode of the main path under
    ``torch.profiler``, which must launch the B3 kernel exactly once, then
    one beam search; device time by kernel, and the device's busy share
    of the search's wall time as measured without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wavs, lens = make_waveforms(cfg, "cuda")
    pipe = Pipeline(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    pipe.transcribe(wavs, lens)
    pipe.transcribe(wavs, lens)
    decode_ms, steps = pipe.last_decode_ms, pipe.searcher.last_steps
    # the encode alone: B3's device launches in one Fbank call
    calls = pipe.fbank_calls
    with profile(activities=[ProfilerActivity.CUDA]) as prof_enc:
        enc, lens_p = pipe.encode(wavs, lens)
        torch.cuda.synchronize()
    fbank_calls = pipe.fbank_calls - calls
    b3_kernels = [(e.key, e.count) for e in prof_enc.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and "fused_fbank" in e.key]
    b3_launches = sum(n for _, n in b3_kernels)
    emit({"phase": "profile_encode", "fbank_calls": fbank_calls,
          "fused_fbank_device_launches": b3_launches,
          "kernels": [[k[:80], n] for k, n in b3_kernels]})
    if fbank_calls != 1 or b3_launches != 1:
        raise AssertionError(
            f"one encode made {b3_launches} B3 launches in {fbank_calls} "
            "Fbank calls, not one"
        )
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        pipe.searcher(enc, lens_p)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, e.count, us))
    rows.sort(key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows) / 1e3
    n_kernels = sum(r[1] for r in rows)
    if device_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    emit({
        "phase": "profile_decode", "steps": steps,
        "decode_ms_unprofiled": decode_ms, "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / decode_ms,
        "device_kernels": n_kernels, "kernels_per_step": n_kernels / steps,
        "top_kernels_name_count_ms": [
            [r[0][:80], r[1], r[2] / 1e3] for r in rows[:12]
        ],
    })


def profile_serve(cfg, repeats=3):
    """``--profile`` only: does the entry point add host time over the
    assembly it wraps? Over the same bf16 modules: ``Pipeline.encode``
    against ``EncoderDecoderASR.encode_batch`` (the ``LengthsCapableSequential``),
    alternated ``4 * repeats`` times, wall ms of each; the tokenizer's
    decoding of the batch's hypotheses, on the host; whole
    ``Pipeline.transcribe`` against ``transcribe_batch`` calls, alternated
    ``repeats`` times (the decode's host-bound loop spreads them wider than
    the difference); then one ``transcribe_batch`` under
    ``torch.profiler``: device kernel time against its median wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wavs, lens = make_waveforms(cfg, "cuda")
    pipe = Pipeline(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    with tempfile.TemporaryDirectory() as tok_dir:
        write_covering_bpe(tok_dir, cfg["vocab"])
        tokenizer = SentencePiece(tok_dir, cfg["vocab"], model_type="bpe")
    asr = served_asr(pipe, tokenizer)

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(wavs, lens)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    wall_ms(pipe.transcribe)
    _, hyps = asr.transcribe_batch(wavs, lens)
    enc_pipe_ms, enc_entry_ms = [], []
    for _ in range(4 * repeats):
        enc_pipe_ms.append(wall_ms(pipe.encode))
        enc_entry_ms.append(wall_ms(asr.encode_batch))
    t0 = time.perf_counter()
    for tokens in hyps:
        tokenizer.decode_ids(tokens)
    words_ms = (time.perf_counter() - t0) * 1e3
    pipe_ms, entry_ms = [], []
    for _ in range(repeats):
        pipe_ms.append(wall_ms(pipe.transcribe))
        entry_ms.append(wall_ms(asr.transcribe_batch))
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        asr.transcribe_batch(wavs, lens)
        torch.cuda.synchronize()
    device_us = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            device_us += e.self_cuda_time_total if us is None else us
    entry_median = float(np.median(entry_ms))
    emit({
        "phase": "profile_serve", "repeats": repeats,
        "encode_median_ms": {"pipeline": float(np.median(enc_pipe_ms)),
                             "entry_point": float(np.median(enc_entry_ms))},
        "encode_ms": {"pipeline": enc_pipe_ms, "entry_point": enc_entry_ms},
        "tokenizer_decode_ms": words_ms,
        "pipeline_transcribe_ms": pipe_ms,
        "entry_point_transcribe_batch_ms": entry_ms,
        "median_ms": {"pipeline": float(np.median(pipe_ms)),
                      "entry_point": entry_median},
        "entry_minus_pipeline_median_ms":
            entry_median - float(np.median(pipe_ms)),
        "device_kernel_ms": device_us / 1e3,
        "device_busy_share": device_us / 1e3 / entry_median,
        "steps": asr.hparams.decoder.searcher.last_steps,
    })


def profile_train(cfg, out_dir, datasets, steps=2, host=False):
    """``--profile`` only: ``steps`` optimizer steps of the train path
    (with ``host``, one epoch of ``host_path``'s loop: dynamic batches,
    four read-ahead threads, pinned batches, the loss read every four
    micro-batches) timed without the profiler (after two warm-up steps,
    or a warm-up epoch), then the same again under ``torch.profiler``:
    device time by kernel, B3's share, and the device's busy share of the
    unprofiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    name = "profile_host" if host else "profile_train"
    out_dir = os.path.join(out_dir, name)  # no checkpoint to recover
    os.makedirs(out_dir)
    gaf = cfg["grad_accumulation_factor"]
    if host:
        brain = train_brain(cfg, out_dir, brain_cls=ASR, run_opts={
            "loss_sync_interval": HOST["loss_sync_interval"]})
        loader = make_dataloader(
            datasets["train"], pin_memory=True,
            **host_loader_kwargs(cfg, datasets["train"]))
    else:
        brain = train_brain(cfg, out_dir, brain_cls=ASR)
        loader = make_dataloader(datasets["train"],
                                 **asr_loader_kwargs(cfg, shuffle=True))
    brain.on_fit_start()
    brain.modules.train()

    def epochs():
        for epoch in itertools.count(1):
            loader.set_epoch(epoch)
            yield from loader

    batches = epochs()

    def run(n_steps):
        for _ in range(n_steps * gaf):
            brain.fit_batch(next(batches))
        torch.cuda.synchronize()

    if host:
        # one whole epoch a run, the timed and the traced run the same
        # epoch's batches through the loader's threads
        def run(epoch):
            loader.set_epoch(epoch)
            for batch in loader:
                brain.fit_batch(batch)
            torch.cuda.synchronize()

        steps = len(loader) / gaf
    run(2)
    t0 = time.perf_counter()
    run(steps if not host else 3)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(steps if not host else 3)
    # device activity by name: kernels and copies, not the annotations
    # (the optimizer's step) that the profiler mirrors onto the device
    by_name = {}
    for e in prof.events():
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    rows = sorted(((k, n, us) for k, (n, us) in by_name.items()),
                  key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows) / 1e3
    if device_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    b3 = [r for r in rows if "fused_fbank" in r[0]]
    emit({
        "phase": name, "optimizer_steps": steps,
        "micro_batches": steps * gaf,
        "wall_ms_unprofiled": wall_ms, "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "device_kernels": sum(r[1] for r in rows),
        "fused_fbank_launches": sum(r[1] for r in b3),
        "fused_fbank_ms": sum(r[2] for r in b3) / 1e3,
        "top_kernels_name_count_ms": [
            [r[0][:80], r[1], r[2] / 1e3] for r in rows[:15]
        ],
    })


# -- the training path --------------------------------------------------

class TimedASR(ASR):
    """The recipe's Brain with the readings of ``train_path``: forward
    passes a stage, each epoch's train loss, the optimizer steps' times by
    CUDA events (from the first micro-batch of an accumulation window to
    its update), the train stages' wall time and their audio seconds. It
    saves no checkpoint after each valid stage (1.3 GB at full width);
    ``train_checks`` saves and recovers one."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.forwards = {Stage.TRAIN: 0, Stage.VALID: 0}
        self.epoch_losses = []
        self.step_events = []
        self.train_seconds = 0.0
        self.audio_seconds = 0.0

    def compute_forward(self, batch, stage):
        self.forwards[stage] = self.forwards.get(stage, 0) + 1
        return super().compute_forward(batch, stage)

    def on_stage_start(self, stage, epoch=None):
        if stage == Stage.TRAIN:
            torch.cuda.synchronize()
            self._t0 = time.perf_counter()

    def on_fit_batch_start(self, batch):
        sig = batch["sig"]
        self.audio_seconds += float(sig.lengths.sum()) * sig.data.shape[1] / SR
        if self._micro_step % self.run_opts.grad_accumulation_factor == 0:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self.step_events.append([start, None])

    def on_fit_batch_end(self, batch, outputs, loss, should_step):
        super().on_fit_batch_end(batch, outputs, loss, should_step)
        if should_step:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.step_events[-1][1] = end

    def on_stage_end(self, stage, stage_loss, epoch=None):
        if stage == Stage.TRAIN:
            torch.cuda.synchronize()
            self.train_seconds += time.perf_counter() - self._t0
            self.epoch_losses.append(stage_loss)
        else:
            self.log_stats(stage_loss, epoch)

    def step_ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.step_events if b]


def train_brain(cfg, out_dir, modules_seed=0, brain_cls=TimedASR,
                device="cuda", run_opts=None):
    """The recipe's Brain at ``cfg`` on the card, with a checkpointer of
    the Noam scheduler and the epoch counter (the Brain adds itself, the
    modules, the optimizer and the train loader); ``run_opts`` adds to
    the recipe's."""
    hparams = make_asr_hparams(cfg, out_dir, device=device)
    checkpointer = Checkpointer(
        os.path.join(out_dir, "save"),
        {"noam_scheduler": hparams["noam_scheduler"],
         "counter": hparams["epoch_counter"]},
    )
    return brain_cls(
        modules=make_asr_modules(cfg, device=device, seed=modules_seed),
        opt_class=adamw(cfg), hparams=hparams,
        run_opts={"device": device, "precision": cfg["precision"],
                  "grad_accumulation_factor":
                      cfg["grad_accumulation_factor"],
                  "max_grad_norm": cfg["max_grad_norm"],
                  "noprogressbar": True, "seed": 2024, **(run_opts or {})},
        checkpointer=checkpointer,
    )


def run_train_path(cfg, out_dir, datasets, device="cuda"):
    """``Brain.fit`` of the recipe at full width for ``cfg["epochs"]``
    epochs, bf16 autocast, accumulation 2: kernel B3 must launch once a
    forward pass, train and valid, and no other kernel at all."""
    brain = train_brain(cfg, out_dir, device=device)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    brain.fit(brain.hparams.epoch_counter, datasets["train"],
              datasets["valid"],
              train_loader_kwargs=asr_loader_kwargs(cfg, shuffle=True),
              valid_loader_kwargs=asr_loader_kwargs(cfg, shuffle=False))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = launch_counts()
    n_train = brain.forwards[Stage.TRAIN]
    n_valid = brain.forwards[Stage.VALID]
    per_epoch = (-(-cfg["n_train"] // cfg["batch_size"]),
                 -(-cfg["n_valid"] // cfg["batch_size"]))
    step_ms = brain.step_ms()
    expected = dict.fromkeys(KERNELS, 0)
    expected["fused_fbank"] = n_train + n_valid
    ok = (
        counts == expected
        and (n_train, n_valid) == tuple(cfg["epochs"] * n for n in per_epoch)
        and brain.optimizer_step == n_train // cfg["grad_accumulation_factor"]
        and len(step_ms) == brain.optimizer_step
        and all(np.isfinite(brain.epoch_losses))
    )
    emit({
        "phase": "train_path", "ok": bool(ok),
        "recipe": "recipes/LibriSpeech/ASR/transformer/train.py with "
                  "hparams/conformer_large.yaml",
        "config": {k: v for k, v in cfg.items()}, "reduced": TRAIN_REDUCED,
        "precision": "bf16 autocast, float32 parameters",
        "micro_batches": n_train, "valid_batches": n_valid,
        "optimizer_steps": brain.optimizer_step,
        "fused_fbank_launches": counts["fused_fbank"],
        "expected_launches": expected,
        "step_ms_median_after_2": float(np.median(step_ms[2:])),
        "step_ms_min_max_after_2": [float(min(step_ms[2:])),
                                    float(max(step_ms[2:]))],
        "train_seconds": brain.train_seconds,
        "train_audio_seconds": brain.audio_seconds,
        "train_audio_seconds_per_second":
            brain.audio_seconds / brain.train_seconds,
        "fit_seconds": fit_s,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "first_epoch_train_loss": brain.epoch_losses[0],
        "last_epoch_train_loss": brain.epoch_losses[-1],
        "epoch_train_losses": brain.epoch_losses,
        "gpu_name_power_limit": gpu_name_power_limit(),
    })
    if not ok:
        raise AssertionError("train_path: a check of the fit failed")
    return brain


# -- phase: the training loop's host side ------------------------------------

# host_path: TRAIN (above) through the host side a user of a real corpus
# configures: batches of at most 160 s of audio from four length buckets,
# drawn in a random order (DynamicBatchSampler), read ahead by four
# threads through the native WAV decoder, and the train loss read by the
# host once every four micro-batches (loss_sync_interval).
# two epochs since PR 12 (three before), so that the script stays within its
# time
HOST = dict(max_batch_length=160.0, num_buckets=4, num_workers=4,
            loss_sync_interval=4, epochs=2, fp32_micro_batches=8)
HOST_REDUCED = {
    "number_of_epochs": "120 -> 2 epochs of TRAIN's 32 utterances",
    "fp32_read_check": "8 micro-batches a run, dropout 0",
}
# the k = 4 window means against the k = 1 per-step means, float32 runs
# from the same weights: the same arithmetic but for cuDNN's and the
# atomics' order, so a few float32 roundings of a loss of about 10
HOST_LOSS_RTOL = 1e-4
WER_PAIRS = 2620  # LibriSpeech test-clean's utterances


class HostASR(TimedASR):
    """``TimedASR`` that also keeps each train epoch's batches' ids, and
    the peak memory of each micro-batch by its shape (batch, padded
    seconds)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.epoch_batches = []
        self.peak_by_shape = {}

    def on_stage_start(self, stage, epoch=None):
        super().on_stage_start(stage, epoch)
        if stage == Stage.TRAIN:
            self.epoch_batches.append([])

    def on_fit_batch_start(self, batch):
        super().on_fit_batch_start(batch)
        self.epoch_batches[-1].append(list(batch.id))
        torch.cuda.reset_peak_memory_stats()

    def on_fit_batch_end(self, batch, outputs, loss, should_step):
        super().on_fit_batch_end(batch, outputs, loss, should_step)
        shape = f"{len(batch)} x {batch.sig.data.shape[1] / SR:g} s"
        self.peak_by_shape[shape] = max(self.peak_by_shape.get(shape, 0),
                                        torch.cuda.max_memory_allocated())


def host_loader_kwargs(cfg, dataset, seed=42):
    """The host path's train loader: dynamic batches, four threads."""
    return {"batch_sampler": DynamicBatchSampler(
                dataset, HOST["max_batch_length"],
                num_buckets=HOST["num_buckets"],
                length_func=lambda x: x["length"], shuffle=True,
                batch_ordering="random", seed=seed),
            "num_workers": HOST["num_workers"],
            "pad_to_multiple": {"sig": cfg["sig_multiple"]}}


def write_wav_encoded(path, wav, sr, fmt, bits):
    """``wav`` (float, mono) as a WAV file of IEEE float32 (``fmt`` 3) or
    ``bits``-bit PCM (``fmt`` 1), header written byte by byte (the
    ``wave`` module writes neither float nor, before Python 3.12, 24-bit
    files)."""
    if fmt == 3:
        data = np.asarray(wav, "<f4").tobytes()
    else:
        q = np.clip(np.round(np.asarray(wav, np.float64) * 2 ** (bits - 1)),
                    -2 ** (bits - 1), 2 ** (bits - 1) - 1).astype("<i4")
        data = np.stack([(q >> s) & 0xFF for s in range(0, bits, 8)], -1) \
            .astype(np.uint8).tobytes()
    block = bits // 8
    body = (b"WAVE" + b"fmt " + struct.pack("<IHHIIHH", 16, fmt, 1, sr,
                                             sr * block, block, bits)
            + b"data" + struct.pack("<I", len(data)) + data)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def check_native_wav(manifests, out_dir):
    """Check 7: every corpus file through the native decoder equals the
    ``wave`` module's bytes as numpy decodes them, bit for bit; a 24-bit
    and a float file of the first utterance read back within one
    quantisation step. Returns the check's record."""
    import wave

    paths = [u["wav"] for m in manifests.values()
             for u in json.load(open(m)).values()]
    equal, t_native, t_wave = True, 0.0, 0.0
    for path in paths:
        t0 = time.perf_counter()
        ours = read_audio(path)
        t1 = time.perf_counter()
        with wave.open(path, "rb") as w:
            ref = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        ref = ref.astype(np.float32) / 32768.0
        t2 = time.perf_counter()
        equal = equal and np.array_equal(ours, ref)
        t_native += t1 - t0
        t_wave += t2 - t1
    wav = read_audio(paths[0])
    errs = {}
    for name, fmt, bits, step in (("pcm24", 1, 24, 2.0 ** -23),
                                  ("float32", 3, 32, 0.0)):
        path = os.path.join(out_dir, f"encoded_{name}.wav")
        write_wav_encoded(path, wav, SR, fmt, bits)
        err = float(np.abs(read_audio(path) - wav).max())
        errs[name] = {"max_abs_err": err, "limit": step,
                      "ok": err <= step}
    return {"files": len(paths), "bit_equal_to_wave_numpy": bool(equal),
            "native_ms": t_native * 1e3, "wave_numpy_ms": t_wave * 1e3,
            "encoded": errs,
            "ok": bool(equal and all(e["ok"] for e in errs.values()))}


def check_native_wer(wer_metric):
    """Check 8: ``recipe_path``'s test WER counted again by the native
    core (``accumulatable_wer_stats``) equals the pure-Python DP's counts
    (``ErrorRateStats``); then both timed on the host over WER_PAIRS
    synthetic pairs of about 20 words."""
    refs = [d["ref_tokens"] for d in wer_metric.scores]
    hyps = [d["hyp_tokens"] for d in wer_metric.scores]
    native = accumulatable_wer_stats(refs, hyps)
    dp = wer_metric.summarize()
    keys = ("insertions", "deletions", "substitutions")
    same = (all(native[k] == dp[k] for k in keys)
            and native["num_ref_tokens"] == dp["num_scored_tokens"])
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(800)]
    refs = [[words[i] for i in rng.integers(0, 800, rng.integers(15, 26))]
            for _ in range(WER_PAIRS)]
    hyps = [[w if rng.random() > 0.15 else words[rng.integers(0, 800)]
             for w in r if rng.random() > 0.05] for r in refs]
    t0 = time.perf_counter()
    native_big = accumulatable_wer_stats(refs, hyps)
    t1 = time.perf_counter()
    dp_ops = [count_ops(op_table(r, h)) for r, h in zip(refs, hyps)]
    t2 = time.perf_counter()
    same_big = all(native_big[k] == sum(o[k] for o in dp_ops)
                   for k in keys)
    return {"recipe_pairs": len(wer_metric.scores),
            "recipe_counts_native": {k: native[k] for k in keys},
            "recipe_counts_dp": {k: dp[k] for k in keys},
            "recipe_WER": native["WER"],
            "synthetic_pairs": WER_PAIRS, "synthetic_WER": native_big["WER"],
            "native_ms": (t1 - t0) * 1e3, "dp_ms": (t2 - t1) * 1e3,
            "ok": bool(same and same_big)}


def count_syncs(fn):
    """``fn()``'s result and the synchronizing CUDA calls it made
    (``torch.cuda.set_sync_debug_mode``), counted by the Python line that
    made them."""
    import collections
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return out, sites


def fp32_host_brain(cfg, k, device):
    """The recipe's Brain in float32, dropout 0, seed-1 weights, with
    ``loss_sync_interval`` k, its optimizer built."""
    brain = ASR(modules=make_asr_modules(cfg, device=device, seed=1,
                                         dropout=0.0),
                opt_class=adamw(cfg),
                hparams=make_asr_hparams(cfg, device=device),
                run_opts={"device": device, "precision": "fp32",
                          "grad_accumulation_factor":
                              cfg["grad_accumulation_factor"],
                          "max_grad_norm": cfg["max_grad_norm"],
                          "loss_sync_interval": k, "seed": 2024})
    brain.init_optimizers()
    brain.modules.train()
    return brain


def check_loss_reads_nan_window_averaging(cfg, batches, out_dir, device):
    """Checks 3, 4 and 6 on float32 Brains from the same weights: the
    k = 4 window means against the k = 1 per-step means; a window of two
    NaN micro-batches leaving every parameter and AdamW tensor as it was;
    ``load_averaged_checkpoints(2)`` of the weights before and after the
    steps against their float64 mean. Counts the synchronizing calls a
    window for k = 1 and k = 4."""
    gaf = cfg["grad_accumulation_factor"]
    n = len(batches)
    reads, syncs, sync_sites = {}, {}, {}
    for k in (1, HOST["loss_sync_interval"]):
        brain = fp32_host_brain(cfg, k, device)
        if k > 1:
            ckpt = Checkpointer(os.path.join(out_dir, "avg"),
                                {"modules": brain.modules})
            brain.checkpointer = ckpt
            ckpt.save_checkpoint(meta={"step": 0})

        def run():
            out = [brain.fit_batch(copy.copy(b)) for b in batches]
            out.append(brain._flush_pending_loss())
            return out

        reads[k], sites = count_syncs(run)
        torch.cuda.synchronize()
        syncs[k] = sum(sites.values())
        sync_sites[k] = dict(sites.most_common(12))
        if k == 1:
            del brain
            torch.cuda.empty_cache()
    per_step = [x for x in reads[1] if x is not None]
    k = HOST["loss_sync_interval"]
    windows = [x for x in reads[k] if x is not None]
    rel = [abs(m - float(np.mean(per_step[i * k:(i + 1) * k])))
           / abs(float(np.mean(per_step[i * k:(i + 1) * k])))
           for i, (m, _) in enumerate(windows)]
    loss_reads = {
        "per_step_k1": per_step, "window_means_k4": [m for m, _ in windows],
        "max_rel_diff": max(rel), "rtol": HOST_LOSS_RTOL,
        "host_reads": {"k1": len(per_step), "k4": len(windows)},
        "sync_calls": {"k1": syncs[1], "k4": syncs[k]},
        "sync_calls_a_window": {"k1": syncs[1] * gaf / n,
                                "k4": syncs[k] * gaf / n},
        "sync_sites": {"k1": sync_sites[1], "k4": sync_sites[k]},
        "ok": len(per_step) == n and len(windows) == n // k
        and all(c == k for _, c in windows) and max(rel) <= HOST_LOSS_RTOL,
    }

    # 4: a window of NaN micro-batches
    params = [p.detach().clone() for p in brain.modules.parameters()]
    state = {(i, key): v.clone()
             for i, st in enumerate(brain.optimizer.state.values())
             for key, v in st.items() if torch.is_tensor(v)}
    window = [w.clone() for w in brain._window]
    count = brain._window_count.clone()
    bad = copy.copy(batches[0])
    bad.sig = bad.sig._replace(data=torch.full_like(bad.sig.data, np.nan))
    for _ in range(gaf):
        brain.fit_batch(copy.copy(bad))
    drained = brain._drain_loss_accum()
    same_params = all(torch.equal(p, q) for p, q in
                      zip(brain.modules.parameters(), params))
    same_state = all(
        torch.equal(v, state[(i, key)])
        for i, st in enumerate(brain.optimizer.state.values())
        for key, v in st.items() if torch.is_tensor(v))
    nan_window = {
        "micro_batches": gaf, "params_bitwise_equal": same_params,
        "adamw_state_bitwise_equal": same_state,
        "adamw_state_tensors": len(state),
        "window_unchanged": all(torch.equal(a, b) for a, b in
                                zip(brain._window, window))
        and torch.equal(brain._window_count, count),
        "nonfinite_counted": brain.nonfinite_count, "drained": drained,
    }
    nan_window["ok"] = bool(same_params and same_state
                            and nan_window["window_unchanged"]
                            and brain.nonfinite_count == gaf
                            and drained is None)
    del params, state, window

    # 6: the mean of two full-width checkpoints
    brain.checkpointer.save_checkpoint(meta={"step": n})
    ckpts = brain.checkpointer.find_checkpoints(max_num_checkpoints=2)
    files = [torch.load(c.paramfiles["modules"], map_location="cpu",
                        weights_only=True) for c in ckpts]
    t0 = time.perf_counter()
    averaged = brain.load_averaged_checkpoints(2)
    avg_s = time.perf_counter() - t0
    state = brain.modules.state_dict()
    equal = all(
        torch.equal(state[key].cpu(), ((files[0][key].double()
                                        + files[1][key].double()) / 2)
                    .to(state[key].dtype))
        for key in state if torch.is_floating_point(state[key]))
    moved = any(not torch.equal(files[0][key], files[1][key])
                for key in state)
    averaging = {"checkpoints": averaged, "bytes_each": sum(
        v.numel() * v.element_size() for v in files[0].values()),
        "seconds": avg_s, "equal_to_float64_mean": equal,
        "checkpoints_differ": moved, "ok": bool(equal and moved
                                                and averaged == 2)}
    del brain, files, state
    torch.cuda.empty_cache()
    return loss_reads, nan_window, averaging


def check_threaded_resume(cfg, dataset, out_dir):
    """Check 5: a mid-epoch checkpoint of the threaded loader, three
    batches in, resumes a threaded and an unthreaded loader on the batch
    an unthreaded loader gives next."""
    def loader(workers):
        kw = host_loader_kwargs(cfg, dataset, seed=11)
        kw["num_workers"] = workers
        return make_dataloader(dataset, **kw)

    reference = loader(0)
    reference.set_epoch(2)
    expected = [list(b.id) for b in itertools.islice(reference, 4)]
    threaded = loader(HOST["num_workers"])
    threaded.set_epoch(2)
    it = iter(threaded)
    for _ in range(3):
        next(it)
    ckpt = Checkpointer(os.path.join(out_dir, "resume"),
                        {"loader": threaded})
    ckpt.save_checkpoint(end_of_epoch=False)
    own_next = list(next(it).id)
    del it
    resumed = {}
    for workers in (0, HOST["num_workers"]):
        fresh = loader(workers)
        Checkpointer(os.path.join(out_dir, "resume"),
                     {"loader": fresh}).recover_if_possible()
        fresh.set_epoch(2)
        resumed[workers] = list(next(iter(fresh)).id)
    return {"expected_next": expected[3], "threaded_next": own_next,
            "resumed_unthreaded": resumed[0],
            "resumed_threaded": resumed[HOST["num_workers"]],
            "ok": expected[3] == own_next == resumed[0]
            == resumed[HOST["num_workers"]]}


def time_num_workers(brain, cfg, dataset):
    """What the read-ahead threads buy: one epoch's batches read and
    collated alone, and one epoch of ``fit_batch`` fed by the loader, with
    0 and ``HOST["num_workers"]`` threads, in turns (0, N, N, 0), the same
    epoch's batches each time. Seconds."""
    seconds = {"read_alone": {}, "epoch_of_fit_batch": {}}
    for workers in (0, HOST["num_workers"], HOST["num_workers"], 0):
        kw = host_loader_kwargs(cfg, dataset)
        kw["num_workers"] = workers
        loader = make_dataloader(dataset, pin_memory=True, **kw)
        loader.set_epoch(9)
        t0 = time.perf_counter()
        n = sum(1 for _ in loader)
        seconds["read_alone"].setdefault(workers, []).append(
            time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in loader:
            brain.fit_batch(batch)
        brain._flush_pending_loss()
        brain._drain_loss_accum()
        torch.cuda.synchronize()
        seconds["epoch_of_fit_batch"].setdefault(workers, []).append(
            time.perf_counter() - t0)
    seconds["batches"] = n
    return seconds


def run_host_path(cfg, out_dir, manifests, wer_metric, device="cuda"):
    """TRAIN through the host side of the loop (``HOST``): ``Brain.fit``
    at full width with dynamic batches, four read-ahead threads and the
    loss read every four micro-batches, then checks 1-8 of the phase's
    record. B3 must launch once a forward pass, and no other kernel."""
    t_phase = time.perf_counter()
    cfg = dict(cfg, epochs=HOST["epochs"])
    os.makedirs(out_dir, exist_ok=True)
    datasets = {split: asr_dataset(path, cfg, train=split == "train")
                for split, path in manifests.items()}
    lengths = {uid: u["length"] for m in manifests.values()
               for uid, u in json.load(open(m)).items()}
    brain = train_brain(cfg, out_dir, brain_cls=HostASR, device=device,
                        run_opts={"loss_sync_interval":
                                  HOST["loss_sync_interval"]})
    train_kw = host_loader_kwargs(cfg, datasets["train"])
    sampler = train_kw["batch_sampler"]
    gc.collect()  # earlier phases' Brains (reference cycles with their
    torch.cuda.empty_cache()  # checkpointers) hold device memory
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    brain.fit(brain.hparams.epoch_counter, datasets["train"],
              datasets["valid"], train_loader_kwargs=train_kw,
              valid_loader_kwargs=dict(asr_loader_kwargs(cfg, False),
                                       num_workers=HOST["num_workers"]))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = launch_counts()
    peak = max(brain.peak_by_shape.values())
    n_train = brain.forwards[Stage.TRAIN]
    n_valid = brain.forwards[Stage.VALID]
    expected = dict.fromkeys(KERNELS, 0)
    expected["fused_fbank"] = n_train + n_valid
    step_ms = brain.step_ms()
    # 2: every example once an epoch, no batch over the limit
    ids = sorted(k for k in lengths if k.startswith("train"))
    batch_seconds = [sum(lengths[i] for i in b)
                     for epoch in brain.epoch_batches for b in epoch]
    once = all(sorted(i for b in epoch for i in b) == ids
               for epoch in brain.epoch_batches)
    records = {
        "b3_launches": {"counts": counts, "expected": expected,
                        "ok": counts == expected},
        "every_example_once": {
            "epochs": len(brain.epoch_batches),
            "batches_an_epoch": [len(e) for e in brain.epoch_batches],
            "batch_sizes_epoch_1": [len(b) for b in brain.epoch_batches[0]],
            "max_batch_seconds": max(batch_seconds),
            "limit_seconds": HOST["max_batch_length"],
            "bucket_edges_seconds": [float(x) for x in
                                     sampler._bucket_boundaries],
            "ok": once and len(brain.epoch_batches) == cfg["epochs"]
            and max(batch_seconds) <= HOST["max_batch_length"]},
    }
    fit_reads = brain.host_syncs
    windows = n_train // cfg["grad_accumulation_factor"]
    ok_fit = (all(np.isfinite(brain.epoch_losses))
              and brain.optimizer_step == windows
              and len(step_ms) == windows)
    emit_fit = {
        "micro_batches": n_train, "valid_batches": n_valid,
        "optimizer_steps": brain.optimizer_step,
        "step_ms_median_after_2": float(np.median(step_ms[2:])),
        "step_ms_min_max_after_2": [float(min(step_ms[2:])),
                                    float(max(step_ms[2:]))],
        "train_seconds": brain.train_seconds,
        "train_audio_seconds": brain.audio_seconds,
        "train_audio_seconds_per_second":
            brain.audio_seconds / brain.train_seconds,
        "fit_seconds": fit_s,
        "max_memory_allocated_bytes_train_micro_batches": peak,
        "max_memory_allocated_bytes_by_batch_shape": dict(brain.peak_by_shape),
        "loss_host_reads": fit_reads,
        "loss_host_reads_a_window": fit_reads / windows,
        "epoch_train_losses": brain.epoch_losses,
        "num_workers": time_num_workers(brain, cfg, datasets["train"]),
    }
    del brain
    gc.collect()
    torch.cuda.empty_cache()

    loader = make_dataloader(datasets["train"],
                             **host_loader_kwargs(cfg, datasets["train"]))
    loader.set_epoch(1)
    batches = list(itertools.islice(loader, HOST["fp32_micro_batches"]))
    reads, nan_window, averaging = check_loss_reads_nan_window_averaging(
        cfg, batches, out_dir, device)
    del batches
    records["loss_reads"] = reads
    records["nan_window"] = nan_window
    records["threaded_resume"] = check_threaded_resume(
        cfg, datasets["train"], out_dir)
    records["averaged_checkpoints"] = averaging
    records["native_wav"] = check_native_wav(manifests, out_dir)
    records["native_wer"] = check_native_wer(wer_metric)
    ok = ok_fit and all(r["ok"] for r in records.values())
    emit({"phase": "host_path", "ok": bool(ok),
          "config": {k: v for k, v in cfg.items()}, "host": HOST,
          "reduced": HOST_REDUCED,
          "precision": "bf16 autocast, float32 parameters",
          **emit_fit, **records,
          "phase_seconds": time.perf_counter() - t_phase,
          "gpu_name_power_limit": gpu_name_power_limit()})
    if not ok:
        raise AssertionError("host_path: a check failed")
    return n_train + n_valid


# B3 against its plain version in one float32 training step: the features
# differ by at most B3_ATOL dB (3e-3 read on the check signals), a few
# 1e-4 of a frame's spread after the sentence normalisation; such a
# perturbation moves the loss and each gradient in proportion. The loss
# is held to 1e-4 relative; each parameter's gradient to 1e-2 of its
# norm in L2, plus 1e-6 of the global gradient norm for tensors whose
# gradient is zero up to rounding (the attention keys' biases), and all
# gradients together to 1e-3.
TRAIN_FP32_LOSS_RTOL = 1e-4
TRAIN_FP32_GRAD_RTOL = 1e-2
TRAIN_FP32_GLOBAL_RTOL = 1e-3


def train_step_kernel_vs_plain(cfg, batch, device="cuda", seed=1):
    """One float32 micro-batch of the recipe's Brain (dropout 0) from
    identical weights, through B3 and through its plain version. Returns
    the losses, the gradients' errors, and whether they are within the
    tolerances above."""
    brain = ASR(modules=make_asr_modules(cfg, device=device, seed=seed,
                                         dropout=0.0),
                hparams=make_asr_hparams(cfg, device=device),
                run_opts={"device": device, "precision": "fp32"})
    brain.modules.train()
    batch = batch.to(device)

    def step():
        brain.modules.zero_grad(set_to_none=True)
        loss = brain.compute_objectives(
            brain.compute_forward(batch, Stage.TRAIN), batch, Stage.TRAIN
        )
        loss.backward()
        return float(loss.detach()), {
            n: p.grad.detach().clone()
            for n, p in brain.modules.named_parameters()
        }

    reset_launch_counts()
    loss_k, grads_k = step()
    kernel_launches = launch_counts()["fused_fbank"]
    reset_launch_counts()
    with plain_versions("fused_fbank"):
        loss_p, grads_p = step()
    plain_launches = launch_counts()["fused_fbank"]
    norms = {n: float(g.norm()) for n, g in grads_p.items()}
    errs = {n: float((grads_k[n] - g).norm()) for n, g in grads_p.items()}
    global_norm = float(np.sqrt(sum(v * v for v in norms.values())))
    global_err = float(np.sqrt(sum(v * v for v in errs.values())))
    rel = {n: errs[n] / max(norms[n], 1e-30) for n in norms}
    worst = max(rel, key=rel.get)
    ok = (
        kernel_launches == 1 and plain_launches == 0
        and np.isfinite(loss_k) and np.isfinite(loss_p)
        and abs(loss_k - loss_p) <= TRAIN_FP32_LOSS_RTOL * abs(loss_p)
        and all(errs[n] <= TRAIN_FP32_GRAD_RTOL * norms[n]
                + 1e-6 * global_norm for n in norms)
        and global_err <= TRAIN_FP32_GLOBAL_RTOL * global_norm
    )
    return {
        "ok": bool(ok), "loss_kernel": loss_k, "loss_plain": loss_p,
        "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
        "grad_global_rel_err": global_err / global_norm,
        "grad_worst_rel_err": rel[worst], "grad_worst_tensor": worst,
        "grad_median_rel_err": float(np.median(list(rel.values()))),
        "grad_tensors": len(rel), "kernel_launches": kernel_launches,
        "plain_launches": plain_launches,
        "tolerances": {"loss_rel": TRAIN_FP32_LOSS_RTOL,
                       "grad_rel_a_tensor": TRAIN_FP32_GRAD_RTOL,
                       "grad_abs_a_tensor": "1e-6 x global norm",
                       "grad_global_rel": TRAIN_FP32_GLOBAL_RTOL},
    }


def _state_equal(a, b):
    """Optimizer state dicts equal bit for bit."""
    if a["param_groups"] != b["param_groups"] or a["state"].keys() != \
            b["state"].keys():
        return False
    return all(
        torch.equal(torch.as_tensor(x), torch.as_tensor(y))
        for k in a["state"] for x, y in zip(a["state"][k].values(),
                                            b["state"][k].values())
    )


def run_train_checks(cfg, brain, out_dir, datasets, device="cuda"):
    """Three checks after ``train_path``: the loss fell; a checkpoint
    taken one batch into an epoch recovers into a fresh Brain bit for
    bit; one float32 micro-batch through B3 and through its plain version
    agree."""
    first, last = brain.epoch_losses[0], brain.epoch_losses[-1]
    falls = {"first_epoch": first, "last_epoch": last,
             "ratio": last / first, "limit": 0.8, "ok": last < 0.8 * first}

    loader = brain.checkpointer.recoverables["dataloader-TRAIN"]
    counter = brain.hparams.epoch_counter
    loader.set_epoch(counter.current)
    it = iter(loader)
    next(it)
    t0 = time.perf_counter()
    ckpt = brain.checkpointer.save_checkpoint(end_of_epoch=False)
    save_s = time.perf_counter() - t0
    next_ids = next(it).id
    del it
    fresh = train_brain(cfg, out_dir, modules_seed=7, brain_cls=ASR,
                        device=device)
    fresh_loader = fresh.make_dataloader(
        datasets["train"], Stage.TRAIN, **asr_loader_kwargs(cfg, True)
    )
    t0 = time.perf_counter()
    fresh.on_fit_start()  # builds the optimizer, recovers the checkpoint
    load_s = time.perf_counter() - t0
    fresh_counter = fresh.hparams.epoch_counter
    fresh_loader.set_epoch(fresh_counter.current + 1)
    params_equal = all(
        torch.equal(p, q) for p, q in zip(brain.modules.parameters(),
                                          fresh.modules.parameters())
    )
    noam, fresh_noam = (b.hparams.noam_scheduler for b in (brain, fresh))
    trip = {
        "files": sorted(p.name for p in ckpt.path.iterdir()),
        "bytes": sum(p.stat().st_size for p in ckpt.path.iterdir()),
        "save_seconds": save_s, "recover_seconds": load_s,
        "parameters_bitwise_equal": params_equal,
        "optimizer_state_bitwise_equal": _state_equal(
            brain.optimizer.state_dict(), fresh.optimizer.state_dict()),
        "noam_equal": (noam.n_steps, noam.current_lr)
        == (fresh_noam.n_steps, fresh_noam.current_lr),
        "brain_counters_equal": (brain.optimizer_step, brain._micro_step)
        == (fresh.optimizer_step, fresh._micro_step),
        "epoch_counter": [counter.current, fresh_counter.current],
        "loader_next_batch_equal": next(iter(fresh_loader)).id == next_ids,
    }
    trip["ok"] = bool(
        params_equal and trip["optimizer_state_bitwise_equal"]
        and trip["noam_equal"] and trip["brain_counters_equal"]
        and fresh_counter.current == counter.current - 1
        and trip["loader_next_batch_equal"]
    )
    del fresh
    torch.cuda.empty_cache()

    batch = next(iter(make_train_loader(cfg, datasets)))
    fp32 = train_step_kernel_vs_plain(cfg, batch, device=device)
    ok = falls["ok"] and trip["ok"] and fp32["ok"]
    emit({"phase": "train_checks", "ok": bool(ok), "loss_falls": falls,
          "checkpoint_round_trip": trip,
          "fp32_kernel_vs_plain_train": fp32,
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32}})
    if not ok:
        raise AssertionError("train_checks: a check failed")


def make_train_loader(cfg, datasets):
    return make_dataloader(datasets["train"],
                           **asr_loader_kwargs(cfg, shuffle=False))


# recipe_path: the twin recipe's own chain
# (speechbrain_tpu_torch/recipes/LibriSpeech/ASR/transformer/train.py
# ``run``) with its hparams/conformer_large.yaml, whose values are below:
# the card's machine has no YAML loader, so ``recipe_hparams`` builds the
# same objects in Python (tests/test_torch_training.py holds the two
# equal).
# Full width and depth; the cuts are overrides, as on a command line.
CONFORMER_LARGE = dict(
    seed=3407, device="cuda", vocab_size=5000, token_type="bpe",
    sample_rate=16000, n_mels=80, number_of_epochs=120, batch_size=16,
    max_batch_length=500, grad_accumulation_factor=2, max_grad_norm=5.0,
    loss_reduction="batchmean", d_model=512, nhead=8, num_encoder_layers=12,
    num_decoder_layers=6, d_ffn=2048, kernel_size=31,
    transformer_dropout=0.1, ctc_weight=0.3, label_smoothing=0.1,
    lr_adam=0.0008, n_warmup_steps=25000, bos_index=1, eos_index=2,
    blank_index=0, beam_size=10, ctc_weight_decode=0.3,
)
RECIPE_OVERRIDES = {"number_of_epochs": 3, "n_warmup_steps": 10}
RECIPE_N_UTTS = 96
RECIPE_RUN_OPTS = {"precision": "bf16", "noprogressbar": True}
RECIPE_REDUCED = {
    "number_of_epochs": "120 -> 3",
    "n_warmup_steps": "25000 -> 10",
    "data": "LibriSpeech 960 h -> prepare_synthetic(n_utts=96): 64 train, "
            "16 dev and 16 test utterances of 0.24-0.48 s (tones a word), "
            "padded to 1 s",
}


def recipe_hparams(overrides):
    """The twin's ``hparams/conformer_large.yaml`` with ``overrides``
    (top-level keys, as ``load_hyperpyyaml`` takes them; ``data_folder``
    is required), built in Python in the YAML's order: the seed first,
    then the modules' weights drawn as the YAML draws them."""
    h = dict(CONFORMER_LARGE, **overrides)
    if "data_folder" not in h:
        raise ValueError("data_folder must be given (!PLACEHOLDER)")
    seed_everything(h["seed"])
    h.setdefault("output_folder", f"results/conformer_large/{h['seed']}")
    h.setdefault("save_folder", f"{h['output_folder']}/save")
    h.setdefault("train_log", f"{h['output_folder']}/train_log.txt")
    for key, split in (("train", "train"), ("valid", "dev"),
                       ("test", "test")):
        h.setdefault(f"{key}_annotation",
                     f"{h['save_folder']}/../manifests/{split}.json")
    device = h["device"]
    h["compute_features"] = Fbank(sample_rate=h["sample_rate"],
                                  n_mels=h["n_mels"], fused=True,
                                  device=device)
    h["normalize"] = InputNormalization(norm_type="sentence")
    h["frontend"] = ConvolutionFrontEnd(
        num_blocks=2, out_channels=(64, 32), kernel_sizes=(3, 3),
        strides=(2, 2), device=device,
    )
    h["model"] = TransformerASR(
        tgt_vocab=h["vocab_size"], input_size=640, d_model=h["d_model"],
        nhead=h["nhead"], num_encoder_layers=h["num_encoder_layers"],
        num_decoder_layers=h["num_decoder_layers"], d_ffn=h["d_ffn"],
        dropout=h["transformer_dropout"], encoder_module="conformer",
        attention_type="RelPosMHAXL", kernel_size=h["kernel_size"],
        device=device,
    )
    for head in ("ctc_head", "seq_head"):
        h[head] = Linear(n_neurons=h["vocab_size"], input_size=h["d_model"],
                         device=device)
    h["modules"] = {k: h[k] for k in ("frontend", "model", "ctc_head",
                                      "seq_head")}
    h["epoch_counter"] = EpochCounter(limit=h["number_of_epochs"])
    h["noam_scheduler"] = NoamScheduler(lr_initial=h["lr_adam"],
                                        n_warmup_steps=h["n_warmup_steps"])
    h["train_logger"] = FileTrainLogger(save_file=h["train_log"])
    h["checkpointer"] = Checkpointer(checkpoints_dir=h["save_folder"])
    return h


class RecipeASR(ASR):
    """The twin's Brain with the readings of ``recipe_path``: forward
    passes a stage and the loss of every stage."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.forwards = dict.fromkeys(Stage, 0)
        self.stage_losses = {stage: [] for stage in Stage}

    def compute_forward(self, batch, stage):
        self.forwards[stage] += 1
        return super().compute_forward(batch, stage)

    def on_stage_end(self, stage, stage_loss, epoch=None):
        self.stage_losses[stage].append(stage_loss)
        super().on_stage_end(stage, stage_loss, epoch)


def run_recipe_path(out_dir):
    """The recipe's chain at full width on the card: a synthetic corpus,
    the BPE tokenizer trained on it, the twin's ``dataio_prepare``, a
    shuffled bf16 ``fit`` with a checkpoint after each valid stage, then
    the test split's loss and greedy-CTC WER. Kernel B3 must launch once a
    forward pass (train, valid and test) and no other kernel at all."""
    t0 = time.perf_counter()
    hparams = recipe_hparams(dict(
        RECIPE_OVERRIDES, data_folder=os.path.join(out_dir, "data"),
        output_folder=os.path.join(out_dir, "results"),
    ))
    manifests = os.path.dirname(hparams["train_annotation"])
    prepare_synthetic(hparams["data_folder"], save_folder=manifests,
                      n_utts=RECIPE_N_UTTS)
    torch.cuda.synchronize()
    reset_launch_counts()
    brain, datasets, tokenizer = recipe.run(hparams, dict(RECIPE_RUN_OPTS),
                                            brain_cls=RecipeASR)
    torch.cuda.synchronize()
    counts = launch_counts()
    seconds = time.perf_counter() - t0
    n = {stage: brain.forwards[stage] for stage in Stage}
    bs = hparams["batch_size"]
    epochs = hparams["number_of_epochs"]
    expected_forwards = {
        Stage.TRAIN: epochs * -(-len(datasets["train"]) // bs),
        Stage.VALID: epochs * -(-len(datasets["valid"]) // bs),
        Stage.TEST: -(-len(datasets["test"]) // bs),
    }
    expected = dict.fromkeys(KERNELS, 0)
    expected["fused_fbank"] = sum(n.values())
    losses = brain.stage_losses
    valid = losses[Stage.VALID]
    kept = brain.checkpointer.list_checkpoints()
    best = min(kept, key=lambda c: c.meta["loss"]) if kept else None
    with open(hparams["test_annotation"], encoding="utf-8") as f:
        test_words = sum(len(u["words"].split())
                         for u in json.load(f).values())
    stats = brain.test_stats
    ok = (
        counts == expected
        and n == expected_forwards
        and brain.optimizer_step == n[Stage.TRAIN]
        // hparams["grad_accumulation_factor"]
        and all(np.isfinite(v) for v in losses.values() for v in v)
        and len(valid) == epochs and len(losses[Stage.TEST]) == 1
        and best is not None and best.meta["loss"] == min(valid)
        and stats["num_ref_tokens"] == test_words
        and np.isfinite(stats["WER"])
    )
    emit({
        "phase": "recipe_path", "ok": bool(ok),
        "recipe": "speechbrain_tpu_torch/recipes/LibriSpeech/ASR/"
                  "transformer/train.py run() with hparams/"
                  "conformer_large.yaml built in Python",
        "overrides": RECIPE_OVERRIDES, "reduced": RECIPE_REDUCED,
        "run_opts": RECIPE_RUN_OPTS,
        "utterances": {k: len(v) for k, v in datasets.items()},
        "micro_batches": n[Stage.TRAIN], "valid_batches": n[Stage.VALID],
        "test_batches": n[Stage.TEST],
        "optimizer_steps": brain.optimizer_step,
        "launches": counts, "expected_launches": expected,
        "tokenizer_pieces": tokenizer.sp.vocab_size(),
        "epoch_train_losses": losses[Stage.TRAIN],
        "valid_losses": valid,
        "first_valid_loss": valid[0] if valid else None,
        "last_valid_loss": valid[-1] if valid else None,
        "checkpoints_kept": [{"name": c.path.name, "loss": c.meta["loss"]}
                             for c in kept],
        "best_checkpoint_loss": best.meta["loss"] if best else None,
        "test_loss": stats["loss"], "WER": stats["WER"],
        "num_ref_tokens": stats["num_ref_tokens"],
        "edits": {k: brain.wer_metric.summary[k] for k in (
            "insertions", "deletions", "substitutions")},
        "test_manifest_words": test_words,
        "seconds": seconds,
        "gpu_name_power_limit": gpu_name_power_limit(),
    })
    if not ok:
        raise AssertionError("recipe_path: a check of the chain failed")
    return n, brain.wer_metric


# -- phase: the serving entry point ------------------------------------------

SERVE_REDUCED = {
    "weights": "random, from seed 0 (the published model's files are not "
               "in the repository)",
    "tokenizer": "a 5000-piece BPE model made by construction "
                 "(write_covering_bpe), not trained",
}


def _bitwise_equal(modules_a, modules_b, cast=None):
    """Every tensor of every module's state equal bit for bit (``b``'s
    cast to ``cast`` first, where given)."""
    for name, a in modules_a.items():
        sa, sb = a.state_dict(), modules_b[name].state_dict()
        if sa.keys() != sb.keys():
            return False
        for key, t in sa.items():
            u = sb[key] if cast is None else sb[key].to(cast)
            if t.dtype != u.dtype or not torch.equal(t, u):
                return False
    return True


def _served_run(asr, wavs, lens, ancestry):
    """One counted ``transcribe_batch`` (after a warm-up) in the given
    search mode; returns its line's readings and whether its launch counts
    are exactly those of :func:`expected_launches`."""
    decoder = asr.hparams.decoder
    decoder.pipe.ancestry = ancestry
    asr.transcribe_batch(wavs, lens)  # warm-up: allocator, cuBLAS set-up
    reset_launch_counts()
    t0 = time.perf_counter()
    words, hyps = asr.transcribe_batch(wavs, lens)
    total_ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    steps = decoder.searcher.last_steps
    expected = expected_launches(decoder.pipe.cfg, ancestry, steps, 1)
    _, _, scores, _ = decoder.last_result
    cfg = decoder.pipe.cfg
    audio_s = cfg["batch"] * cfg["seconds"]
    ok = (counts == expected and len(words) == cfg["batch"]
          and all(isinstance(w, str) for w in words)
          and np.all(np.isfinite(scores)) and steps >= 1
          and all(0 <= t < cfg["vocab"] for h in hyps for t in h))
    return ok, {
        "ancestry_kv": ancestry, "steps": steps, "words": words,
        "hyp_lengths": [len(h) for h in hyps],
        **{f"{name}_launches": n for name, n in counts.items()},
        "expected_launches": expected,
        "encode_ms": asr.last_encode_ms, "decode_ms": decoder.last_ms,
        "transcribe_batch_ms": total_ms,
        "audio_seconds_per_second": audio_s / (total_ms / 1e3),
    }


def run_serve_path(cfg, out_dir):
    """NORTH served through the port's entry point: a model source
    directory written from seed-0 modules through their savers and a
    covering tokenizer; a second set of modules (seed 1) loaded from it by
    a ``Pretrainer``, bit for bit; ``EncoderDecoderASR.transcribe_batch``
    in bf16 with ancestry KV (B1 18 x steps, B3 once) and permuting (B4
    36 x steps, B3 once); in fp32 against ``Pipeline.transcribe`` on the
    same modules (tokens equal, scores within 1e-5); ``transcribe_file``
    of a 10 s WAV against ``transcribe_batch`` of its samples; and
    ``EncoderASR`` with greedy CTC (B3 only). Returns each run's launch
    counts."""
    t0 = time.perf_counter()
    src = os.path.join(out_dir, "model")
    os.makedirs(src)
    pipe0 = Pipeline(cfg, device="cuda", dtype=torch.float32, seed=0)
    for name, module in serve_modules(pipe0).items():
        get_default_hook(module, DEFAULT_SAVE_HOOKS)(
            module, os.path.join(src, f"{name}.ckpt"))
    write_covering_bpe(src, cfg["vocab"])
    source_bytes = sum(os.path.getsize(os.path.join(src, f))
                       for f in os.listdir(src))

    loaded = {}
    for dtype in (torch.float32, torch.bfloat16):
        pipe = Pipeline(cfg, device="cuda", dtype=dtype, seed=1)
        pretrainer = Pretrainer(
            collect_in=os.path.join(out_dir, f"collected_{dtype}"),
            loadables=serve_modules(pipe))
        pretrainer.collect_files(default_source=src)
        pretrainer.load_collected()
        loaded[dtype] = pipe
    bit_equal = (
        _bitwise_equal(serve_modules(loaded[torch.float32]),
                       serve_modules(pipe0))
        and _bitwise_equal(serve_modules(loaded[torch.bfloat16]),
                           serve_modules(pipe0), cast=torch.bfloat16))
    del pipe0
    tokenizer = SentencePiece(src, cfg["vocab"], model_type="bpe")
    load_seconds = time.perf_counter() - t0
    wavs, lens = make_waveforms(cfg, "cuda")

    asr = served_asr(loaded[torch.bfloat16], tokenizer)
    frozen = not any(p.requires_grad for m in serve_modules(
        loaded[torch.bfloat16]).values() for p in m.parameters())
    ok_anc, anc = _served_run(asr, wavs, lens, ancestry=True)
    ok_perm, perm = _served_run(asr, wavs, lens, ancestry=False)
    del asr
    loaded.pop(torch.bfloat16)
    torch.cuda.empty_cache()

    pipe = loaded[torch.float32]
    asr32 = served_asr(pipe, tokenizer)
    words32, hyps32 = asr32.transcribe_batch(wavs, lens)
    scores32 = asr32.hparams.decoder.last_result[2]
    ref_hyps, _, ref_scores, _ = pipe.transcribe(wavs, lens)
    fp32_diff = float(np.max(np.abs(scores32 - ref_scores)))
    fp32_ok = hyps32 == ref_hyps and fp32_diff <= 1e-5

    signal = 0.1 * wavs[0].cpu().numpy()
    wav_path = os.path.join(out_dir, "utterance.wav")
    write_audio(wav_path, signal, SR)
    file_words = asr32.transcribe_file(wav_path)
    batch_words, _ = asr32.transcribe_batch(
        torch.from_numpy(read_audio(wav_path))[None].cuda(),
        torch.ones(1, device="cuda"))
    file_ok = file_words == batch_words[0]

    ctc_asr = EncoderASR(hparams={
        "encoder": served_encoder(pipe, ctc=True),
        "decoding_function": functools.partial(
            ctc_greedy_decode, blank_id=cfg["blank"]),
        "tokenizer": tokenizer, "sample_rate": SR,
    }, run_opts={"device": "cuda"})
    reset_launch_counts()
    ctc_words, ctc_hyps = ctc_asr.transcribe_batch(wavs, lens)
    ctc_counts = launch_counts()
    ctc_expected = dict.fromkeys(KERNELS, 0)
    ctc_expected["fused_fbank"] = 1
    ctc_ok = (ctc_counts == ctc_expected and len(ctc_words) == cfg["batch"]
              and all(0 <= t < cfg["vocab"] for h in ctc_hyps for t in h))

    checks = {"pretrainer_bit_equal": bit_equal, "modules_frozen": frozen,
              "ancestry": ok_anc, "permute": ok_perm,
              "fp32_vs_pipeline": fp32_ok, "transcribe_file": file_ok,
              "encoder_asr": ctc_ok}
    ok = all(checks.values())
    emit({
        "phase": "serve_path", "ok": bool(ok), "checks": checks,
        "config": {**cfg, "ctc_scorer": True, "fused_fbank": True},
        "reduced": SERVE_REDUCED,
        "source_files": sorted(os.listdir(src)),
        "source_bytes": source_bytes, "build_and_load_seconds": load_seconds,
        "bf16_ancestry": anc, "bf16_permute": perm,
        "fp32_tokens_equal_pipeline": hyps32 == ref_hyps,
        "fp32_max_score_diff": fp32_diff, "fp32_score_atol": 1e-5,
        "fp32_words": words32,
        "transcribe_file": {"seconds": cfg["seconds"], "words": file_words,
                            "equals_batch_of_one": file_ok},
        "encoder_asr": {"words": ctc_words,
                        **{f"{n}_launches": c for n, c in ctc_counts.items()},
                        "expected_launches": ctc_expected},
        "seconds": time.perf_counter() - t0,
        "gpu_name_power_limit": gpu_name_power_limit(),
    })
    if not ok:
        raise AssertionError(f"serve_path: a check failed: {checks}")
    return {"ancestry": {k: anc[f"{k}_launches"] for k in KERNELS},
            "permute": {k: perm[f"{k}_launches"] for k in KERNELS},
            "encoder_asr": ctc_counts}


# -- phase: the recipe's other encoder families -------------------------------

# family_path: the seven other hparams files of the LibriSpeech transformer
# recipe (recipes/LibriSpeech/ASR/transformer/hparams/, twins under
# speechbrain_tpu_torch/recipes/LibriSpeech/ASR/transformer/hparams/) at
# their full width and depth: the encoder, its attention and the sizes from
# the YAML; the front end, heads, vocabulary and kernel size as in
# conformer_large (the YAMLs share them).
FAMILIES = {
    "transformer": dict(d_model=512, nhead=4, enc_layers=12, dec_layers=6,
                        d_ffn=2048, encoder_module="transformer",
                        attention_type="regularMHA"),
    "conformer_large_rope": dict(d_model=512, nhead=8, enc_layers=12,
                                 dec_layers=6, d_ffn=2048,
                                 encoder_module="conformer",
                                 attention_type="RoPEMHA"),
    "branchformer_large": dict(d_model=512, nhead=8, enc_layers=18,
                               dec_layers=6, d_ffn=3072,
                               encoder_module="branchformer",
                               attention_type="RelPosMHAXL"),
    "hyperconformer_22M": dict(d_model=256, nhead=8, enc_layers=10,
                               dec_layers=4, d_ffn=1024,
                               encoder_module="conformer",
                               attention_type="hypermixing"),
    "hyperconformer_8M": dict(d_model=144, nhead=8, enc_layers=10,
                              dec_layers=4, d_ffn=576,
                              encoder_module="conformer",
                              attention_type="hypermixing"),
    "hyperbranchformer_25M": dict(d_model=256, nhead=8, enc_layers=10,
                                  dec_layers=4, d_ffn=1024,
                                  encoder_module="branchformer",
                                  attention_type="hypermixing"),
    "hyperbranchformer_13M": dict(d_model=144, nhead=8, enc_layers=10,
                                  dec_layers=4, d_ffn=1024,
                                  encoder_module="branchformer",
                                  attention_type="hypermixing"),
}
# serving: NORTH's batch and search, the YAMLs' post-norm decoder and their
# ctc_weight_decode; the YAMLs name no LM
FAMILY_SERVE = dict(normalize_before=False, lm=False, ctc_weight=0.3)
FAMILY_REDUCED = {
    "weights": "random, from a seed (no trained model of these families "
               "is in the repository)",
    "search": "beam 10 and max_decode_ratio 0.2 (the recipe's test "
              "setting: 66 and 1.0), no LM, NORTH's 8 x 10 s of noise",
    "training": "one optimizer step (2 micro-batches; two until PR 12) on "
                "TRAIN's synthetic WAV corpus",
}
# one step a family since PR 12, so that the script stays within its time
FAMILY_TRAIN_STEPS = 1
# the branchformer with encoder_remat against without: one float32 step at
# dropout 0 from the same weights; the recomputation replays the same
# kernels, so only the atomics' order of the backward differs
REMAT_RTOL = 1e-5


def family_cfg(name):
    return {**NORTH, **FAMILY_SERVE, **FAMILIES[name]}


def family_train_cfg(name):
    return {**TRAIN, **FAMILIES[name], "epochs": FAMILY_TRAIN_STEPS}


def run_family_serve(name):
    """bf16 ``transcribe`` through the family's pipeline, after a warm-up:
    B1 in every decoder layer at every step, B3 once, nothing else."""
    cfg = family_cfg(name)
    wavs, lens = make_waveforms(cfg, "cuda")
    pipe = Pipeline(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    pipe.transcribe(wavs, lens)
    reset_launch_counts()
    pipe.fbank_calls = 0
    hyps, lengths, scores, _ = pipe.transcribe(wavs, lens)
    counts = launch_counts()
    steps = pipe.searcher.last_steps
    expected = expected_launches(cfg, True, steps, pipe.fbank_calls)
    ok = (
        len(hyps) == cfg["batch"] and np.all(np.isfinite(scores))
        and all(0 <= t < cfg["vocab"] for h in hyps for t in h)
        and steps >= 1 and pipe.fbank_calls == 1 and counts == expected
    )
    line = {
        "family": name, "ok": bool(ok), "head_dim":
            cfg["d_model"] // cfg["nhead"],
        "parameters": sum(
            p.numel() for m in (pipe.frontend, pipe.net, pipe.ctc_lin,
                                pipe.seq_lin) for p in m.parameters()),
        "steps": steps, "hyp_lengths": [int(x) for x in lengths],
        "launches": counts, "expected_launches": expected,
        "encode_ms": pipe.last_encode_ms, "decode_ms": pipe.last_decode_ms,
        "audio_seconds_per_second": cfg["batch"] * cfg["seconds"]
        / ((pipe.last_encode_ms + pipe.last_decode_ms) / 1e3),
        "max_steps": pipe.last_max_steps,
    }
    del pipe
    torch.cuda.empty_cache()
    if not ok:
        emit({"phase": "family_path", **line})
        raise AssertionError(f"family_path {name}: the bf16 run failed")
    return line


def run_family_train(name, out_dir, datasets):
    """Two optimizer steps of the twin ``ASR`` Brain at the family's full
    width: bf16 autocast, accumulation 2, B3 on every micro-batch."""
    cfg = family_train_cfg(name)
    os.makedirs(out_dir, exist_ok=True)
    brain = train_brain(cfg, out_dir, device="cuda")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    brain.fit(brain.hparams.epoch_counter, datasets["train"],
              train_loader_kwargs=asr_loader_kwargs(cfg, shuffle=False))
    counts = launch_counts()
    n_train = brain.forwards[Stage.TRAIN]
    expected = dict.fromkeys(KERNELS, 0)
    expected["fused_fbank"] = n_train
    step_ms = brain.step_ms()
    line = {
        "ok": bool(
            counts == expected
            and brain.optimizer_step == FAMILY_TRAIN_STEPS
            and n_train == FAMILY_TRAIN_STEPS
            * cfg["grad_accumulation_factor"]
            and all(np.isfinite(brain.epoch_losses))
        ),
        "micro_batches": n_train, "optimizer_steps": brain.optimizer_step,
        "fused_fbank_launches": counts["fused_fbank"],
        "train_losses": brain.epoch_losses, "step_ms": step_ms,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    del brain
    gc.collect()
    torch.cuda.empty_cache()
    return line


def remat_step(cfg, batch, remat):
    """One float32 micro-batch of the twin ``ASR`` Brain (dropout 0, seed-1
    weights) with or without ``encoder_remat``: the loss, the gradients and
    the peak memory of the step."""
    brain = ASR(modules=make_asr_modules(cfg, seed=1, dropout=0.0,
                                         encoder_remat=remat),
                hparams=make_asr_hparams(cfg),
                run_opts={"device": "cuda", "precision": "fp32"})
    brain.modules.train()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loss = brain.compute_objectives(
        brain.compute_forward(batch, Stage.TRAIN), batch, Stage.TRAIN)
    loss.backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    grads = {n: p.grad.detach().clone()
             for n, p in brain.modules.named_parameters()}
    del brain
    gc.collect()
    torch.cuda.empty_cache()
    return float(loss.detach()), grads, peak


def run_family_remat(name, datasets):
    """``encoder_remat=True`` against without, float32, one micro-batch of
    TRAIN's 16 utterances: loss and every gradient within REMAT_RTOL
    (each tensor's error against its norm, plus 1e-6 of the global norm
    for gradients that are zero up to rounding), and the peak memories."""
    cfg = family_train_cfg(name)
    batch = next(iter(make_train_loader(cfg, datasets))).to("cuda")
    loss_0, grads_0, peak_0 = remat_step(cfg, batch, False)
    loss_1, grads_1, peak_1 = remat_step(cfg, batch, True)
    norms = {n: float(g.norm()) for n, g in grads_0.items()}
    errs = {n: float((grads_1[n] - g).norm()) for n, g in grads_0.items()}
    global_norm = float(np.sqrt(sum(v * v for v in norms.values())))
    rel = {n: errs[n] / max(norms[n], 1e-30) for n in norms}
    ok = (
        grads_0.keys() == grads_1.keys()
        and abs(loss_1 - loss_0) <= REMAT_RTOL * abs(loss_0)
        and all(errs[n] <= REMAT_RTOL * norms[n] + 1e-6 * global_norm
                for n in norms)
    )
    return {
        "family": name, "ok": bool(ok), "dtype": "float32", "dropout": 0.0,
        "loss": loss_0, "loss_remat": loss_1,
        "loss_rel_diff": abs(loss_1 - loss_0) / abs(loss_0),
        "grad_worst_rel_err": max(rel.values()),
        "grad_global_rel_err": float(np.sqrt(sum(
            v * v for v in errs.values()))) / global_norm,
        "rtol": REMAT_RTOL, "step_peak_bytes": peak_0,
        "step_peak_bytes_remat": peak_1,
    }


def run_family_path(out_dir, datasets):
    """Each family: bf16 serving (B1 dec_layers x steps, B3 once), the same
    transcribe in float32 through the kernels and their plain versions
    (equal tokens), two bf16 training steps (B3 every micro-batch); then
    branchformer_large with and without encoder_remat. Returns each
    family's launches of B1 and B3 (serving and training), and the hd-18
    family's steps and maximum steps."""
    t0 = time.perf_counter()
    lines, launches = {}, {}
    for name in FAMILIES:
        t1 = time.perf_counter()
        serve = run_family_serve(name)
        run_fp32_comparison(family_cfg(name), ancestry=True,
                            phase=f"family_fp32_kernel_vs_plain/{name}")
        train = run_family_train(name, os.path.join(out_dir, name), datasets)
        lines[name] = {**serve, "train": train,
                       "seconds": time.perf_counter() - t1}
        launches[name] = {
            "ancestry_attention": serve["launches"]["ancestry_attention"],
            "fused_fbank": serve["launches"]["fused_fbank"]
            + train["fused_fbank_launches"],
        }
        emit({"phase": "family_path", **lines[name]})
        if not train["ok"]:
            raise AssertionError(f"family_path {name}: training failed")
    remat = run_family_remat("branchformer_large", datasets)
    emit({"phase": "family_remat", **remat})
    if not remat["ok"]:
        raise AssertionError("family_remat: remat changed the step")
    emit({"phase": "family_path_summary", "reduced": FAMILY_REDUCED,
          "parameters": {n: l["parameters"] for n, l in lines.items()},
          "launches": launches,
          "seconds": time.perf_counter() - t0,
          "gpu_name_power_limit": gpu_name_power_limit()})
    hd18 = lines["hyperconformer_8M"]
    return launches, (hd18["steps"], hd18["max_steps"])


# -- phase: recurrent seq2seq ASR (the CRDNN recipe) --------------------------

# crdnn_path: the LibriSpeech CRDNN seq2seq recipe
# (recipes/LibriSpeech/ASR/seq2seq/hparams/train_BPE_1000.yaml, twin under
# speechbrain_tpu_torch/recipes/LibriSpeech/ASR/seq2seq/) at its full width
# and depth, and its RNNLM (recipes/LibriSpeech/LM/hparams/RNNLM.yaml), with
# random weights from a seed; the decode settings of upstream's CRDNN model
# (asr-crdnn-rnnlm-librispeech: beam 16 as the YAML's test_beam_size, CTC
# 0.4, RNNLM 0.5, coverage 1.5, max_attn_shift 240, temperatures 1.25).
CRDNN_CFG = dict(
    n_mels=40, n_fft=400, cnn_channels=(128, 256),
    inter_layer_pooling_size=(2, 2), time_pooling_size=4, rnn_layers=4,
    rnn_neurons=1024, dnn_blocks=2, dnn_neurons=512, emb_size=128,
    dec_neurons=1024, attn_dim=512, location_channels=10,
    location_kernel=100, vocab=1000, bos=0, eos=0, blank=0, dropout=0.15,
    lr=1.0, ctc_weight=0.5, label_smoothing=0.1, batch_size=8,
    lm_emb_size=128, lm_rnn_neurons=2048, lm_rnn_layers=2,
    lm_dnn_neurons=512, lm_lr=1e-3, lm_batch_size=80,
)
CRDNN_DECODE = dict(
    beam_size=16, min_decode_ratio=0.0, max_decode_ratio=1.0,
    eos_threshold=1.5, ctc_weight=0.4, lm_weight=0.5, coverage_penalty=1.5,
    using_max_attn_shift=True, max_attn_shift=240, temperature=1.25,
    temperature_lm=1.25,
)
CRDNN_REDUCED = {
    "weights": "trained checkpoints -> random weights from a seed",
    "train": "15 epochs of LibriSpeech 960 h -> two Adadelta steps of 8 "
             "utterances of TRAIN's synthetic corpus (8-12 s; its token ids "
             "folded into 1..999), then its valid split",
    "lm_train": "20 epochs of the LM corpus -> two AdamW steps of 80 "
                "sequences of TRAIN's token ids",
    "serve": "LibriSpeech test-clean -> NORTH's batch, 8 x 10 s of noise",
    "fp32_comparison": "tokens held equal at decode ratio 0.2 (50 steps), "
                       "not the recipe's 1.0: over 250 steps a random-"
                       "weight model's best hypotheses lie within about "
                       "6e-4 of each other a step, and B3's 2e-7 change of "
                       "the encoder states flipped one of 8 searches at "
                       "step 216 (an H100, float32); the full-ratio "
                       "comparison is read as fp32_full_ratio_read",
}
CRDNN_SCORE_ATOL = 1e-3
# the float32 comparison of B3 against its plain version: encoder states,
# and the search at NORTH's decode ratio (50 of 250 steps)
CRDNN_ENC_ATOL = 1e-5
CRDNN_CMP_RATIO = 0.2
CRDNN_TRAIN_STEPS = 2


def crdnn_modules(cfg, device="cuda", seed=0, rnn_class="lstm",
                  dropout=None):
    """The recipe's five modules (``enc``, ``emb``, ``dec``, ``seq_lin``,
    ``ctc_lin``), random weights from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    kw = dict(device=device, generator=gen)
    drop = cfg["dropout"] if dropout is None else dropout
    return {
        "enc": CRDNNEncoder(
            input_size=cfg["n_mels"], cnn_channels=cfg["cnn_channels"],
            inter_layer_pooling_size=cfg["inter_layer_pooling_size"],
            time_pooling=True, time_pooling_size=cfg["time_pooling_size"],
            rnn_class=rnn_class, rnn_layers=cfg["rnn_layers"],
            rnn_neurons=cfg["rnn_neurons"], dnn_blocks=cfg["dnn_blocks"],
            dnn_neurons=cfg["dnn_neurons"], dropout=drop, **kw),
        "emb": Embedding(cfg["vocab"], cfg["emb_size"], **kw),
        "dec": AttentionalRNNDecoder(
            hidden_size=cfg["dec_neurons"], attn_dim=cfg["attn_dim"],
            input_size=cfg["emb_size"], enc_dim=cfg["dnn_neurons"],
            attn_type="location", channels=cfg["location_channels"],
            kernel_size=cfg["location_kernel"], dropout=drop, **kw),
        "seq_lin": Linear(cfg["vocab"], cfg["dec_neurons"], **kw),
        "ctc_lin": Linear(cfg["vocab"], cfg["dnn_neurons"], **kw),
    }


def crdnn_lm(cfg, device="cuda", seed=7):
    """``RNNLM.yaml``'s language model, random weights from ``seed``."""
    return RNNLM(cfg["vocab"], cfg["lm_emb_size"],
                 rnn_neurons=cfg["lm_rnn_neurons"],
                 rnn_layers=cfg["lm_rnn_layers"],
                 dnn_neurons=cfg["lm_dnn_neurons"], device=device,
                 generator=torch.Generator().manual_seed(seed))


def crdnn_hparams(cfg, device="cuda", out_dir=None):
    """The twin recipe's hparams that its Brain reads, built in Python
    (the card's machine has no YAML loader)."""
    hparams = {
        "compute_features": Fbank(n_fft=cfg["n_fft"], n_mels=cfg["n_mels"],
                                  fused=True, device=device),
        "normalize": InputNormalization(norm_type="sentence"),
        "ctc_weight": cfg["ctc_weight"],
        "label_smoothing": cfg["label_smoothing"],
        "blank_index": cfg["blank"], "bos_index": cfg["bos"],
        "eos_index": cfg["eos"], "output_neurons": cfg["vocab"],
        "min_decode_ratio": 0.0, "max_decode_ratio": 1.0,
        "eos_threshold": 1.5,
        "lr_annealing": NewBobScheduler(initial_value=cfg["lr"],
                                        improvement_threshold=0.0025,
                                        annealing_factor=0.8, patient=0),
        "epoch_counter": EpochCounter(1),
    }
    if out_dir is not None:
        hparams["train_logger"] = FileTrainLogger(
            os.path.join(out_dir, "train_log.txt"))
    return hparams


def crdnn_served_asr(cfg, modules, lm, tokenizer, device="cuda",
                     decode=CRDNN_DECODE):
    """An ``EncoderDecoderASR`` built from hparams in Python: the encoder
    ``LengthsCapableSequential(Fbank(fused=True), InputNormalization,
    CRDNN)``, the decoder the twin's ``RNNSearchDecoder`` with CTC, RNNLM
    and coverage fusion."""
    encoder = LengthsCapableSequential([
        Fbank(n_fft=cfg["n_fft"], n_mels=cfg["n_mels"], fused=True,
              device=device),
        InputNormalization(norm_type="sentence"),
        modules["enc"],
    ])
    decoder = seq2seq_recipe.RNNSearchDecoder(
        modules["emb"], modules["dec"], modules["seq_lin"],
        ctc_lin=modules["ctc_lin"], lm=lm, bos_index=cfg["bos"],
        eos_index=cfg["eos"], blank_index=cfg["blank"],
        vocab_size=cfg["vocab"], **decode)
    return TimedEncoderDecoderASR(
        hparams={"encoder": encoder, "decoder": decoder,
                 "tokenizer": tokenizer, "sample_rate": SR},
        run_opts={"device": device})


def _crdnn_transcribe(asr, wavs, lens, autocast):
    """One ``transcribe_batch`` (launch counts from 0, bf16 autocast or
    float32): its tokens, scores, launches, times and steps."""
    reset_launch_counts()
    with torch.autocast(wavs.device.type, dtype=torch.bfloat16,
                        enabled=autocast):
        words, hyps = asr.transcribe_batch(wavs, lens)
    counts = launch_counts()
    searcher = asr.hparams.decoder.searcher
    _, _, scores, _ = asr.hparams.decoder.last_result
    return {"words": words, "hyps": hyps, "scores": np.asarray(scores),
            "launches": counts, "encode_ms": asr.last_encode_ms,
            "decode_ms": asr.last_decode_ms, "steps": searcher.last_steps}


class TimedSteps:
    """Readings for a twin recipe's Brain (put before the Brain in the
    bases): forward passes a stage, each micro-batch's loss read on the
    host and its time by CUDA events (from its start to its update), the
    train stage's audio seconds, and the losses of the valid stage."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.forwards = {Stage.TRAIN: 0, Stage.VALID: 0}
        self.step_events, self.losses, self.valid_losses = [], [], []
        self.audio_seconds = 0.0

    def compute_forward(self, batch, stage):
        self.forwards[stage] = self.forwards.get(stage, 0) + 1
        return super().compute_forward(batch, stage)

    # the batch's waveform and its rate (the separation twins': the
    # mixture at 8 kHz)
    SIGNAL_KEY, SIGNAL_RATE = "sig", SR

    def on_fit_batch_start(self, batch):
        sig = batch[self.SIGNAL_KEY]
        self.audio_seconds += (float(sig.lengths.sum()) * sig.data.shape[1]
                               / self.SIGNAL_RATE)
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        self.step_events.append([start, None])
        super().on_fit_batch_start(batch)

    def on_fit_batch_end(self, batch, outputs, loss, should_step):
        super().on_fit_batch_end(batch, outputs, loss, should_step)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.step_events[-1][1] = end
        self.losses.append(float(loss))

    def on_stage_end(self, stage, stage_loss, epoch=None):
        if stage == Stage.VALID:
            self.valid_losses.append(stage_loss)
        super().on_stage_end(stage, stage_loss, epoch)

    def step_ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.step_events]


class TimedCRDNNBrain(TimedSteps, seq2seq_recipe.ASR):
    """The CRDNN twin's ``ASR`` with :class:`TimedSteps`' readings."""


def crdnn_brain(cfg, modules, out_dir=None, precision="bf16", seed=2602,
                device="cuda", brain_cls=TimedCRDNNBrain):
    """The twin's Brain over ``modules``: Adadelta, NewBob, a stop after
    ``CRDNN_TRAIN_STEPS`` optimizer steps."""
    return brain_cls(
        modules=modules, opt_class=seq2seq_recipe.adadelta(cfg["lr"]),
        hparams=crdnn_hparams(cfg, device=device, out_dir=out_dir),
        run_opts={"device": device, "precision": precision,
                  "noprogressbar": True, "seed": seed,
                  "optimizer_step_limit": CRDNN_TRAIN_STEPS})


def _batch_norms(modules):
    return {f"{name}.{sub}": m for name, module in modules.items()
            for sub, m in module.named_modules()
            if isinstance(m, BatchNorm1d)}


def crdnn_step_kernel_vs_plain(cfg, batch, device="cuda"):
    """One float32 training micro-batch (dropout 0, the same seed-3
    weights) through B3 and through its plain version: the losses and
    every BatchNorm's running statistics after the step."""
    out = {}
    for arm in ("kernel", "plain"):
        modules = crdnn_modules(cfg, device=device, seed=3, dropout=0.0)
        brain = crdnn_brain(cfg, modules, precision="fp32", device=device,
                            brain_cls=seq2seq_recipe.ASR)
        brain.init_optimizers()
        brain.modules.train()
        ctx = plain_versions("fused_fbank") if arm == "plain" \
            else contextlib.nullcontext()
        with ctx:
            brain.fit_batch(batch)
            loss = brain._flush_pending_loss()
        out[arm] = (loss, {n: (bn.running_mean.clone(),
                               bn.running_var.clone())
                           for n, bn in _batch_norms(modules).items()})
        del brain, modules
        gc.collect()
        torch.cuda.empty_cache()
    (lk, sk), (lp, sp) = out["kernel"], out["plain"]
    stats_diff = max(
        max((sk[n][0] - sp[n][0]).abs().max().item(),
            ((sk[n][1] - sp[n][1]).abs() / sp[n][1]).max().item())
        for n in sk)
    return {"loss_kernel": lk, "loss_plain": lp,
            "loss_rel_diff": abs(lk - lp) / abs(lp),
            "running_stats_max_diff": stats_diff, "batch_norms": len(sk)}


def lm_token_dataset(manifest, cfg, repeats=5):
    """Token sequences for the LM twin: TRAIN's ids ``repeats`` times over,
    folded as ``asr_dataset(fold=True)`` folds them, with BOS and EOS."""
    with open(manifest) as f:
        entries = json.load(f)
    ds = DynamicItemDataset({f"{key}_{r}": {"tokens": e["tokens"]}
                             for r in range(repeats)
                             for key, e in entries.items()})

    def tokens_pipeline(text):
        ids = [1 + int(t) % (cfg["vocab"] - 1) for t in text.split()]
        yield np.asarray([cfg["bos"]] + ids, np.int32)
        yield np.asarray(ids + [cfg["eos"]], np.int32)

    ds.add_dynamic_item(tokens_pipeline, takes="tokens",
                        provides=["tokens_bos", "tokens_eos"])
    ds.set_output_keys(["id", "tokens_bos", "tokens_eos"])
    return ds


def run_crdnn_lm_train(cfg, manifest, device="cuda"):
    """Two AdamW steps of the LM twin at ``RNNLM.yaml``'s width, batch 80
    of TRAIN's token sequences, bf16 autocast."""
    lm = crdnn_lm(cfg, device=device)
    brain = lm_recipe.LM(
        modules={"lm": lm}, opt_class=lm_recipe.adamw(cfg["lm_lr"]),
        hparams={"lr_annealing": NewBobScheduler(cfg["lm_lr"])},
        run_opts={"device": device, "precision": "bf16",
                  "noprogressbar": True,
                  "optimizer_step_limit": CRDNN_TRAIN_STEPS})
    losses = []
    brain.on_fit_batch_end = (lambda batch, outputs, loss, should_step:
                              losses.append(float(loss)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    brain.fit(EpochCounter(1), lm_token_dataset(manifest, cfg),
              train_loader_kwargs={"batch_size": cfg["lm_batch_size"]})
    torch.cuda.synchronize()
    return {"ok": bool(brain.optimizer_step == CRDNN_TRAIN_STEPS
                       and len(losses) == CRDNN_TRAIN_STEPS
                       and all(np.isfinite(losses))),
            "optimizer_steps": brain.optimizer_step, "losses": losses,
            "seconds": time.perf_counter() - t0,
            "parameters": sum(p.numel() for p in lm.parameters())}


def run_crdnn_serve(cfg, modules, lm, tokenizer, device="cuda"):
    """NORTH's batch served through ``EncoderDecoderASR`` at the decode
    settings: bf16 autocast, then float32 through B3 and through its plain
    version. Held: the encoder states of the two float32 runs within
    ``CRDNN_ENC_ATOL``, and their tokens equal with scores within
    ``CRDNN_SCORE_ATOL`` at decode ratio ``CRDNN_CMP_RATIO``. Over the
    recipe's 250 steps the two searches are read, not held: a
    random-weight model's best hypotheses lie within about 6e-4 of each
    other a step, and a 2e-7 change of the encoder states can flip a
    choice late in the search (``CRDNN_REDUCED``)."""
    wavs, lens = make_waveforms(NORTH, device)
    asr = crdnn_served_asr(cfg, modules, lm, tokenizer, device=device)
    frozen = not any(p.requires_grad for m in modules.values()
                     for p in m.parameters())
    # cuDNN builds its plans for each shape and type on the first call
    for autocast in (True, False):
        with torch.autocast(wavs.device.type, dtype=torch.bfloat16,
                            enabled=autocast):
            asr.encode_batch(wavs, lens)
    _crdnn_transcribe(asr, wavs[:2, :SR].contiguous(), lens[:2],
                      autocast=True)
    bf16 = _crdnn_transcribe(asr, wavs, lens, autocast=True)
    fp32 = _crdnn_transcribe(asr, wavs, lens, autocast=False)
    enc_kernel = asr.encode_batch(wavs, lens)
    with plain_versions("fused_fbank"):
        plain = _crdnn_transcribe(asr, wavs, lens, autocast=False)
        enc_plain = asr.encode_batch(wavs, lens)
    enc_diff = (enc_kernel - enc_plain).abs().max().item()
    search = asr.hparams.decoder.search_kwargs
    full_ratio = search["max_decode_ratio"]
    search["max_decode_ratio"] = CRDNN_CMP_RATIO
    try:
        cmp_kernel = _crdnn_transcribe(asr, wavs, lens, autocast=False)
        with plain_versions("fused_fbank"):
            cmp_plain = _crdnn_transcribe(asr, wavs, lens, autocast=False)
    finally:
        search["max_decode_ratio"] = full_ratio
    score_diff = float(np.max(np.abs(cmp_kernel["scores"]
                                     - cmp_plain["scores"])))
    b3_once = dict.fromkeys(KERNELS, 0)
    b3_once["fused_fbank"] = 1
    audio_s = wavs.shape[0] * wavs.shape[1] / SR
    runs = {}
    for name, run in (("bf16", bf16), ("fp32_kernel", fp32),
                      ("fp32_plain", plain)):
        runs[name] = {
            "encode_ms": run["encode_ms"], "decode_ms": run["decode_ms"],
            "steps": run["steps"],
            "audio_s_per_s": audio_s * 1e3 / (run["encode_ms"]
                                              + run["decode_ms"]),
            "launches": run["launches"],
            "hyp_lengths": [len(h) for h in run["hyps"]],
            "scores": run["scores"].tolist(),
        }
    runs["fp32_full_ratio_read"] = {
        "utterances_with_equal_tokens": sum(
            a == b for a, b in zip(fp32["hyps"], plain["hyps"])),
        "first_differing_step": [
            next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
            for a, b in zip(fp32["hyps"], plain["hyps"])],
        "max_score_diff": float(np.max(np.abs(fp32["scores"]
                                              - plain["scores"]))),
    }
    runs["fp32_compared"] = {
        "max_decode_ratio": CRDNN_CMP_RATIO, "steps": cmp_kernel["steps"],
        "max_score_diff": score_diff, "score_atol": CRDNN_SCORE_ATOL,
        "encoder_states_max_diff": enc_diff,
        "encoder_states_atol": CRDNN_ENC_ATOL,
    }
    checks = {
        "modules_frozen": frozen,
        "bf16_b3_once": bf16["launches"] == b3_once,
        "fp32_b3_once": fp32["launches"] == b3_once,
        "fp32_encoder_states_close": enc_diff <= CRDNN_ENC_ATOL,
        "fp32_tokens_equal": cmp_kernel["hyps"] == cmp_plain["hyps"],
        "fp32_scores_close": score_diff <= CRDNN_SCORE_ATOL,
        "finite": all(np.isfinite(r["scores"]).all()
                      for r in (bf16, fp32, plain)),
        "tokens_in_vocab": all(0 <= t < cfg["vocab"]
                               for r in (bf16, fp32) for h in r["hyps"]
                               for t in h),
        "eight_utterances": len(bf16["words"]) == wavs.shape[0],
    }
    return checks, runs, score_diff


def run_crdnn_sligru(cfg, tokenizer, device="cuda"):
    """One float32 ``transcribe_batch`` of ``train_BPE_1000_sligru.yaml``'s
    model (SLi-GRU encoder), no LM."""
    modules = crdnn_modules(cfg, device=device, seed=5, rnn_class="sligru")
    wavs, lens = make_waveforms(NORTH, device)
    decode = {**CRDNN_DECODE, "lm_weight": 0.0}
    asr = crdnn_served_asr(cfg, modules, None, tokenizer, device=device,
                           decode=decode)
    run = _crdnn_transcribe(asr, wavs, lens, autocast=False)
    b3_once = dict.fromkeys(KERNELS, 0)
    b3_once["fused_fbank"] = 1
    line = {"ok": bool(run["launches"] == b3_once
                       and np.isfinite(run["scores"]).all()
                       and len(run["hyps"]) == wavs.shape[0]),
            "encode_ms": run["encode_ms"], "decode_ms": run["decode_ms"],
            "steps": run["steps"], "launches": run["launches"],
            "parameters": sum(p.numel() for m in modules.values()
                              for p in m.parameters())}
    del asr, modules
    gc.collect()
    torch.cuda.empty_cache()
    return line


def run_crdnn_train(cfg, modules, out_dir, paths, device="cuda"):
    """Two bf16 Adadelta steps of the twin's ``ASR`` (8 utterances a
    batch, B3 on every batch), then its valid stage (NewBob, BatchNorm's
    running statistics); and one float32 step through B3 against its
    plain version."""
    train = asr_dataset(paths["train"], cfg, train=True, fold=True)
    valid = asr_dataset(paths["valid"], cfg, train=False, fold=True)
    for module in modules.values():
        module.requires_grad_(True)
    brain = crdnn_brain(cfg, modules, out_dir=out_dir, device=device)
    bns = _batch_norms(modules)
    stats0 = {n: bn.running_var.clone() for n, bn in bns.items()}
    loader = {"batch_size": cfg["batch_size"],
              "pad_to_multiple": {"sig": seq2seq_recipe.SIG_PAD_MULTIPLE}}
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    brain.fit(brain.hparams.epoch_counter, train, valid,
              train_loader_kwargs=loader, valid_loader_kwargs=loader)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    n_fwd = brain.forwards[Stage.TRAIN] + brain.forwards[Stage.VALID]
    expected = dict.fromkeys(KERNELS, 0)
    expected["fused_fbank"] = n_fwd
    step_ms = brain.step_ms()
    stats_moved = all(not torch.equal(stats0[n], bn.running_var)
                      for n, bn in bns.items())
    line = {
        "optimizer_steps": brain.optimizer_step,
        "forwards": {s.name: c for s, c in brain.forwards.items()},
        "launches": counts, "expected_launches": expected,
        "losses": brain.losses, "valid_losses": brain.valid_losses,
        "lr_after_valid": brain.optimizer.param_groups[0]["lr"],
        "step_ms": step_ms,
        "audio_s_per_s": brain.audio_seconds * 1e3 / sum(step_ms),
        "seconds": seconds,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "running_stats_moved": stats_moved, "batch_norms": len(bns),
    }
    ok = (counts == expected and brain.optimizer_step == CRDNN_TRAIN_STEPS
          and brain.forwards[Stage.TRAIN] == CRDNN_TRAIN_STEPS
          and all(np.isfinite(brain.losses + brain.valid_losses))
          and stats_moved)
    batch = next(iter(make_dataloader(train, **loader)))
    del brain
    gc.collect()
    torch.cuda.empty_cache()
    line["fp32_kernel_vs_plain"] = crdnn_step_kernel_vs_plain(
        cfg, batch, device=device)
    cmp = line["fp32_kernel_vs_plain"]
    line["ok"] = bool(ok and cmp["loss_rel_diff"] <= 1e-4
                      and cmp["running_stats_max_diff"] <= 1e-3)
    return line


def run_crdnn_path(out_dir, paths, cfg=CRDNN_CFG, device="cuda"):
    """The CRDNN recipe at full width: served with CTC, RNNLM and coverage
    fusion (bf16, float32 through B3 and its plain version), the sligru
    variant served once, two training steps of the twin ``ASR`` and two
    of the LM twin. Returns B3's launches in each run."""
    t0 = time.perf_counter()
    modules = crdnn_modules(cfg, device=device)
    lm = crdnn_lm(cfg, device=device)
    n_params = sum(p.numel() for m in modules.values()
                   for p in m.parameters())
    n_lm = sum(p.numel() for p in lm.parameters())
    write_covering_bpe(out_dir, cfg["vocab"])
    tokenizer = SentencePiece(out_dir, cfg["vocab"], model_type="bpe")
    build_seconds = time.perf_counter() - t0
    serve_checks, serve_runs, score_diff = run_crdnn_serve(
        cfg, modules, lm, tokenizer, device=device)
    emit({"phase": "crdnn_serve", "ok": all(serve_checks.values()),
          "checks": serve_checks, "decode": CRDNN_DECODE,
          "fp32_max_score_diff": score_diff,
          "fp32_score_atol": CRDNN_SCORE_ATOL, **serve_runs})
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    if not all(serve_checks.values()):
        raise AssertionError(f"crdnn_path serve: a check failed: "
                             f"{serve_checks}")
    sligru = run_crdnn_sligru(cfg, tokenizer, device=device)
    emit({"phase": "crdnn_sligru", **sligru})
    if not sligru["ok"]:
        raise AssertionError("crdnn_path: the sligru transcribe failed")
    train = run_crdnn_train(cfg, modules, out_dir, paths, device=device)
    emit({"phase": "crdnn_train", **train})
    del modules
    gc.collect()
    torch.cuda.empty_cache()
    if not train["ok"]:
        raise AssertionError("crdnn_path: training failed")
    lm_train = run_crdnn_lm_train(cfg, paths["train"], device=device)
    emit({"phase": "crdnn_lm_train", **lm_train})
    if not lm_train["ok"]:
        raise AssertionError("crdnn_path: LM training failed")
    emit({"phase": "crdnn_path_summary", "reduced": CRDNN_REDUCED,
          "parameters": n_params, "lm_parameters": n_lm,
          "sligru_parameters": sligru["parameters"],
          "build_seconds": build_seconds,
          "seconds": time.perf_counter() - t0,
          "gpu_name_power_limit": gpu_name_power_limit()})
    return {"serve_bf16": serve_runs["bf16"]["launches"]["fused_fbank"],
            "serve_fp32": serve_runs["fp32_kernel"]["launches"][
                "fused_fbank"],
            "sligru": sligru["launches"]["fused_fbank"],
            "train": train["launches"]["fused_fbank"]}


# -- the transducer: the LibriSpeech conformer transducer recipe -------------

# The LibriSpeech Conformer transducer recipe
# (recipes/LibriSpeech/ASR/transducer/hparams/conformer_transducer.yaml, twin
# under speechbrain_tpu_torch/recipes/LibriSpeech/ASR/transducer/) at its full
# width and depth, random weights from a seed; the search at the JAX
# searcher's defaults (beam 4, as the YAML's comment names it); the RNNLM of
# crdnn_path (RNNLM.yaml: 1000 outputs, the same vocabulary) fused at 0.5.
TRANSDUCER_CFG = dict(
    n_mels=80, n_fft=400, fe_channels=(64, 32), d_model=512, nhead=8,
    d_ffn=2048, enc_layers=12, kernel_size=31, dropout=0.1, joint_dim=640,
    joint="sum", dec_neurons=512, emb_size=128, vocab=1000, blank=0,
    bos=0, eos=0, lr=8e-4, ctc_weight=0.3, batch_size=8,
)
TRANSDUCER_DECODE = dict(beam_size=4, nbest=5, state_beam=2.3,
                         expand_beam=2.3, max_symbols_per_step=10)
TRANSDUCER_LM_WEIGHT = 0.5
# the beam searches (host-bound, one utterance at a time) run on the first
# two utterances of NORTH's batch, so that the script stays within its time
TRANSDUCER_BEAM_BATCH = 2
TRANSDUCER_REDUCED = {
    "weights": "trained checkpoints -> random weights from a seed",
    "train": "50 epochs of LibriSpeech 960 h -> two AdamW steps of 8 "
             "utterances of TRAIN's synthetic corpus (8-12 s; its token ids "
             "folded into 1..999 in place of BPE-1000), then its valid split",
    "serve": "LibriSpeech test-clean -> NORTH's batch, 8 x 10 s of noise; "
             "the beam searches on its first 2 utterances (8 until PR 12)",
    "lm": "the recipe fuses none; RNNLM.yaml's LM (random weights) at 0.5",
    "fp32_comparison": "greedy tokens held equal over the first 50 encoder "
                       "frames, and read over all 251: a random-weight "
                       "search may flip on a near tie (crdnn_path's C32)",
}
TRANSDUCER_ENC_ATOL = 1e-5
TRANSDUCER_CMP_FRAMES = 50
TRANSDUCER_LOSS_RTOL = 1e-6
TRANSDUCER_TRAIN_STEPS = 2


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def transducer_modules(cfg, device="cuda", seed=0, dropout=None):
    """The recipe's nine modules (``frontend``, ``encoder``, ``enc_proj``,
    ``emb``, ``dec``, ``dec_proj``, ``joint``, ``out``, ``ctc_head``),
    random weights from ``seed``. The front end's dropout is its default,
    0.1, as the YAML's, the same value as the encoder's."""
    gen = torch.Generator().manual_seed(seed)
    kw = dict(device=device, generator=gen)
    drop = cfg["dropout"] if dropout is None else dropout
    J = cfg["joint_dim"]
    n_feat = (cfg["n_mels"] + 3) // 4 * cfg["fe_channels"][-1]
    return {
        "frontend": ConvolutionFrontEnd(
            num_blocks=2, out_channels=cfg["fe_channels"],
            kernel_sizes=(3, 3), strides=(2, 2), dropout=drop, **kw),
        "encoder": TransformerASR(
            tgt_vocab=cfg["vocab"], input_size=n_feat,
            d_model=cfg["d_model"], nhead=cfg["nhead"],
            num_encoder_layers=cfg["enc_layers"], num_decoder_layers=0,
            d_ffn=cfg["d_ffn"], dropout=drop, encoder_module="conformer",
            kernel_size=cfg["kernel_size"], **kw),
        "enc_proj": Linear(J, cfg["d_model"], **kw),
        "emb": Embedding(cfg["vocab"], cfg["emb_size"], **kw),
        "dec": LSTM(cfg["dec_neurons"], cfg["emb_size"], **kw),
        "dec_proj": Linear(J, cfg["dec_neurons"], **kw),
        "joint": TransducerJoint(J, J, J, joint=cfg["joint"], **kw),
        "out": Linear(cfg["vocab"], J, **kw),
        "ctc_head": Linear(cfg["vocab"], J, **kw),
    }


def transducer_hparams(cfg, device="cuda", out_dir=None):
    """The twin recipe's hparams that its Brain reads, built in Python."""
    hparams = {
        "compute_features": Fbank(n_fft=cfg["n_fft"], n_mels=cfg["n_mels"],
                                  fused=True, device=device),
        "normalize": InputNormalization(norm_type="sentence"),
        "ctc_weight": cfg["ctc_weight"], "blank_index": cfg["blank"],
        "lr_annealing": NewBobScheduler(initial_value=cfg["lr"],
                                        improvement_threshold=0.0025,
                                        annealing_factor=0.8),
        "epoch_counter": EpochCounter(1),
    }
    if out_dir is not None:
        hparams["train_logger"] = FileTrainLogger(
            os.path.join(out_dir, "train_log.txt"))
    return hparams


class TimedTransducerBrain(TimedSteps, transducer_recipe.TransducerASR):
    """The transducer twin's Brain with :class:`TimedSteps`' readings."""


def transducer_brain(cfg, modules, out_dir=None, precision="bf16",
                     seed=7402, device="cuda", brain_cls=TimedTransducerBrain,
                     extra_hparams=None):
    """The twin's Brain over ``modules``: AdamW, NewBob, a stop after
    ``TRANSDUCER_TRAIN_STEPS`` optimizer steps; ``extra_hparams`` join
    ``transducer_hparams``."""
    return brain_cls(
        modules=modules, opt_class=recipe.adamw(cfg["lr"]),
        hparams={**transducer_hparams(cfg, device=device, out_dir=out_dir),
                 **(extra_hparams or {})},
        run_opts={"device": device, "precision": precision,
                  "noprogressbar": True, "seed": seed,
                  "optimizer_step_limit": TRANSDUCER_TRAIN_STEPS})


class TimedSearch:
    """A searcher that notes when it is called (the encode before it has
    ended; the device is synchronized first), when its search ends, and
    the frames it is handed."""

    def __init__(self, searcher, device):
        self.searcher, self.device = searcher, device
        self.frames = self.t_start = self.t_end = None

    def __call__(self, enc):
        _sync(self.device)
        self.t_start = time.perf_counter()
        self.frames = enc.shape[1]
        out = self.searcher(enc)
        _sync(self.device)
        self.t_end = time.perf_counter()
        return out


def _transducer_transcribe(brain, searcher, wavs, lens, autocast):
    """One ``TransducerASR.transcribe_batch`` (launch counts from 0, bf16
    autocast or float32): tokens, scores, launches, encode and decode
    ms, the frames handed to the searcher."""
    timed = TimedSearch(searcher, wavs.device)
    reset_launch_counts()
    _sync(wavs.device)
    t0 = time.perf_counter()
    with torch.autocast(wavs.device.type, dtype=torch.bfloat16,
                        enabled=autocast):
        hyps, scores, _, _ = brain.transcribe_batch(wavs, lens, timed)
    return {"hyps": hyps, "scores": scores, "launches": launch_counts(),
            "encode_ms": (timed.t_start - t0) * 1e3,
            "decode_ms": (timed.t_end - timed.t_start) * 1e3,
            "frames": timed.frames}


def run_transducer_serve(cfg, brain, lm, device="cuda"):
    """NORTH's batch through ``transcribe_batch``: bf16 greedy, beam search
    at the searcher's defaults, and the same fused with ``lm``; then
    float32 through B3 and through its plain version, held on the encoder
    states and on the greedy tokens of the first ``TRANSDUCER_CMP_FRAMES``
    frames, and read over all frames."""
    wavs, lens = make_waveforms(NORTH, device)
    greedy = brain.make_searcher(
        beam_size=1,
        max_symbols_per_step=TRANSDUCER_DECODE["max_symbols_per_step"])
    beam = brain.make_searcher(**TRANSDUCER_DECODE)
    fused = brain.make_searcher(lm=lm, lm_weight=TRANSDUCER_LM_WEIGHT,
                                **TRANSDUCER_DECODE)
    # cuDNN's plans and the first calls of every shape and type
    short = wavs[:2, :SR].contiguous()
    for autocast in (True, False):
        _transducer_transcribe(brain, greedy, short, lens[:2], autocast)
    _transducer_transcribe(brain, fused, short[:, :SR // 4].contiguous(),
                           lens[:2], True)
    few = wavs[:TRANSDUCER_BEAM_BATCH].contiguous()
    runs = {"bf16_greedy": _transducer_transcribe(brain, greedy, wavs, lens,
                                                  True),
            "bf16_beam": _transducer_transcribe(
                brain, beam, few, lens[:TRANSDUCER_BEAM_BATCH], True),
            "bf16_beam_lm": _transducer_transcribe(
                brain, fused, few, lens[:TRANSDUCER_BEAM_BATCH], True),
            "fp32_greedy_kernel": _transducer_transcribe(brain, greedy, wavs,
                                                         lens, False)}
    with plain_versions("fused_fbank"):
        runs["fp32_greedy_plain"] = _transducer_transcribe(
            brain, greedy, wavs, lens, False)
    with torch.no_grad():
        enc_kernel, enc_lens = brain.encode(wavs, lens)
        with plain_versions("fused_fbank"):
            enc_plain, _ = brain.encode(wavs, lens)
        prefix_kernel = greedy(enc_kernel[:, :TRANSDUCER_CMP_FRAMES])[0]
        prefix_plain = greedy(enc_plain[:, :TRANSDUCER_CMP_FRAMES])[0]
    enc_diff = (enc_kernel - enc_plain).abs().max().item()
    valid_frames = int(round(float(enc_lens.max()) * enc_kernel.shape[1]))
    kernel, plain = runs["fp32_greedy_kernel"], runs["fp32_greedy_plain"]
    b3_once = dict.fromkeys(KERNELS, 0)
    b3_once["fused_fbank"] = 1
    lines = {}
    for name, run in runs.items():
        audio_s = len(run["hyps"]) * wavs.shape[1] / SR
        lines[name] = {
            "encode_ms": run["encode_ms"], "decode_ms": run["decode_ms"],
            "audio_s_per_s": audio_s * 1e3 / (run["encode_ms"]
                                              + run["decode_ms"]),
            "launches": run["launches"],
            "emitted_tokens": sum(len(h) for h in run["hyps"]),
            "hyp_lengths": [len(h) for h in run["hyps"]],
            "scores": run["scores"],
        }
    lines["searcher_input"] = {
        "frames": runs["bf16_greedy"]["frames"],
        "encoder_frames_padded": enc_kernel.shape[1],
        "valid_frames": valid_frames,
        "padded_to_a_multiple_of_128": runs["bf16_greedy"]["frames"] % 128
        == 0,
        "padding_frames_decoded": runs["bf16_greedy"]["frames"]
        - valid_frames,
    }
    lines["fp32_full_read"] = {
        "utterances_with_equal_tokens": sum(
            a == b for a, b in zip(kernel["hyps"], plain["hyps"])),
        "first_differing_token": [
            next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 None if len(a) == len(b) else min(len(a), len(b)))
            for a, b in zip(kernel["hyps"], plain["hyps"])],
    }
    lines["fp32_compared"] = {
        "frames": TRANSDUCER_CMP_FRAMES,
        "tokens": sum(len(h) for h in prefix_kernel),
        "encoder_states_max_diff": enc_diff,
        "encoder_states_atol": TRANSDUCER_ENC_ATOL,
    }
    vocab_ok = all(0 < t < cfg["vocab"] for r in runs.values()
                   for h in r["hyps"] for t in h)
    checks = {
        "b3_once_a_transcribe": all(r["launches"] == b3_once
                                    for n, r in runs.items()
                                    if n != "fp32_greedy_plain"),
        "plain_run_no_kernel": sum(
            runs["fp32_greedy_plain"]["launches"].values()) == 0,
        "fp32_encoder_states_close": enc_diff <= TRANSDUCER_ENC_ATOL,
        "fp32_tokens_equal_over_prefix": prefix_kernel == prefix_plain,
        "no_padding_frame_decoded": lines["searcher_input"][
            "padding_frames_decoded"] == 0,
        "beam_scores_finite": all(
            np.isfinite(runs[n]["scores"]).all()
            for n in ("bf16_beam", "bf16_beam_lm")),
        "lm_fusion_changes_scores": runs["bf16_beam"]["scores"]
        != runs["bf16_beam_lm"]["scores"],
        "tokens_in_vocab_not_blank": vocab_ok,
        "every_utterance": all(
            len(r["hyps"]) == (TRANSDUCER_BEAM_BATCH if "beam" in n
                               else wavs.shape[0])
            for n, r in runs.items()),
        "tokens_emitted": all(sum(len(h) for h in r["hyps"]) > 0
                              for r in runs.values()),
    }
    return checks, lines


def time_transducer_loss(brain, batch, iters=5):
    """The transducer loss alone at a training batch's shape: the bf16
    forward's float32 log-probabilities (B, T, U+1, V) computed once, then
    ``iters`` times the loss's forward and its backward, each by CUDA
    events (the host's launch time included, as in a step)."""
    blank = brain.hparams.blank_index
    batch = brain._prepare_batch(batch)
    brain.modules.eval()
    with torch.no_grad(), torch.autocast(brain.device.type,
                                         dtype=torch.bfloat16):
        logp, enc_lens, *_ = brain.compute_forward(batch, Stage.VALID)
    tokens, tok_lens = batch["tokens"]
    fwd, bwd = [], []
    for _ in range(iters):
        x = logp.detach().requires_grad_(True)
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        loss = transducer_loss(x, tokens, enc_lens, tok_lens, blank)
        marks[1].record()
        loss.backward()
        marks[2].record()
        torch.cuda.synchronize()
        fwd.append(marks[0].elapsed_time(marks[1]))
        bwd.append(marks[1].elapsed_time(marks[2]))
    return {"log_probs_shape": list(logp.shape),
            "forward_ms": fwd, "backward_ms": bwd,
            "forward_ms_median": float(np.median(fwd)),
            "backward_ms_median": float(np.median(bwd)),
            "loss": float(loss.detach())}


def transducer_step_kernel_vs_plain(cfg, batch, device="cuda",
                                    extra_hparams=None):
    """One float32 training micro-batch (dropout 0, the same seed-3
    weights) through B3 and through its plain version: the losses."""
    out = {}
    for arm in ("kernel", "plain"):
        modules = transducer_modules(cfg, device=device, seed=3, dropout=0.0)
        brain = transducer_brain(cfg, modules, precision="fp32",
                                 device=device,
                                 brain_cls=transducer_recipe.TransducerASR,
                                 extra_hparams=extra_hparams)
        brain.init_optimizers()
        brain.modules.train()
        ctx = plain_versions("fused_fbank") if arm == "plain" \
            else contextlib.nullcontext()
        with ctx:
            brain.fit_batch(batch)
            out[arm] = brain._flush_pending_loss()
        del brain, modules
        gc.collect()
        torch.cuda.empty_cache()
    lk, lp = out["kernel"], out["plain"]
    return {"loss_kernel": lk, "loss_plain": lp,
            "loss_rel_diff": abs(lk - lp) / abs(lp),
            "loss_rtol": TRANSDUCER_LOSS_RTOL}


def run_transducer_train(cfg, modules, out_dir, paths, device="cuda"):
    """Two bf16 AdamW steps of the twin's Brain (8 utterances a batch, B3
    on every batch), then its valid stage (NewBob); the loss alone at the
    first batch's shape; one float32 step through B3 against its plain
    version."""
    train = asr_dataset(paths["train"], cfg, train=True, fold=True)
    valid = asr_dataset(paths["valid"], cfg, train=False, fold=True)
    brain = transducer_brain(cfg, modules, out_dir=out_dir, device=device)
    loader = {"batch_size": cfg["batch_size"],
              "pad_to_multiple": {"sig": transducer_recipe.SIG_PAD_MULTIPLE}}
    gc.collect()
    _sync(device)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    brain.fit(brain.hparams.epoch_counter, train, valid,
              train_loader_kwargs=loader, valid_loader_kwargs=loader)
    _sync(device)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = launch_counts()
    n_fwd = brain.forwards[Stage.TRAIN] + brain.forwards[Stage.VALID]
    expected = dict.fromkeys(KERNELS, 0)
    expected["fused_fbank"] = n_fwd
    step_ms = brain.step_ms()
    forwards = {s.name: c for s, c in brain.forwards.items()}
    batch = next(iter(make_dataloader(train, **loader)))
    loss_alone = time_transducer_loss(brain, batch)
    loss_alone["share_of_median_step"] = (
        (loss_alone["forward_ms_median"] + loss_alone["backward_ms_median"])
        / float(np.median(step_ms)))
    line = {
        "optimizer_steps": brain.optimizer_step, "forwards": forwards,
        "launches": counts, "expected_launches": expected,
        "losses": brain.losses, "valid_losses": brain.valid_losses,
        "lr_after_valid": brain.optimizer.param_groups[0]["lr"],
        "step_ms": step_ms,
        "audio_s_per_s": brain.audio_seconds * 1e3 / sum(step_ms),
        "seconds": seconds, "max_memory_allocated_bytes": peak,
        "batch_shape": list(batch["sig"].data.shape),
        "transducer_loss_alone": loss_alone,
    }
    ok = (counts == expected
          and brain.optimizer_step == TRANSDUCER_TRAIN_STEPS
          and brain.forwards[Stage.TRAIN] == TRANSDUCER_TRAIN_STEPS
          and all(np.isfinite(brain.losses + brain.valid_losses)))
    del brain
    gc.collect()
    torch.cuda.empty_cache()
    line["fp32_kernel_vs_plain"] = cmp = transducer_step_kernel_vs_plain(
        cfg, batch, device=device)
    line["ok"] = bool(ok and cmp["loss_rel_diff"] <= TRANSDUCER_LOSS_RTOL)
    return line


def run_transducer_path(out_dir, paths, cfg=TRANSDUCER_CFG, lm_cfg=CRDNN_CFG,
                        device="cuda"):
    """The transducer recipe at full width: served greedy and by beam
    search with and without the RNNLM (bf16), greedy in float32 through B3
    and its plain version, two training steps and the valid stage.
    Returns B3's launches in each run and the first training batch's
    waveform shape."""
    t0 = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    modules = transducer_modules(cfg, device=device)
    lm = crdnn_lm(lm_cfg, device=device).eval()
    n_params = sum(p.numel() for m in modules.values()
                   for p in m.parameters())
    build_seconds = time.perf_counter() - t0
    brain = transducer_brain(cfg, modules, device=device)
    checks, serve = run_transducer_serve(cfg, brain, lm, device=device)
    emit({"phase": "transducer_serve", "ok": all(checks.values()),
          "checks": checks, "decode": TRANSDUCER_DECODE,
          "lm_weight": TRANSDUCER_LM_WEIGHT, **serve})
    del brain, lm
    gc.collect()
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"transducer_path serve: a check failed: "
                             f"{checks}")
    train = run_transducer_train(cfg, modules, out_dir, paths, device=device)
    emit({"phase": "transducer_train", **train})
    del modules
    gc.collect()
    torch.cuda.empty_cache()
    if not train["ok"]:
        raise AssertionError("transducer_path: training failed")
    emit({"phase": "transducer_path_summary", "reduced": TRANSDUCER_REDUCED,
          "parameters": n_params, "build_seconds": build_seconds,
          "seconds": time.perf_counter() - t0,
          "gpu_name_power_limit": gpu_name_power_limit()})
    launches = {name: serve[name]["launches"]["fused_fbank"]
                for name in ("bf16_greedy", "bf16_beam", "bf16_beam_lm",
                             "fp32_greedy_kernel")}
    launches["train"] = train["launches"]["fused_fbank"]
    return launches, train["batch_shape"]


# -- the LibriSpeech CTC, BayesSpeech and Transformer-LM twins ---------------

# recipes/LibriSpeech/ASR/CTC/hparams/{conformer_large,train,
# branchformer_large}.yaml at their full width and depth (33 characters,
# blank 0), random weights from a seed; each with the steps ctc_path takes.
CTC_CFG = dict(n_mels=80, fe_channels=(64, 32), kernel_size=31, dropout=0.1,
               vocab=33, blank=0, bos=0, eos=0, lr=5e-4, batch_size=8)
CTC_FAMILIES = {
    "conformer_large": dict(d_model=512, nhead=8, enc_layers=18, d_ffn=2048,
                            encoder_module="conformer", steps=2, serve=True),
    "train": dict(d_model=256, nhead=4, enc_layers=12, d_ffn=1024,
                  encoder_module="conformer", steps=1, serve=False),
    "branchformer_large": dict(d_model=512, nhead=8, enc_layers=18,
                               d_ffn=2048, encoder_module="branchformer",
                               steps=1, serve=False),
}
# recipes/LibriSpeech/ASR/transformer/hparams/bayesspeech.yaml: a d-144
# transformer (12 encoder, 4 decoder layers, 5000 outputs) whose every weight
# is a posterior (mu, rho)
BAYES_CFG = dict(
    n_mels=80, fe_channels=(64, 32), d_model=144, nhead=4, enc_layers=12,
    dec_layers=4, d_ffn=1024, kernel_size=31, dropout=0.1, vocab=5000,
    encoder_module="transformer", attention_type="regularMHA",
    ctc_weight=0.3, label_smoothing=0.1, kl_div_weight=1e-6, prior_std=0.1,
    lr_adam=8e-4, n_warmup_steps=25000, batch_size=16,
    grad_accumulation_factor=2, max_grad_norm=5.0, epochs=2, bos=1, eos=2,
    blank=0,
)
BAYES_TRAIN_STEPS = 2
BAYES_LOSS_RTOL = 1e-6
BAYES_LOGP_ATOL = 1e-4
# recipes/LibriSpeech/LM/hparams/transformer.yaml
TLM_CFG = dict(vocab=5000, d_model=768, nhead=12, layers=12, d_ffn=3072,
               dropout=0.1, lr=1e-4, batch_size=32, bos=0, eos=0)
TLM_TRAIN_STEPS = 2
CTC_PATH_REDUCED = {
    "weights": "random weights from a seed",
    "ctc": "30 epochs of LibriSpeech 960 h -> two AdamW steps "
           "(conformer_large) or one (train, branchformer_large) of 8 "
           "utterances of TRAIN's corpus, its token ids folded into 1..32 "
           "in place of characters; served on NORTH's batch",
    "bayesspeech": "120 epochs -> two optimizer steps (4 micro-batches of "
                   "16, accumulation 2) of TRAIN's corpus and its token ids; "
                   "Noam's warm-up of 25000 kept",
    "transformer_lm": "20 epochs of the LM corpus -> two AdamW steps of 32 "
                      "sequences of TRAIN's token ids folded into 1..4999",
}


class TimedCTCBrain(TimedSteps, ctc_recipe.ASRCTC):
    """The CTC twin's Brain with :class:`TimedSteps`' readings."""


class TimedBayesBrain(TimedSteps, bayes_recipe.BayesASR):
    """The BayesSpeech twin's Brain with :class:`TimedSteps`' readings and
    each micro-batch's KL term."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.kls = []

    def on_fit_batch_end(self, batch, outputs, loss, should_step):
        super().on_fit_batch_end(batch, outputs, loss, should_step)
        self.kls.append(float(self.last_kl))


def ctc_modules(cfg, family, device="cuda", seed=0):
    """The CTC recipe's three modules at ``family``'s width."""
    gen = torch.Generator().manual_seed(seed)
    kw = dict(device=device, generator=gen)
    n_feat = (cfg["n_mels"] + 3) // 4 * cfg["fe_channels"][-1]
    return {
        "frontend": ConvolutionFrontEnd(
            num_blocks=2, out_channels=cfg["fe_channels"],
            kernel_sizes=(3, 3), strides=(2, 2), **kw),
        "encoder": TransformerASR(
            tgt_vocab=cfg["vocab"], input_size=n_feat,
            d_model=family["d_model"], nhead=family["nhead"],
            num_encoder_layers=family["enc_layers"], num_decoder_layers=0,
            d_ffn=family["d_ffn"], dropout=cfg["dropout"],
            encoder_module=family["encoder_module"],
            attention_type="RelPosMHAXL", kernel_size=cfg["kernel_size"],
            **kw),
        "ctc_head": Linear(cfg["vocab"], family["d_model"], **kw),
    }


def _peak_and_reset(device):
    _sync(device)
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    return peak


def run_ctc_family(name, paths, device="cuda"):
    """One CTC hparams file at full width: (conformer_large) NORTH's batch
    through ``transcribe_batch`` in bf16, then its bf16 AdamW steps on
    TRAIN's corpus."""
    cfg, family = CTC_CFG, CTC_FAMILIES[name]
    modules = ctc_modules(cfg, family, device=device)
    n_params = sum(p.numel() for m in modules.values()
                   for p in m.parameters())
    hparams = {"compute_features": Fbank(n_mels=cfg["n_mels"], fused=True,
                                         device=device),
               "normalize": InputNormalization(norm_type="sentence"),
               "blank_index": cfg["blank"]}
    brain = TimedCTCBrain(
        modules=modules, opt_class=recipe.adamw(cfg["lr"]), hparams=hparams,
        run_opts={"device": device, "precision": "bf16",
                  "noprogressbar": True, "seed": 1234,
                  "optimizer_step_limit": family["steps"]})
    line = {"parameters": n_params}
    if family["serve"]:
        wavs, lens = make_waveforms(NORTH, device)
        with torch.autocast(wavs.device.type, dtype=torch.bfloat16):
            brain.transcribe_batch({"sig": (wavs[:2, :SR].contiguous(),
                                            lens[:2])})
            reset_launch_counts()
            _sync(device)
            t0 = time.perf_counter()
            hyps = brain.transcribe_batch({"sig": (wavs, lens)})
            _sync(device)
        serve_ms = (time.perf_counter() - t0) * 1e3
        line["serve"] = {
            "ms": serve_ms, "launches": launch_counts(),
            "audio_s_per_s": wavs.numel() / SR * 1e3 / serve_ms,
            "hyp_lengths": [len(h) for h in hyps],
            "ok": bool(launch_counts()["fused_fbank"] == 1
                       and len(hyps) == wavs.shape[0]
                       and all(0 < c < cfg["vocab"] for h in hyps
                               for c in h)),
        }
    train = asr_dataset(paths["train"], cfg, train=True, fold=True)
    loader = {"batch_size": cfg["batch_size"],
              "pad_to_multiple": {"sig": ctc_recipe.SIG_PAD_MULTIPLE}}
    _peak_and_reset(device)
    reset_launch_counts()
    brain.fit(EpochCounter(1), train, train_loader_kwargs=loader)
    counts = launch_counts()
    line.update({
        "optimizer_steps": brain.optimizer_step, "losses": brain.losses,
        "step_ms": brain.step_ms(), "launches": counts,
        "max_memory_allocated_bytes": _peak_and_reset(device),
    })
    line["ok"] = bool(
        brain.optimizer_step == family["steps"]
        and counts["fused_fbank"] == family["steps"]
        and sum(counts.values()) == family["steps"]
        and all(np.isfinite(brain.losses))
        and line.get("serve", {"ok": True})["ok"])
    del brain, modules
    gc.collect()
    torch.cuda.empty_cache()
    return line


def run_bayes(paths, device="cuda"):
    """BayesSpeech at full width: two bf16 optimizer steps (accumulation 2)
    drawing the weights from the posterior, the KL term of each
    micro-batch; then one float32 evaluation forward on ``mu`` through B3
    and through its plain version."""
    cfg = BAYES_CFG
    modules = make_asr_modules(cfg, device=device)
    hparams = {**make_asr_hparams(cfg, device=device),
               "kl_div_weight": cfg["kl_div_weight"],
               "prior_std": cfg["prior_std"]}
    brain = TimedBayesBrain(
        modules=modules, opt_class=recipe.adamw(cfg["lr_adam"]),
        hparams=hparams,
        run_opts={"device": device, "precision": "bf16",
                  "noprogressbar": True, "seed": 74443,
                  "grad_accumulation_factor":
                      cfg["grad_accumulation_factor"],
                  "max_grad_norm": cfg["max_grad_norm"],
                  "optimizer_step_limit": BAYES_TRAIN_STEPS})
    rho = brain.modules["rho"]
    rho0 = {k: v.detach().clone() for k, v in rho.state_dict().items()}
    mu_params = sum(p.numel() for n, m in brain.modules.items()
                    if n != "rho" for p in m.parameters())
    train = asr_dataset(paths["train"], cfg, train=True)
    loader = {"batch_size": cfg["batch_size"],
              "pad_to_multiple": {"sig": recipe.SIG_PAD_MULTIPLE}}
    _peak_and_reset(device)
    reset_launch_counts()
    brain.fit(EpochCounter(cfg["epochs"]), train,
              train_loader_kwargs=loader)
    counts = launch_counts()
    in_optimizer = {id(p) for g in brain.optimizer.param_groups
                    for p in g["params"]}
    rho_moved = any(not torch.equal(v, rho0[k])
                    for k, v in rho.state_dict().items())
    line = {
        "optimizer_steps": brain.optimizer_step, "losses": brain.losses,
        "kl_terms": brain.kls,
        "kl_weighted": [cfg["kl_div_weight"] * k for k in brain.kls],
        "step_ms": brain.step_ms(), "launches": counts,
        "max_memory_allocated_bytes": _peak_and_reset(device),
        "mu_parameters": mu_params,
        "rho_parameters": sum(p.numel() for p in rho.parameters()),
        "rho_in_optimizer": all(id(p) in in_optimizer
                                for p in rho.parameters()),
        "rho_in_state_dict": any(k.startswith("rho.")
                                 for k in brain.modules.state_dict()),
        "rho_moved": rho_moved,
    }
    n_micro = BAYES_TRAIN_STEPS * cfg["grad_accumulation_factor"]
    ok = (brain.optimizer_step == BAYES_TRAIN_STEPS
          and counts["fused_fbank"] == n_micro
          and sum(counts.values()) == n_micro
          and all(np.isfinite(brain.losses + brain.kls))
          and line["rho_in_optimizer"] and line["rho_in_state_dict"]
          and rho_moved and line["rho_parameters"] == mu_params)
    # the evaluation forward, on mu, float32
    batch = brain._prepare_batch(next(iter(make_dataloader(train,
                                                           **loader))))
    brain.modules.eval()
    out = {}
    with torch.no_grad():
        for arm in ("kernel", "plain"):
            ctx = plain_versions("fused_fbank") if arm == "plain" \
                else contextlib.nullcontext()
            reset_launch_counts()
            with ctx:
                preds = brain.compute_forward(batch, Stage.VALID)
                loss = brain.compute_objectives(preds, batch, Stage.VALID)
            out[arm] = (preds, float(loss), launch_counts()["fused_fbank"])
    (pk, lk, nk), (pp, lp, npl) = out["kernel"], out["plain"]
    logp_diff = max((a - b).abs().max().item() for a, b in zip(pk, pp))
    line["fp32_eval_kernel_vs_plain"] = {
        "loss_kernel": lk, "loss_plain": lp,
        "loss_rel_diff": abs(lk - lp) / abs(lp), "loss_rtol": BAYES_LOSS_RTOL,
        "log_probs_max_diff": logp_diff, "log_probs_atol": BAYES_LOGP_ATOL,
        "b3_launches": [nk, npl],
    }
    line["ok"] = bool(ok and abs(lk - lp) / abs(lp) <= BAYES_LOSS_RTOL
                      and logp_diff <= BAYES_LOGP_ATOL and [nk, npl] == [1, 0])
    del brain, modules
    gc.collect()
    torch.cuda.empty_cache()
    return line


def run_transformer_lm(paths, device="cuda"):
    """Two bf16 AdamW steps of the LM twin with ``transformer.yaml``'s
    ``TransformerLM`` at batch 32 of TRAIN's token sequences."""
    cfg = TLM_CFG
    lm = TransformerLM(cfg["vocab"], d_model=cfg["d_model"],
                       nhead=cfg["nhead"], num_encoder_layers=cfg["layers"],
                       d_ffn=cfg["d_ffn"], dropout=cfg["dropout"],
                       device=device,
                       generator=torch.Generator().manual_seed(11))
    brain = lm_recipe.LM(
        modules={"lm": lm}, opt_class=lm_recipe.adamw(cfg["lr"]),
        hparams={"lr_annealing": NewBobScheduler(cfg["lr"])},
        run_opts={"device": device, "precision": "bf16",
                  "noprogressbar": True,
                  "optimizer_step_limit": TLM_TRAIN_STEPS})
    losses = []
    brain.on_fit_batch_end = (lambda batch, outputs, loss, should_step:
                              losses.append(float(loss)))
    _peak_and_reset(device)
    reset_launch_counts()
    _sync(device)
    t0 = time.perf_counter()
    brain.fit(EpochCounter(1), lm_token_dataset(paths["train"], cfg),
              train_loader_kwargs={"batch_size": cfg["batch_size"]})
    _sync(device)
    line = {"ok": bool(brain.optimizer_step == TLM_TRAIN_STEPS
                       and len(losses) == TLM_TRAIN_STEPS
                       and all(np.isfinite(losses))
                       and sum(launch_counts().values()) == 0),
            "optimizer_steps": brain.optimizer_step, "losses": losses,
            "seconds": time.perf_counter() - t0,
            "max_memory_allocated_bytes": _peak_and_reset(device),
            "parameters": sum(p.numel() for p in lm.parameters())}
    del brain, lm
    gc.collect()
    torch.cuda.empty_cache()
    return line


def run_ctc_path(paths, device="cuda"):
    """The LibriSpeech CTC twin's three hparams files, BayesSpeech and the
    Transformer LM at full width. Returns B3's launches in each run."""
    t0 = time.perf_counter()
    launches = {}
    for name in CTC_FAMILIES:
        line = run_ctc_family(name, paths, device=device)
        emit({"phase": f"ctc_path/ctc_{name}", **line})
        if not line["ok"]:
            raise AssertionError(f"ctc_path: the CTC twin's {name} failed")
        if "serve" in line:
            launches[f"ctc_{name}.yaml_serve"] = line["serve"]["launches"][
                "fused_fbank"]
        launches[f"ctc_{name}.yaml_train"] = line["launches"]["fused_fbank"]
    bayes = run_bayes(paths, device=device)
    emit({"phase": "ctc_path/bayesspeech", **bayes})
    if not bayes["ok"]:
        raise AssertionError("ctc_path: BayesSpeech failed")
    launches["bayesspeech_train"] = bayes["launches"]["fused_fbank"]
    launches["bayesspeech_fp32_eval"] = bayes["fp32_eval_kernel_vs_plain"][
        "b3_launches"][0]
    tlm = run_transformer_lm(paths, device=device)
    emit({"phase": "ctc_path/transformer_lm", **tlm})
    if not tlm["ok"]:
        raise AssertionError("ctc_path: the Transformer LM failed")
    emit({"phase": "ctc_path_summary", "reduced": CTC_PATH_REDUCED,
          "seconds": time.perf_counter() - t0,
          "gpu_name_power_limit": gpu_name_power_limit()})
    return launches


# -- streaming: the LibriSpeech streaming Conformer transducer -----------------

# recipes/LibriSpeech/ASR/transducer/hparams/conformer_transducer_streaming.yaml
# (twin under speechbrain_tpu_torch/recipes/LibriSpeech/ASR/transducer/):
# conformer_transducer.yaml's model (TRANSDUCER_CFG: full width and depth)
# trained with dynamic chunks and served chunk by chunk at its test_config.
STREAMING_SAMPLER = dict(chunkwise_prob=0.6, chunk_size_min=8,
                         chunk_size_max=32, limited_left_context_prob=0.75,
                         left_context_chunks_min=2,
                         left_context_chunks_max=32)
# the YAML's valid_config and test_config
STREAMING_CONFIG = dict(chunk_size=24, left_context_size=4)
# the front end's two stride-2 blocks: four feature frames an encoder frame
STREAMING_FRONTEND_STRIDE = 4
# the training step with a chunked configuration forced: the sampler's
# smallest chunk and smallest limited left context
STREAMING_FORCED = dict(chunk_size=8, left_context_size=2)
# float32: the streamed states against the chunked offline encode of the
# same front-end outputs (the attention's sums in another order and over
# other lengths), and through B3 against its plain version (C32's 1e-5)
STREAMING_ENC_ATOL = 1e-4
STREAMING_B3_ATOL = 1e-5
STREAMING_CMP_FRAMES = 50
# the TIMIT twin (its YAML is conformer_transducer.yaml's but for the output
# folder and the valid manifest): prepare_synthetic's 8 train utterances in
# two micro-batches
TIMIT_BATCH = 4
STREAMING_REDUCED = {
    "weights": "trained checkpoints -> random weights from a seed",
    "serve": "LibriSpeech test-clean -> NORTH's batch, 8 x 10 s of noise, "
             "11 chunks of 0.96 s (the last padded with zeros), and one "
             "10 s WAV through transcribe_file_streaming",
    "train": "50 epochs of LibriSpeech 960 h with a chunk configuration "
             "drawn a batch -> two AdamW steps of 8 utterances of TRAIN's "
             "synthetic corpus (token ids folded into 1..999), one step "
             "with chunk 8 and left context 2 forced, the valid stage",
    "fp32_comparison": "streaming greedy tokens through B3 and its plain "
                       "version held over the first 50 encoder frames, "
                       "read over all 264 (C32)",
    "timit": "TIMIT -> timit_prepare.prepare_synthetic (8 train, 2 valid "
             "utterances of 0.3 s), batch 8 -> 4, one epoch of two "
             "micro-batches (--debug)",
}


class RecordedSampler:
    """A dynamic chunk sampler that notes each draw (``draws``: stage and
    ``[chunk_size, left_context_size]`` or None); where ``forced`` is set
    it replaces the training draws."""

    def __init__(self, sampler, forced=None):
        self.sampler, self.forced, self.draws = sampler, forced, []

    def __call__(self, stage):
        if self.forced is not None and stage == Stage.TRAIN:
            config = self.forced
        else:
            config = self.sampler(stage)
        self.draws.append([stage.name, None if config is None else [
            config.chunk_size, config.left_context_size]])
        return config


def streaming_hparams(forced=None):
    """The streaming YAML's additions to the twin's hparams: ``streaming``
    and its sampler (seed 875, recorded)."""
    valid = DynChunkTrainConfig(**STREAMING_CONFIG)
    sampler = DynChunkTrainConfigRandomSampler(
        **STREAMING_SAMPLER, valid_config=valid, test_config=valid)
    return {"streaming": True,
            "dynchunktrain_config_sampler": RecordedSampler(sampler, forced)}


def _ms_stats(values):
    return {"median": float(np.median(values)), "worst": float(max(values)),
            "all": values}


def _departure(ours, ref, frames_a_chunk):
    """Max absolute difference and the relative L2 of ``ours - ref`` (B,
    T, D), over all frames and chunk by chunk."""
    diff = (ours - ref).float()
    B, T, D = diff.shape
    chunks = diff.reshape(B, T // frames_a_chunk, frames_a_chunk * D)
    ref_chunks = ref.float().reshape(chunks.shape)
    return {"max_abs": diff.abs().max().item(),
            "relative_l2": (diff.norm() / ref.float().norm()).item(),
            "max_abs_by_chunk": chunks.abs().amax(dim=(0, 2)).tolist(),
            "relative_l2_by_chunk": (chunks.norm(dim=(0, 2))
                                     / ref_chunks.norm(dim=(0, 2))).tolist()}


class StreamRun:
    """One pass of a batch of waveforms through ``StreamingASR.
    transcribe_chunk``, chunk after chunk (launch counts from 0)."""

    def __init__(self, serve, asr, wavs, config, autocast, keep=False,
                 marks=False, n_chunks=None):
        chunk = asr.get_chunk_size_frames(config)
        audio_samples = wavs.shape[1]
        total = -(-audio_samples // chunk)
        n_chunks = n_chunks or total
        wavs = torch.nn.functional.pad(wavs, (0, total * chunk
                                              - wavs.shape[1]))
        serve.keep = [] if keep else None
        serve.marks = [] if marks else None
        serve.tokens = [[] for _ in range(wavs.shape[0])]
        context = asr.make_streaming_context(config, batch=wavs.shape[0])
        self.texts = [""] * wavs.shape[0]
        reset_launch_counts()
        _sync(wavs.device)
        t0 = time.perf_counter()
        with torch.autocast(wavs.device.type, dtype=torch.bfloat16,
                            enabled=autocast):
            for i in range(n_chunks):
                new = asr.transcribe_chunk(
                    context, wavs[:, i * chunk:(i + 1) * chunk])
                self.texts = [a + b for a, b in zip(self.texts, new)]
        _sync(wavs.device)
        self.seconds = time.perf_counter() - t0
        self.launches = launch_counts()
        self.n_chunks = n_chunks
        self.audio_seconds = wavs.shape[0] * n_chunks * chunk / SR
        # the share of the streamed samples that are audio, not tail padding
        self.audio_fraction = audio_samples / (total * chunk)
        self.tokens = serve.tokens
        self.kept = serve.keep
        self.marks = serve.marks
        serve.keep = serve.marks = None

    def chunk_ms(self):
        """Each chunk's encode (features included) and decode ms."""
        torch.cuda.synchronize()
        return ([a.elapsed_time(b) for a, b, _ in self.marks],
                [b.elapsed_time(c) for _, b, c in self.marks])

    def states(self):
        return torch.cat([k[-1] for k in self.kept], dim=1)


def streaming_departures(brain, run, config):
    """The streamed states, and how far they lie from offline encodes of
    the same feature frames (float32; the launch counts are left as they
    are):
    ``encoder``, the chunked offline encode of the concatenated per-chunk
    front-end outputs (the encoder's streaming alone); ``frontend_edges``,
    the front end run over the concatenated per-chunk normalised features
    (the front end's zero padding at chunk edges); ``normalization``, the
    features normalised over the stream's audio (its relative length, as
    an offline caller gives it), then as ``frontend_edges`` (both
    departures); ``normalization_with_padding``, the same with the
    statistics over the tail padding too."""
    modules = brain.modules
    streamed = run.states()
    feats = torch.cat([k[0] for k in run.kept], dim=1)
    normed = torch.cat([k[1] for k in run.kept], dim=1)
    fronts = torch.cat([k[2] for k in run.kept], dim=1)
    ones = torch.ones(feats.shape[0], device=feats.device)
    with torch.no_grad():
        def encode(front):
            return modules.enc_proj(modules.encoder.encode(
                front, dynchunktrain_config=config))

        offline = {
            "encoder": encode(fronts),
            "frontend_edges": encode(modules.frontend(normed)),
            "normalization": encode(modules.frontend(
                brain.hparams.normalize(feats, ones * run.audio_fraction))),
            "normalization_with_padding": encode(modules.frontend(
                brain.hparams.normalize(feats, ones))),
        }
    return streamed, {name: _departure(streamed, ref, config.chunk_size)
                      for name, ref in offline.items()}


def run_streaming_serve(cfg, brain, tokenizer, out_dir, device="cuda"):
    """``StreamingASR`` over ``StreamingServe``: NORTH's batch chunk by
    chunk in bf16 (per-chunk ms, audio-s/s, tokens, B3 a chunk); in
    float32 through B3 and through its plain version (the streamed states
    against the chunked offline encode, the streaming greedy against
    greedy over the concatenated states, B3 against plain); the
    departures of the chunked front end and normalisation; and
    ``transcribe_file_streaming`` of one 10 s WAV."""
    config = DynChunkTrainConfig(**STREAMING_CONFIG)
    serve = StreamingServe(brain, cfg, device)
    asr = serve.asr(tokenizer)
    wavs, _ = make_waveforms(NORTH, device)
    # cuDNN's plans and the first calls of every shape and type
    for autocast in (True, False):
        StreamRun(serve, asr, wavs, config, autocast, n_chunks=2)
    bf16 = StreamRun(serve, asr, wavs, config, True, marks=True)
    encode_ms, decode_ms = bf16.chunk_ms()
    kernel = StreamRun(serve, asr, wavs, config, False, keep=True)
    with plain_versions("fused_fbank"):
        plain = StreamRun(serve, asr, wavs, config, False, keep=True)
    streamed, departures = streaming_departures(brain, kernel, config)
    searcher = serve.searcher
    greedy_whole = searcher(streamed)[0]
    plain_states = plain.states()
    b3_diff = (streamed - plain_states).abs().max().item()
    prefix_kernel = searcher(streamed[:, :STREAMING_CMP_FRAMES])[0]
    prefix_plain = searcher(plain_states[:, :STREAMING_CMP_FRAMES])[0]
    wav_path = os.path.join(out_dir, "stream.wav")
    write_audio(wav_path, wavs[0].cpu().numpy(), SR)
    reset_launch_counts()
    _sync(device)
    t0 = time.perf_counter()
    pieces = list(asr.transcribe_file_streaming(wav_path, config))
    _sync(device)
    file_ms = (time.perf_counter() - t0) * 1e3
    file_launches = launch_counts()
    chunk_seconds = asr.get_chunk_size_frames(config) / SR
    b3_chunks = dict.fromkeys(KERNELS, 0)
    b3_chunks["fused_fbank"] = bf16.n_chunks
    lines = {
        "config": STREAMING_CONFIG,
        "chunk_samples": asr.get_chunk_size_frames(config),
        "chunk_seconds": chunk_seconds, "chunks": bf16.n_chunks,
        "wrapper_context_samples": 2 * serve.fea.get_required_padding(),
        "wrapper_lag_frames": serve.fea.get_output_count_per_pad_frame(),
        "encoder_frames_a_chunk": kernel.kept[0][-1].shape[1],
        "bf16": {
            "encode_ms": _ms_stats(encode_ms),
            "decode_ms": _ms_stats(decode_ms),
            "seconds": bf16.seconds,
            "audio_s_per_s": bf16.audio_seconds / bf16.seconds,
            "launches": bf16.launches,
            "emitted_tokens": sum(len(t) for t in bf16.tokens),
            "text_chars": [len(t) for t in bf16.texts],
        },
        "fp32": {
            "seconds_kernel": kernel.seconds, "seconds_plain": plain.seconds,
            "launches_kernel": kernel.launches,
            "launches_plain": plain.launches,
            "streamed_vs_offline_chunked_encode": departures["encoder"],
            "streamed_vs_offline_atol": STREAMING_ENC_ATOL,
            "departure_frontend_chunk_edges": departures["frontend_edges"],
            "departure_frontend_edges_and_normalization":
                departures["normalization"],
            "departure_frontend_edges_and_normalization_with_padding":
                departures["normalization_with_padding"],
            "b3_vs_plain_states_max_diff": b3_diff,
            "b3_vs_plain_atol": STREAMING_B3_ATOL,
            "b3_vs_plain_tokens_over_frames": STREAMING_CMP_FRAMES,
            "b3_vs_plain_full_read_equal_utterances": sum(
                a == b for a, b in zip(kernel.tokens, plain.tokens)),
            "streaming_tokens": sum(len(t) for t in kernel.tokens),
        },
        "file": {"ms": file_ms, "launches": file_launches,
                 "chunks": len(pieces),
                 "text_chars": len("".join(pieces).strip())},
    }
    checks = {
        "b3_once_a_chunk": bf16.launches == b3_chunks
        and kernel.launches == b3_chunks,
        "plain_run_no_kernel": sum(plain.launches.values()) == 0,
        "streamed_equals_offline_chunked_encode":
            departures["encoder"]["max_abs"] <= STREAMING_ENC_ATOL,
        "streaming_tokens_equal_greedy_over_streamed_states":
            kernel.tokens == greedy_whole,
        "fp32_b3_states_close": b3_diff <= STREAMING_B3_ATOL,
        "fp32_tokens_equal_over_prefix": prefix_kernel == prefix_plain,
        "file_b3_once_a_chunk": file_launches["fused_fbank"] == len(pieces)
        == -(-int(SR * NORTH["seconds"]) // asr.get_chunk_size_frames(
            config)),
        "tokens_emitted": sum(len(t) for t in bf16.tokens) > 0
        and all(np.isfinite(encode_ms + decode_ms)),
        "tokens_in_vocab_not_blank": all(
            0 < t < cfg["vocab"] for r in (bf16, kernel, plain)
            for row in r.tokens for t in row),
    }
    return checks, lines


def run_streaming_train(cfg, modules, out_dir, paths, device="cuda"):
    """Two bf16 AdamW steps of the streaming twin (a chunk configuration
    drawn for each), its valid stage under ``valid_config``, one bf16 step
    with ``STREAMING_FORCED``, and one float32 step under the test
    configuration through B3 against its plain version."""
    train = asr_dataset(paths["train"], cfg, train=True, fold=True)
    valid = asr_dataset(paths["valid"], cfg, train=False, fold=True)
    extra = streaming_hparams()
    sampler = extra["dynchunktrain_config_sampler"]
    brain = transducer_brain(cfg, modules, out_dir=out_dir, device=device,
                             extra_hparams=extra)
    loader = {"batch_size": cfg["batch_size"],
              "pad_to_multiple": {"sig": transducer_recipe.SIG_PAD_MULTIPLE}}
    gc.collect()
    _sync(device)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    brain.fit(brain.hparams.epoch_counter, train, valid,
              train_loader_kwargs=loader, valid_loader_kwargs=loader)
    _sync(device)
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    n_fwd = brain.forwards[Stage.TRAIN] + brain.forwards[Stage.VALID]
    expected = dict.fromkeys(KERNELS, 0)
    expected["fused_fbank"] = n_fwd
    fit_draws = list(sampler.draws)
    batch = next(iter(make_dataloader(train, **loader)))
    sampler.forced = DynChunkTrainConfig(**STREAMING_FORCED)
    brain.modules.train()
    brain.on_fit_batch_start(batch)
    brain.fit_batch(batch)
    forced_loss = brain._flush_pending_loss()
    step_ms = brain.step_ms()
    peak = torch.cuda.max_memory_allocated()
    line = {
        "optimizer_steps": brain.optimizer_step,
        "forwards": {s.name: c for s, c in brain.forwards.items()},
        "sampler_draws": fit_draws,
        "forced_draw": sampler.draws[len(fit_draws):],
        "launches": counts, "expected_launches": expected,
        "losses": brain.losses, "valid_losses": brain.valid_losses,
        "forced_step_loss": forced_loss,
        "step_ms": step_ms, "seconds": seconds,
        "audio_s_per_s": brain.audio_seconds * 1e3 / sum(step_ms),
        "max_memory_allocated_bytes": peak,
        "batch_shape": list(batch["sig"].data.shape),
    }
    train_draws = [d for d in fit_draws if d[0] == "TRAIN"]
    ok = (counts == expected
          and brain.forwards[Stage.TRAIN] == TRANSDUCER_TRAIN_STEPS + 1
          and len(train_draws) == TRANSDUCER_TRAIN_STEPS
          and all(d == ["VALID", list(STREAMING_CONFIG.values())]
                  for d in fit_draws if d[0] == "VALID")
          and sampler.draws[-1] == ["TRAIN",
                                    list(STREAMING_FORCED.values())]
          and all(np.isfinite(brain.losses + brain.valid_losses)))
    del brain
    gc.collect()
    torch.cuda.empty_cache()
    line["fp32_kernel_vs_plain"] = cmp = transducer_step_kernel_vs_plain(
        cfg, batch, device=device, extra_hparams=streaming_hparams(
            forced=DynChunkTrainConfig(**STREAMING_CONFIG)))
    line["ok"] = bool(ok and cmp["loss_rel_diff"] <= TRANSDUCER_LOSS_RTOL)
    return line


def timit_hparams(cfg, out_dir, device="cuda"):
    """The TIMIT twin's hparams (its YAML's, built in Python) at full
    width, batch ``TIMIT_BATCH``."""
    data = os.path.join(out_dir, "data")
    save = os.path.join(out_dir, "save")
    return {
        **transducer_hparams(cfg, device=device, out_dir=out_dir),
        "data_folder": data, "save_folder": save,
        "train_annotation": os.path.join(data, "train.json"),
        "valid_annotation": os.path.join(data, "valid.json"),
        "modules": transducer_modules(cfg, device=device, seed=5),
        "lr": cfg["lr"], "batch_size": TIMIT_BATCH,
        "checkpointer": Checkpointer(save),
    }


def run_timit_chain(cfg, out_dir, device="cuda"):
    """The TIMIT transducer twin's ``run`` once (``--debug``: one epoch of
    two micro-batches): ``prepare_synthetic``, the phone map, two bf16
    steps, the valid stage; B3 on each batch."""
    hparams = timit_hparams(cfg, out_dir, device=device)
    reset_launch_counts()
    t0 = time.perf_counter()
    brain, _, phone_map = transducer_recipe.run(
        hparams, {"device": device, "precision": "bf16",
                  "noprogressbar": True, "debug": True, "debug_batches": 2,
                  "debug_epochs": 1},
        brain_cls=TimedTransducerBrain, prepare=timit_recipe.prepare,
        labels=timit_recipe.phone_labels)
    _sync(device)
    counts = launch_counts()
    n_fwd = brain.forwards[Stage.TRAIN] + brain.forwards[Stage.VALID]
    line = {"seconds": time.perf_counter() - t0,
            "phones": len(phone_map), "forwards": {
                s.name: c for s, c in brain.forwards.items()},
            "launches": counts, "losses": brain.losses,
            "valid_losses": brain.valid_losses,
            "step_ms": brain.step_ms(),
            "checkpoints": len(brain.checkpointer.list_checkpoints())}
    line["ok"] = bool(
        counts["fused_fbank"] == n_fwd
        and brain.forwards[Stage.TRAIN] == 2
        and brain.forwards[Stage.VALID] >= 1
        # prepare_synthetic's utterances use every phone but silence
        and len(phone_map) == len(timit_prepare.PHONES) - 1
        and all(np.isfinite(brain.losses + brain.valid_losses)))
    return line


def run_streaming_path(out_dir, paths, cfg=TRANSDUCER_CFG, device="cuda"):
    """The streaming transducer at full width: served chunk by chunk
    through ``StreamingASR`` (bf16, float32 through B3 and its plain
    version, a WAV file), trained two steps with drawn chunk
    configurations, one forced, its valid stage and a float32 step
    against the plain version; then the TIMIT twin's chain. Returns B3's
    launches in each run and the streamed chunks' waveform shape."""
    t0 = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    modules = transducer_modules(cfg, device=device, seed=11)
    n_params = sum(p.numel() for m in modules.values()
                   for p in m.parameters())
    write_covering_bpe(out_dir, cfg["vocab"])
    tokenizer = SentencePiece(out_dir, cfg["vocab"], model_type="bpe")
    brain = transducer_brain(cfg, modules, device=device,
                             extra_hparams=streaming_hparams())
    checks, serve = run_streaming_serve(cfg, brain, tokenizer, out_dir,
                                        device=device)
    emit({"phase": "streaming_serve", "ok": all(checks.values()),
          "checks": checks, **serve})
    del brain
    gc.collect()
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"streaming_path serve: a check failed: "
                             f"{checks}")
    train = run_streaming_train(cfg, modules, out_dir, paths, device=device)
    emit({"phase": "streaming_train", **train})
    del modules
    gc.collect()
    torch.cuda.empty_cache()
    if not train["ok"]:
        raise AssertionError("streaming_path: training failed")
    timit = run_timit_chain(cfg, os.path.join(out_dir, "timit"),
                            device=device)
    emit({"phase": "streaming_path/timit_transducer", **timit})
    gc.collect()
    torch.cuda.empty_cache()
    if not timit["ok"]:
        raise AssertionError("streaming_path: the TIMIT twin failed")
    emit({"phase": "streaming_path_summary", "reduced": STREAMING_REDUCED,
          "parameters": n_params, "seconds": time.perf_counter() - t0,
          "gpu_name_power_limit": gpu_name_power_limit()})
    launches = {"bf16_stream": serve["bf16"]["launches"]["fused_fbank"],
                "fp32_stream": serve["fp32"]["launches_kernel"][
                    "fused_fbank"],
                "file_stream": serve["file"]["launches"]["fused_fbank"],
                "train": train["launches"]["fused_fbank"],
                "timit_train_valid": timit["launches"]["fused_fbank"]}
    # B3 takes a chunk after the wrapper's context of twice its padding
    width = serve["chunk_samples"] + serve["wrapper_context_samples"]
    return launches, (NORTH["batch"], width), (1, width)


# -- speaker_path: speaker recognition and classification -------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
VOXCELEB = os.path.join(ROOT, "speechbrain_tpu_torch", "recipes", "VoxCeleb",
                        "SpeakerRec", "hparams")
GSC = os.path.join(ROOT, "speechbrain_tpu_torch", "recipes",
                   "Google_speech_commands", "command_recognition", "hparams")
SPEAKER_ID = os.path.join(ROOT, "speechbrain_tpu_torch", "templates",
                          "speaker_id")
# the three VoxCeleb training YAMLs, trained in turn; ECAPA and the x-vector
# are then scored by the verification script (cosine, PLDA)
SPEAKER_TWINS = {"ecapa": "train_ecapa_tdnn.yaml",
                 "xvector": "train_xvector.yaml",
                 "resnet": "train_resnet.yaml"}
SPEAKER_VERIFY = {"ecapa": "verification_ecapa.yaml",
                  "xvector": "verification_plda_xvector.yaml"}
# synthetic speakers: a glottal-like tone of its own f0 and harmonics over
# noise, 3.2-5 s an utterance, so that every 3 s crop is drawn
SPEAKER_CORPUS = dict(speakers=16, train_per_speaker=4, dev_per_speaker=2,
                      seconds=(3.2, 5.0))
# serve: 32 pairs of 3-8 s, padded to 8 s (every relative length below 1)
SPEAKER_SERVE = dict(pairs=32, seconds=(3.0, 7.9), padded_seconds=8.0,
                     threshold=0.25, repeats=3)
SPEAKER_TRAIN_STEPS = 2
# float32 through B3 against its plain version: embeddings (relative L2),
# cosine scores (absolute), the training loss (relative)
SPEAKER_EMB_RTOL = 1e-5
SPEAKER_SCORE_ATOL = 1e-5
SPEAKER_LOSS_RTOL = 1e-6
# B3 at the family's two new configurations: (batch, samples, mels)
SPEAKER_B3_SHAPES = ((32, 48000, 80), (16, 16000, 24))
SPEAKER_REDUCED = {
    "weights": "random, from each YAML's seed (1986)",
    "voxceleb_epochs": "10 -> 2 optimizer steps and the valid stage",
    "voxceleb_corpus": "16 synthetic speakers, 4 train and 2 dev "
                       "utterances each, 3.2-5 s",
    "speech_commands_epochs": "5 -> 1, the recipe's synthetic command set",
    "speaker_id_epochs": "15 -> 1, on the synthetic speakers",
    "speaker_id_classes": "28 -> the corpus's 16 speakers, so that every "
                          "output decodes to a label",
}
# text replacements applied to every YAML this path loads: none on the
# card (full width); the CPU test shrinks widths with them
SPEAKER_YAML_EDITS = []


def speaker_yaml(path, overrides):
    """A twin YAML loaded as the twins' scripts load it, after
    ``SPEAKER_YAML_EDITS``."""
    from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml

    with open(path, encoding="utf-8") as f:
        text = f.read()
    for old, new in SPEAKER_YAML_EDITS:
        text = text.replace(old, new)
    return load_hyperpyyaml(text, overrides)


def write_speaker_corpus(data_folder, seed=0):
    """``SPEAKER_CORPUS``'s synthetic speakers as 16-bit PCM WAV files in
    ``data_folder`` and the manifests ``train.json``/``dev.json`` (``wav``,
    ``spk_id``, ``length``) beside them; returns the manifests' paths."""
    cfg = SPEAKER_CORPUS
    os.makedirs(data_folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    manifests = {"train": {}, "dev": {}}
    for s in range(cfg["speakers"]):
        f0 = 90.0 + 11.0 * s
        weights = rng.uniform(0.2, 1.0, 4)
        for i in range(cfg["train_per_speaker"] + cfg["dev_per_speaker"]):
            secs = float(rng.uniform(*cfg["seconds"]))
            t = np.arange(int(SR * secs)) / SR
            vibrato = 1.0 + 0.02 * np.sin(2 * np.pi * rng.uniform(3, 6) * t)
            phase = 2 * np.pi * f0 * np.cumsum(vibrato) / SR
            wav = sum(w * np.sin((k + 1) * phase)
                      for k, w in enumerate(weights)) * 0.15
            wav += 0.01 * rng.standard_normal(len(t))
            name = f"spk{s:02d}_{i}"
            path = os.path.join(data_folder, name + ".wav")
            write_audio(path, wav.astype(np.float32), SR)
            split = "train" if i < cfg["train_per_speaker"] else "dev"
            manifests[split][name] = {"wav": path, "spk_id": f"spk{s:02d}",
                                      "length": secs}
    paths = {}
    for split, items in manifests.items():
        paths[split] = os.path.join(data_folder, f"{split}.json")
        with open(paths[split], "w") as f:
            json.dump(items, f)
    return paths


def check_b3_at_shapes(shapes, device="cuda"):
    """B3 against its plain version at each ``(batch, samples, mels)`` of
    ``shapes``, on white noise and a chirp: the largest difference (dB)
    at each."""
    out = {}
    for B, T, n_mels in shapes:
        fused = Fbank(n_mels=n_mels, fused=True, device=device)
        errs = []
        for kind in ("noise", "chirp"):
            wav = torch.from_numpy(make_check_signal(kind, B, T, seed=3)).to(
                device)
            with torch.no_grad():
                kernel = fused(wav)
                with plain_versions("fused_fbank"):
                    plain = fused(wav)
            errs.append((kernel - plain).abs().max().item())
        out[f"{B}x{T}@{n_mels}"] = max(errs)
    return out


class TimedSpeakerBrain(TimedSteps, speaker_recipe.SpeakerBrain):
    """The VoxCeleb twin's Brain with :class:`TimedSteps`' readings."""


class TimedCommandBrain(TimedSteps, gsc_recipe.CommandBrain):
    """The speech-commands twin's Brain with :class:`TimedSteps`'
    readings."""


class TimedTemplateBrain(TimedSteps, speaker_id_template.SpeakerBrain):
    """The speaker_id template's Brain with :class:`TimedSteps`'
    readings."""


def speaker_pairs(device, seed=5):
    """``SPEAKER_SERVE["pairs"]`` pairs of noise-excited tones of 3-8 s,
    padded to 8 s: (wavs1, lens1, wavs2, lens2, audio seconds)."""
    cfg = SPEAKER_SERVE
    rng = np.random.default_rng(seed)
    T = int(SR * cfg["padded_seconds"])
    out, seconds = [], 0.0
    for _ in range(2):
        wavs = np.zeros((cfg["pairs"], T), np.float32)
        lens = rng.uniform(*cfg["seconds"], cfg["pairs"])
        for b, secs in enumerate(lens):
            n = int(SR * secs)
            t = np.arange(n) / SR
            wavs[b, :n] = (0.2 * np.sin(2 * np.pi * rng.uniform(90, 260) * t)
                           + 0.02 * rng.standard_normal(n))
        seconds += float(lens.sum())
        out += [torch.from_numpy(wavs).to(device),
                torch.from_numpy((lens * SR).astype(np.int64) / T).float()
                .to(device)]
    return (*out, seconds)


def _elapsed_ms(fn, repeats, device):
    """Median milliseconds of ``fn()`` by CUDA events, after one warm-up
    call; returns (median, every reading, the last result)."""
    result = fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        result = fn()
        end.record()
        _sync(device)
        times.append(start.elapsed_time(end))
    return float(np.median(times)), times, result


def run_speaker_serve(hparams, device="cuda"):
    """The VoxCeleb ECAPA twin served: ``SpeakerRecognition.verify_batch``
    of 32 pairs (B3 once an encode), ``encode_batch`` and
    ``EncoderClassifier.classify_batch``; then float32 through B3 against
    its plain version: embeddings, scores, decisions."""
    modules = {"embedding_model": hparams["embedding_model"],
               "classifier": hparams["classifier"]}
    served = {"compute_features": hparams["compute_features"]}
    verifier = SpeakerRecognition(modules=modules, hparams=served,
                                  run_opts={"device": device})
    classifier = EncoderClassifier(modules=modules, hparams=served,
                                   run_opts={"device": device})
    w1, l1, w2, l2, audio_s = speaker_pairs(device)
    n_pairs = w1.shape[0]
    reset_launch_counts()
    score, decision = verifier.verify_batch(w1, w2, l1, l2,
                                            SPEAKER_SERVE["threshold"])
    _sync(device)
    verify_launches = launch_counts()["fused_fbank"]
    verify_ms, verify_all, _ = _elapsed_ms(
        lambda: verifier.verify_batch(w1, w2, l1, l2), SPEAKER_SERVE[
            "repeats"], device)
    encode_ms, encode_all, _ = _elapsed_ms(
        lambda: verifier.encode_batch(w1, l1), SPEAKER_SERVE["repeats"],
        device)
    reset_launch_counts()
    out_prob, best, index, _ = classifier.classify_batch(w1, l1)
    _sync(device)
    classify_launches = launch_counts()["fused_fbank"]
    emb_k = verifier.encode_batch(w1, l1)
    with plain_versions("fused_fbank"):
        emb_p = verifier.encode_batch(w1, l1)
        score_p, decision_p = verifier.verify_batch(
            w1, w2, l1, l2, SPEAKER_SERVE["threshold"])
    rel_l2 = ((emb_k - emb_p).norm() / emb_p.norm()).item()
    score_diff = (score - score_p).abs().max().item()
    line = {
        "pairs": n_pairs, "audio_seconds": audio_s,
        "verify_batch_ms": verify_ms, "verify_batch_ms_all": verify_all,
        "encode_batch_ms": encode_ms, "encode_batch_ms_all": encode_all,
        "pairs_per_s": n_pairs / (verify_ms / 1e3),
        "audio_s_per_s": audio_s / (verify_ms / 1e3),
        "launches_verify_batch": verify_launches,
        "launches_classify_batch": classify_launches,
        "classes": int(out_prob.shape[-1]),
        "accepted": int(decision.sum()),
        "fp32_emb_rel_l2": rel_l2, "fp32_score_max_diff": score_diff,
        "decisions_equal": bool(torch.equal(decision, decision_p)),
        "score_range": [score.min().item(), score.max().item()],
    }
    line["ok"] = bool(
        verify_launches == 2 and classify_launches == 1
        and tuple(score.shape) == (n_pairs,)
        and torch.isfinite(score).all() and torch.isfinite(out_prob).all()
        and tuple(index.shape) == (n_pairs,)
        and rel_l2 <= SPEAKER_EMB_RTOL and score_diff <= SPEAKER_SCORE_ATOL
        and line["decisions_equal"])
    return line


def speaker_loss_kernel_vs_plain(brain, batch):
    """The float32 loss of one batch through B3 and its plain version, the
    trained modules in training mode (a copy: the running statistics stay
    as they were)."""
    modules = copy.deepcopy(brain.modules).train()
    hparams = brain.hparams
    out = {}
    for arm in ("kernel", "plain"):
        ctx = plain_versions("fused_fbank") if arm == "plain" \
            else contextlib.nullcontext()
        with ctx, torch.no_grad():
            wavs, lens = batch["sig"]
            emb = modules.embedding_model(hparams.compute_features(wavs),
                                          lengths=lens)
            loss, _ = brain.compute_objectives(modules.classifier(emb),
                                               batch, Stage.TRAIN)
            out[arm] = loss.item()
    del modules
    lk, lp = out["kernel"], out["plain"]
    return {"loss_kernel": lk, "loss_plain": lp,
            "loss_rel_diff": abs(lk - lp) / abs(lp),
            "loss_rtol": SPEAKER_LOSS_RTOL}


def run_speaker_train(name, manifests, out_dir, device="cuda"):
    """Two bf16 optimizer steps of the VoxCeleb twin's ``run`` from its
    YAML (AAM-softmax, Adam, the cyclic rate at the valid stage, batch 32
    of 3 s crops) and its valid stage with a checkpoint; then the float32
    loss of the first train batch through B3 and its plain version.
    Returns the line and the run's output folder."""
    out = os.path.join(out_dir, name)
    hparams = speaker_yaml(os.path.join(VOXCELEB, SPEAKER_TWINS[name]), {
        "data_folder": os.path.dirname(manifests["train"]),
        "output_folder": out, "train_annotation": manifests["train"],
        "valid_annotation": manifests["dev"], "number_of_epochs": 1,
        "device": device})
    n_params = sum(p.numel() for m in hparams["modules"].values()
                   for p in m.parameters())
    if torch.device(device).type == "cuda":
        _peak_and_reset(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    brain = speaker_recipe.run(hparams, {
        "device": device, "precision": "bf16", "noprogressbar": True,
        "optimizer_step_limit": SPEAKER_TRAIN_STEPS},
        brain_cls=TimedSpeakerBrain)
    _sync(device)
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    peak = (_peak_and_reset(device) if torch.device(device).type == "cuda"
            else 0)
    n_fwd = brain.forwards[Stage.TRAIN] + brain.forwards[Stage.VALID]
    loader = make_dataloader(
        speaker_recipe.dataio_prepare(hparams)["train"],
        batch_size=hparams["batch_size"])
    batch = next(iter(loader)).to(brain.device)
    crop = batch["sig"].data.shape
    check = speaker_loss_kernel_vs_plain(brain, batch)
    line = {
        "model": name, "parameters": n_params, "seconds": seconds,
        "step_ms": brain.step_ms(), "losses": brain.losses,
        "valid_losses": brain.valid_losses, "peak_bytes": peak,
        "forwards": {s.name: c for s, c in brain.forwards.items()},
        "launches": counts, "batch_shape": list(crop),
        "lr_after_valid": brain.optimizer.param_groups[0]["lr"],
        "checkpoints": len(brain.checkpointer.list_checkpoints()), **check,
    }
    line["ok"] = bool(
        counts["fused_fbank"] == n_fwd
        and brain.forwards[Stage.TRAIN] == SPEAKER_TRAIN_STEPS
        and brain.forwards[Stage.VALID] >= 1
        and crop[1] == int(SR * hparams["sentence_len"])
        and crop[0] == hparams["batch_size"]
        and line["checkpoints"] == 1
        and all(np.isfinite(brain.losses + brain.valid_losses))
        and check["loss_rel_diff"] <= SPEAKER_LOSS_RTOL)
    del brain, hparams
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return line, out


def run_speaker_verification(name, train_out, manifests, device="cuda"):
    """The verification script's scoring (cosine for ECAPA, PLDA for the
    x-vector) of every pair of dev utterances, with the model the training
    run checkpointed: its EER and minDCF (a chain that computes: the
    weights took two steps)."""
    data = os.path.dirname(manifests["train"])
    trials = speaker_prepare.write_trials(data, [manifests["dev"]])
    hparams = speaker_yaml(os.path.join(VOXCELEB, SPEAKER_VERIFY[name]), {
        "output_folder": train_out, "data_folder": data,
        "plda_train_annotation": manifests["train"], "device": device})
    reset_launch_counts()
    t0 = time.perf_counter()
    result = verify_recipe.score_trials(hparams, device)
    _sync(device)
    counts = launch_counts()
    n_dev = len(json.load(open(manifests["dev"])))
    n_train = len(json.load(open(manifests["train"])))
    expected = n_dev + (n_train if hparams.get("scoring") == "plda" else 0)
    line = {"model": name, "scoring": hparams.get("scoring", "cosine"),
            "trials": len(result["scores"]),
            "targets": int(result["labels"].sum()), "eer": result["eer"],
            "min_dcf": result["min_dcf"], "threshold": result["threshold"],
            "seconds": time.perf_counter() - t0, "launches": counts,
            "trials_file": os.path.basename(str(trials))}
    line["ok"] = bool(counts["fused_fbank"] == expected
                      and np.isfinite(result["scores"]).all()
                      and 0.0 <= result["eer"] <= 1.0)
    return line


def run_gsc_chain(yaml, out_dir, device="cuda"):
    """A speech-commands twin from its YAML for one bf16 epoch on the
    recipe's synthetic command set (``prepare_synthetic``): B3 at 24 mels
    on every batch, none with LEAF."""
    data = os.path.join(out_dir, "data")
    gsc_prepare.prepare_synthetic(data)
    hparams = speaker_yaml(os.path.join(GSC, yaml), {
        "data_folder": data, "output_folder": os.path.join(out_dir, "out"),
        "number_of_epochs": 1, "device": device})
    leaf = "compute_features" in hparams["modules"]
    reset_launch_counts()
    t0 = time.perf_counter()
    brain = gsc_recipe.run(hparams, {"device": device, "precision": "bf16",
                                     "noprogressbar": True},
                           brain_cls=TimedCommandBrain)
    _sync(device)
    counts = launch_counts()
    n_fwd = brain.forwards[Stage.TRAIN] + brain.forwards[Stage.VALID]
    line = {"yaml": yaml, "seconds": time.perf_counter() - t0,
            "forwards": {s.name: c for s, c in brain.forwards.items()},
            "launches": counts, "losses": brain.losses,
            "valid_losses": brain.valid_losses, "step_ms": brain.step_ms()}
    line["ok"] = bool(
        counts["fused_fbank"] == (0 if leaf else n_fwd)
        and brain.forwards[Stage.TRAIN] >= 1
        and brain.forwards[Stage.VALID] >= 1
        and all(np.isfinite(brain.losses + brain.valid_losses)))
    return line


def run_speaker_id_template(manifests, out_dir, device="cuda"):
    """The speaker_id template twin from its YAML for one bf16 epoch on
    the synthetic speakers, its export, and the export served through
    ``EncoderClassifier.from_hparams``: ``classify_file`` and
    ``classify_batch`` against the trained modules on the same input."""
    data = os.path.join(out_dir, "data")
    os.makedirs(data, exist_ok=True)
    for split, src in (("train", "train"), ("valid", "dev")):
        shutil.copy(manifests[src], os.path.join(data, f"{split}.json"))
    hparams = speaker_yaml(os.path.join(SPEAKER_ID, "train.yaml"), {
        "data_folder": data, "output_folder": os.path.join(out_dir, "out"),
        "number_of_epochs": 1, "n_classes": SPEAKER_CORPUS["speakers"],
        "device": device})
    reset_launch_counts()
    brain = speaker_id_template.run(
        hparams, {"device": device, "precision": "bf16",
                  "noprogressbar": True}, brain_cls=TimedTemplateBrain)
    _sync(device)
    train_counts = launch_counts()
    served = EncoderClassifier.from_hparams(
        source=hparams["pretrained_folder"],
        savedir=os.path.join(out_dir, "served"),
        run_opts={"device": device})
    dev = json.load(open(manifests["dev"]))
    wav_path = next(iter(dev.values()))["wav"]
    reset_launch_counts()
    _, _, _, label = served.classify_file(wav_path)
    wav = torch.from_numpy(read_audio(wav_path))[None].to(device)
    out_prob, _, index, labels = served.classify_batch(wav)
    _sync(device)
    serve_counts = launch_counts()
    modules = brain.modules.eval()
    with torch.no_grad():
        feats = hparams["compute_features"](wav)
        trained = modules.classifier(modules.embedding_model(feats))
    n_fwd = brain.forwards[Stage.TRAIN] + brain.forwards[Stage.VALID]
    line = {"forwards": {s.name: c for s, c in brain.forwards.items()},
            "launches_train": train_counts, "launches_serve": serve_counts,
            "losses": brain.losses, "valid_losses": brain.valid_losses,
            "label": label, "classes": int(out_prob.shape[-1]),
            "served_vs_trained_max_diff":
                (out_prob - trained).abs().max().item(),
            "exported": sorted(os.listdir(hparams["pretrained_folder"]))}
    line["ok"] = bool(
        train_counts["fused_fbank"] == n_fwd
        and serve_counts["fused_fbank"] == 2
        and label == labels and label[0] in hparams["label_encoder"].lab2ind
        and line["served_vs_trained_max_diff"] <= 1e-6
        and all(np.isfinite(brain.losses + brain.valid_losses)))
    return line


def run_speaker_path(out_dir, device="cuda"):
    """The speaker family at full width: B3 against its plain version at
    its two configurations; the VoxCeleb ECAPA twin served (verify_batch,
    classify_batch, float32 through B3 and its plain version); two bf16
    steps of each VoxCeleb twin with the valid stage; the verification
    script's cosine and PLDA scoring to an EER; the speech-commands ECAPA
    and LEAF twins one epoch each; the speaker_id template trained one
    epoch, exported and served through ``EncoderClassifier.from_hparams``.
    Returns B3's launches in each run and its errors at the two
    configurations."""
    t0 = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    b3 = check_b3_at_shapes(SPEAKER_B3_SHAPES, device)
    emit({"phase": "speaker_b3_check", "max_abs_err_db": b3,
          "atol": B3_ATOL, "ok": max(b3.values()) <= B3_ATOL})
    if max(b3.values()) > B3_ATOL:
        raise AssertionError(f"speaker_path: B3 against its plain version "
                             f"{b3}")
    manifests = write_speaker_corpus(os.path.join(out_dir, "voxceleb"))
    hparams = speaker_yaml(os.path.join(VOXCELEB, SPEAKER_TWINS["ecapa"]), {
        "data_folder": out_dir, "output_folder": out_dir, "device": device})
    serve = run_speaker_serve(hparams, device)
    emit({"phase": "speaker_serve", **serve})
    del hparams
    gc.collect()
    if not serve["ok"]:
        raise AssertionError(f"speaker_path: serving failed: {serve}")
    launches = {"verify_batch": serve["launches_verify_batch"],
                "classify_batch": serve["launches_classify_batch"]}
    trained = {}
    for name in SPEAKER_TWINS:
        line, trained[name] = run_speaker_train(name, manifests, out_dir,
                                                device)
        emit({"phase": f"speaker_train/{name}", **line})
        launches[f"train_{name}"] = line["launches"]["fused_fbank"]
        if not line["ok"]:
            raise AssertionError(f"speaker_path: training {name} failed")
    for name in SPEAKER_VERIFY:
        line = run_speaker_verification(name, trained[name], manifests,
                                        device)
        emit({"phase": f"speaker_verify/{name}", **line})
        launches[f"verify_{name}"] = line["launches"]["fused_fbank"]
        if not line["ok"]:
            raise AssertionError(f"speaker_path: verification {name} failed")
    for yaml in ("ecapa.yaml", "xvect_leaf.yaml"):
        line = run_gsc_chain(yaml, os.path.join(out_dir, "gsc_" + yaml[:-5]),
                             device)
        emit({"phase": f"speaker_path/speech_commands/{yaml}", **line})
        launches[f"speech_commands_{yaml[:-5]}"] = line["launches"][
            "fused_fbank"]
        if not line["ok"]:
            raise AssertionError(f"speaker_path: speech commands {yaml} "
                                 f"failed")
    line = run_speaker_id_template(manifests, os.path.join(out_dir,
                                                           "speaker_id"),
                                   device)
    emit({"phase": "speaker_path/speaker_id", **line})
    launches["speaker_id_train"] = line["launches_train"]["fused_fbank"]
    launches["speaker_id_serve"] = line["launches_serve"]["fused_fbank"]
    if not line["ok"]:
        raise AssertionError("speaker_path: the speaker_id template failed")
    emit({"phase": "speaker_path_summary", "reduced": SPEAKER_REDUCED,
          "seconds": time.perf_counter() - t0,
          "gpu_name_power_limit": gpu_name_power_limit()})
    return launches, b3


# -- classify_path: the audio classifiers -----------------------------------

TWINS_ROOT = os.path.join(ROOT, "speechbrain_tpu_torch", "recipes")
ESC50 = os.path.join(TWINS_ROOT, "ESC50", "classification", "hparams")
# the four ESC50 YAMLs, each trained two bf16 steps; the first two served
ESC50_YAMLS = ("cnn14.yaml", "vit.yaml", "conv2d.yaml", "focalnet.yaml")
ESC50_SERVED = ("cnn14.yaml", "vit.yaml")
# the other classification twins, one epoch each on their synthetic
# corpora: (name, recipe folder, YAML, train module)
OTHER_CLASSIFIERS = (
    ("us8k_cnn14", "UrbanSound8k/SoundClassification", "cnn14.yaml",
     us8k_recipe),
    ("us8k_ecapa", "UrbanSound8k/SoundClassification",
     "train_ecapa_tdnn.yaml", us8k_recipe),
    ("common_language", "CommonLanguage/lang_id", "train_ecapa.yaml",
     cl_recipe),
    ("voxlingua107", "VoxLingua107/lang_id", "train_ecapa.yaml", vl_recipe),
    ("iemocap_ecapa", "IEMOCAP/emotion_recognition", "train_ecapa.yaml",
     iemocap_recipe),
    ("iemocap_xvector", "IEMOCAP/emotion_recognition", "train_xvector.yaml",
     iemocap_recipe),
)
# serving: 8 clips of ESC50's 5 s, each shorter than the padded batch
CLASSIFY_SERVE = dict(clips=8, seconds=5.0, fill=(0.6, 0.98), repeats=3)
# training: ESC50's four synthetic classes as 5 s clips, 4 train and 2
# valid a class, so that two steps at the YAML's batch of 8 are drawn
CLASSIFY_CORPUS = dict(train_per_class=4, valid_per_class=2, seconds=5.0)
CLASSIFY_TRAIN_STEPS = 2
# float32 through B3 against its plain version: the served outputs
# (relative L2) and the training loss (relative)
CLASSIFY_OUT_RTOL = 1e-5
CLASSIFY_LOSS_RTOL = 1e-6
# B3 at the family's new shapes: ESC50's 5 s and UrbanSound8k's 4 s clips
CLASSIFY_B3_SHAPES = ((8, 80000, 80), (8, 64000, 80))
CLASSIFY_REDUCED = {
    "weights": "random, from each YAML's seed",
    "esc50_epochs": "50 -> 2 optimizer steps and the valid stage",
    "esc50_corpus": "the recipe's four synthetic classes as 5 s clips, "
                    "4 train and 2 valid a class",
    "other_twins_epochs": "30-50 -> 1, on each recipe's synthetic corpus "
                          "(1 s clips)",
}
# text replacements applied to every YAML this path and
# recurrent_twins_path load: none on the card (full width); the CPU tests
# shrink widths with them
TWIN_YAML_EDITS = []


def twin_yaml(path, overrides):
    """A twin YAML's text after ``TWIN_YAML_EDITS`` and the objects it
    builds with ``overrides``: ``(text, hparams)``."""
    from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml

    with open(path, encoding="utf-8") as f:
        text = f.read()
    for old, new in TWIN_YAML_EDITS:
        text = text.replace(old, new)
    return text, load_hyperpyyaml(text, overrides)


def write_sound_corpus(data_folder, seed=0):
    """ESC50's synthetic classes (``prepare.py``'s square tones under a
    decaying envelope) as ``CLASSIFY_CORPUS`` clips, WAV files and the
    manifests ``train.json``/``valid.json`` (``wav``, ``class_name``,
    ``length``); returns the manifests' paths."""
    cfg = CLASSIFY_CORPUS
    os.makedirs(data_folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * cfg["seconds"])) / SR
    manifests = {"train": {}, "valid": {}}
    for ci, cls in enumerate(esc50_prepare.CLASSES):
        for i in range(cfg["train_per_class"] + cfg["valid_per_class"]):
            f0 = (100 + 200 * ci) * rng.uniform(0.95, 1.05)
            sig = (np.sign(np.sin(2 * np.pi * f0 * t))
                   * np.exp(-3 * ((t * (ci + 1)) % 1.0)) * 0.4
                   + 0.02 * rng.standard_normal(len(t)))
            name = f"{cls}_{i}"
            path = os.path.join(data_folder, name + ".wav")
            write_audio(path, sig.astype(np.float32), SR)
            split = "train" if i < cfg["train_per_class"] else "valid"
            manifests[split][name] = {"wav": path, "class_name": cls,
                                      "length": len(t)}
    paths = {}
    for split, items in manifests.items():
        paths[split] = os.path.join(data_folder, f"{split}.json")
        with open(paths[split], "w") as f:
            json.dump(items, f)
    return paths


def tone_clips(device, cfg, seed=7):
    """``cfg["clips"]`` tones over noise, each filling a share drawn from
    ``cfg["fill"]`` of the padded ``cfg["seconds"]``: (wavs, relative
    lengths, audio seconds)."""
    rng = np.random.default_rng(seed)
    T = int(SR * cfg["seconds"])
    wavs = np.zeros((cfg["clips"], T), np.float32)
    fills = rng.uniform(*cfg["fill"], cfg["clips"])
    for b, fill in enumerate(fills):
        n = int(T * fill)
        t = np.arange(n) / SR
        wavs[b, :n] = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 900) * t)
                       + 0.02 * rng.standard_normal(n))
    lens = np.floor(T * fills) / T
    return (torch.from_numpy(wavs).to(device),
            torch.from_numpy(lens.astype(np.float32)).to(device),
            float(np.floor(T * fills).sum()) / SR)


def run_classify_serve(yaml, device="cuda"):
    """An ESC50 twin (random weights at the YAML's width) served through
    ``AudioClassifier.classify_batch``: the encoder with the recipe's
    pooling, the linear head. Encode and classify ms (CUDA events), clips
    and audio seconds a second, B3 launches a call; float32 through B3
    against its plain version: the outputs within ``CLASSIFY_OUT_RTOL``
    relative L2, the same best class."""
    _, hparams = twin_yaml(os.path.join(ESC50, yaml), {
        "data_folder": ".", "output_folder": ".", "device": device})
    served = AudioClassifier(
        modules={"embedding_model": hparams["pooled_encoder"],
                 "classifier": hparams["classifier"]},
        hparams={"compute_features": hparams["compute_features"]},
        run_opts={"device": device})
    n_params = sum(p.numel() for m in served.mods.values()
                   for p in m.parameters())
    wavs, lens, audio_s = tone_clips(device, CLASSIFY_SERVE)
    reset_launch_counts()
    out_prob, _, index, _ = served.classify_batch(wavs, lens)
    _sync(device)
    launches = launch_counts()["fused_fbank"]
    repeats = CLASSIFY_SERVE["repeats"]
    classify_ms, classify_all, _ = _elapsed_ms(
        lambda: served.classify_batch(wavs, lens), repeats, device)
    encode_ms, _, _ = _elapsed_ms(lambda: served.encode_batch(wavs, lens),
                                  repeats, device)
    with plain_versions("fused_fbank"):
        plain_prob, _, plain_index, _ = served.classify_batch(wavs, lens)
    rel_l2 = ((out_prob - plain_prob).norm() / plain_prob.norm()).item()
    line = {"yaml": yaml, "parameters": n_params,
            "clips": int(wavs.shape[0]), "batch_shape": list(wavs.shape),
            "audio_seconds": audio_s, "encode_batch_ms": encode_ms,
            "classify_batch_ms": classify_ms,
            "classify_batch_ms_all": classify_all,
            "clips_per_s": wavs.shape[0] / (classify_ms / 1e3),
            "audio_s_per_s": audio_s / (classify_ms / 1e3),
            "launches_classify_batch": launches,
            "classes": int(out_prob.shape[-1]),
            "fp32_out_rel_l2": rel_l2, "out_rtol": CLASSIFY_OUT_RTOL,
            "argmax_equal": bool(torch.equal(index, plain_index))}
    line["ok"] = bool(launches == 1 and torch.isfinite(out_prob).all()
                      and tuple(out_prob.shape[:1]) == (wavs.shape[0],)
                      and rel_l2 <= CLASSIFY_OUT_RTOL
                      and line["argmax_equal"])
    del served, hparams
    gc.collect()
    return line


class TimedSoundBrain(TimedSteps, esc50_recipe.SoundBrain):
    """The ESC50 twin's Brain with :class:`TimedSteps`' readings."""


class TimedLangIdBrain(TimedSteps, cl_recipe.LangIdBrain):
    """The lang-id and emotion twins' Brain with :class:`TimedSteps`'
    readings."""


def sound_loss_kernel_vs_plain(brain, batch):
    """The float32 loss of one batch through B3 and its plain version, a
    copy of the trained modules in training mode."""
    modules = copy.deepcopy(brain.modules).train()
    saved, brain.modules = brain.modules, modules
    out = {}
    try:
        for arm in ("kernel", "plain"):
            ctx = plain_versions("fused_fbank") if arm == "plain" \
                else contextlib.nullcontext()
            with ctx, torch.no_grad():
                loss, _ = brain.compute_objectives(
                    brain.compute_forward(batch, Stage.TRAIN), batch,
                    Stage.TRAIN)
                out[arm] = loss.item()
    finally:
        brain.modules = saved
    lk, lp = out["kernel"], out["plain"]
    return {"loss_kernel": lk, "loss_plain": lp,
            "loss_rel_diff": abs(lk - lp) / abs(lp),
            "loss_rtol": CLASSIFY_LOSS_RTOL}


def _train_line(brain, counts, seconds, peak, n_params):
    n_fwd = brain.forwards[Stage.TRAIN] + brain.forwards[Stage.VALID]
    return {"parameters": n_params, "seconds": seconds,
            "step_ms": brain.step_ms(), "losses": brain.losses,
            "valid_losses": brain.valid_losses, "peak_bytes": peak,
            "forwards": {s.name: c for s, c in brain.forwards.items()},
            "launches": counts,
            "checkpoints": len(brain.checkpointer.list_checkpoints()),
            "b3_equals_batches": counts["fused_fbank"] == n_fwd}


def _timed_run(fn, device):
    """``fn()`` with the launch counts set to 0 before it and read after,
    its seconds and the device's peak memory over it."""
    if torch.device(device).type == "cuda":
        _peak_and_reset(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    result = fn()
    _sync(device)
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    peak = (_peak_and_reset(device) if torch.device(device).type == "cuda"
            else 0)
    return result, counts, seconds, peak


def run_esc50_train(yaml, manifests, out_dir, device="cuda"):
    """Two bf16 Adam steps of an ESC50 twin's ``run`` from its YAML at
    batch 8 of 5 s clips, the valid stage and a checkpoint; then the
    float32 loss of the first train batch through B3 and its plain
    version."""
    _, hparams = twin_yaml(os.path.join(ESC50, yaml), {
        "data_folder": os.path.dirname(manifests["train"]),
        "output_folder": os.path.join(out_dir, yaml[:-5]),
        "number_of_epochs": 1, "device": device})
    n_params = sum(p.numel() for m in hparams["modules"].values()
                   for p in m.parameters())
    brain, counts, seconds, peak = _timed_run(lambda: esc50_recipe.run(
        hparams, {"device": device, "precision": "bf16",
                  "noprogressbar": True,
                  "optimizer_step_limit": CLASSIFY_TRAIN_STEPS},
        brain_cls=TimedSoundBrain), device)
    line = {"yaml": yaml,
            **_train_line(brain, counts, seconds, peak, n_params)}
    forwards = dict(brain.forwards)
    loader = make_dataloader(esc50_recipe.dataio_prepare(hparams)["train"],
                             batch_size=hparams["batch_size"])
    batch = next(iter(loader)).to(brain.device)
    check = sound_loss_kernel_vs_plain(brain, batch)
    line.update(batch_shape=list(batch["sig"].data.shape), **check)
    line["ok"] = bool(
        line["b3_equals_batches"]
        and forwards[Stage.TRAIN] == CLASSIFY_TRAIN_STEPS
        and forwards[Stage.VALID] >= 1 and line["checkpoints"] == 1
        and all(np.isfinite(brain.losses + brain.valid_losses))
        and check["loss_rel_diff"] <= CLASSIFY_LOSS_RTOL)
    del brain, hparams
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return line


def run_other_classifier(name, recipe_dir, yaml, module, out_dir,
                         device="cuda"):
    """One bf16 epoch of a classification twin from its YAML on its
    recipe's synthetic corpus (``prepare_synthetic``), with the export
    of its checkpoint; VoxLingua107's export is served through
    ``EncoderClassifier.from_hparams`` and held against the trained
    modules."""
    data = os.path.join(out_dir, name, "data")
    prepare = importlib.import_module(
        module.__name__.rsplit(".", 1)[0] + ".prepare")
    prepare.prepare_synthetic(data)
    overrides = {"data_folder": data,
                 "output_folder": os.path.join(out_dir, name, "out"),
                 "number_of_epochs": 1, "device": device}
    text, hparams = twin_yaml(
        os.path.join(TWINS_ROOT, recipe_dir, "hparams", yaml), overrides)
    n_params = sum(p.numel() for m in hparams["modules"].values()
                   for p in m.parameters())
    brain_cls = (TimedSoundBrain if hasattr(module, "SoundBrain")
                 else TimedLangIdBrain)
    brain, counts, seconds, peak = _timed_run(lambda: module.run(
        hparams, {"device": device, "precision": "bf16",
                  "noprogressbar": True}, brain_cls=brain_cls,
        export_from=(text, overrides)), device)
    line = {"yaml": f"{recipe_dir}/{yaml}",
            **_train_line(brain, counts, seconds, peak, n_params)}
    ok = (line["b3_equals_batches"] and brain.forwards[Stage.TRAIN] >= 1
          and brain.forwards[Stage.VALID] >= 1
          and all(np.isfinite(brain.losses + brain.valid_losses)))
    if name == "voxlingua107":
        served = EncoderClassifier.from_hparams(
            source=hparams["pretrained_folder"],
            savedir=os.path.join(out_dir, name, "served"),
            run_opts={"device": device})
        wavs, lens, _ = tone_clips(device, CLASSIFY_SERVE)
        reset_launch_counts()
        out_prob, _, index, labels = served.classify_batch(wavs, lens)
        _sync(device)
        line["launches_served"] = launch_counts()["fused_fbank"]
        modules = brain.modules.eval()
        with torch.no_grad():
            trained = modules.classifier(modules.embedding_model(
                hparams["compute_features"](wavs), lengths=lens))
        line["served_vs_trained_max_diff"] = \
            (out_prob - trained).abs().max().item()
        line["labels"] = labels
        ok = ok and line["launches_served"] == 1 and \
            line["served_vs_trained_max_diff"] <= 1e-6 and \
            all(lab in hparams["label_encoder"].lab2ind for lab in labels)
    line["ok"] = bool(ok)
    del brain, hparams
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return line


def run_classify_path(out_dir, device="cuda"):
    """The audio classifiers at full width: B3 against its plain version
    at ESC50's and UrbanSound8k's batches; the ESC50 CNN14 and ViT twins
    served through ``AudioClassifier.classify_batch``; two bf16 steps of
    each ESC50 twin with the valid stage; one epoch each of the
    UrbanSound8k, CommonLanguage, VoxLingua107 and IEMOCAP twins, the
    VoxLingua107 export served through ``EncoderClassifier.from_hparams``.
    Returns B3's launches in each run and its errors at the two shapes."""
    t0 = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    b3 = check_b3_at_shapes(CLASSIFY_B3_SHAPES, device)
    emit({"phase": "classify_b3_check", "max_abs_err_db": b3,
          "atol": B3_ATOL, "ok": max(b3.values()) <= B3_ATOL})
    if max(b3.values()) > B3_ATOL:
        raise AssertionError(f"classify_path: B3 against its plain version "
                             f"{b3}")
    launches = {}
    for yaml in ESC50_SERVED:
        line = run_classify_serve(yaml, device)
        emit({"phase": f"classify_serve/{yaml[:-5]}", **line})
        launches[f"serve_{yaml[:-5]}"] = line["launches_classify_batch"]
        if not line["ok"]:
            raise AssertionError(f"classify_path: serving {yaml} failed")
    manifests = write_sound_corpus(os.path.join(out_dir, "esc50_data"))
    for yaml in ESC50_YAMLS:
        line = run_esc50_train(yaml, manifests, out_dir, device)
        emit({"phase": f"classify_train/esc50_{yaml[:-5]}", **line})
        launches[f"train_esc50_{yaml[:-5]}"] = line["launches"]["fused_fbank"]
        if not line["ok"]:
            raise AssertionError(f"classify_path: training {yaml} failed")
    for name, recipe_dir, yaml, module in OTHER_CLASSIFIERS:
        line = run_other_classifier(name, recipe_dir, yaml, module, out_dir,
                                    device)
        emit({"phase": f"classify_train/{name}", **line})
        launches[f"train_{name}"] = line["launches"]["fused_fbank"]
        if "launches_served" in line:
            launches[f"serve_{name}"] = line["launches_served"]
        if not line["ok"]:
            raise AssertionError(f"classify_path: {name} failed")
    emit({"phase": "classify_path_summary", "reduced": CLASSIFY_REDUCED,
          "seconds": time.perf_counter() - t0,
          "gpu_name_power_limit": gpu_name_power_limit()})
    return launches, b3


# -- recurrent_twins_path: CommonVoice, TIMIT, Switchboard, SLURP -----------

# name: (recipe folder, train module, synthetic corpus maker); each corpus
# holds 16 train utterances, two batches of the YAMLs' 8
RECURRENT_TWINS = {
    "commonvoice": ("CommonVoice/ASR/seq2seq", cv_seq2seq_recipe,
                    lambda d: commonvoice_synthetic(d, n_utts=24)),
    "timit": ("TIMIT/ASR/seq2seq", timit_seq2seq_recipe,
              lambda d: timit_prepare.prepare_synthetic(d, n_utt=18)),
    "switchboard": ("Switchboard/ASR/seq2seq", swbd_seq2seq_recipe,
                    lambda d: swbd_prepare.prepare_synthetic(d, n_utt=18)),
    "slurp": ("SLURP/direct", slurp_recipe,
              lambda d: slurp_prepare.prepare_synthetic(d, n_utts=24)),
}
RECURRENT_TRAIN_STEPS = 2
# SLURP served: 8 utterances of 60-98 % of 3 s, a spoken command's length
# (the synthetic corpus's are 0.3 s), beam ``SLU_BEAM_SIZE``; float32
# tokens held over a short decode (C32: a search over random weights is
# chaotic)
SLU_SERVE = dict(clips=8, seconds=3.0, fill=(0.6, 0.98),
                 max_decode_ratio=1.0, held_decode_ratio=0.2)
RECURRENT_REDUCED = {
    "weights": "random, from each YAML's seed",
    "epochs": "15-20 -> 2 optimizer steps and the valid stage",
    "corpora": "each recipe's synthetic corpus, 16 train utterances of "
               "0.24-0.48 s (CommonVoice) or 0.3 s (TIMIT, Switchboard, "
               "SLURP), padded to 1 s (SLURP: 8192 samples)",
    "slurp_serve": "8 tone clips of 1.8-2.94 s padded to 3 s, not the "
                   "corpus's utterances",
    "float32_tokens": "held at decode ratio 0.2 (C32)",
}


def commonvoice_synthetic(data_folder, n_utts):
    """CommonVoice's synthetic corpus without its test split: outside
    ``--debug`` the twin's ``run`` would beam-search it."""
    commonvoice_prepare.prepare_synthetic(data_folder, n_utts=n_utts)
    os.remove(os.path.join(data_folder, "test.json"))


class TimedSeq2SeqBrain(TimedSteps, seq2seq_recipe.ASR):
    """The LibriSpeech seq2seq twin's ``ASR`` (CommonVoice, Switchboard)
    with :class:`TimedSteps`' readings."""


class TimedTimitBrain(TimedSteps, timit_seq2seq_recipe.ASR):
    """The TIMIT seq2seq twin's ``ASR`` with :class:`TimedSteps`'
    readings."""


class TimedSLUBrain(TimedSteps, slurp_recipe.SLU):
    """The SLURP twin's ``SLU`` with :class:`TimedSteps`' readings."""


def run_slu_serve(hparams, tokenizer, device="cuda"):
    """The SLURP twin's trained modules served through
    ``EndToEndSLU.decode_batch`` on ``SLU_SERVE``'s clips (B3 once a
    call): bf16 is not asked for (the interface runs float32); the
    search's steps; the tokens through B3 and through its plain version,
    equal at a short decode."""
    wavs, lens, audio_s = tone_clips(device, SLU_SERVE)

    def interface(ratio):
        return EndToEndSLU(hparams={
            "tokenizer": tokenizer,
            "slu_enc": slurp_recipe.slu_encoder(hparams),
            "beam_searcher": slurp_recipe.slu_searcher(
                hparams, max_decode_ratio=ratio)},
            run_opts={"device": device})

    slu = interface(SLU_SERVE["max_decode_ratio"])
    reset_launch_counts()
    words, hyps = slu.decode_batch(wavs, lens)
    _sync(device)
    launches = launch_counts()["fused_fbank"]
    searcher = slu.hparams.beam_searcher.searcher
    steps, enc_frames = searcher.last_steps, slu.encode_batch(
        wavs, lens).shape[1]
    decode_ms, decode_all, _ = _elapsed_ms(
        lambda: slu.decode_batch(wavs, lens), 2, device)
    encode_ms, _, _ = _elapsed_ms(lambda: slu.encode_batch(wavs, lens), 3,
                                  device)
    short = interface(SLU_SERVE["held_decode_ratio"])
    _, kernel_hyps = short.decode_batch(wavs, lens)
    with plain_versions("fused_fbank"):
        _, plain_hyps = short.decode_batch(wavs, lens)
    equal = [list(map(int, a)) == list(map(int, b))
             for a, b in zip(kernel_hyps, plain_hyps)]
    line = {"utterances": int(wavs.shape[0]),
            "batch_shape": list(wavs.shape), "audio_seconds": audio_s,
            "encoder_frames": enc_frames, "search_steps": steps,
            "beam_size": slurp_recipe.SLU_BEAM_SIZE,
            "decode_batch_ms": decode_ms, "decode_batch_ms_all": decode_all,
            "audio_s_per_s": audio_s / (decode_ms / 1e3),
            "encode_batch_ms": encode_ms, "launches_decode_batch": launches,
            "tokens": [len(h) for h in hyps], "words": words[:2],
            "fp32_tokens_equal_at_short_decode": all(equal)}
    line["ok"] = bool(launches == 1 and len(words) == wavs.shape[0]
                      and all(equal))
    return line


def run_recurrent_twin(name, out_dir, device="cuda"):
    """Two bf16 optimizer steps of a recurrent twin's ``run`` from its
    YAML at full width and its valid stage (B3 on every batch); SLURP's
    trained model is then served through ``EndToEndSLU``."""
    recipe_dir, module, prepare = RECURRENT_TWINS[name]
    data = os.path.join(out_dir, name, "data")
    prepare(data)
    _, hparams = twin_yaml(
        os.path.join(TWINS_ROOT, recipe_dir, "hparams", "train.yaml"), {
            "data_folder": data,
            "output_folder": os.path.join(out_dir, name, "out"),
            "number_of_epochs": 1, "device": device})
    n_params = sum(p.numel() for m in hparams["modules"].values()
                   for p in m.parameters())
    brain_cls = {"timit": TimedTimitBrain,
                 "slurp": TimedSLUBrain}.get(name, TimedSeq2SeqBrain)
    (brain, _, tokens), counts, seconds, peak = _timed_run(
        lambda: module.run(hparams, {
            "device": device, "precision": "bf16", "noprogressbar": True,
            "optimizer_step_limit": RECURRENT_TRAIN_STEPS},
            brain_cls=brain_cls), device)
    line = {"yaml": f"{recipe_dir}/train.yaml",
            **_train_line(brain, counts, seconds, peak, n_params),
            "train_audio_seconds": brain.audio_seconds}
    ok = (line["b3_equals_batches"]
          and brain.forwards[Stage.TRAIN] == RECURRENT_TRAIN_STEPS
          and brain.forwards[Stage.VALID] >= 1 and line["checkpoints"] == 1
          and all(np.isfinite(brain.losses + brain.valid_losses)))
    if name == "slurp":
        brain.modules.eval()
        serve = run_slu_serve(hparams, tokens, device)
        line["serve"] = serve
        ok = ok and serve["ok"]
    line["ok"] = bool(ok)
    del brain, hparams
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return line


def run_recurrent_twins_path(out_dir, device="cuda"):
    """The CommonVoice, TIMIT, Switchboard and SLURP twins at their YAMLs'
    widths, each two bf16 steps and its valid stage; SLURP served through
    ``EndToEndSLU.decode_batch``. Returns B3's launches in each run."""
    t0 = time.perf_counter()
    launches = {}
    for name in RECURRENT_TWINS:
        line = run_recurrent_twin(name, out_dir, device)
        emit({"phase": f"recurrent_twins/{name}", **line})
        launches[f"train_{name}"] = line["launches"]["fused_fbank"]
        if "serve" in line:
            launches[f"serve_{name}"] = line["serve"][
                "launches_decode_batch"]
        if not line["ok"]:
            raise AssertionError(f"recurrent_twins_path: {name} failed")
    emit({"phase": "recurrent_twins_path_summary",
          "reduced": RECURRENT_REDUCED,
          "seconds": time.perf_counter() - t0,
          "gpu_name_power_limit": gpu_name_power_limit()})
    return launches


# -- separation_path: SepFormer and the other separation twins --------------

# the WSJ0Mix SepFormer twin: trained, checkpointed, exported and served
SEPARATION_MAIN = ("WSJ0Mix", "sepformer.yaml")
# every other separation twin YAML, one bf16 step each at its full width
SEPARATION_TWINS = tuple((corpus, yaml) for corpus, yamls in (
    ("WSJ0Mix", ("sepformer-conformerintra.yaml",
                 "sepformer-customdataset.yaml", "dprnn.yaml",
                 "resepformer.yaml", "skim.yaml", "convtasnet.yaml")),
    ("LibriMix", ("sepformer-libri2mix.yaml", "sepformer-libri3mix.yaml")),
    ("WHAMandWHAMR", ("sepformer-wham.yaml", "sepformer-whamr.yaml")),
    ("Aishell1Mix", ("sepformer-aishell1mix2.yaml",
                     "sepformer-aishell1mix2-wham.yaml",
                     "sepformer-aishell1mix3.yaml",
                     "sepformer-aishell1mix3-wham.yaml")),
    ("BinauralWSJ0Mix", ("convtasnet-independent.yaml",
                         "convtasnet-cross.yaml", "convtasnet-parallel.yaml",
                         "convtasnet-parallel-noise.yaml",
                         "convtasnet-parallel-reverb.yaml",
                         "sepformer-binaural.yaml")),
) for yaml in yamls)
SEPARATION_SR = 8000
# the main chain's corpus: 2 train mixtures (two steps at the YAML's batch
# of 1, each a random 4 s crop) and 1 valid; every other twin's: 1 and 1
SEPARATION_CORPUS = dict(train=2, valid=1, seconds=4.5)
SEPARATION_TWIN_CORPUS = dict(train=1, valid=1, seconds=4.0)
SEPARATION_TRAIN_STEPS = 2
# served: 4 mixtures of 4 s, float32, through both exports
SEPARATION_SERVE = dict(batch=4, seconds=4.0, repeats=3)
# float32 (TF32 off): the card's served output against the same weights
# run by the port on the CPU, relative L2 over the first mixture (the
# same arithmetic summed in another order, 32 Transformer layers deep)
SEPARATION_CPU_RTOL = 1e-4
SEPARATION_REDUCED = {
    "weights": "random, from each YAML's seed",
    "epochs": "200 (WSJ0Mix) or 100 -> 2 optimizer steps (SepFormer) or "
              "1 (every other twin) and one valid batch",
    "corpus": "synthetic tone mixtures at 8 kHz: 2 train and 1 valid of "
              "4.5 s for the SepFormer chain (4 s crops), 1 and 1 of 4 s "
              "for every other twin (stereo for BinauralWSJ0Mix)",
}
# width overrides given to every separation YAML that names the key: none
# on the card (full width); the CPU tests shrink widths with them
SEPARATION_WIDTHS = {}
SEPARATION_RECIPES = {
    "WSJ0Mix": wsj0mix_recipe, "LibriMix": librimix_recipe,
    "WHAMandWHAMR": librimix_recipe, "Aishell1Mix": librimix_recipe,
    "BinauralWSJ0Mix": binaural_recipe,
}


class TimedSeparationSteps(TimedSteps):
    """:class:`TimedSteps` over the separation twins' mixtures."""

    SIGNAL_KEY, SIGNAL_RATE = "mix_sig", SEPARATION_SR


class TimedWSJ0MixBrain(TimedSeparationSteps, wsj0mix_recipe.Separation):
    """The WSJ0Mix twin's Brain with :class:`TimedSteps`' readings."""


class TimedLibriMixBrain(TimedSeparationSteps, librimix_recipe.Separation):
    """The LibriMix, WHAM! and Aishell1Mix twins' Brain with
    :class:`TimedSteps`' readings."""


class TimedBinauralBrain(TimedSeparationSteps,
                         binaural_recipe.BinauralSeparation):
    """The BinauralWSJ0Mix twin's Brain with :class:`TimedSteps`'
    readings."""


SEPARATION_BRAINS = {"WSJ0Mix": TimedWSJ0MixBrain,
                     "BinauralWSJ0Mix": TimedBinauralBrain}


def separation_sources(rng, n, num_spks, stereo=False):
    """``num_spks`` sources of ``n`` samples at 8 kHz, each a tone with a
    vibrato in its own band (stereo: louder in one ear), float32."""
    t = np.arange(n) / SEPARATION_SR
    srcs = []
    for k in range(num_spks):
        f = rng.uniform(150 + 300 * k, 350 + 300 * k)
        src = 0.3 * np.sin(2 * np.pi * f * t + 3 * np.sin(
            2 * np.pi * rng.uniform(2, 6) * t))
        if stereo:
            gains = (1.0, 0.5) if k % 2 == 0 else (0.5, 1.0)
            src = np.stack([g * src for g in gains], -1)
        srcs.append(src.astype(np.float32))
    return srcs


def write_separation_corpus(folder, cfg, num_spks=2, stereo=False, seed=0):
    """``cfg["train"] + cfg["valid"]`` mixtures of
    :func:`separation_sources` plus noise 30 dB down, as WAV files and
    the manifests ``train.json``/``valid.json`` (``mix_wav``,
    ``s<i>_wav``, ``length``); returns the manifests' paths."""
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = int(SEPARATION_SR * cfg["seconds"])
    manifests = {"train": {}, "valid": {}}
    for i in range(cfg["train"] + cfg["valid"]):
        srcs = separation_sources(rng, n, num_spks, stereo)
        mix = sum(srcs) + 0.01 * rng.standard_normal(srcs[0].shape)
        item = {"length": n}
        for name, sig in [("mix", mix)] + [
                (f"s{k + 1}", s) for k, s in enumerate(srcs)]:
            path = os.path.join(folder, f"u{i}_{name}.wav")
            write_audio(path, sig.astype(np.float32), SEPARATION_SR)
            item[f"{name}_wav"] = path
        split = "train" if i < cfg["train"] else "valid"
        manifests[split][f"u{i}"] = item
    paths = {}
    for split, items in manifests.items():
        paths[split] = os.path.join(folder, f"{split}.json")
        with open(paths[split], "w") as f:
            json.dump(items, f)
    return paths


def separation_yaml(corpus, yaml, data, out, device):
    """A separation twin's YAML with ``SEPARATION_WIDTHS`` (the keys it
    names), one epoch, its data and output folders and ``device``:
    ``(text, overrides, hparams)``."""
    path = os.path.join(TWINS_ROOT, corpus, "separation", "hparams", yaml)
    with open(path, encoding="utf-8") as f:
        names = {line.split(":")[0] for line in f if ":" in line}
    overrides = {k: v for k, v in SEPARATION_WIDTHS.items() if k in names}
    overrides.update(
        data_folder=data, output_folder=out, number_of_epochs=1,
        device=device, train_annotation=os.path.join(data, "train.json"),
        valid_annotation=os.path.join(data, "valid.json"))
    text, hparams = twin_yaml(path, overrides)
    return text, overrides, hparams


def _separation_train(corpus, yaml, out_dir, corpus_cfg, steps, device,
                      export=False):
    """``steps`` bf16 optimizer steps of a separation twin's ``run`` from
    its YAML on a :func:`write_separation_corpus` corpus, its valid stage
    and checkpoint (and with ``export`` the export of its best
    checkpoint): ``(brain, hparams, text, overrides, line)``."""
    folder = os.path.join(out_dir, f"{corpus}_{yaml[:-5]}")
    data = os.path.join(folder, "data")
    text, overrides, hparams = separation_yaml(
        corpus, yaml, data, os.path.join(folder, "out"), device)
    write_separation_corpus(data, corpus_cfg, num_spks=hparams["num_spks"],
                            stereo=corpus == "BinauralWSJ0Mix")
    n_params = sum(p.numel() for m in hparams["modules"].values()
                   for p in m.parameters())
    module = SEPARATION_RECIPES[corpus]
    brain, counts, seconds, peak = _timed_run(lambda: module.run(
        hparams, {"device": device, "precision": "bf16",
                  "noprogressbar": True, "optimizer_step_limit": steps},
        brain_cls=SEPARATION_BRAINS.get(corpus, TimedLibriMixBrain),
        export_from=(text, overrides) if export else None), device)
    step_ms = brain.step_ms()
    line = {"yaml": f"{corpus}/separation/hparams/{yaml}",
            "parameters": n_params, "seconds": seconds, "step_ms": step_ms,
            "losses": brain.losses, "valid_losses": brain.valid_losses,
            "peak_gb": peak / 1e9, "launches": counts,
            "forwards": {s.name: c for s, c in brain.forwards.items()},
            "checkpoints": len(brain.checkpointer.list_checkpoints()),
            "train_audio_seconds": brain.audio_seconds}
    # the valid stage's mean skips a non-finite loss: the weights say
    line["parameters_finite"] = all(
        bool(torch.isfinite(p).all()) for p in brain.modules.parameters())
    line["ok"] = bool(
        brain.forwards[Stage.TRAIN] == steps
        and brain.forwards[Stage.VALID] == corpus_cfg["valid"]
        and line["checkpoints"] == 1 and len(brain.losses) == steps
        and all(np.isfinite(brain.losses + brain.valid_losses))
        and line["parameters_finite"])
    return brain, hparams, text, overrides, line


def separation_mixtures(device, cfg, num_spks=2, seed=9):
    """``cfg["batch"]`` mixtures of ``cfg["seconds"]`` (B, T) and their
    sources (B, T, num_spks), on ``device``."""
    rng = np.random.default_rng(seed)
    n = int(SEPARATION_SR * cfg["seconds"])
    srcs = np.stack([np.stack(separation_sources(rng, n, num_spks), -1)
                     for _ in range(cfg["batch"])])
    mix = srcs.sum(-1) + 0.01 * rng.standard_normal(srcs.shape[:2])
    return (torch.from_numpy(mix.astype(np.float32)).to(device),
            torch.from_numpy(srcs).to(device))


def run_separation_main(out_dir, device="cuda"):
    """The WSJ0Mix SepFormer twin at its YAML's width: two bf16 steps on
    4 s crops, the valid batch, a checkpoint and its export as a
    ``SepformerSeparation`` source, the whole wrapper and the three
    modules; both served in float32 on 4 mixtures of 4 s (median ms by
    CUDA events, audio seconds a second), held bit for bit against the
    trained model, the card against the CPU on the first mixture
    (``SEPARATION_CPU_RTOL``), and the PIT loss against the same with the
    two targets swapped."""
    corpus, yaml = SEPARATION_MAIN
    brain, hparams, text, overrides, line = _separation_train(
        corpus, yaml, out_dir, SEPARATION_CORPUS, SEPARATION_TRAIN_STEPS,
        device, export=True)
    out = hparams["output_folder"]
    exports = {"full_wrapper": os.path.join(out, "pretrained"),
               "three_modules": export_separator(
                   hparams, text, overrides,
                   folder=os.path.join(out, "pretrained_three"),
                   three_modules=True, min_key="loss")}
    mix, sources = separation_mixtures(device, SEPARATION_SERVE)
    audio_s = mix.numel() / SEPARATION_SR
    launches = dict(line["launches"])
    served, serve = {}, {}
    for name, folder in exports.items():
        sep = SepformerSeparation.from_hparams(
            source=folder, savedir=os.path.join(out, f"served_{name}"),
            run_opts={"device": device})
        reset_launch_counts()
        served[name] = sep.separate_batch(mix)
        _sync(device)
        for k, v in launch_counts().items():
            launches[k] += v
        ms, all_ms, _ = _elapsed_ms(lambda: sep.separate_batch(mix),
                                    SEPARATION_SERVE["repeats"], device)
        serve[name] = {"separate_batch_ms": ms, "separate_batch_ms_all":
                       all_ms, "audio_s_per_s": audio_s / (ms / 1e3),
                       "modules": sorted(sep.mods.keys())}
        del sep
    model = brain.modules.model.eval()
    with torch.no_grad():
        trained = model(mix)
        cpu_out = copy.deepcopy(model).to("cpu")(mix[:1].cpu())
    card = trained[:1].cpu()
    rel_l2 = ((card - cpu_out).norm() / cpu_out.norm()).item()
    pit = get_si_snr_with_pitwrapper(sources, trained)
    pit_swapped = get_si_snr_with_pitwrapper(sources.flip(-1), trained)
    checks = {
        "batch_shape": list(mix.shape), "est_shape": list(trained.shape),
        "served_equals_trained": {n: bool(torch.equal(e, trained))
                                  for n, e in served.items()},
        "fp32_card_vs_cpu_rel_l2": rel_l2, "cpu_rtol": SEPARATION_CPU_RTOL,
        "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                 "cudnn": torch.backends.cudnn.allow_tf32,
                 "float32_matmul_precision":
                     torch.get_float32_matmul_precision()},
        "pit_loss": pit.tolist(), "pit_loss_swapped": pit_swapped.tolist(),
        "pit_swap_bitwise": bool(torch.equal(pit, pit_swapped)),
    }
    line.update(serve=serve, checks=checks, launches=launches,
                second_step_ms=line["step_ms"][-1])
    line["ok"] = bool(
        line["ok"] and tuple(trained.shape) == (*mix.shape, 2)
        and bool(torch.isfinite(trained).all())
        and all(checks["served_equals_trained"].values())
        and rel_l2 <= SEPARATION_CPU_RTOL
        and torch.allclose(pit, pit_swapped, rtol=1e-6, atol=0))
    del brain, hparams, model, served, trained
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return line


def run_separation_twin(corpus, yaml, out_dir, device="cuda"):
    """One bf16 optimizer step of a separation twin from its YAML at full
    width and one valid batch; the twin's folder is removed after."""
    brain, hparams, _, _, line = _separation_train(
        corpus, yaml, out_dir, SEPARATION_TWIN_CORPUS, 1, device)
    del brain, hparams
    gc.collect()
    shutil.rmtree(os.path.join(out_dir, f"{corpus}_{yaml[:-5]}"),
                  ignore_errors=True)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return line


def run_separation_path(out_dir, device="cuda"):
    """The WSJ0Mix SepFormer chain (:func:`run_separation_main`), then
    every other separation twin YAML one step each. No kernel of the port
    is on this path: returns each kernel's launches over it (all 0)."""
    t0 = time.perf_counter()
    main_line = run_separation_main(out_dir, device)
    emit({"phase": "separation_path/wsj0mix_sepformer", **main_line})
    if not main_line["ok"]:
        raise AssertionError("separation_path: the SepFormer chain failed")
    launches = dict(main_line["launches"])
    readings = {"served_audio_s_per_s": {
        n: s["audio_s_per_s"] for n, s in main_line["serve"].items()},
        "sepformer_second_step_ms": main_line["second_step_ms"],
        "sepformer_peak_gb": main_line["peak_gb"], "twins": {}}
    for key in ("served_audio_s_per_s", "sepformer_second_step_ms",
                "sepformer_peak_gb"):
        emit({"phase": "separation_reading", key: readings[key]})
    for corpus, yaml in SEPARATION_TWINS:
        line = run_separation_twin(corpus, yaml, out_dir, device)
        emit({"phase": f"separation_path/{corpus}/{yaml[:-5]}", **line})
        for k, v in line["launches"].items():
            launches[k] += v
        readings["twins"][line["yaml"]] = {"step_ms": line["step_ms"][0],
                                           "peak_gb": line["peak_gb"]}
        if not line["ok"]:
            raise AssertionError(f"separation_path: {corpus}/{yaml} failed")
    emit({"phase": "separation_path_summary", "readings": readings,
          "launches": launches, "reduced": SEPARATION_REDUCED,
          "seconds": time.perf_counter() - t0,
          "gpu_name_power_limit": gpu_name_power_limit()})
    return launches


# -- enhancement_path: the enhancement twins and their two interfaces -------

PORT_ROOT = os.path.join(ROOT, "speechbrain_tpu_torch")
# the rate of the two served chains and of their served batch
ENHANCE_SR = 16000
# the VoiceBank spectral-mask twin (CNN-Transformer: d_model 256, 8 layers,
# 16 heads, d_ffn 512; n_fft 512 at 16 kHz): trained, checkpointed,
# exported and served through SpectralMaskEnhancement
ENHANCEMENT_MAIN = ("recipes/VoiceBank/enhance/spectral_mask", "train.yaml")
# the waveform-mapping FCN twin (80 channels, kernel 55, 8 blocks): the
# same, served through WaveformEnhancement
ENHANCEMENT_WAVEFORM = ("recipes/VoiceBank/enhance/waveform_map",
                        "train.yaml")
# the spectral-mask twin's other maskers, its MaskNet include swapped
ENHANCEMENT_MASKERS = ("BLSTM.yaml", "2DFCN.yaml", "2DFCN+BLSTM.yaml")
# every other enhancement twin YAML, one bf16 step each at its full width
ENHANCEMENT_TWINS = tuple(
    ("recipes/WHAMandWHAMR/enhancement", yaml) for yaml in (
        "cnntransformer-wham-DM.yaml", "cnntransformer-whamr-DM.yaml",
        "convtasnet-whamr-DM.yaml", "dprnn-whamr-DM.yaml",
        "sepformer-wham.yaml", "sepformer-whamr.yaml",
        "sepformer-whamr-DM.yaml", "sepformer-whamr-16k.yaml",
        "sepformer-whamr-16k-DM.yaml",
    )) + (("recipes/DNS/enhancement", "sepformer-dns.yaml"),
          ("recipes/VoiceBank/dereverb/spectral_mask", "train.yaml"),
          ("templates/enhancement", "train.yaml"))
# the main chains' corpus: 8 train utterances (two steps at the YAMLs'
# batch of 4) and 4 valid (one batch), 4 s at 16 kHz; every other twin's:
# one YAML batch to train and one to validate, 4 s at the YAML's rate
ENHANCEMENT_CORPUS = dict(train=8, valid=4, seconds=4.0)
ENHANCEMENT_TWIN_SECONDS = 4.0
ENHANCEMENT_TRAIN_STEPS = 2
# served: 4 noisy utterances of 4 s, float32, through both exports
ENHANCEMENT_SERVE = dict(batch=4, seconds=4.0, repeats=5)
# float32 (TF32 off): the card's served output against the same weights
# run by the port on the CPU, relative L2 over the first utterance
ENHANCEMENT_CPU_RTOL = 1e-4
# the ISTFT round trips on the card: (rate, n_fft, window and hop in ms);
# the first is C48's case, a 256-sample window in a 512-sample frame
ISTFT_CASES = ((8000, 512, 32, 16), (16000, 512, 32, 16))
ISTFT_RTOL = 1e-5
ENHANCEMENT_REDUCED = {
    "weights": "random, from each YAML's seed",
    "epochs": "100-200 -> 2 optimizer steps (the spectral-mask and "
              "waveform-map chains) or 1 (every other twin) and one valid "
              "batch",
    "corpus": "synthetic vibrato tones in white noise (WHAM!/WHAMR!: "
              "mixture and first source): 8 train and 4 valid utterances "
              "of 4 s at 16 kHz for the two chains, one YAML batch each "
              "of 4 s at the YAML's rate for every other twin",
}
# width overrides given to every enhancement YAML that names the key, and
# to the swapped maskers' include: none on the card (full width); the CPU
# tests shrink widths with them
ENHANCEMENT_WIDTHS = {}
ENHANCEMENT_MASKER_WIDTHS = {}
# the recipe Brain each twin folder runs, and the key of its noisy signal
ENHANCEMENT_SIGNALS = {"recipes/WHAMandWHAMR/enhancement": "mix_sig"}


def _enhancement_module(folder):
    """A twin folder's ``train`` module."""
    return importlib.import_module(
        "speechbrain_tpu_torch." + folder.replace("/", ".") + ".train")


def _default_brain(run_fn):
    """The Brain class a twin's ``run`` trains by default."""
    import inspect

    return inspect.signature(run_fn).parameters["brain_cls"].default


def write_enhancement_corpus(folder, n_train, n_valid, seconds, sample_rate,
                             keys=("noisy", "clean"), seed=0):
    """``n_train + n_valid`` pairs of ``seconds``: a clean vibrato tone
    with two harmonics under a slow amplitude modulation, and the same plus
    white noise (about 5 dB SNR), as WAV files and the manifests
    ``train.json``/``valid.json`` (``<key>_wav`` for the noisy and the
    clean ``keys``, ``length`` in seconds); returns the manifests'
    paths."""
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = int(sample_rate * seconds)
    t = np.arange(n) / sample_rate
    manifests = {"train": {}, "valid": {}}
    for i in range(n_train + n_valid):
        f0 = rng.uniform(120, 260)
        phase = 2 * np.pi * f0 * t + 2 * np.sin(2 * np.pi * rng.uniform(
            2, 5) * t)
        am = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(1, 4) * t)
        clean = 0.2 * am * (np.sin(phase) + 0.5 * np.sin(2 * phase)
                            + 0.25 * np.sin(3 * phase))
        noisy = clean + 0.06 * rng.standard_normal(n)
        item = {"length": seconds}
        for key, sig in zip(keys, (noisy, clean)):
            path = os.path.join(folder, f"u{i}_{key}.wav")
            write_audio(path, sig.astype(np.float32), sample_rate)
            item[f"{key}_wav"] = path
        manifests["train" if i < n_train else "valid"][f"u{i}"] = item
    paths = {}
    for split, items in manifests.items():
        paths[split] = os.path.join(folder, f"{split}.json")
        with open(paths[split], "w") as f:
            json.dump(items, f)
    return paths


def enhancement_batch(device, cfg, sample_rate=16000, seed=9):
    """``cfg["batch"]`` noisy utterances of ``cfg["seconds"]`` (B, T) and
    their clean signals, on ``device``: :func:`write_enhancement_corpus`'s
    signals made in memory."""
    rng = np.random.default_rng(seed)
    n = int(sample_rate * cfg["seconds"])
    t = np.arange(n) / sample_rate
    clean = []
    for _ in range(cfg["batch"]):
        phase = 2 * np.pi * rng.uniform(120, 260) * t + 2 * np.sin(
            2 * np.pi * rng.uniform(2, 5) * t)
        am = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(1, 4) * t)
        clean.append(0.2 * am * (np.sin(phase) + 0.5 * np.sin(2 * phase)
                                 + 0.25 * np.sin(3 * phase)))
    clean = np.stack(clean)
    noisy = clean + 0.06 * rng.standard_normal(clean.shape)
    return (torch.from_numpy(noisy.astype(np.float32)).to(device),
            torch.from_numpy(clean.astype(np.float32)).to(device))


def enhancement_yaml(folder, yaml, data, out, device, masker=None):
    """An enhancement twin's YAML with ``ENHANCEMENT_WIDTHS`` (the keys it
    names), one epoch, its data and output folders and ``device``, its
    ``MaskNet`` include swapped to ``models/<masker>`` (with ``n_fft``,
    ``device`` and ``ENHANCEMENT_MASKER_WIDTHS``) where ``masker`` is
    given: ``(text, overrides, hparams, yaml folder)``."""
    from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml

    yaml_dir = os.path.join(PORT_ROOT, folder,
                            "" if folder.startswith("templates") else
                            "hparams")
    with open(os.path.join(yaml_dir, yaml), encoding="utf-8") as f:
        text = f.read()
    if masker is not None:
        block = "".join(f"  {k}: {v}\n"
                        for k, v in ENHANCEMENT_MASKER_WIDTHS.items())
        start = text.index("MaskNet: !include:")
        end = text.index("\n\n", start)
        text = (text[:start] + f"MaskNet: !include:models/{masker}\n"
                "  n_fft: !ref <n_fft>\n  device: !ref <device>\n" + block
                + text[end + 1:])
    names = {line.split(":")[0] for line in text.splitlines() if ":" in line}
    overrides = {k: v for k, v in ENHANCEMENT_WIDTHS.items() if k in names}
    overrides.update(
        data_folder=data, output_folder=out, number_of_epochs=1,
        device=device, train_annotation=os.path.join(data, "train.json"),
        valid_annotation=os.path.join(data, "valid.json"))
    hparams = load_hyperpyyaml(text, overrides, base_dir=yaml_dir)
    return text, overrides, hparams, yaml_dir


def _enhancement_train(folder, yaml, out_dir, corpus, steps, device,
                       masker=None, export=False):
    """``steps`` bf16 optimizer steps of an enhancement twin's ``run``
    from its YAML on a :func:`write_enhancement_corpus` corpus
    (``corpus``: train and valid counts and seconds), its valid stage and
    checkpoint, and with ``export`` the export of its best checkpoint:
    ``(brain, hparams, line)``."""
    name = "_".join(folder.split("/")[-2:] + [yaml[:-5]]) + (
        f"_{masker[:-5]}" if masker else "")
    work = os.path.join(out_dir, name)
    data = os.path.join(work, "data")
    text, overrides, hparams, yaml_dir = enhancement_yaml(
        folder, yaml, data, os.path.join(work, "out"), device, masker)
    key = ENHANCEMENT_SIGNALS.get(folder, "noisy_sig")
    rate = hparams["sample_rate"]
    write_enhancement_corpus(data, corpus["train"], corpus["valid"],
                             corpus["seconds"], rate,
                             keys=(key[:-4], "s1" if key == "mix_sig"
                                   else "clean"))
    n_params = sum(p.numel() for p in hparams["modules"]["model"]
                   .parameters())
    module = _enhancement_module(folder)
    run_fn = module.run
    brain_cls = type("Timed" + module.__name__.split(".")[-2], (
        TimedSteps, _default_brain(run_fn)), {"SIGNAL_KEY": key,
                                             "SIGNAL_RATE": rate})
    brain, counts, seconds, peak = _timed_run(lambda: run_fn(
        hparams, {"device": device, "precision": "bf16",
                  "noprogressbar": True, "optimizer_step_limit": steps},
        brain_cls=brain_cls,
        export_from=(text, overrides, yaml_dir) if export else None),
        device)
    line = {"yaml": f"{folder}/{yaml}" + (f" + models/{masker}" if masker
                                          else ""),
            "parameters": n_params, "seconds": seconds,
            "step_ms": brain.step_ms(), "losses": brain.losses,
            "valid_losses": brain.valid_losses, "peak_gb": peak / 1e9,
            "launches": counts,
            "forwards": {s.name: c for s, c in brain.forwards.items()},
            "checkpoints": len(brain.checkpointer.list_checkpoints()),
            "train_audio_seconds": brain.audio_seconds}
    line["parameters_finite"] = all(
        bool(torch.isfinite(p).all()) for p in brain.modules.parameters())
    n_valid_batches = -(-corpus["valid"] // hparams["batch_size"])
    line["ok"] = bool(
        brain.forwards[Stage.TRAIN] == steps
        and brain.forwards[Stage.VALID] == n_valid_batches
        and line["checkpoints"] == 1 and len(brain.losses) == steps
        and all(np.isfinite(brain.losses + brain.valid_losses))
        and line["parameters_finite"])
    return brain, hparams, line


def _spectral_features(stft, noisy):
    spec = stft(noisy)
    return torch.log1p(torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-14))


def _spectral_enhance(model, stft, istft, noisy):
    """``SpectralMaskEnhancement.enhance_batch``'s arithmetic written out:
    log1p magnitudes, the model's mask, expm1, resynthesis with the noisy
    phase."""
    feats = _spectral_features(stft, noisy)
    return resynthesize(torch.expm1(feats * model(feats)), noisy, stft,
                        istft)


def _serve_enhancer(interface, source, noisy, clean, composed, cpu_out,
                    launches, device):
    """One export served through ``interface.from_hparams`` on ``noisy``:
    its first call's launches (added to ``launches``), the median
    ``enhance_batch`` ms by CUDA events, audio seconds a second, the
    output against ``composed`` (the same arithmetic on the trained
    module, bit for bit) and its first utterance against ``cpu_out``,
    and the served output's STOI against ``clean``."""
    enhancer = interface.from_hparams(
        source=source, savedir=source + "_served",
        run_opts={"device": device})
    reset_launch_counts()
    served = enhancer.enhance_batch(noisy)
    _sync(device)
    for k, v in launch_counts().items():
        launches[k] += v
    ms, all_ms, _ = _elapsed_ms(lambda: enhancer.enhance_batch(noisy),
                                ENHANCEMENT_SERVE["repeats"], device)
    card = served[:1].cpu()
    rel_l2 = ((card - cpu_out).norm() / cpu_out.norm()).item()
    stoi = -stoi_loss(served, clean, torch.ones(len(served)),
                      reduction="batch")
    line = {"enhance_batch_ms": ms, "enhance_batch_ms_all": all_ms,
            "audio_s_per_s": noisy.numel() / ENHANCE_SR / (ms / 1e3),
            "out_shape": list(served.shape),
            "served_equals_trained": bool(torch.equal(served, composed)),
            "fp32_card_vs_cpu_rel_l2": rel_l2,
            "cpu_rtol": ENHANCEMENT_CPU_RTOL,
            "stoi_of_random_weights": [float(v) for v in stoi]}
    line["ok"] = bool(
        tuple(served.shape) == tuple(noisy.shape)
        and bool(torch.isfinite(served).all())
        and line["served_equals_trained"] and rel_l2 <= ENHANCEMENT_CPU_RTOL)
    return line


def forward_backward_ms(model, x, precision, device, repeats=3):
    """Median forward and backward ms (CUDA events) of ``model(x)``'s mean
    at ``precision`` (``"bf16"`` under autocast, or ``"fp32"``), after a
    warm-up pass; the gradients are dropped."""
    from speechbrain_tpu_torch.utils.autocast import autocast

    model.train()
    times = []
    for i in range(repeats + 1):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        events[0].record()
        with autocast(precision, device):
            loss = model(x).float().mean()
        events[1].record()
        loss.backward()
        events[2].record()
        _sync(device)
        if i:
            times.append([events[0].elapsed_time(events[1]),
                          events[1].elapsed_time(events[2])])
    model.zero_grad(set_to_none=True)
    model.eval()
    fwd, bwd = np.median(np.array(times), axis=0)
    return {"forward_ms": float(fwd), "backward_ms": float(bwd)}


def run_enhancement_main(out_dir, device="cuda"):
    """The VoiceBank spectral-mask twin (CNN-Transformer) and waveform-map
    twin (FCN) at their YAMLs' widths: two bf16 steps each on 4 s
    utterances, the valid batch, a checkpoint and its export, served
    through ``SpectralMaskEnhancement``/``WaveformEnhancement.from_hparams``
    in float32 on 4 utterances of 4 s (median ms by CUDA events, audio
    seconds a second), held bit for bit against the same arithmetic on the
    trained module and the card against the CPU on the first utterance
    (``ENHANCEMENT_CPU_RTOL``); the STOI of the served output, a number
    only (the weights are random); the model's forward and backward alone
    on the served batch, bf16 and float32 (``model_step_split``)."""
    noisy, clean = enhancement_batch(device, ENHANCEMENT_SERVE)
    lines = {}
    for label, (folder, yaml), interface in (
            ("spectral_mask", ENHANCEMENT_MAIN, SpectralMaskEnhancement),
            ("waveform_map", ENHANCEMENT_WAVEFORM, WaveformEnhancement)):
        brain, hparams, line = _enhancement_train(
            folder, yaml, out_dir, ENHANCEMENT_CORPUS,
            ENHANCEMENT_TRAIN_STEPS, device, export=True)
        launches = dict(line["launches"])
        model = brain.modules.model.eval()
        cpu_model = copy.deepcopy(model).to("cpu")
        with torch.no_grad():
            if interface is SpectralMaskEnhancement:
                stft = hparams["compute_stft"]
                composed = _spectral_enhance(model, stft, stft.inverse(),
                                             noisy)
                cpu_stft = STFT(ENHANCE_SR, n_fft=hparams["n_fft"],
                                win_length=hparams["win_length"],
                                hop_length=hparams["hop_length"],
                                device="cpu")
                cpu_out = _spectral_enhance(cpu_model, cpu_stft,
                                            cpu_stft.inverse(),
                                            noisy[:1].cpu())
            else:
                composed = model(noisy)
                cpu_out = cpu_model(noisy[:1].cpu())
            serve = _serve_enhancer(
                interface, os.path.join(hparams["output_folder"],
                                        "pretrained"),
                noisy, clean, composed, cpu_out, launches, device)
        # the step's model alone on the served batch: forward and
        # backward, bf16 as trained and float32
        feats = (_spectral_features(hparams["compute_stft"], noisy)
                 if interface is SpectralMaskEnhancement else noisy)
        split = {p: forward_backward_ms(model, feats, p, device)
                 for p in ("bf16", "fp32")}
        line.update(serve=serve, launches=launches, model_step_split=split,
                    second_step_ms=line["step_ms"][-1],
                    tf32={"matmul": torch.backends.cuda.matmul.allow_tf32,
                          "cudnn": torch.backends.cudnn.allow_tf32})
        line["ok"] = bool(line["ok"] and serve["ok"])
        lines[label] = line
        del brain, hparams, model, cpu_model, composed
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return lines


def run_istft_round_trips(device="cuda", seconds=4.0, batch=4, seed=11):
    """``ISTFT(STFT(x))`` on the card for each of ``ISTFT_CASES`` on white
    noise: the relative L2 error, at most ``ISTFT_RTOL``, and the
    round trip's median ms by CUDA events."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    cases = {}
    for sr, n_fft, win, hop in ISTFT_CASES:
        x = torch.randn(batch, int(sr * seconds), generator=gen).to(device)
        stft = STFT(sr, win_length=win, hop_length=hop, n_fft=n_fft,
                    device=device)
        istft = stft.inverse()
        ms, _, rec = _elapsed_ms(
            lambda: istft(stft(x), sig_length=x.shape[1]), 3, device)
        err = ((rec - x).norm() / x.norm()).item()
        cases[f"{sr}Hz_nfft{n_fft}_win{stft.win_length}"] = {
            "rel_l2": err, "round_trip_ms": ms,
            "ok": bool(err <= ISTFT_RTOL)}
    return {"cases": cases, "rtol": ISTFT_RTOL,
            "ok": all(c["ok"] for c in cases.values())}


def run_enhancement_twin(folder, yaml, out_dir, device="cuda", masker=None):
    """One bf16 optimizer step of an enhancement twin from its YAML at full
    width and one valid batch, on one YAML batch of 4 s utterances each;
    the twin's folder is removed after."""
    path = os.path.join(PORT_ROOT, folder, "" if folder.startswith(
        "templates") else "hparams", yaml)
    with open(path, encoding="utf-8") as f:
        batch = int(re.search(r"^batch_size: (\d+)", f.read(), re.M)[1])
    corpus = dict(train=batch, valid=batch,
                  seconds=ENHANCEMENT_TWIN_SECONDS)
    brain, hparams, line = _enhancement_train(
        folder, yaml, out_dir, corpus, 1, device, masker=masker)
    work = os.path.dirname(hparams["data_folder"])
    del brain, hparams
    gc.collect()
    shutil.rmtree(work, ignore_errors=True)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return line


def run_enhancement_path(out_dir, device="cuda"):
    """The spectral-mask and waveform-map chains
    (:func:`run_enhancement_main`), the ISTFT round trips, then every other
    enhancement twin YAML and the spectral-mask twin's other maskers, one
    step each. No kernel of the port is on this path: returns each
    kernel's launches over it (all 0)."""
    t0 = time.perf_counter()
    lines = run_enhancement_main(out_dir, device)
    launches = {name: 0 for name in KERNELS}
    for label, line in lines.items():
        emit({"phase": f"enhancement_path/{label}", **line})
        if not line["ok"]:
            raise AssertionError(f"enhancement_path: the {label} chain "
                                 "failed")
        for k, v in line["launches"].items():
            launches[k] += v
    istft = run_istft_round_trips(device)
    emit({"phase": "enhancement_path/istft_round_trip", **istft})
    if not istft["ok"]:
        raise AssertionError("enhancement_path: ISTFT does not invert STFT")
    readings = {
        "served_audio_s_per_s": {label: line["serve"]["audio_s_per_s"]
                                 for label, line in lines.items()},
        "enhance_batch_ms": {label: line["serve"]["enhance_batch_ms"]
                             for label, line in lines.items()},
        "second_step_ms": {label: line["second_step_ms"]
                           for label, line in lines.items()},
        "twins": {}}
    for key in ("served_audio_s_per_s", "enhance_batch_ms",
                "second_step_ms"):
        emit({"phase": "enhancement_reading", key: readings[key]})
    twins = [(folder, yaml, None) for folder, yaml in ENHANCEMENT_TWINS]
    twins += [(ENHANCEMENT_MAIN[0], ENHANCEMENT_MAIN[1], masker)
              for masker in ENHANCEMENT_MASKERS]
    for folder, yaml, masker in twins:
        line = run_enhancement_twin(folder, yaml, out_dir, device, masker)
        emit({"phase": f"enhancement_path/{line['yaml']}", **line})
        for k, v in line["launches"].items():
            launches[k] += v
        readings["twins"][line["yaml"]] = {"step_ms": line["step_ms"][0],
                                           "peak_gb": line["peak_gb"]}
        if not line["ok"]:
            raise AssertionError(f"enhancement_path: {line['yaml']} failed")
    emit({"phase": "enhancement_path_summary", "readings": readings,
          "launches": launches, "reduced": ENHANCEMENT_REDUCED,
          "seconds": time.perf_counter() - t0,
          "gpu_name_power_limit": gpu_name_power_limit()})
    return launches


# -- gan_path: GAN training and the GAN twins ---------------------------------

# the VoiceBank MetricGAN+ twin (a 2-layer BLSTM of 200, DNN 300, n_fft
# 512; a discriminator of four 15-channel 5 x 5 convolutions): alternating
# D/G steps with the host STOI target, a checkpoint, the generator served
GAN_MAIN = ("recipes/VoiceBank/enhance/MetricGAN", "train.yaml")
# SEGAN at the YAML's width: channels 16 ... 128, kernel 32, batch 8 of
# 16384 samples
GAN_SEGAN = ("recipes/VoiceBank/enhance/SEGAN", "train.yaml")
# the MTL chain: the perceptual CRDNN pre-trained on clean speech with B3
# on every batch, then the robust ASR stage with the unfused Fbank
GAN_MTL = "recipes/VoiceBank/MTL/ASR_enhance"
# every other GAN twin YAML, one step each at its full width (the DNSMOS
# YAML with the port's SRMR as the local stand-in its comment names)
GAN_TWINS = (
    ("recipes/VoiceBank/enhance/MetricGAN-U", "train.yaml", {}),
    ("recipes/VoiceBank/enhance/MetricGAN-U", "train_dnsmos.yaml",
     {"dnsmos_fn": "!name:speechbrain_tpu_torch.processing.srmr.srmr_batch"}),
    ("recipes/VoiceBank/dereverb/MetricGAN-U", "train_dereverb.yaml", {}),
    ("recipes/VoiceBank/enhancement", "train.yaml", {}),
    ("recipes/VoiceBank/MTL/ASR_enhance", "enhance_mimic.yaml", {}),
    ("recipes/RescueSpeech/ASR/noise-robust", "train.yaml", {}),
)
# D/G steps (batches of the YAML's 4) of MetricGAN+, of SEGAN (batches of
# 8), of each MTL stage; utterances of 4 s at 16 kHz (SEGAN's 1.1 s hold a
# segment of 16384 samples); one valid batch for the MTL stages
GAN_STEPS = 3
GAN_SEGAN_STEPS = 2
GAN_MTL_STEPS = 2
GAN_SECONDS = 4.0
GAN_SEGAN_SECONDS = 1.1
# served: 4 noisy utterances of 4 s, float32
GAN_SERVE = dict(batch=4, seconds=4.0, repeats=5)
# B3 at the MTL pre-training's 40 mels: the 4 s batch as the loader pads
# it (to a multiple of 2048 samples) and unpadded
GAN_B3_SHAPES = ((4, 65536, 40), (4, 64000, 40))
GAN_REDUCED = {
    "weights": "random, from each YAML's seed",
    "epochs": "400-600 (GAN), 20-30 (MTL, RescueSpeech) -> 3 D/G steps "
              "(MetricGAN+), 2 (SEGAN, each MTL stage), 1 (every other "
              "twin), one valid batch for the Brain.fit twins",
    "corpus": "synthetic vibrato tones in white noise at 16 kHz, 4 s "
              "(SEGAN: 1.1 s, one 16384-sample segment each), transcripts "
              "of two words for the ASR twins",
}
# width overrides given to every GAN YAML that names the key: none on the
# card (full width); the CPU test shrinks widths with them
GAN_WIDTHS = {}
GAN_WORDS = ("clean", "speech", "now", "rescue", "help", "over")


def write_gan_corpus(folder, n_train, n_valid, seconds, seed=0):
    """:func:`write_enhancement_corpus`'s pairs, each manifest item with a
    transcript of two words (``words``) for the ASR twins."""
    paths = write_enhancement_corpus(folder, n_train, n_valid, seconds,
                                     ENHANCE_SR, seed=seed)
    for path in paths.values():
        with open(path) as f:
            items = json.load(f)
        for i, item in enumerate(items.values()):
            item["words"] = " ".join(GAN_WORDS[(i + j) % len(GAN_WORDS)]
                                     for j in range(2))
        with open(path, "w") as f:
            json.dump(items, f)
    return paths


def gan_yaml(folder, yaml, data, out, device, overrides=None):
    """A GAN or MTL twin's YAML with ``GAN_WIDTHS`` (the top-level keys it
    names), one epoch, its data and output folders, ``device`` and
    ``overrides``: the hparams."""
    from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml

    yaml_dir = os.path.join(PORT_ROOT, folder, "hparams")
    with open(os.path.join(yaml_dir, yaml), encoding="utf-8") as f:
        text = f.read()
    names = {line.split(":")[0] for line in text.splitlines() if ":" in line}
    over = {k: v for k, v in GAN_WIDTHS.items() if k in names}
    over.update(
        data_folder=data, output_folder=out, number_of_epochs=1,
        device=device, train_annotation=os.path.join(data, "train.json"),
        valid_annotation=os.path.join(data, "valid.json"), **(overrides or {}))
    return load_hyperpyyaml(text, over, base_dir=yaml_dir)


class TimedGanSteps:
    """Readings for a GAN twin's Brain (put before the Brain in the
    bases): each D and G step's time by CUDA events, and the host time of
    each call of the twin module's ``stoi_loss`` and ``srmr_batch``."""

    def make_gan_steps(self, *args):
        self.step_events = {"d": [], "g": []}
        d_step, g_step = super().make_gan_steps(*args)
        return self._timed(d_step, "d"), self._timed(g_step, "g")

    def _timed(self, step, key):
        def timed(batch, generator=None):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = step(batch, generator)
            end.record()
            self.step_events[key].append((start, end))
            return loss
        return timed

    def step_ms(self, key):
        return [s.elapsed_time(e) for s, e in self.step_events[key]]


@contextlib.contextmanager
def host_timed(module, name, readings):
    """``module.<name>`` wrapped to append each call's host seconds (its
    result read on the host) to ``readings``."""
    fn = getattr(module, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        readings.append(time.perf_counter() - t0)
        return out

    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, fn)


def _gan_run_opts(device, steps):
    return {"device": device, "noprogressbar": True, "debug": True,
            "debug_batches": steps, "debug_epochs": 1}


def _gan_train(folder, yaml, out_dir, n_train, n_valid, seconds, steps,
               device, overrides=None, brain_cls=None):
    """``steps`` batches of a GAN or MTL twin's ``run`` from its YAML on a
    :func:`write_gan_corpus` corpus: ``(brain, hparams, counts, seconds,
    peak)``, the launch counts set to 0 just before the run and read just
    after it."""
    name = "_".join(folder.split("/")[-2:] + [yaml[:-5]])
    work = os.path.join(out_dir, name)
    data = os.path.join(work, "data")
    write_gan_corpus(data, n_train, n_valid, seconds)
    hparams = gan_yaml(folder, yaml, data, os.path.join(work, "out"), device,
                       overrides)
    run_fn = _enhancement_module(folder).run
    brain_cls = brain_cls or _default_brain(run_fn)
    brain, counts, secs, peak = _timed_run(
        lambda: run_fn(hparams, _gan_run_opts(device, steps),
                       brain_cls=brain_cls), device)
    return brain, hparams, counts, secs, peak


def _group_state(brain, key):
    """Copies of a group's parameters, buffers and optimizer state."""
    module = brain.modules[key]
    opt = brain.optimizers_dict[key]
    return ([t.detach().clone() for t in module.state_dict().values()]
            + [v.clone() for s in opt.state.values() for v in s.values()
               if torch.is_tensor(v)])


def _unchanged(before, after):
    return len(before) == len(after) and all(
        torch.equal(a, b) for a, b in zip(before, after))


def check_gan_step_semantics(brain, noisy, clean):
    """After a G step the discriminator's parameters, optimizer state and
    BatchNorm buffers are bit for bit what they were, and after a D step
    the generator's; each step moves its own group."""
    brain.modules.train()
    noisy_mag, clean_mag = brain.spec_mag(noisy), brain.spec_mag(clean)
    est_mag, _ = brain.enhanced(noisy, noisy_mag)
    target = torch.full((len(noisy),), 0.5, device=noisy.device)
    d0, g0 = _group_state(brain, "discriminator"), _group_state(brain,
                                                                "generator")
    brain.g_step((noisy_mag, clean_mag))
    d1, g1 = _group_state(brain, "discriminator"), _group_state(brain,
                                                                "generator")
    brain.d_step((est_mag, clean_mag, target))
    d2, g2 = _group_state(brain, "discriminator"), _group_state(brain,
                                                                "generator")
    out = {"g_step_leaves_discriminator": _unchanged(d0, d1),
           "g_step_moves_generator": not _unchanged(g0, g1),
           "d_step_leaves_generator": _unchanged(g1, g2),
           "d_step_moves_discriminator": not _unchanged(d1, d2),
           "discriminator_tensors": len(d0), "generator_tensors": len(g0)}
    out["ok"] = all(v for k, v in out.items() if not k.endswith("tensors"))
    return out


def run_metricgan_main(out_dir, device="cuda"):
    """MetricGAN+ at the YAML's width: ``GAN_STEPS`` alternating D/G
    steps (fp32) with the host STOI target on batches of 4 utterances of
    4 s, a checkpoint; the generator restored from it into a model built
    anew from the YAML and served through
    ``SpectralMaskEnhancement.enhance_batch`` on 4 utterances of 4 s
    (median ms, audio seconds a second), bit for bit the same arithmetic
    on the trained module; the step semantics checked on the card."""
    module = _enhancement_module(GAN_MAIN[0])
    brain_cls = type("TimedMetricGanBrain",
                     (TimedGanSteps, module.MetricGanBrain), {})
    stoi_s = []
    with host_timed(module, "stoi_loss", stoi_s):
        brain, hparams, counts, secs, peak = _gan_train(
            *GAN_MAIN, out_dir, 4 * GAN_STEPS, 4, GAN_SECONDS, GAN_STEPS,
            device, brain_cls=brain_cls)
    d_ms, g_ms = brain.step_ms("d"), brain.step_ms("g")
    generator = brain.modules.generator.eval()
    ckpts = brain.checkpointer.list_checkpoints()
    fresh = gan_yaml(*GAN_MAIN, hparams["data_folder"],
                     hparams["output_folder"] + "_fresh", device)
    served_model = fresh["modules"]["generator"]
    saved = torch.load(ckpts[0].paramfiles["modules"], map_location=device,
                       weights_only=True)
    served_model.load_state_dict({k[len("generator."):]: v
                                  for k, v in saved.items()
                                  if k.startswith("generator.")})
    restored = all(torch.equal(a, b) for a, b in zip(
        served_model.state_dict().values(), generator.state_dict().values()))
    stft, istft = hparams["compute_stft"], hparams["compute_istft"]
    enhancer = SpectralMaskEnhancement(
        modules={"enhance_model": served_model},
        hparams={"compute_stft": stft, "compute_istft": istft},
        run_opts={"device": device})
    noisy, clean = enhancement_batch(device, GAN_SERVE)
    reset_launch_counts()
    with torch.no_grad():
        served = enhancer.enhance_batch(noisy)
        # the interface serves weights that require no grad, which moves
        # a 3-D Linear onto another cuBLAS path (1.8e-7 apart on an H100,
        # tools/served_generator_bitwise.py): the trained module is run so
        # too
        generator.requires_grad_(False)
        composed = _spectral_enhance(generator, stft, istft, noisy)
        generator.requires_grad_(True)
    _sync(device)
    serve_launches = launch_counts()
    ms, all_ms, _ = _elapsed_ms(lambda: enhancer.enhance_batch(noisy),
                                GAN_SERVE["repeats"], device)
    semantics = check_gan_step_semantics(brain, noisy, clean)
    line = {"yaml": "/".join(GAN_MAIN), "seconds": secs,
            "peak_gb": peak / 1e9, "launches": counts,
            "d_step_ms": d_ms, "g_step_ms": g_ms,
            "stoi_ms": [1e3 * s for s in stoi_s],
            "checkpoints": len(ckpts), "restored_bitwise": restored,
            "parameters": {k: sum(p.numel() for p in m.parameters())
                           for k, m in brain.modules.items()},
            "serve": {"enhance_batch_ms": ms, "enhance_batch_ms_all": all_ms,
                      "audio_s_per_s": noisy.numel() / ENHANCE_SR
                      / (ms / 1e3),
                      "out_shape": list(served.shape),
                      "served_equals_trained": bool(torch.equal(served,
                                                                composed)),
                      "launches": serve_launches},
            "step_semantics": semantics,
            "feature_mismatch": "C49: trained on sqrt(|STFT|^2 + 1e-8), "
                                "served on log1p(sqrt(|STFT|^2 + 1e-14))"}
    with open(os.path.join(hparams["output_folder"], "train_log.txt")) as f:
        line["train_log"] = f.read().strip().splitlines()
    line["ok"] = bool(
        len(line["d_step_ms"]) == len(line["g_step_ms"]) == GAN_STEPS
        and len(stoi_s) == GAN_STEPS and len(ckpts) == 1 and restored
        and line["serve"]["served_equals_trained"]
        and tuple(served.shape) == tuple(noisy.shape)
        and bool(torch.isfinite(served).all()) and semantics["ok"]
        and all(v == 0 for v in counts.values())
        and all(v == 0 for v in serve_launches.values()))
    return line


def run_segan(out_dir, device="cuda"):
    """SEGAN at the YAML's width: ``GAN_SEGAN_STEPS`` D/G steps on
    batches of 8 segments of 16384 samples."""
    module = _enhancement_module(GAN_SEGAN[0])
    brain_cls = type("TimedSeganBrain", (TimedGanSteps, module.SeganBrain),
                     {})
    brain, hparams, counts, secs, peak = _gan_train(
        *GAN_SEGAN, out_dir, 8 * GAN_SEGAN_STEPS, 8, GAN_SEGAN_SECONDS,
        GAN_SEGAN_STEPS, device,
        brain_cls=brain_cls)
    line = {"yaml": "/".join(GAN_SEGAN), "seconds": secs,
            "peak_gb": peak / 1e9, "launches": counts,
            "d_step_ms": brain.step_ms("d"), "g_step_ms": brain.step_ms("g"),
            "parameters": {k: sum(p.numel() for p in m.parameters())
                           for k, m in brain.modules.items()},
            "parameters_finite": all(bool(torch.isfinite(p).all())
                                     for p in brain.modules.parameters())}
    line["ok"] = bool(len(line["d_step_ms"]) == GAN_SEGAN_STEPS
                      and line["parameters_finite"]
                      and all(v == 0 for v in counts.values()))
    return line


def _timed_mtl_brain(module):
    return type("Timed" + module.__name__.split(".")[-2], (
        TimedSteps, _default_brain(module.run)),
        {"SIGNAL_KEY": "noisy_sig", "SIGNAL_RATE": ENHANCE_SR})


def run_mtl_chain(out_dir, device="cuda"):
    """The MTL chain: ``pretrain_perceptual.yaml`` (the fused Fbank, B3,
    on every train and valid batch: its launches equal the batches run)
    then ``robust_asr.yaml`` (the unfused Fbank: no launch), each
    ``GAN_MTL_STEPS`` steps and one valid batch of 4 utterances of 4 s;
    then the fused Fbank handed to ``robust_asr``'s training step, which
    B3's wrapper refuses (the enhanced waveform requires grad)."""
    module = _enhancement_module(GAN_MTL)
    lines = {}
    for yaml in ("pretrain_perceptual.yaml", "robust_asr.yaml"):
        brain, hparams, counts, secs, peak = _gan_train(
            GAN_MTL, yaml, out_dir, 4 * GAN_MTL_STEPS, 4, GAN_SECONDS,
            GAN_MTL_STEPS, device, brain_cls=_timed_mtl_brain(module))
        batches = brain.forwards[Stage.TRAIN] + brain.forwards[Stage.VALID]
        fused = hparams["compute_features"].fused
        line = {"yaml": f"{GAN_MTL}/{yaml}", "seconds": secs,
                "peak_gb": peak / 1e9, "launches": counts,
                "fused_fbank": fused,
                "forwards": {s.name: c for s, c in brain.forwards.items()},
                "step_ms": brain.step_ms(), "losses": brain.losses,
                "valid_losses": brain.valid_losses}
        line["ok"] = bool(
            brain.forwards[Stage.TRAIN] == GAN_MTL_STEPS
            and brain.forwards[Stage.VALID] == min(
                GAN_MTL_STEPS, -(-4 // hparams["batch_size"]))
            and counts["fused_fbank"] == (batches if fused else 0)
            and all(v == 0 for k, v in counts.items() if k != "fused_fbank")
            and all(np.isfinite(brain.losses + brain.valid_losses)))
        lines[yaml] = line
    # robust_asr's step with the fused Fbank: the wrapper raises
    hparams["compute_features"] = Fbank(n_mels=hparams["n_mels"], fused=True,
                                        device=device)
    brain.hparams.compute_features = hparams["compute_features"]
    brain.modules.train()
    loader = brain.make_dataloader(
        module.dataio_prepare(hparams)["train"], Stage.TRAIN,
        ckpt_prefix=None, batch_size=hparams["batch_size"],
        pad_to_multiple=module.PAD_TO_MULTIPLE)
    reset_launch_counts()
    try:
        brain.fit_batch(next(iter(loader)))
        raised = None
    except ValueError as e:
        raised = str(e)
    refusal = {"raised": raised is not None
               and "fused_fbank_reference" in raised,
               "message": raised,
               "b3_launches": launch_counts()["fused_fbank"]}
    refusal["ok"] = bool(refusal["raised"] and refusal["b3_launches"] == 0)
    lines["robust_asr_with_fused_fbank"] = refusal
    return lines


def run_gan_twin(folder, yaml, overrides, out_dir, device="cuda"):
    """One step of a GAN or MTL twin at its YAML's width (and, for a
    ``Brain.fit`` twin, one valid batch), on one YAML batch of 4 s
    utterances; the twin's folder is removed after."""
    with open(os.path.join(PORT_ROOT, folder, "hparams", yaml)) as f:
        batch = int(re.search(r"^batch_size: (\d+)", f.read(), re.M)[1])
    brain, hparams, counts, secs, peak = _gan_train(
        folder, yaml, out_dir, batch, batch, GAN_SECONDS, 1, device,
        overrides)
    line = {"yaml": f"{folder}/{yaml}", "seconds": secs,
            "peak_gb": peak / 1e9, "launches": counts,
            "parameters": sum(p.numel() for p in brain.modules.parameters()),
            "parameters_finite": all(bool(torch.isfinite(p).all())
                                     for p in brain.modules.parameters())}
    with open(os.path.join(hparams["output_folder"], "train_log.txt")) as f:
        line["train_log"] = f.read().strip().splitlines()
    line["ok"] = bool(line["parameters_finite"] and line["train_log"]
                      and all(v == 0 for v in counts.values()))
    work = os.path.dirname(hparams["data_folder"])
    del brain, hparams
    gc.collect()
    shutil.rmtree(work, ignore_errors=True)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return line


def run_gan_path(out_dir, device="cuda"):
    """B3 against its plain version at the MTL pre-training's shapes;
    MetricGAN+ trained, checkpointed and served
    (:func:`run_metricgan_main`); SEGAN; the MTL chain
    (:func:`run_mtl_chain`); every other GAN twin one step. Returns each
    kernel's launches over the path and B3's errors."""
    t0 = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    b3 = check_b3_at_shapes(GAN_B3_SHAPES, device)
    emit({"phase": "gan_b3_check", "max_abs_err_db": b3, "atol": B3_ATOL,
          "ok": max(b3.values()) <= B3_ATOL})
    if max(b3.values()) > B3_ATOL:
        raise AssertionError(f"gan_path: B3 against its plain version {b3}")
    launches = {name: 0 for name in KERNELS}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    main = run_metricgan_main(out_dir, device)
    emit({"phase": "gan_path/metricgan", **main})
    add(main["launches"])
    if not main["ok"]:
        raise AssertionError("gan_path: MetricGAN+ failed")
    segan = run_segan(out_dir, device)
    emit({"phase": "gan_path/segan", **segan})
    add(segan["launches"])
    if not segan["ok"]:
        raise AssertionError("gan_path: SEGAN failed")
    mtl = run_mtl_chain(out_dir, device)
    for label, line in mtl.items():
        emit({"phase": f"gan_path/mtl/{label}", **line})
        add(line.get("launches", {}))
        if not line["ok"]:
            raise AssertionError(f"gan_path: MTL {label} failed")
    pretrain = mtl["pretrain_perceptual.yaml"]
    b3_launches = {"pretrain_perceptual": pretrain["launches"]["fused_fbank"],
                   "robust_asr": mtl["robust_asr.yaml"]["launches"][
                       "fused_fbank"]}
    readings = {"d_step_ms": main["d_step_ms"],
                "g_step_ms": main["g_step_ms"], "stoi_ms": main["stoi_ms"],
                "served_audio_s_per_s": main["serve"]["audio_s_per_s"],
                "enhance_batch_ms": main["serve"]["enhance_batch_ms"],
                "segan_d_step_ms": segan["d_step_ms"],
                "segan_g_step_ms": segan["g_step_ms"],
                "mtl_step_ms": {k: v["step_ms"] for k, v in mtl.items()
                                if "step_ms" in v},
                "b3_launches": b3_launches, "twins": {}}
    for folder, yaml, overrides in GAN_TWINS:
        line = run_gan_twin(folder, yaml, overrides, out_dir, device)
        emit({"phase": f"gan_path/{line['yaml']}", **line})
        add(line["launches"])
        readings["twins"][line["yaml"]] = {"seconds": line["seconds"],
                                           "peak_gb": line["peak_gb"]}
        if not line["ok"]:
            raise AssertionError(f"gan_path: {line['yaml']} failed")
    emit({"phase": "gan_path_summary", "readings": readings,
          "launches": launches, "reduced": GAN_REDUCED,
          "seconds": time.perf_counter() - t0,
          "gpu_name_power_limit": gpu_name_power_limit()})
    return launches, b3_launches, b3


# -- frame_path: VAD, speaker and emotion diarization ----------------------

FRAME_VAD = "recipes/LibriParty/VAD"
FRAME_ZED = "recipes/ZaionEmotionDataset/emotion_diarization"
FRAME_AMI = "recipes/AMI/Diarization"
FRAME_AMI_YAMLS = ("ecapa.yaml", "xvectors.yaml")
# the VAD twin's corpus: its prepare_synthetic's tone bursts, 64 train and
# 2 valid parties of 2 s; epochs of 16 float32 Adam steps at batch 4
FRAME_VAD_UTTS = 66
FRAME_VAD_EPOCHS = 8
# the ZED twin: its own corpus (6 train and 2 valid utterances of 2 s),
# one epoch of 2 steps at batch 4
FRAME_ZED_EPOCHS = 1
# the served meeting: two "speakers" as tones of two pitches in turns of
# 1-4 s separated by 0.5-1.5 s of the noise floor; the first turn starts
# after a gap
FRAME_MEETING = dict(seconds=300.0, turn_s=(1.0, 4.0), gap_s=(0.5, 1.5),
                     freqs=(220.0, 660.0), amplitude=0.5, noise=0.01,
                     seed=5)
# the emotion file: a 220 Hz tone, its emotional intervals modulated as
# the ZED twin's corpus modulates them (2 + 3 emo Hz), 1.5-4 s each after
# 1-3 s of neutral
FRAME_ZED_FILE = dict(seconds=60.0, emo_s=(1.5, 4.0), neutral_s=(1.0, 3.0),
                      seed=6)
# the ZED twin's emotion ids as EDER's labels ("n" is EDER's neutral)
FRAME_EMOTION_LABELS = {0: "n", 1: "h", 2: "s", 3: "a"}
# B3 where this path runs it: the VAD's 30 chunks of 10 s at 40 mels, and
# one 1.5 s window at 80 mels (the AMI window; a diarizer segment or a
# double-checked one is a batch of one of its own length)
FRAME_B3_SHAPES = ((30, 160000, 40), (1, 24000, 80))
# float32 posteriors through B3 against the same model on the unfused
# Fbank: B3 is within 5e-3 dB of its plain version (B3_ATOL), and the two
# float32 Fbanks differ by about as much (ROADMAP C15); a 5e-3 dB move of
# a 40-mel frame moves a sigmoid posterior by far less than this
FRAME_PROB_ATOL = 1e-3
# the served VAD's thresholded frames that agree with the meeting's truth
FRAME_ACCURACY = 0.9
FRAME_REDUCED = {
    "weights": "random ECAPA and x-vector embedders from each AMI YAML's "
               "seed; the VAD and ZED CRDNNs trained from their YAMLs' "
               "seed",
    "corpus": "synthetic tones: tone-burst parties (VAD), modulated "
              "tones (ZED), a 300 s two-tone meeting and a 60 s emotion "
              "file made with numpy from a seed",
    "epochs": "20 -> 8 epochs of 16 steps (VAD), 1 epoch of 2 steps "
              "(ZED)",
}
# text edits of every frame-level twin YAML: none on the card (full
# width); the CPU test shrinks the models with them
FRAME_YAML_EDITS = []


def frame_yaml_text(folder, yaml):
    """A frame-level twin's YAML after ``FRAME_YAML_EDITS``."""
    with open(os.path.join(PORT_ROOT, folder, "hparams", yaml),
              encoding="utf-8") as f:
        text = f.read()
    for old, new in FRAME_YAML_EDITS:
        text = text.replace(old, new)
    return text


def frame_yaml(folder, yaml, overrides):
    """:func:`frame_yaml_text` and the objects it builds with
    ``overrides``: ``(text, hparams)``."""
    from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml

    text = frame_yaml_text(folder, yaml)
    return text, load_hyperpyyaml(text, overrides)


def write_meeting(path, cfg, sr=SR):
    """``cfg``'s meeting as a WAV file; returns its turns ``[(start_s,
    end_s, "A" or "B")]``, the speakers alternating."""
    rng = np.random.default_rng(cfg["seed"])
    T = int(cfg["seconds"] * sr)
    t = np.arange(T) / sr
    sig = rng.normal(0, cfg["noise"], T).astype(np.float32)
    turns, pos = [], float(rng.uniform(*cfg["gap_s"]))
    while True:
        dur = float(rng.uniform(*cfg["turn_s"]))
        if pos + dur > cfg["seconds"]:
            break
        k = len(turns) % 2
        seg = (t >= pos) & (t < pos + dur)
        sig[seg] += (cfg["amplitude"] * np.sin(
            2 * np.pi * cfg["freqs"][k] * t[seg])).astype(np.float32)
        turns.append((pos, pos + dur, "AB"[k]))
        pos += dur + float(rng.uniform(*cfg["gap_s"]))
    write_audio(path, sig, sr)
    return turns


def write_emotion_file(path, cfg, sr=SR):
    """``cfg``'s emotion file as a WAV file; returns its emotional
    intervals as EDER's ``[{"start", "end", "emo"}]``."""
    rng = np.random.default_rng(cfg["seed"])
    T = int(cfg["seconds"] * sr)
    t = np.arange(T) / sr
    sig = 0.4 * np.sin(2 * np.pi * 220 * t).astype(np.float32)
    intervals, pos = [], float(rng.uniform(*cfg["neutral_s"]))
    while True:
        dur = float(rng.uniform(*cfg["emo_s"]))
        if pos + dur > cfg["seconds"]:
            break
        emo = 1 + len(intervals) % 3
        seg = (t >= pos) & (t < pos + dur)
        sig[seg] *= (1 + 0.9 * np.sin(2 * np.pi * (2 + 3 * emo) * t[seg])
                     ).astype(np.float32)
        intervals.append({"start": pos, "end": pos + dur,
                          "emo": FRAME_EMOTION_LABELS[emo]})
        pos += dur + float(rng.uniform(*cfg["neutral_s"]))
    write_audio(path, sig, sr)
    return intervals


def _stats(values):
    values = np.asarray(values, np.float64)
    if not len(values):
        return None
    return {"median": float(np.median(values)), "mean": float(values.mean()),
            "max": float(values.max())}


def boundary_errors(boundaries, turns, res=0.01, last_from=None):
    """Each true turn against the detected segment that overlaps it most:
    the start and end differences in frames of ``res`` seconds (their
    median, mean and max), over every turn and over the turns that start
    at or after ``last_from`` (the last chunk's); turns no segment
    overlaps are missed, segments that overlap no turn are extra."""
    segs = np.asarray(boundaries, np.float64).reshape(-1, 2)
    out = {"turns": len(turns), "segments": len(segs)}
    errs, last, used = {"start": [], "end": []}, {"start": [], "end": []}, \
        set()
    for s, e, _ in turns:
        overlap = np.minimum(segs[:, 1], e) - np.maximum(segs[:, 0], s)
        if not len(segs) or overlap.max() <= 0:
            continue
        i = int(overlap.argmax())
        used.add(i)
        for key, err in (("start", abs(segs[i, 0] - s) / res),
                         ("end", abs(segs[i, 1] - e) / res)):
            errs[key].append(err)
            if last_from is not None and s >= last_from:
                last[key].append(err)
    out["matched"] = len(errs["start"])
    out["missed"] = len(turns) - out["matched"]
    out["extra"] = sum(
        1 for i, (s, e) in enumerate(segs) if i not in used and not any(
            min(e, te) > max(s, ts) for ts, te, _ in turns))
    out["start_err_frames"] = _stats(errs["start"])
    out["end_err_frames"] = _stats(errs["end"])
    if last_from is not None:
        out["last_chunk"] = {"from_s": last_from,
                             "turns": len(last["start"]),
                             "start_err_frames": _stats(last["start"]),
                             "end_err_frames": _stats(last["end"])}
    return out


def truth_frames(turns, n_frames, res=0.01):
    """Speech (True) at each frame whose centre lies in a turn."""
    centers = (np.arange(n_frames) + 0.5) * res
    inside = np.zeros(n_frames, bool)
    for s, e, _ in turns:
        inside |= (centers >= s) & (centers < e)
    return inside


def _host_ms(fn, device):
    """``fn()`` and its milliseconds on the host's clock, the device
    synchronized before and after."""
    _sync(device)
    t0 = time.perf_counter()
    result = fn()
    _sync(device)
    return result, 1e3 * (time.perf_counter() - t0)


def _same_partition(a, b):
    """Whether two label lists are equal up to a permutation of labels."""
    return (len(a) == len(b)
            and len(set(zip(a, b))) == len(set(a)) == len(set(b)))


def _candidates(vad, prob):
    """The segments ``get_speech_segments`` double-checks for the
    posteriors ``prob`` (its default thresholds)."""
    return vad.remove_short_segments(vad.merge_close_segments(
        vad.get_boundaries(vad.apply_threshold(prob))))


def run_frame_vad(out_dir, device="cuda"):
    """The LibriParty VAD twin trained from its YAML (float32, Adam,
    ``FRAME_VAD_EPOCHS`` epochs on ``FRAME_VAD_UTTS`` parties, the unfused
    Fbank), its best checkpoint exported and served through
    ``VAD.from_hparams`` (B3 at 40 mels) on the 300 s meeting:
    ``get_speech_segments`` in both modes, each stage timed, the boundary
    errors against the turns (JAX's layout of the posteriors too, C51),
    the posteriors and boundaries held against the same model on the
    unfused Fbank. B3: one launch for a file's chunks, one a
    double-checked segment. Returns ``(line, vad, audio, boundaries,
    turns, wav)``."""
    data = os.path.join(out_dir, "vad_data")
    vad_prepare.prepare_synthetic(data, n_utts=FRAME_VAD_UTTS)
    overrides = {"data_folder": data, "device": device,
                 "output_folder": os.path.join(out_dir, "vad_out"),
                 "number_of_epochs": FRAME_VAD_EPOCHS}
    text, hparams = frame_yaml(FRAME_VAD, "train.yaml", overrides)
    brain_cls = type("TimedVADBrain", (TimedSteps, vad_recipe.VADBrain),
                     {})
    brain, train_counts, train_s, peak = _timed_run(
        lambda: vad_recipe.run(hparams, {"device": device,
                                         "noprogressbar": True},
                               brain_cls=brain_cls,
                               export_from=(text, overrides)), device)
    step_ms = brain.step_ms()
    train = {"seconds": train_s, "peak_bytes": peak,
             "steps": len(brain.losses), "first_losses": brain.losses[:3],
             "last_losses": brain.losses[-3:],
             "valid_losses": brain.valid_losses,
             "step_ms_median": float(np.median(step_ms)),
             "parameters": sum(p.numel() for p in
                               brain.modules.parameters()),
             "launches": train_counts}
    vad = VAD.from_hparams(source=hparams["pretrained_folder"],
                           savedir=os.path.join(out_dir, "vad_served"),
                           run_opts={"device": device})
    wav = os.path.join(out_dir, "meeting.wav")
    turns = write_meeting(wav, FRAME_MEETING)
    seconds = FRAME_MEETING["seconds"]
    chunk = 10 * SR
    last_from = (-(-int(seconds * SR) // chunk) - 1) * chunk / SR
    _sync(device)
    reset_launch_counts()
    # the entry point, twice: the first call pays the first-use costs
    calls = [_host_ms(lambda: vad.get_speech_segments(wav), device)
             for _ in range(2)]
    boundaries = calls[-1][0]
    # the stages one by one, on the audio read once
    audio, load_ms = _host_ms(lambda: vad.load_audio(wav), device)
    prob, prob_ms = _host_ms(lambda: vad.get_speech_prob_file(audio), device)
    candidates, th_ms = _host_ms(lambda: _candidates(vad, prob), device)
    checked, dc_ms = _host_ms(
        lambda: vad.double_check_speech_segments(candidates, audio), device)
    overlapped, ov_ms = _host_ms(
        lambda: vad.get_speech_segments(audio, overlap_small_chunk=True),
        device)
    ov_candidates = _candidates(vad, vad.get_speech_prob_file(
        audio, overlap_small_chunk=True))
    # JAX's layout of the default mode keeps each chunk's extra frame
    # (C51): the same model's posteriors laid out so, one launch
    padded = torch.nn.functional.pad(audio, (0, -(-len(audio) // chunk)
                                             * chunk - len(audio)))
    jax_layout = vad.get_speech_prob_chunk(padded.reshape(-1, chunk))
    jax_layout = jax_layout.reshape(1, -1, 1)[:, : prob.shape[1]]
    _sync(device)
    counts = launch_counts()
    # 2 + 1 calls of the default mode, 1 + 1 of the overlapped one, and
    # the JAX layout
    predicted = (3 * (1 + len(candidates)) + 2 + len(ov_candidates) + 1)
    # the same model on the unfused Fbank: no launch
    plain = VAD(modules={"model": vad.mods.model},
                hparams={**vars(vad.hparams), "compute_features": Fbank(
                    n_mels=vad.hparams.n_mels, fused=False, device=device)},
                run_opts={"device": device})
    plain_prob = plain.get_speech_prob_file(audio)
    plain_boundaries = plain.get_speech_segments(audio)
    prob_err = float((prob - plain_prob).abs().max())
    decisions = vad.apply_threshold(prob)[0, :, 0] > 0
    accuracy = float(np.mean(decisions == truth_frames(turns,
                                                       len(decisions))))
    whole_ms = calls[-1][1]
    line = {
        "train": train,
        "serve": {
            "get_speech_segments_ms": [ms for _, ms in calls],
            "audio_s_per_s": seconds / (whole_ms / 1e3),
            "load_ms": load_ms, "posterior_ms": prob_ms,
            "threshold_ms": th_ms, "double_check_ms": dc_ms,
            "double_checked": len(candidates), "segments": len(boundaries),
            "frame_accuracy": accuracy,
            "boundary_errors": boundary_errors(boundaries, turns,
                                               last_from=last_from)},
        "overlapped": {"ms": ov_ms, "segments": len(overlapped),
                       "boundary_errors": boundary_errors(
                           overlapped, turns, last_from=last_from)},
        "c51_jax_layout": {"boundary_errors": boundary_errors(
            _candidates(vad, jax_layout), turns, last_from=last_from)},
        "vs_unfused": {"posterior_max_abs_err": prob_err,
                       "atol": FRAME_PROB_ATOL,
                       "boundaries_equal": bool(np.array_equal(
                           boundaries, plain_boundaries))},
        "launches": counts, "predicted_b3": predicted,
    }
    line["ok"] = bool(
        train_counts["fused_fbank"] == 0
        and np.isfinite(brain.losses).all()
        and np.mean(train["last_losses"]) < np.mean(train["first_losses"])
        and len(boundaries) > 0 and accuracy >= FRAME_ACCURACY
        and np.array_equal(boundaries, checked)
        and prob_err <= FRAME_PROB_ATOL
        and line["vs_unfused"]["boundaries_equal"]
        and bool(torch.isfinite(prob).all())
        and tuple(prob.shape) == (1, int(seconds * 100), 1)
        and counts["fused_fbank"] == predicted
        and all(v == 0 for k, v in counts.items() if k != "fused_fbank"))
    return line, vad, audio, boundaries, turns, wav


def run_frame_speakers(out_dir, audio, boundaries, turns, device="cuda"):
    """``SpeakerDiarization.diarize_segments`` with the AMI ECAPA YAML's
    embedder (random weights, B3 at 80 mels once a segment) on the VAD's
    segments: clustered to the YAML's oracle 2 speakers, merged, written
    as RTTM and scored by DER against the meeting's turns; the labels
    equal, up to a permutation, those of the unfused Fbank's
    embeddings."""
    _, h = frame_yaml(FRAME_AMI, "ecapa.yaml", {
        "data_folder": out_dir, "device": device,
        "output_folder": os.path.join(out_dir, "diar_out")})
    model = h["embedding_model"]
    diar = SpeakerDiarization(
        modules={"embedding_model": model},
        hparams={"compute_features": h["compute_features"],
                 "sample_rate": h["sample_rate"]},
        run_opts={"device": device})
    segs = [(float(s), float(e)) for s, e in boundaries]
    n = h["oracle_n_speakers"]
    _sync(device)
    reset_launch_counts()
    # first-use costs: the embedder's and the k-means' on the device
    warm = min(len(segs), 4)
    diar.diarize_segments(audio, segs[:warm], n_speakers=min(n, warm))
    merged, diar_ms = _host_ms(
        lambda: diar.diarize_segments(audio, segs, n_speakers=n), device)
    embs, embed_ms = _host_ms(lambda: diar.embed_segments(audio, segs),
                              device)
    counts = launch_counts()
    labels, cluster_ms = _host_ms(
        lambda: do_spec_clustering(embs, n_speakers=n, device=device),
        device)
    plain = SpeakerDiarization(
        modules={"embedding_model": model},
        hparams={"compute_features": Fbank(n_mels=h["n_mels"], fused=False,
                                           device=device),
                 "sample_rate": h["sample_rate"]},
        run_opts={"device": device})
    plain_embs = plain.embed_segments(audio, segs)
    plain_labels = do_spec_clustering(plain_embs, n_speakers=n,
                                      device=device)
    rttm = os.path.join(out_dir, "meeting.rttm")
    write_rttm(merged, "meeting", rttm)
    with open(rttm) as f:
        rttm_lines = len(f.read().splitlines())
    der = DER(list(turns), [(s, e, str(lab)) for s, e, lab in merged])
    rel = float(np.max(np.abs(embs - plain_embs))
                / max(np.max(np.abs(plain_embs)), 1e-12))
    line = {"segments": len(segs), "merged_segments": len(merged),
            "diarize_segments_ms": diar_ms,
            "embed_ms_per_segment": embed_ms / len(segs),
            "spectral_clustering_ms": cluster_ms,
            "der": der, "rttm_lines": rttm_lines,
            "labels": labels, "unfused_labels": plain_labels,
            "labels_equal_unfused_up_to_permutation": _same_partition(
                labels, plain_labels),
            "embedding_max_rel_err_vs_unfused": rel,
            "launches": counts, "predicted_b3": 2 * len(segs) + warm}
    line["ok"] = bool(
        len(segs) > 1 and np.isfinite(embs).all() and 0.0 <= der <= 1.0
        and rttm_lines == len(merged)
        and line["labels_equal_unfused_up_to_permutation"]
        and counts["fused_fbank"] == line["predicted_b3"]
        and all(v == 0 for k, v in counts.items() if k != "fused_fbank"))
    return line


def run_frame_ami(out_dir, turns, wav, device="cuda"):
    """The AMI twin's ``experiment.py`` with each YAML on its own
    synthetic meeting and on the 300 s one: DER, windows, ms a window (the
    embedding loop's host time over its windows), B3 once a window."""
    data = os.path.join(out_dir, "ami_data")
    ami_recipe.prepare_synthetic(data)
    meta = os.path.join(data, "meetings.json")
    with open(meta) as f:
        meetings = json.load(f)
    meetings["meeting300"] = {"wav": wav, "turns": [
        {"start": s, "end": e, "spk": spk} for s, e, spk in turns]}
    with open(meta, "w") as f:
        json.dump(meetings, f, indent=1)
    lines = {}
    for yaml in FRAME_AMI_YAMLS:
        path = os.path.join(out_dir, "ami_" + yaml)
        with open(path, "w") as f:
            f.write(frame_yaml_text(FRAME_AMI, yaml))
        embed_s = []
        with host_timed(ami_recipe, "embed_windows", embed_s):
            results, counts, secs, peak = _timed_run(lambda: ami_recipe.main(
                [path, f"--data_folder={data}",
                 f"--output_folder={os.path.join(out_dir, 'ami_out_' + yaml[:-5])}",
                 f"--device={device}"]), device)
        windows = sum(r["windows"] for r in results.values())
        line = {"seconds": secs, "peak_bytes": peak,
                "der": {k: r["der"] for k, r in results.items()},
                "windows": {k: r["windows"] for k, r in results.items()},
                "ms_per_window": 1e3 * sum(embed_s) / windows,
                "launches": counts, "predicted_b3": windows}
        line["ok"] = bool(
            counts["fused_fbank"] == windows
            and all(0.0 <= r["der"] <= 1.0 for r in results.values())
            and all(v == 0 for k, v in counts.items() if k != "fused_fbank"))
        lines[yaml] = line
    return lines


def run_frame_zed(out_dir, device="cuda"):
    """The ZED twin one epoch (2 float32 steps) from its YAML, its export
    served through ``Speech_Emotion_Diarization.from_hparams`` (B3 at 40
    mels once a window) on the 60 s emotion file: the windows, the last
    one included (C52), and EDER against the file's intervals."""
    data = os.path.join(out_dir, "zed_data")
    zed_prepare.prepare_synthetic(data)
    overrides = {"data_folder": data, "device": device,
                 "output_folder": os.path.join(out_dir, "zed_out"),
                 "number_of_epochs": FRAME_ZED_EPOCHS}
    text, hparams = frame_yaml(FRAME_ZED, "train.yaml", overrides)
    brain_cls = type("TimedZEDBrain",
                     (TimedSteps, zed_recipe.EmoDiarBrain), {})
    brain, train_counts, train_s, _ = _timed_run(
        lambda: zed_recipe.run(hparams, {"device": device,
                                         "noprogressbar": True},
                               brain_cls=brain_cls,
                               export_from=(text, overrides)), device)
    diarizer = Speech_Emotion_Diarization.from_hparams(
        source=hparams["pretrained_folder"],
        savedir=os.path.join(out_dir, "zed_served"),
        run_opts={"device": device})
    wav = os.path.join(out_dir, "emotions.wav")
    reference = write_emotion_file(wav, FRAME_ZED_FILE)
    _sync(device)
    reset_launch_counts()
    diarizer.diarize_file(wav)  # first-use costs
    segments, ms = _host_ms(lambda: diarizer.diarize_file(wav), device)
    counts = launch_counts()
    hyp = [dict(s, emotion=FRAME_EMOTION_LABELS[s["emotion"]])
           for s in segments]
    T = int(FRAME_ZED_FILE["seconds"] * SR)
    win, hop = SR, SR // 2
    expected = (T - win) // hop + 1
    line = {"train_steps": len(brain.losses), "train_losses": brain.losses,
            "valid_losses": brain.valid_losses, "train_seconds": train_s,
            "windows": len(segments), "expected_windows": expected,
            "jax_windows": len(range(0, max(T - win, 1), hop)),
            "last_window_end_s": segments[-1]["end"],
            "eder": EDER(hyp, "emotions", FRAME_ZED_FILE["seconds"],
                         reference),
            "diarize_file_ms": ms, "ms_per_window": ms / len(segments),
            "launches": counts, "predicted_b3": 2 * expected}
    line["ok"] = bool(
        len(segments) == expected
        and segments[-1]["end"] == FRAME_ZED_FILE["seconds"]
        and train_counts["fused_fbank"] == 0
        and np.isfinite(brain.losses).all()
        and counts["fused_fbank"] == line["predicted_b3"]
        and all(v == 0 for k, v in counts.items() if k != "fused_fbank"))
    return line


def run_frame_path(out_dir, device="cuda"):
    """B3 against its plain version at ``FRAME_B3_SHAPES``; the VAD
    trained, exported and served (:func:`run_frame_vad`); speaker
    diarization of its segments (:func:`run_frame_speakers`); the AMI
    twin with both YAMLs (:func:`run_frame_ami`); the ZED twin trained and
    served (:func:`run_frame_zed`). Returns each kernel's launches over
    the path (the counts set to 0 just before each stage and read just
    after it) and B3's errors."""
    t0 = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    b3 = check_b3_at_shapes(FRAME_B3_SHAPES, device)
    emit({"phase": "frame_b3_check", "max_abs_err_db": b3, "atol": B3_ATOL,
          "ok": max(b3.values()) <= B3_ATOL})
    if max(b3.values()) > B3_ATOL:
        raise AssertionError(f"frame_path: B3 against its plain version {b3}")
    launches = {name: 0 for name in KERNELS}
    predicted = 0

    def add(line, label):
        nonlocal predicted
        emit({"phase": f"frame_path/{label}", **line})
        for k, v in line["launches"].items():
            launches[k] += v
        predicted += line["predicted_b3"]
        if not line["ok"]:
            raise AssertionError(f"frame_path: {label} failed")

    vad_line, vad, audio, boundaries, turns, wav = run_frame_vad(
        out_dir, device)
    add(vad_line, "vad")
    add(run_frame_speakers(out_dir, audio, boundaries, turns, device),
        "speaker_diarization")
    for yaml, line in run_frame_ami(out_dir, turns, wav, device).items():
        add(line, f"ami/{yaml}")
    add(run_frame_zed(out_dir, device), "emotion_diarization")
    ok = launches["fused_fbank"] == predicted > 0 and all(
        v == 0 for k, v in launches.items() if k != "fused_fbank")
    emit({"phase": "frame_path_summary", "launches": launches,
          "predicted_b3": predicted, "reduced": FRAME_REDUCED,
          "seconds": time.perf_counter() - t0, "ok": ok,
          "gpu_name_power_limit": gpu_name_power_limit()})
    if not ok:
        raise AssertionError("frame_path: B3's launches are not the "
                             "path's prediction")
    return launches, b3

SSL_W2V = "recipes/LibriSpeech/self-supervised-learning/wav2vec2"
SSL_BRQ = "recipes/LibriSpeech/self-supervised-learning/BEST-RQ"
SSL_CTC = "recipes/LibriSpeech/ASR/CTC"
# every other twin of the slice, one step each from its own --debug corpus:
# (folder, script, yaml)
SSL_TWINS = (
    ("recipes/Libri-Light/self-supervised-learning/wav2vec2", "train",
     "wav2vec2.yaml"),
    ("recipes/Libri-Light/self-supervised-learning/BEST-RQ", "train",
     "bestrq.yaml"),
    ("recipes/CommonVoice/self-supervised-learning/wav2vec2",
     "train_hf_wav2vec2", "train_hf_wav2vec2.yaml"),
    *(("recipes/DVoice/ASR/CTC", "train_with_wav2vec2", f"{name}.yaml")
      for name in ("train_with_wav2vec2", "train_amh_with_wav2vec",
                   "train_dar_with_wav2vec", "train_fon_with_wav2vec",
                   "train_multi_with_wav2vec", "train_sw_with_wav2vec",
                   "train_wol_with_wav2vec")),
)
# the corpus of the full-width runs: train utterances of 15-16 s, padded to
# 16 s (the twins pad to multiples of 0.5 and 1 s), valid ones of 16 s;
# one tone a character, 80 ms each
SSL_CORPUS = dict(seconds=(15.0, 16.0), valid_seconds=16.0, char_s=0.08)
SSL_BATCH = 8
SSL_STEPS = 3
SSL_SERVE_REPEATS = 3
SSL_WORDS = ("self", "supervised", "speech", "wave", "vector", "quantised",
             "target", "masked", "frames", "codebook")
# B3 at BEST-RQ's batches: 8 utterances of 16 s at 80 mels
SSL_B3_SHAPES = ((8, 256000, 80),)
SSL_REDUCED = {
    "weights": "random, from each twin YAML's seed",
    "corpus": "synthetic tones (one a character, 80 ms) with noise 26 dB "
              "down, 15-16 s an utterance, made with numpy from a seed",
    "epochs": "one epoch of 3 steps a run (wav2vec 2.0 and BEST-RQ "
              "pretraining, both fine-tunings); one step of every other "
              "twin",
}
# text edits of every SSL twin YAML: none on the card (full width); the CPU
# test shrinks the models with them
SSL_YAML_EDITS = []


def ssl_yaml(folder, yaml, data, out, device, overrides=None):
    """An SSL twin's YAML after ``SSL_YAML_EDITS``, with one epoch, its data
    and output folders, ``device`` and ``overrides``: the hparams."""
    from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml

    with open(os.path.join(PORT_ROOT, folder, "hparams", yaml),
              encoding="utf-8") as f:
        text = f.read()
    for old, new in SSL_YAML_EDITS:
        text = text.replace(old, new)
    over = {"output_folder": out, "number_of_epochs": 1, "device": device}
    if data is not None:
        over.update(data_folder=data,
                    train_annotation=os.path.join(data, "train.json"),
                    valid_annotation=os.path.join(data, "valid.json"))
    over.update(overrides or {})
    return load_hyperpyyaml(text, over)


def _ssl_module(folder, script):
    return importlib.import_module(
        "speechbrain_tpu_torch." + folder.replace("/", ".") + "." + script)


def write_ssl_corpus(folder, n_train, n_valid, cfg=None, seed=0):
    """Speech-like utterances with transcripts: the words of ``SSL_WORDS``
    in turn (the valid split's from those the train split used), one tone a
    character (``char_s`` each, silence for a space) over noise 26 dB down,
    ``train.json`` and ``valid.json`` with ``wav``, ``length`` and
    ``words``."""
    cfg = cfg or SSL_CORPUS
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    seg = int(SR * cfg["char_s"])
    # the valid split takes its words in turn from those the train split
    # used, so that the character encoder made from it knows them all
    pool = SSL_WORDS
    for split, n in (("train", n_train), ("valid", n_valid)):
        manifest, used, word = {}, [], 0
        for i in range(n):
            secs = (cfg["valid_seconds"] if split == "valid"
                    else float(rng.uniform(*cfg["seconds"])))
            T = int(SR * secs)
            words = []
            while not words or (len(" ".join(words)) + 12) * seg < T:
                words.append(pool[word % len(pool)])
                word += 1
            used += [w for w in words if w not in used]
            text = " ".join(words)
            freq = np.repeat([0.0 if c == " " else 150.0 + 40.0 * (ord(c) % 26)
                              for c in text], seg)
            freq = np.pad(freq, (0, T - len(freq)))
            wav = (0.3 * np.sin(2 * np.pi * np.cumsum(freq) / SR)
                   * (freq > 0) + 0.015 * rng.standard_normal(T))
            path = os.path.join(folder, f"{split}_{i:03d}.wav")
            write_audio(path, wav.astype(np.float32), SR)
            manifest[f"{split}_{i:03d}"] = {"wav": path, "length": secs,
                                            "words": text}
        with open(os.path.join(folder, f"{split}.json"), "w") as f:
            json.dump(manifest, f)
        pool = used


def _ssl_run_opts(device, steps, precision="fp32"):
    return {"device": device, "noprogressbar": True, "debug": True,
            "debug_batches": steps, "debug_epochs": 1,
            "precision": precision}


class TimedW2VBrain(TimedSteps, w2v_pretrain_recipe.SBW2V2Pretrain):
    """The wav2vec 2.0 twin's Brain with :class:`TimedSteps`' readings and
    each train step's ``prob_perplexity``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.perplexities = []

    def compute_objectives(self, predictions, batch, stage):
        if stage == Stage.TRAIN:
            self.perplexities.append(predictions[4].item())
        return super().compute_objectives(predictions, batch, stage)


def _ssl_train(folder, script, yaml, work, data, device, steps, precision,
               overrides=None, brain_cls=None):
    """``steps`` batches of an SSL twin's ``run`` from its YAML: ``(brain,
    hparams, datasets, counts, seconds, peak)``, the launch counts set to
    0 just before the run and read just after it. ``data`` None: the
    twin's own ``--debug`` corpus."""
    os.makedirs(work, exist_ok=True)
    hparams = ssl_yaml(folder, yaml, data, work, device, overrides)
    module = _ssl_module(folder, script)
    brain_cls = brain_cls or type(
        "Timed" + _default_brain(module.run).__name__,
        (TimedSteps, _default_brain(module.run)), {})
    (brain, datasets), counts, secs, peak = _timed_run(
        lambda: module.run(hparams, _ssl_run_opts(device, steps, precision),
                           brain_cls=brain_cls), device)
    return brain, hparams, datasets, counts, secs, peak


def _ssl_line(brain, counts, secs, peak, predicted_b3):
    line = _train_line(brain, counts, secs, peak,
                       sum(p.numel() for p in brain.modules.parameters()))
    line["predicted_b3"] = predicted_b3
    line["peak_gb"] = peak / 1e9
    return line


def _ssl_serve(brain, datasets, device):
    """The fine-tuned Brain's ``transcribe_batch`` (bf16, greedy CTC) on the
    valid split's first ``SSL_BATCH`` utterances: the launches of the first
    call and of all ``calls`` (that one, a warm-up and
    ``SSL_SERVE_REPEATS`` timed ones), the median ms of the timed ones,
    audio seconds a second, the hypotheses' lengths. B3 launches once a
    call where the model's Fbank is fused."""
    from speechbrain_tpu_torch.dataio.batch import PaddedBatch

    batch = PaddedBatch([datasets["valid"][i] for i in range(SSL_BATCH)])
    wavs, lens = batch["sig"]
    with torch.autocast(torch.device(device).type, dtype=torch.bfloat16):
        _sync(device)
        reset_launch_counts()
        hyps = brain.transcribe_batch(batch)
        _sync(device)
        one_call = launch_counts()
        ms, all_ms, _ = _elapsed_ms(lambda: brain.transcribe_batch(batch),
                                    SSL_SERVE_REPEATS, device)
        counts = launch_counts()
    audio_s = float(lens.sum()) * wavs.shape[1] / SR
    return {"ms": ms, "ms_all": all_ms, "shape": list(wavs.shape),
            "audio_s_per_s": audio_s / (ms / 1e3), "launches": counts,
            "launches_one_call": one_call, "calls": 2 + SSL_SERVE_REPEATS,
            "hyp_lengths": [len(h) for h in hyps],
            "ok": len(hyps) == SSL_BATCH and all(
                isinstance(c, int) for h in hyps for c in h)}


def run_ssl_w2v(out_dir, data, device="cuda"):
    """wav2vec 2.0 pretraining at the YAML's full width: ``SSL_STEPS``
    AdamW steps in float32 and, from a fresh init, in bf16, each run's
    valid batch and checkpoint; the float32 run's checkpoint recovered
    into modules built anew, bit for bit."""
    lines = {}
    for precision in ("fp32", "bf16"):
        work = os.path.join(out_dir, f"w2v_{precision}")
        brain, hparams, _, counts, secs, peak = _ssl_train(
            SSL_W2V, "train_sb_wav2vec2", "train_sb_wav2vec2.yaml", work,
            data, device, SSL_STEPS, precision, brain_cls=TimedW2VBrain)
        line = _ssl_line(brain, counts, secs, peak, 0)
        line["prob_perplexity"] = brain.perplexities
        line["codebook_entries"] = (hparams["quantiser_vars"]
                                    * hparams["quantiser_groups"])
        if precision == "fp32":
            fresh = ssl_yaml(SSL_W2V, "train_sb_wav2vec2.yaml", data, work,
                             device, {"seed": 7})
            modules = torch.nn.ModuleDict(fresh["modules"])
            fresh["checkpointer"].add_recoverable("modules", modules)
            fresh["checkpointer"].recover_if_possible()
            line["recovered_bitwise"] = _bitwise_equal(brain.modules, modules)
        line["ok"] = bool(
            len(brain.losses) == SSL_STEPS and np.isfinite(brain.losses).all()
            and line["checkpoints"] == 1
            and all(0 < p <= line["codebook_entries"]
                    for p in brain.perplexities)
            and line.get("recovered_bitwise", True)
            and all(v == 0 for v in counts.values()))
        lines[precision] = line
        del brain, hparams
        gc.collect()
        torch.cuda.empty_cache()
    return lines


def run_ssl_bestrq(out_dir, data, device="cuda"):
    """BEST-RQ pretraining at the YAML's full width (bf16, B3 once a
    batch): the quantiser's buffers bit for bit after the steps and in
    no optimizer group; the front end and encoder written where
    ``train_with_bestrq`` reads them. Returns ``(line, save_folder)``."""
    work = os.path.join(out_dir, "bestrq")
    frozen = {}

    class FrozenBRQ(TimedSteps, _ssl_module(SSL_BRQ, "train").BestRQ):
        def on_fit_start(self):
            super().on_fit_start()
            q = self.modules.quantizer
            frozen.update(P=q.P.clone(), CB=q.CB.clone(),
                          in_optimizer=any(
                              p is b for g in self.optimizer.param_groups
                              for p in g["params"] for b in q.buffers()))

    brain, hparams, _, counts, secs, peak = _ssl_train(
        SSL_BRQ, "train", "bestrq.yaml", work, data, device, SSL_STEPS,
        "bf16", brain_cls=FrozenBRQ)
    q = brain.modules.quantizer
    n_fwd = brain.forwards[Stage.TRAIN] + brain.forwards[Stage.VALID]
    line = _ssl_line(brain, counts, secs, peak, n_fwd)
    save = hparams["save_folder"]
    line.update(
        buffers_bitwise=bool(torch.equal(q.P, frozen["P"])
                             and torch.equal(q.CB, frozen["CB"])),
        buffers_in_optimizer=frozen["in_optimizer"],
        quantiser_parameters=sum(p.numel() for p in q.parameters()),
        exported=sorted(f for f in os.listdir(save) if f.endswith(".ckpt")))
    line["ok"] = bool(
        len(brain.losses) == SSL_STEPS and np.isfinite(brain.losses).all()
        and line["buffers_bitwise"] and not line["buffers_in_optimizer"]
        and line["quantiser_parameters"] == 0
        and line["exported"] == ["encoder.ckpt", "frontend.ckpt"]
        and counts["fused_fbank"] == n_fwd
        and sum(counts.values()) == n_fwd)
    return line, save


def run_ssl_finetune_bestrq(out_dir, data, pretrained, device="cuda"):
    """``train_with_bestrq`` at full width from the BEST-RQ export (bf16,
    B3 once a batch): the pour checked on modules built anew (the front
    end's tensors and the encoder's shared ones bit for bit, 3 relative
    position tensors a layer left at their init: C54); then served by
    greedy CTC with B3 once a call."""
    ft = _ssl_module(SSL_CTC, "train_with_bestrq")
    work = os.path.join(out_dir, "ft_bestrq")
    check = ssl_yaml(SSL_CTC, "train_with_bestrq.yaml", data,
                     work + "_pour", device, {"pretrained_folder": pretrained})
    fresh_names = ft.pour_pretrained(check)
    poured = True
    for name in ft.ENCODER_MODULES:
        saved = torch.load(os.path.join(pretrained, f"{name}.ckpt"),
                           map_location=device, weights_only=True)
        state = check[name].state_dict()
        poured = poured and all(torch.equal(state[k], v)
                                for k, v in saved.items())
    del check
    brain, hparams, datasets, counts, secs, peak = _ssl_train(
        SSL_CTC, "train_with_bestrq", "train_with_bestrq.yaml", work, data,
        device, SSL_STEPS, "bf16", {"pretrained_folder": pretrained})
    n_fwd = brain.forwards[Stage.TRAIN] + brain.forwards[Stage.VALID]
    line = _ssl_line(brain, counts, secs, peak, n_fwd)
    serve = _ssl_serve(brain, datasets, device)
    line.update(poured_bitwise=poured, left_at_init=len(fresh_names),
                serve=serve, lr_groups={
                    g["name"]: g["lr"] for g in brain.optimizer.param_groups})
    line["predicted_b3"] += serve["calls"]
    layers = hparams["num_encoder_layers"]
    line["ok"] = bool(
        poured and len(fresh_names) == 3 * layers
        and len(brain.losses) == SSL_STEPS and np.isfinite(brain.losses).all()
        and counts["fused_fbank"] == n_fwd
        and sum(counts.values()) == n_fwd and serve["ok"]
        and serve["launches_one_call"]["fused_fbank"] == 1
        and sum(serve["launches_one_call"].values()) == 1)
    line["launches"] = {k: v + serve["launches"][k]
                        for k, v in counts.items()}
    return line


def run_ssl_finetune_w2v(out_dir, data, device="cuda"):
    """``train_with_wav2vec`` at full width (bf16; no kernel), then served
    by greedy CTC."""
    brain, hparams, datasets, counts, secs, peak = _ssl_train(
        SSL_CTC, "train_with_wav2vec", "train_with_wav2vec.yaml",
        os.path.join(out_dir, "ft_w2v"), data, device, SSL_STEPS, "bf16")
    line = _ssl_line(brain, counts, secs, peak, 0)
    serve = _ssl_serve(brain, datasets, device)
    line["serve"] = serve
    line["ok"] = bool(
        len(brain.losses) == SSL_STEPS and np.isfinite(brain.losses).all()
        and serve["ok"] and sum(serve["launches"].values()) == 0
        and all(v == 0 for v in counts.values()))
    return line


def run_ssl_twin(folder, script, yaml, out_dir, device="cuda"):
    """One bf16 step and the valid stage of a twin from its YAML at full
    width, on its own ``--debug`` corpus."""
    work = os.path.join(out_dir, "_".join(folder.split("/")[1:] + [yaml[:-5]]))
    over = {"data_folder": os.path.join(work, "data")}
    brain, hparams, _, counts, secs, peak = _ssl_train(
        folder, script, yaml, work, None, device, 1, "bf16", over)
    fused = getattr(hparams.get("compute_features"), "fused", False)
    n_fwd = brain.forwards[Stage.TRAIN] + brain.forwards[Stage.VALID]
    line = _ssl_line(brain, counts, secs, peak, n_fwd if fused else 0)
    line["parameters_finite"] = all(bool(torch.isfinite(p).all())
                                    for p in brain.modules.parameters())
    line["ok"] = bool(
        len(brain.losses) == 1 and np.isfinite(brain.losses).all()
        and line["parameters_finite"]
        and counts["fused_fbank"] == line["predicted_b3"]
        and sum(counts.values()) == line["predicted_b3"])
    return line


def run_ssl_path(out_dir, device="cuda"):
    """B3 against its plain version at BEST-RQ's shape; wav2vec 2.0
    pretraining (:func:`run_ssl_w2v`); BEST-RQ pretraining
    (:func:`run_ssl_bestrq`); the CTC fine-tuning from its export, served
    (:func:`run_ssl_finetune_bestrq`); the wav2vec 2.0 CTC fine-tuning,
    served (:func:`run_ssl_finetune_w2v`); one step of every other twin.
    Returns each kernel's launches over the path (the counts set to 0
    just before each stage and read just after it) and B3's errors."""
    t0 = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    b3 = check_b3_at_shapes(SSL_B3_SHAPES, device)
    emit({"phase": "ssl_b3_check", "max_abs_err_db": b3, "atol": B3_ATOL,
          "ok": max(b3.values()) <= B3_ATOL})
    if max(b3.values()) > B3_ATOL:
        raise AssertionError(f"ssl_path: B3 against its plain version {b3}")
    data = os.path.join(out_dir, "data")
    write_ssl_corpus(data, SSL_BATCH * SSL_STEPS, SSL_BATCH)
    launches = {name: 0 for name in KERNELS}
    predicted = 0

    def add(line, label):
        nonlocal predicted
        line["gpu_name_power_limit"] = gpu_name_power_limit()
        emit({"phase": f"ssl_path/{label}", **line})
        for k, v in line["launches"].items():
            launches[k] += v
        predicted += line["predicted_b3"]
        if not line["ok"]:
            raise AssertionError(f"ssl_path: {label} failed")
        # the Brain and its checkpointer hold each other: free the run's
        # modules and optimizer before the next one's peak is read
        gc.collect()
        torch.cuda.empty_cache()

    for precision, line in run_ssl_w2v(out_dir, data, device).items():
        add(line, f"wav2vec2_pretrain/{precision}")
    line, pretrained = run_ssl_bestrq(out_dir, data, device)
    add(line, "bestrq_pretrain")
    add(run_ssl_finetune_bestrq(out_dir, data, pretrained, device),
        "train_with_bestrq")
    add(run_ssl_finetune_w2v(out_dir, data, device), "train_with_wav2vec")
    for folder, script, yaml in SSL_TWINS:
        add(run_ssl_twin(folder, script, yaml, out_dir, device),
            f"{folder.split('/')[1]}/{yaml}")
    ok = launches["fused_fbank"] == predicted > 0 and all(
        v == 0 for k, v in launches.items() if k != "fused_fbank")
    emit({"phase": "ssl_path_summary", "launches": launches,
          "predicted_b3": predicted, "reduced": SSL_REDUCED,
          "seconds": time.perf_counter() - t0, "ok": ok,
          "gpu_name_power_limit": gpu_name_power_limit()})
    if not ok:
        raise AssertionError("ssl_path: B3's launches are not the path's "
                             "prediction")
    return launches, b3


# -- rescore_path: n-best decoding and second-pass rescoring ----------------

# NORTH's search returns its 10 best hypotheses an utterance; the rerank
# weighs the Transformer LM (TLM_CFG) at 0.5 (the rescoring YAMLs' weight)
RESCORE_TOPK = 10
RESCORE_WEIGHT = 0.5
# rescorer against the teacher-forced sum taken step by step (float32)
RESCORE_SCORE_ATOL = 1e-4
# ... and, for the CRDNN's hypotheses of up to 250 tokens, whose LM sums
# come to about -1,200 (where one float32 step is 1.2e-4), 1e-6 of the sum
# on top: about 8 float32 roundings of it
RESCORE_RNN_RTOL = 1e-6
# the host CTC searches: the rescoring YAMLs' setting and JAX's default
CTC_SEARCHES = {"yaml_beam8_topk4": dict(beam_size=8, topk=4),
                "default_beam100": dict(beam_size=100)}
# utterances of NORTH's batch decoded at each setting: beam 100 over 33
# characters takes seconds an utterance on the host (about 25 of them above
# the pruning floor a frame)
CTC_SEARCH_UTTS = {"yaml_beam8_topk4": 8, "default_beam100": 1}
# the buffer LM scorer's token buffer, and the scores' tolerance against
# the KV-cached scorer's (float32)
BUFFER_LM_LENGTH = 64
BUFFER_SCORE_ATOL = 1e-4
RESCORE_TWINS = ("train_hf_wav2vec_rnn_rescoring.yaml",
                 "train_hf_wav2vec_transformer_rescoring.yaml")
# the twins' corpus: 6 utterances a split (the YAMLs' batch), 3.5-4 s
RESCORE_TWIN_CORPUS = dict(seconds=(3.5, 4.0), valid_seconds=4.0,
                           char_s=0.08, utterances=6)
RESCORE_REDUCED = {
    "weights": "random, from seeds (the search's, both LMs', the CTC "
               "twin's); the LMs rerank hypotheses they never learned",
    "nbest_transformer": "NORTH's search at beam 10 and decode ratio 0.2 "
                         "(recipe: 66, 1.0), its 10 best an utterance",
    "ctc_beam": "LibriSpeech test-clean -> NORTH's batch of noise; JAX's "
                "default beam of 100 on its first utterance only",
    "w2v_rescoring_twins": "one bf16 step and one valid batch of 6 "
                           "synthetic tone utterances of 3.5-4 s (10 "
                           "epochs of LibriSpeech in the recipe)",
    "buffer_lm_scorer": "the buffer's length 64, not the YAML's 512: the "
                        "LM is causal, so slots past the step change no "
                        "score; NORTH's decode ratio 0.2 (51 steps)",
}


def teacher_forced_lm_sums(lm_step, init, tokens, lens, bos, eos,
                           temperature=1.0):
    """Each hypothesis's LM log-probability summed one position at a time:
    ``lm_step(column (N,), state, step) -> (logits (N, V), state)`` fed
    bos and then the hypothesis, the eos's log-probability read at its
    length, positions past it left out; the log-probabilities in float32,
    summed in float64 (so that the sum's own rounding, up to about 1e-4 in
    float32 over 50 positions of -8, does not count against the
    rescorer). The rescorers' sums by another road (one incremental call
    a position)."""
    N, L = tokens.shape
    inp = torch.cat([tokens.new_full((N, 1), bos), tokens], dim=1)
    tgt = torch.cat([tokens, tokens.new_full((N, 1), eos)], dim=1).long()
    rows = torch.arange(N, device=tokens.device)
    tgt[rows, lens.long()] = eos
    state = init
    total = torch.zeros(N, dtype=torch.float64, device=tokens.device)
    for s in range(L + 1):
        logits, state = lm_step(inp[:, s], state, s)
        logp = torch.log_softmax(logits.float() / temperature, dim=-1)
        total = total + torch.where(
            lens >= s, logp[rows, tgt[:, s]].double(), torch.zeros_like(total))
    return total


def _rerank_checks(builder, topk_hyps, topk_scores, lm_scores, weight):
    """The builder's rerank (first row of each list) against numpy's
    ``argsort(-combined)`` of the float32 combined scores computed here."""
    best, best_scores, (rr_hyps, _) = builder.rescore(topk_hyps, topk_scores)
    B, K = len(topk_hyps), len(topk_hyps[0])
    combined = (np.asarray(topk_scores, np.float32)
                + weight * np.asarray(lm_scores).reshape(B, K))
    order = np.argsort(-combined, axis=-1)
    expected = [[topk_hyps[b][k] for k in order[b]] for b in range(B)]
    return {"order_equals_numpy_argsort": rr_hyps == expected,
            "best_equals_first": best == [row[0] for row in expected],
            "best_scores_close": bool(np.allclose(
                best_scores, combined.max(-1), atol=RESCORE_SCORE_ATOL)),
            "changed_best": sum(int(order[b][0] != 0) for b in range(B))}


def rescore_lm(device="cuda"):
    """``transformer.yaml``'s LM (``TLM_CFG``) in evaluation, random
    weights from seed 11."""
    cfg = TLM_CFG
    return TransformerLM(cfg["vocab"], d_model=cfg["d_model"],
                         nhead=cfg["nhead"], num_encoder_layers=cfg["layers"],
                         d_ffn=cfg["d_ffn"], dropout=0.0, device=device,
                         generator=torch.Generator().manual_seed(11)).eval()


def run_nbest_transformer(device="cuda"):
    """NORTH's bf16 ancestry search with its 10 best hypotheses an
    utterance (B3 once, B1 in every decoder and LM layer a step), reranked
    by a ``RescorerBuilder`` over the Transformer LM at
    ``RESCORE_WEIGHT``; the rerank timed in bf16 and float32, the float32
    LM scores held against :func:`teacher_forced_lm_sums`, the order
    against numpy's argsort."""
    cfg = dict(NORTH, topk=RESCORE_TOPK)
    wavs, lens = make_waveforms(cfg, device)
    pipe = Pipeline(cfg, device=device, dtype=torch.bfloat16, seed=0,
                    ancestry=True)
    pipe.transcribe(wavs, lens)  # warm-up
    reset_launch_counts()
    pipe.fbank_calls = 0
    _, _, _, (topk_hyps, topk_scores, _) = pipe.transcribe(wavs, lens)
    counts = launch_counts()
    expected = expected_launches(cfg, True, pipe.searcher.last_steps,
                                 pipe.fbank_calls)
    lm = rescore_lm(device)
    rescorer = TransformerLMRescorer(lm, bos_index=TLM_CFG["bos"],
                                     eos_index=TLM_CFG["eos"], device=device)
    builder = RescorerBuilder({"lm": RESCORE_WEIGHT}, {"lm": rescorer})
    with torch.autocast(torch.device(device).type, dtype=torch.bfloat16):
        builder.rescore(topk_hyps, topk_scores)  # warm-up
        _, bf16_ms = _host_ms(lambda: builder.rescore(topk_hyps, topk_scores),
                            device)
    builder.rescore(topk_hyps, topk_scores)
    _, fp32_ms = _host_ms(lambda: builder.rescore(topk_hyps, topk_scores),
                        device)
    tokens, hyp_lens = BaseRescorerInterface.pad_topk(topk_hyps)
    B, K, L = tokens.shape
    flat = torch.from_numpy(tokens.reshape(B * K, L)).to(device)
    flat_lens = torch.from_numpy(hyp_lens.reshape(B * K)).to(device)
    lm_scores = rescorer.rescore(flat, flat_lens)
    with torch.no_grad():
        stepwise = teacher_forced_lm_sums(
            lambda col, cache, s: lm.score_step(col, cache, s),
            lm.init_cache(B * K, L + 1), flat, flat_lens, TLM_CFG["bos"],
            TLM_CFG["eos"])
    diff = float((lm_scores.double() - stepwise).abs().max())
    checks = _rerank_checks(builder, topk_hyps, topk_scores,
                            lm_scores.cpu().numpy(), RESCORE_WEIGHT)
    line = {
        "hypotheses": B * K, "max_hyp_length": L,
        "steps": pipe.searcher.last_steps, "launches": counts,
        "expected_launches": expected, "decode_ms": pipe.last_decode_ms,
        "encode_ms": pipe.last_encode_ms, "rerank_ms_bf16": bf16_ms,
        "rerank_ms_fp32": fp32_ms, "lm_vs_stepwise_max_diff": diff,
        "atol": RESCORE_SCORE_ATOL, **checks,
    }
    line["ok"] = bool(
        counts == expected and counts["ancestry_attention"] > 0
        and B == cfg["batch"] and K == RESCORE_TOPK
        and np.isfinite(np.asarray(topk_scores)).all()
        and diff <= RESCORE_SCORE_ATOL and checks["order_equals_numpy_argsort"]
        and checks["best_equals_first"] and checks["best_scores_close"])
    del pipe, lm
    return line


def run_nbest_rnn(device="cuda"):
    """The CRDNN serve (``CRDNN_CFG``, ``CRDNN_DECODE``: beam 16, CTC,
    RNNLM and coverage fusion) in bf16 with its 16 best an utterance,
    reranked through ``RNNLMRescorer`` over ``RNNLM.yaml``'s LM; float32 LM
    scores against :func:`teacher_forced_lm_sums` through the LSTM's
    state (within ``RESCORE_SCORE_ATOL`` plus ``RESCORE_RNN_RTOL`` of the
    sum), the order against numpy's argsort."""
    cfg = CRDNN_CFG
    beam = CRDNN_DECODE["beam_size"]
    modules = crdnn_modules(cfg, device=device)
    lm = crdnn_lm(cfg, device=device).eval()
    asr = crdnn_served_asr(cfg, modules, lm, None, device=device,
                           decode=dict(CRDNN_DECODE, topk=beam,
                                       return_topk=True))
    wavs, lens = make_waveforms(NORTH, device)
    decoder = asr.hparams.decoder

    def serve():
        with torch.no_grad(), torch.autocast(
                torch.device(device).type, dtype=torch.bfloat16):
            return decoder(asr.encode_batch(wavs, lens), lens)

    serve()  # warm-up: cuDNN's plans
    reset_launch_counts()
    (_, _, _, (topk_hyps, topk_scores, _)), decode_ms = _host_ms(serve, device)
    counts = launch_counts()
    rescorer = RNNLMRescorer(lambda t, s: lm(t, hx=s), lambda n: None,
                             bos_index=cfg["bos"], eos_index=cfg["eos"],
                             device=device)
    builder = RescorerBuilder({"lm": RESCORE_WEIGHT}, {"lm": rescorer})
    builder.rescore(topk_hyps, topk_scores)
    _, fp32_ms = _host_ms(lambda: builder.rescore(topk_hyps, topk_scores),
                        device)
    tokens, hyp_lens = BaseRescorerInterface.pad_topk(topk_hyps)
    B, K, L = tokens.shape
    flat = torch.from_numpy(tokens.reshape(B * K, L)).to(device)
    flat_lens = torch.from_numpy(hyp_lens.reshape(B * K)).to(device)
    lm_scores = rescorer.rescore(flat, flat_lens)

    def lstm_step(col, state, s):
        logits, state = lm(col[:, None], hx=state)
        return logits[:, 0], state

    with torch.no_grad():
        stepwise = teacher_forced_lm_sums(lstm_step, None, flat, flat_lens,
                                          cfg["bos"], cfg["eos"])
    gap = (lm_scores.double() - stepwise).abs()
    diff = float(gap.max())
    within = bool((gap <= RESCORE_SCORE_ATOL
                   + RESCORE_RNN_RTOL * stepwise.abs()).all())
    checks = _rerank_checks(builder, topk_hyps, topk_scores,
                            lm_scores.cpu().numpy(), RESCORE_WEIGHT)
    b3_once = dict.fromkeys(KERNELS, 0)
    b3_once["fused_fbank"] = 1
    line = {"hypotheses": B * K, "max_hyp_length": L, "launches": counts,
            "serve_ms": decode_ms, "steps": decoder.searcher.last_steps,
            "rerank_ms_fp32": fp32_ms, "lm_vs_stepwise_max_diff": diff,
            "lm_vs_stepwise_max_rel_diff": float((gap / stepwise.abs()).max()),
            "atol": RESCORE_SCORE_ATOL, "rtol": RESCORE_RNN_RTOL,
            "lm_sum_range": [float(stepwise.min()), float(stepwise.max())],
            **checks}
    line["ok"] = bool(
        counts == b3_once and K == beam and B == NORTH["batch"] and within
        and checks["order_equals_numpy_argsort"]
        and checks["best_equals_first"] and checks["best_scores_close"])
    del asr, modules, lm
    return line


def ctc_posteriors(brain, wavs, lens, autocast):
    """The CTC twin's posteriors of a batch (its ``compute_forward`` in
    evaluation), float32 on the device, and the lengths rescaled to
    them."""
    brain.modules.eval()
    with torch.no_grad(), torch.autocast(
            wavs.device.type, dtype=torch.bfloat16, enabled=autocast):
        logp, enc_lens = brain.compute_forward(
            brain._prepare_batch({"sig": (wavs, lens)}), Stage.TEST)
    return logp.float(), enc_lens


def _top1_margin(beams):
    """The best beam's score above the second's (inf with one beam)."""
    if len(beams) < 2:
        return float("inf")
    return float(beams[0].score - beams[1].score)


def run_ctc_beam(device="cuda"):
    """The LibriSpeech CTC twin's ``conformer_large`` (full width, B3)
    posteriors of NORTH's batch, decoded on the host by ``CTCBeamSearcher``
    and ``CTCPrefixBeamSearcher`` at the rescoring YAMLs' setting and at
    JAX's default beam of 100: host ms an utterance and a frame. Then in
    float32 the posteriors through B3 and through its plain version,
    decoded at the YAMLs' setting: the top-1 texts must agree wherever the
    first's margin over its runner-up exceeds twice the largest change a
    path's score can take (the sum over frames of the posteriors' largest
    difference; C32's policy)."""
    cfg, family = CTC_CFG, CTC_FAMILIES["conformer_large"]
    modules = ctc_modules(cfg, family, device=device)
    brain = TimedCTCBrain(
        modules=modules, opt_class=recipe.adamw(cfg["lr"]),
        hparams={"compute_features": Fbank(n_mels=cfg["n_mels"], fused=True,
                                           device=device),
                 "normalize": InputNormalization(norm_type="sentence"),
                 "blank_index": cfg["blank"]},
        run_opts={"device": device, "noprogressbar": True})
    wavs, lens = make_waveforms(NORTH, device)
    ctc_posteriors(brain, wavs, lens, True)  # warm-up
    reset_launch_counts()
    (logp, enc_lens), fwd_ms = _host_ms(
        lambda: ctc_posteriors(brain, wavs, lens, True), device)
    counts = launch_counts()
    T = logp.shape[1]
    searches = {}
    for name, kw in CTC_SEARCHES.items():
        n = CTC_SEARCH_UTTS[name]
        for cls in (CTCBeamSearcher, CTCPrefixBeamSearcher):
            searcher = cls(blank_index=cfg["blank"], **kw)
            t0 = time.perf_counter()
            out = searcher(logp[:n], enc_lens[:n])
            ms = (time.perf_counter() - t0) * 1e3
            frames = sum(int(round(float(v) * T))
                         for v in enc_lens[:n].cpu())
            searches[f"{cls.__name__}/{name}"] = {
                "utterances": n, "frames": frames, "ms": ms,
                "ms_per_utterance": ms / n, "ms_per_frame": ms / frames,
                "beams": [len(row) for row in out],
                "top1_lengths": [len(row[0].text) for row in out],
                "finite": all(np.isfinite(b.score) for row in out
                              for b in row)}
    reset_launch_counts()
    kernel_lp, kernel_lens = ctc_posteriors(brain, wavs, lens, False)
    fp32_counts = launch_counts()
    with plain_versions("fused_fbank"):
        plain_lp, _ = ctc_posteriors(brain, wavs, lens, False)
    searcher = CTCBeamSearcher(blank_index=cfg["blank"],
                               **CTC_SEARCHES["yaml_beam8_topk4"])
    beams_k = searcher(kernel_lp, kernel_lens)
    beams_p = searcher(plain_lp, kernel_lens)
    frame_diff = (kernel_lp - plain_lp).abs().amax(-1)  # (B, T)
    compared, agree = 0, True
    for b, (rk, rp) in enumerate(zip(beams_k, beams_p)):
        n_frames = int(round(float(kernel_lens[b]) * T))
        bound = 2 * float(frame_diff[b, :n_frames].sum())
        if _top1_margin(rk) > bound:
            compared += 1
            agree = agree and rk[0].text == rp[0].text
    line = {"posteriors_shape": list(logp.shape), "forward_ms_bf16": fwd_ms,
            "launches": {k: counts[k] + fp32_counts[k] for k in KERNELS},
            "bf16_launches": counts, "fp32_launches": fp32_counts,
            "searches": searches,
            "fp32_max_posterior_diff": float(frame_diff.max()),
            "fp32_utterances_compared": compared,
            "fp32_top1_equal_where_compared": agree,
            "fp32_top1_equal_all": [rk[0].text == rp[0].text
                                    for rk, rp in zip(beams_k, beams_p)]}
    b3_once = dict.fromkeys(KERNELS, 0)
    b3_once["fused_fbank"] = 1
    line["ok"] = bool(
        counts == b3_once and fp32_counts == b3_once and agree
        and all(s["finite"] and min(s["beams"]) >= 1
                for s in searches.values()))
    del brain, modules
    return line


def run_w2v_rescoring_twins(out_dir, device="cuda"):
    """Both rescoring YAMLs at their widths (wav2vec 768 x 12): one bf16
    step, then the valid stage through the rescoring ``evaluate_batch``
    (the host CTC search's top 4 reranked by the YAML's LM); the CER must
    be a number, the run must not raise, and no kernel launches."""
    cfg = RESCORE_TWIN_CORPUS
    data = os.path.join(out_dir, "data")
    write_ssl_corpus(data, cfg["utterances"], cfg["utterances"], cfg)
    lines = {}
    for yaml in RESCORE_TWINS:
        brain, hparams, _, counts, secs, peak = _ssl_train(
            SSL_CTC, "train_with_wav2vec", yaml,
            os.path.join(out_dir, yaml[:-5]), data, device, 1, "bf16")
        cer = brain.cer_metric.summarize("error_rate")
        line = _ssl_line(brain, counts, secs, peak, 0)
        line.update(cer=cer, rescored_utterances=len(brain.cer_metric.ids),
                    rescorer=type(hparams["rescorer"].rescorers["lm"]).__name__)
        line["ok"] = bool(
            len(brain.losses) == 1 and np.isfinite(brain.losses).all()
            and np.isfinite(cer) and line["rescored_utterances"] > 0
            and sum(counts.values()) == 0)
        lines[yaml] = line
        del brain, hparams
        gc.collect()
    return lines


def run_buffer_lm_scorer(device="cuda"):
    """NORTH's permuting search in float32 (B4 on the decoder's cache
    permute) with the buffer ``TransformerLMScorer`` (length
    ``BUFFER_LM_LENGTH``) and with ``KVTransformerLMScorer``: tokens equal,
    scores within ``BUFFER_SCORE_ATOL``, each run's decode ms a step; B4
    gathers the LM's caches too in the KV run only."""
    wavs, lens = make_waveforms(NORTH, device)
    runs = {}
    for name, extra in (("buffer", {"buffer_lm_length": BUFFER_LM_LENGTH}),
                        ("kv", {})):
        cfg = dict(NORTH, **extra)
        pipe = Pipeline(cfg, device=device, dtype=torch.float32, seed=0,
                        ancestry=False)
        pipe.transcribe(wavs, lens)  # warm-up
        reset_launch_counts()
        pipe.fbank_calls = 0
        hyps, _, scores, _ = pipe.transcribe(wavs, lens)
        steps = pipe.searcher.last_steps
        expected = expected_launches(cfg, False, steps, pipe.fbank_calls)
        if name == "buffer":
            expected["row_gather"] = 2 * cfg["dec_layers"] * steps
        runs[name] = {"hyps": hyps, "scores": np.asarray(scores),
                      "steps": steps, "decode_ms": pipe.last_decode_ms,
                      "step_ms": pipe.last_decode_ms / steps,
                      "launches": launch_counts(), "expected": expected}
        del pipe
        _sync(device)
    buf, kv = runs["buffer"], runs["kv"]
    diff = float(np.max(np.abs(buf["scores"] - kv["scores"])))
    line = {name: {k: v for k, v in run.items()
                   if k not in ("hyps", "scores")}
            for name, run in runs.items()}
    line.update(tokens_equal=buf["hyps"] == kv["hyps"],
                max_score_diff=diff, atol=BUFFER_SCORE_ATOL,
                buffer_length=BUFFER_LM_LENGTH)
    line["ok"] = bool(
        line["tokens_equal"] and diff <= BUFFER_SCORE_ATOL
        and all(r["launches"] == r["expected"] for r in runs.values())
        and buf["steps"] + 1 <= BUFFER_LM_LENGTH)
    line["launches"] = {k: buf["launches"][k] + kv["launches"][k]
                        for k in KERNELS}
    return line


def run_frontend_options(device="cuda"):
    """``Fbank(deltas=True, context=True, fused=True)`` on NORTH's batch
    (8 x 10 s -> (8, 1001, 2640); B3 once) against ``fused=False``: the
    log-mels within ``B3_ATOL``, their deltas within 0.6 of it and the
    second deltas within 0.36 (the weights of a delta sum to 6/10 in
    absolute value), each context block the same; then ``MFCC``."""
    wavs, _ = make_waveforms(NORTH, device)
    n = NORTH["n_mels"]
    fused = Fbank(n_mels=n, deltas=True, context=True, fused=True,
                  device=device)
    unfused = Fbank(n_mels=n, deltas=True, context=True, device=device)
    mfcc = MFCC(device=device)
    with torch.no_grad():
        fused(wavs)
        unfused(wavs)
        mfcc(wavs)  # warm-up
        reset_launch_counts()
        out, fused_ms = _host_ms(lambda: fused(wavs), device)
        counts = launch_counts()
        ref, unfused_ms = _host_ms(lambda: unfused(wavs), device)
        coeffs, mfcc_ms = _host_ms(lambda: mfcc(wavs), device)
    blocks = (out - ref).abs().reshape(*out.shape[:2], -1, 3, n)
    errs = [float(blocks[..., i, :].max()) for i in range(3)]
    bounds = [B3_ATOL, 0.6 * B3_ATOL, 0.36 * B3_ATOL]
    b3_once = dict.fromkeys(KERNELS, 0)
    b3_once["fused_fbank"] = 1
    line = {"shape": list(out.shape), "fused_ms": fused_ms,
            "unfused_ms": unfused_ms, "launches": counts,
            "max_abs_err_db": {"static": errs[0], "delta": errs[1],
                               "delta_delta": errs[2]},
            "atol_db": {"static": bounds[0], "delta": bounds[1],
                        "delta_delta": bounds[2]},
            "mfcc_shape": list(coeffs.shape), "mfcc_ms": mfcc_ms,
            "mfcc_finite": bool(torch.isfinite(coeffs).all())}
    T = 1 + wavs.shape[1] // fused.compute_STFT.hop_length
    line["ok"] = bool(
        counts == b3_once and list(out.shape) == [wavs.shape[0], T, 33 * n]
        and all(e <= b for e, b in zip(errs, bounds))
        and line["mfcc_finite"]
        and list(coeffs.shape) == [wavs.shape[0], T, 660])
    return line


def run_rescore_path(out_dir, device="cuda"):
    """The n-best decoding and second-pass rescoring path, phase by phase:
    :func:`run_nbest_transformer`, :func:`run_nbest_rnn`,
    :func:`run_ctc_beam`, :func:`run_w2v_rescoring_twins`,
    :func:`run_buffer_lm_scorer`, :func:`run_frontend_options`. Each
    phase's launches are counted from 0 just before its measured runs
    and read just after. Returns each kernel's launches over the path."""
    t0 = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    launches = {name: 0 for name in KERNELS}
    by_phase = {}

    def add(label, line):
        line["gpu_name_power_limit"] = gpu_name_power_limit()
        emit({"phase": f"rescore_path/{label}", **line})
        by_phase[label] = line["launches"]
        for k, v in line["launches"].items():
            launches[k] += v
        if not line["ok"]:
            raise AssertionError(f"rescore_path: {label} failed")
        gc.collect()
        torch.cuda.empty_cache()

    add("nbest_transformer", run_nbest_transformer(device))
    add("nbest_rnn", run_nbest_rnn(device))
    add("ctc_beam", run_ctc_beam(device))
    twins = run_w2v_rescoring_twins(os.path.join(out_dir, "twins"), device)
    for yaml, line in twins.items():
        add(f"w2v_rescoring_twins/{yaml}", line)
    add("buffer_lm_scorer", run_buffer_lm_scorer(device))
    add("frontend", run_frontend_options(device))
    ok = (launches["fused_fbank"] >= 4 and launches["ancestry_attention"] > 0
          and launches["row_gather"] > 0 and launches["flash_attention"] == 0)
    emit({"phase": "rescore_path_summary", "launches": launches,
          "launches_by_phase": by_phase, "reduced": RESCORE_REDUCED,
          "seconds": time.perf_counter() - t0, "ok": ok,
          "gpu_name_power_limit": gpu_name_power_limit()})
    if not ok:
        raise AssertionError("rescore_path: a kernel's launches are off")
    return launches


def run_grad_guard():
    """Each kernel's wrapper, given a CUDA input that requires grad with
    grad mode on, raises (naming the plain version) and launches nothing;
    under ``torch.no_grad()`` the same call launches its kernel once. Also
    ``MultiheadAttention(use_pallas=True)`` in training mode with dropout
    0, which PR 2-4 let through with its result cut off from the graph."""
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

    fbank = Fbank(n_mels=80, fused=True)
    mha = MultiheadAttention(nhead=4, d_model=256, use_pallas=True).train()
    q = rand(2, 10, 4, 64)
    cache = rand(2, 10, 16, 256)
    anc = torch.zeros(2, 10, 16, dtype=torch.int32, device="cuda")
    cases = {
        "fused_fbank": ("fused_fbank", "fused_fbank_reference",
                        lambda g: fbank(rand(2, 16000).requires_grad_(g))),
        "ancestry_attention": (
            "ancestry_attention", "ancestry_attention_reference",
            lambda g: beam_attention.ancestry_attention(
                q.clone().requires_grad_(g), cache, cache, anc, 5)),
        "flash_attention": (
            "flash_attention", "flash_attention_reference",
            lambda g: attention.flash_attention(
                *(rand(2, 4, 64, 64).requires_grad_(g) for _ in range(3)))),
        "row_gather": (
            "row_gather", "row_gather_reference",
            lambda g: gather.row_gather(
                rand(9, 512).requires_grad_(g),
                torch.tensor([3, 1, 8], device="cuda"))),
        "mha_use_pallas_training": (
            "flash_attention", "flash_attention_reference",
            lambda g: mha(*(rand(2, 64, 256).requires_grad_(g)
                            for _ in range(3)))),
    }
    results, ok = {}, True
    for case, (kernel, plain, call) in cases.items():
        reset_launch_counts()
        try:
            call(True)
            raised = None
        except ValueError as e:
            raised = str(e)
        refused = raised is not None and plain in raised
        launched_when_refused = launch_counts()[kernel]
        with torch.no_grad():
            call(True)
        launched_no_grad = launch_counts()[kernel] - launched_when_refused
        results[case] = {"raised": refused,
                         "launches_when_refused": launched_when_refused,
                         "launches_under_no_grad": launched_no_grad}
        ok = ok and refused and launched_when_refused == 0 \
            and launched_no_grad == 1
    emit({"phase": "grad_guard", "ok": bool(ok), "cases": results})
    if not ok:
        raise AssertionError("grad_guard: a wrapper let a graph through")


def gpu_name_power_limit():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--profile", action="store_true",
        help="also trace two training steps, one encode (B3 must launch "
             "once), one beam search and one transcribe_batch through the "
             "entry point with torch.profiler and print the device's busy "
             "share and the heaviest kernels",
    )
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    # float32 products in full float32 everywhere, cuDNN's convolutions
    # included (they default to TF32), so that float32 phases compare
    # like with like
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = gpu_name_power_limit()

    t_script = t0 = time.perf_counter()
    _build.load_library()
    emit({"phase": "environment", "torch": torch.__version__,
          "cuda": torch.version.cuda, "gpu_name_power_limit": smi,
          "kernel_build_seconds": _build.last_build_seconds,
          "kernel_load_seconds": time.perf_counter() - t0,
          "nvcc_flags": list(_build.NVCC_FLAGS)})

    err_b1 = check_b1()
    err_b3 = check_b3()
    err_b2 = check_b2()
    err_b4 = check_b4()
    run_grad_guard()
    main_pipe, main_run = run_transcribe_path(NORTH, ancestry=True)
    run_fp32_comparison(NORTH, ancestry=True)
    _, perm_run = run_transcribe_path(NORTH, ancestry=False)
    run_fp32_comparison(NORTH, ancestry=False)
    flash_shapes, flash_launches = run_flash_path(NORTH, main_pipe)
    del main_pipe
    torch.cuda.empty_cache()
    main_launches = main_run["launches"]
    kernels = [
        measure_b1(NORTH, main_run["steps"], main_run["max_steps"],
                   main_launches["ancestry_attention"], err_b1),
        measure_b3(NORTH, main_launches["fused_fbank"], err_b3),
        measure_b2(flash_shapes, flash_launches, err_b2),
        measure_b4(NORTH, perm_run, err_b4),
    ]
    del flash_shapes
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        # TRAIN's corpus serves train_path, then host_path after recipe_path
        paths = write_asr_corpus(TRAIN, out_dir)
        datasets = {split: asr_dataset(path, TRAIN, train=split == "train")
                    for split, path in paths.items()}
        brain = run_train_path(TRAIN, out_dir, datasets)
        kernels[1]["launches_by_path"] = {
            "main_path": main_launches["fused_fbank"],
            "permute_path": perm_run["launches"]["fused_fbank"],
            "train_path": brain.forwards[Stage.TRAIN]
            + brain.forwards[Stage.VALID],
        }
        run_train_checks(TRAIN, brain, out_dir, datasets)
        del brain
        torch.cuda.empty_cache()
        if args.profile:
            # the decode's traces first: the encode's trace (device
            # activity only) recorded nothing when it followed the
            # training's (host and device; torch 2.11 on an H100)
            profile_decode(NORTH)
            profile_train(TRAIN, out_dir, datasets)
        # the recipe's checkpoints (about 1.3 GB each) go with the directory
        with tempfile.TemporaryDirectory() as recipe_dir:
            recipe_forwards, wer_metric = run_recipe_path(recipe_dir)
        torch.cuda.empty_cache()
        kernels[1]["launches_by_path"]["recipe_path"] = sum(
            recipe_forwards.values())
        kernels[1]["launches_by_path"]["host_path"] = run_host_path(
            TRAIN, os.path.join(out_dir, "host"), paths, wer_metric)
        torch.cuda.empty_cache()
        family, (hd18_steps, hd18_max) = run_family_path(
            os.path.join(out_dir, "family"), datasets)
        torch.cuda.empty_cache()
        kernels[0]["launches_by_path"] = {
            "main_path": main_launches["ancestry_attention"],
            "family_path": {n: c["ancestry_attention"]
                            for n, c in family.items()}}
        kernels[1]["launches_by_path"]["family_path"] = {
            n: c["fused_fbank"] for n, c in family.items()}
        kernels[0]["at_head_dim_18"] = measure_b1_at(
            family_cfg("hyperconformer_8M"), hd18_steps, hd18_max)
        kernels[1]["launches_by_path"]["crdnn_path"] = run_crdnn_path(
            os.path.join(out_dir, "crdnn"), paths)
        torch.cuda.empty_cache()
        (kernels[1]["launches_by_path"]["transducer_path"],
         rnnt_batch) = run_transducer_path(
            os.path.join(out_dir, "transducer"), paths)
        torch.cuda.empty_cache()
        kernels[1]["launches_by_path"]["ctc_path"] = run_ctc_path(paths)
        torch.cuda.empty_cache()
        (kernels[1]["launches_by_path"]["streaming_path"], stream_shape,
         stream_file_shape) = run_streaming_path(
            os.path.join(out_dir, "streaming"), paths)
        torch.cuda.empty_cache()
        (kernels[1]["launches_by_path"]["speaker_path"],
         speaker_b3_err) = run_speaker_path(os.path.join(out_dir, "speaker"))
        torch.cuda.empty_cache()
        (kernels[1]["launches_by_path"]["classify_path"],
         classify_b3_err) = run_classify_path(
            os.path.join(out_dir, "classify"))
        torch.cuda.empty_cache()
        kernels[1]["launches_by_path"]["recurrent_twins_path"] = \
            run_recurrent_twins_path(os.path.join(out_dir, "recurrent"))
        torch.cuda.empty_cache()
        separation_launches = run_separation_path(
            os.path.join(out_dir, "separation"))
        for kernel in kernels:
            kernel.setdefault("launches_by_path", {})["separation_path"] = \
                separation_launches[kernel["name"]]
        torch.cuda.empty_cache()
        enhancement_launches = run_enhancement_path(
            os.path.join(out_dir, "enhancement"))
        for kernel in kernels:
            kernel["launches_by_path"]["enhancement_path"] = \
                enhancement_launches[kernel["name"]]
        torch.cuda.empty_cache()
        gan_launches, gan_b3_launches, gan_b3_err = run_gan_path(
            os.path.join(out_dir, "gan"))
        for kernel in kernels:
            kernel["launches_by_path"]["gan_path"] = \
                gan_launches[kernel["name"]]
        kernels[1]["launches_by_path"]["gan_path_by_stage"] = gan_b3_launches
        torch.cuda.empty_cache()
        frame_launches, frame_b3_err = run_frame_path(
            os.path.join(out_dir, "frame"))
        for kernel in kernels:
            kernel["launches_by_path"]["frame_path"] = \
                frame_launches[kernel["name"]]
        torch.cuda.empty_cache()
        ssl_launches, ssl_b3_err = run_ssl_path(os.path.join(out_dir, "ssl"))
        for kernel in kernels:
            kernel["launches_by_path"]["ssl_path"] = \
                ssl_launches[kernel["name"]]
        torch.cuda.empty_cache()
        rescore_launches = run_rescore_path(os.path.join(out_dir, "rescore"))
        for kernel in kernels:
            kernel["launches_by_path"]["rescore_path"] = \
                rescore_launches[kernel["name"]]
        torch.cuda.empty_cache()
        if args.profile:
            profile_train(TRAIN, out_dir, datasets, host=True)
    with tempfile.TemporaryDirectory() as serve_dir:
        served = run_serve_path(NORTH, serve_dir)
    torch.cuda.empty_cache()
    if args.profile:
        profile_serve(NORTH)
    for kernel in kernels:
        by_path = kernel.setdefault("launches_by_path", {})
        by_path["serve_path"] = {run: counts[kernel["name"]]
                                 for run, counts in served.items()}
    kernels[1]["at_recipe_shape"] = measure_b3_at(
        CONFORMER_LARGE["batch_size"], recipe.SIG_PAD_MULTIPLE)
    kernels[1]["at_crdnn_shape"] = measure_b3_at(
        NORTH["batch"], int(SR * NORTH["seconds"]),
        n_mels=CRDNN_CFG["n_mels"])
    kernels[1]["at_transducer_train_shape"] = measure_b3_at(*rnnt_batch)
    kernels[1]["at_streaming_shape"] = measure_b3_at(*stream_shape)
    kernels[1]["at_streaming_file_shape"] = measure_b3_at(*stream_file_shape)
    for (B, T, n_mels), key in zip(SPEAKER_B3_SHAPES, (
            "at_speaker_train_shape", "at_speech_commands_24_mels")):
        kernels[1][key] = {**measure_b3_at(B, T, n_mels=n_mels),
                           "n_mels": n_mels,
                           "max_abs_err": speaker_b3_err[f"{B}x{T}@{n_mels}"]}
    B, T, n_mels = GAN_B3_SHAPES[0]
    kernels[1]["at_gan_pretrain_perceptual_shape"] = {
        **measure_b3_at(B, T, n_mels=n_mels), "n_mels": n_mels,
        "max_abs_err": gan_b3_err[f"{B}x{T}@{n_mels}"]}
    for (B, T, n_mels), key in zip(FRAME_B3_SHAPES, (
            "at_frame_vad_shape", "at_frame_window_shape")):
        kernels[1][key] = {**measure_b3_at(B, T, n_mels=n_mels),
                           "n_mels": n_mels,
                           "max_abs_err": frame_b3_err[f"{B}x{T}@{n_mels}"]}
    for B, T, n_mels in SSL_B3_SHAPES:
        kernels[1]["at_bestrq_shape"] = {
            **measure_b3_at(B, T, n_mels=n_mels), "n_mels": n_mels,
            "max_abs_err": ssl_b3_err[f"{B}x{T}@{n_mels}"]}
    for (B, T, n_mels), key in zip(CLASSIFY_B3_SHAPES, (
            "at_esc50_shape", "at_urbansound8k_shape")):
        kernels[1][key] = {**measure_b3_at(B, T, n_mels=n_mels),
                           "n_mels": n_mels,
                           "max_abs_err": classify_b3_err[f"{B}x{T}@{n_mels}"]}
    emit({"phase": "script", "seconds": time.perf_counter() - t_script,
          "gpu_name_power_limit": smi})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
