"""The port stands alone: nothing of it imports JAX, flax or the JAX
package (every module under ``speechbrain_tpu_torch/``, found anew at each
run, and ``chip_smoke.py``); it imports where there is no nvcc, triton,
GPU or PyYAML; and an entry point asked for a CUDA device that is not
there (the serving interfaces included) raises instead of carrying on on
the CPU."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import ast
import importlib
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "speechbrain_tpu_torch"
FORBIDDEN = ("jax", "flax", "speechbrain_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def _import_all_in_a_fresh_interpreter(forbidden):
    """Import every module of the port and chip_smoke in a new
    interpreter; fail if any of ``forbidden`` was loaded."""
    modules = [
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in sorted(PORT.rglob("*.py"))
    ]
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m
               for m in modules] + ["chip_smoke"]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in {tuple(forbidden)!r} if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_every_module_imports_without_toolchain():
    """In a fresh interpreter: import every module of the port and
    chip_smoke, then check that neither JAX nor triton came along."""
    _import_all_in_a_fresh_interpreter(
        ("jax", "flax", "triton", "speechbrain_tpu"))


def test_importing_the_port_loads_no_yaml():
    """The card's machine has no PyYAML: importing every module of the
    port (the YAML loader and the twin recipe included) and chip_smoke
    does not load it; the loader imports PyYAML when it parses."""
    _import_all_in_a_fresh_interpreter(("yaml",))


def _cuda_available():
    return torch.cuda.is_available()


def test_entry_points_default_to_cuda_and_raise_without_it():
    if _cuda_available():
        pytest.skip("this machine has a CUDA device")
    from speechbrain_tpu_torch.lobes.features import Fbank
    from speechbrain_tpu_torch.lobes.models.transformer.Transformer import (
        get_lookahead_mask,
    )
    from speechbrain_tpu_torch.lobes.models.transformer.TransformerLM import (
        TransformerLM,
    )
    from speechbrain_tpu_torch.core import Brain
    from speechbrain_tpu_torch.dataio.batch import PaddedBatch
    from speechbrain_tpu_torch.inference.ASR import (
        EncoderASR,
        EncoderDecoderASR,
    )
    from speechbrain_tpu_torch.nnet.linear import Linear
    from speechbrain_tpu_torch.nnet.transducer_joint import TransducerJoint

    for build in (
        lambda: Fbank(),
        lambda: Linear(4, 4),
        lambda: TransducerJoint(4, 4, 4),
        lambda: TransformerLM(vocab=8, d_model=8, nhead=2,
                              num_encoder_layers=1, d_ffn=8),
        lambda: get_lookahead_mask(4),
        lambda: Brain(modules={"lin": torch.nn.Linear(2, 2)}),
        lambda: PaddedBatch([{"x": torch.ones(2)}]).to(),
        lambda: EncoderDecoderASR(hparams={
            "encoder": torch.nn.Linear(2, 2), "decoder": None,
            "tokenizer": None}),
        lambda: EncoderASR(hparams={
            "encoder": torch.nn.Linear(2, 2), "decoding_function": None,
            "tokenizer": None}),
    ):
        with pytest.raises((RuntimeError, AssertionError)):
            build()


def _speaker_entry_points():
    from speechbrain_tpu_torch.inference.classifiers import (
        EncoderClassifier,
    )
    from speechbrain_tpu_torch.inference.speaker import SpeakerRecognition
    from speechbrain_tpu_torch.lobes.features import Leaf
    from speechbrain_tpu_torch.lobes.models import ECAPA_TDNN, ResNet, Xvector
    from speechbrain_tpu_torch.nnet.CNN import GaborConv1d
    from speechbrain_tpu_torch.nnet.normalization import PCEN
    from speechbrain_tpu_torch.nnet.pooling import (
        AttentionPooling,
        GaussianLowpassPooling,
    )

    lin = torch.nn.Linear(2, 2)
    return {
        "ECAPA_TDNN": lambda: ECAPA_TDNN.ECAPA_TDNN(8, channels=(8,) * 5),
        "ECAPA_Classifier": lambda: ECAPA_TDNN.Classifier(4, 3),
        "Xvector": lambda: Xvector.Xvector(8),
        "Xvector_Classifier": lambda: Xvector.Classifier(4, 3),
        "ResNet": lambda: ResNet.ResNet(8, layers=(1, 1, 1, 1)),
        "Leaf": lambda: Leaf(4),
        "GaborConv1d": lambda: GaborConv1d(4, 9),
        "PCEN": lambda: PCEN(4),
        "GaussianLowpassPooling": lambda: GaussianLowpassPooling(4),
        "AttentionPooling": lambda: AttentionPooling(4),
        "EncoderClassifier": lambda: EncoderClassifier(
            modules={"embedding_model": lin, "classifier": lin}),
        "SpeakerRecognition": lambda: SpeakerRecognition(
            modules={"embedding_model": lin}),
    }


@pytest.mark.parametrize("name", [
    "ECAPA_TDNN", "ECAPA_Classifier", "Xvector", "Xvector_Classifier",
    "ResNet", "Leaf", "GaborConv1d", "PCEN", "GaussianLowpassPooling",
    "AttentionPooling", "EncoderClassifier", "SpeakerRecognition"])
def test_speaker_entry_points_default_to_cuda_and_raise_without_it(name):
    """The speaker family's modules and interfaces are built on the card
    unless asked otherwise, and raise where there is none."""
    if _cuda_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        _speaker_entry_points()[name]()


def _ssl_entry_points():
    from speechbrain_tpu_torch.lobes.models import BESTRQ, wav2vec
    from speechbrain_tpu_torch.nnet import quantisers

    return {
        "W2VLatentExtractor": lambda: wav2vec.W2VLatentExtractor(
            out_channels=(4, 4), kernel_sizes=(3, 3), strides=(2, 2)),
        "W2VTargetQuantiser": lambda: wav2vec.W2VTargetQuantiser(8, 4, 4),
        "GumbelVectorQuantizer": lambda: quantisers.GumbelVectorQuantizer(
            8, num_vars=4, vq_dim=4),
        "RandomProjectionQuantizer":
            lambda: quantisers.RandomProjectionQuantizer(8, 4, 16),
        "w2v_mask": lambda: wav2vec.w2v_mask((2, 20), 0.2, 4),
        "brq_mask": lambda: BESTRQ.brq_mask((2, 20), 0.2, 4),
    }


# the SSL slice's modules, among the files test_no_jax_imports reads
SSL_FILES = (
    "nnet/quantisers.py", "lobes/models/wav2vec.py", "lobes/models/BESTRQ.py",
    "lobes/models/fairseq_wav2vec.py", "dataio/dataio.py",
    "recipes/LibriSpeech/self-supervised-learning/wav2vec2/"
    "train_sb_wav2vec2.py",
    "recipes/LibriSpeech/self-supervised-learning/BEST-RQ/train.py",
    "recipes/LibriSpeech/ASR/CTC/train_with_bestrq.py",
    "recipes/LibriSpeech/ASR/CTC/train_with_wav2vec.py",
    "recipes/Libri-Light/self-supervised-learning/wav2vec2/train.py",
    "recipes/Libri-Light/self-supervised-learning/BEST-RQ/train.py",
    "recipes/CommonVoice/self-supervised-learning/wav2vec2/"
    "train_hf_wav2vec2.py",
    "recipes/DVoice/ASR/CTC/train_with_wav2vec2.py",
    "recipes/DVoice/ASR/CTC/prepare.py",
)


@pytest.mark.parametrize("name", [
    "W2VLatentExtractor", "W2VTargetQuantiser", "GumbelVectorQuantizer",
    "RandomProjectionQuantizer", "w2v_mask", "brq_mask"])
def test_ssl_entry_points_default_to_cuda_and_raise_without_it(name):
    """The SSL modules and samplers build and draw on the card unless asked
    otherwise, and raise where there is none; their files are among those
    the import checks read."""
    assert set(PORT / f for f in SSL_FILES) <= set(_port_files())
    if _cuda_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        _ssl_entry_points()[name]()


def test_searcher_refuses_states_off_its_device():
    from speechbrain_tpu_torch.decoders.seq2seq import S2SKVBeamSearcher

    searcher = S2SKVBeamSearcher(
        None, None, bos_index=1, eos_index=2, min_decode_ratio=0.0,
        max_decode_ratio=1.0, beam_size=2,
    )
    assert searcher.device.type == "cuda"
    with pytest.raises(ValueError, match="runs on cuda"):
        searcher(torch.zeros(1, 4, 8), torch.ones(1))


def test_chip_smoke_fails_without_a_card():
    if _cuda_available():
        pytest.skip("this machine has a CUDA device")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises; it does not give way to anything."""
    import shutil

    from speechbrain_tpu_torch.ops import _build

    if shutil.which("nvcc") or pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_library()
    assert importlib.import_module("speechbrain_tpu_torch.ops._build")


def _classifier_entry_points():
    from speechbrain_tpu_torch.inference.classifiers import AudioClassifier
    from speechbrain_tpu_torch.inference.SLU import EndToEndSLU
    from speechbrain_tpu_torch.lobes.models import PIQ, Cnn14, focalnet, vit

    lin = torch.nn.Linear(2, 2)
    return {
        "Cnn14": lambda: Cnn14.Cnn14(mel_bins=32, emb_dim=8,
                                     base_channels=2),
        "Conv2dEncoder_v2": lambda: PIQ.Conv2dEncoder_v2(dim=4),
        "ResBlockAudio": lambda: PIQ.ResBlockAudio(4),
        "ViTEncoder": lambda: vit.ViTEncoder(d_model=8, nhead=2,
                                             num_layers=1, d_ffn=8,
                                             max_patches=8),
        "FocalNetEncoder": lambda: focalnet.FocalNetEncoder(
            8, hidden_dims=(8,), downscale_factors=(2,)),
        "FocalEncoder": lambda: focalnet.FocalEncoder(8, 4, (8,), (1,)),
        "FocalDecoder": lambda: focalnet.FocalDecoder(4, 8, (8,), (1,)),
        "AudioClassifier": lambda: AudioClassifier(
            modules={"embedding_model": lin, "classifier": lin}),
        "EndToEndSLU": lambda: EndToEndSLU(hparams={
            "tokenizer": None, "slu_enc": lin, "beam_searcher": lin}),
    }


@pytest.mark.parametrize("name", [
    "Cnn14", "Conv2dEncoder_v2", "ResBlockAudio", "ViTEncoder",
    "FocalNetEncoder", "FocalEncoder", "FocalDecoder", "AudioClassifier",
    "EndToEndSLU"])
def test_classifier_entry_points_default_to_cuda_and_raise_without_it(name):
    """The audio classifiers and the classification and SLU interfaces
    are built on the card unless asked otherwise, and raise where there
    is none."""
    if _cuda_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        _classifier_entry_points()[name]()


def _separation_entry_points():
    from speechbrain_tpu_torch.inference.separation import (
        SepformerSeparation,
    )
    from speechbrain_tpu_torch.lobes.models import (
        conv_tasnet,
        dual_path,
        resepformer,
    )
    from speechbrain_tpu_torch.nnet.CNN import ConvTranspose1d
    from speechbrain_tpu_torch.nnet.normalization import GroupNorm

    lin = torch.nn.Linear(2, 2)
    return {
        "GroupNorm": lambda: GroupNorm(8, num_groups=1),
        "ConvTranspose1d": lambda: ConvTranspose1d(1, 4, in_channels=8),
        "SepformerWrapper": lambda: dual_path.SepformerWrapper(
            encoder_out_nchannels=8, masknet_chunksize=4,
            masknet_numlayers=1, intra_numlayers=1, inter_numlayers=1,
            intra_nhead=2, inter_nhead=2, intra_dffn=8, inter_dffn=8),
        "DPRNN": lambda: dual_path.SepformerWrapper(
            encoder_out_nchannels=8, masknet_numlayers=1, intra_numlayers=1,
            inter_numlayers=1, block_type="rnn", rnn_hidden=4),
        "RESepformerWrapper": lambda: resepformer.RESepformerWrapper(
            encoder_out_nchannels=8, masknet_chunksize=4, nhead=2, d_ffn=8),
        "SkiM": lambda: resepformer.RESepformerWrapper(
            encoder_out_nchannels=8, masknet_chunksize=4, mem_type="hc",
            seg_model="lstm"),
        "ConvTasNetWrapper": lambda: conv_tasnet.ConvTasNetWrapper(
            N=8, B=4, H=8, X=1, R=1),
        "BinauralConvTasNetWrapper": lambda:
            conv_tasnet.BinauralConvTasNetWrapper(N=8, B=4, H=8, X=1, R=1,
                                                  mode="cross"),
        "SepformerSeparation": lambda: SepformerSeparation(
            modules={"masknet": lin}),
    }


@pytest.mark.parametrize("name", [
    "GroupNorm", "ConvTranspose1d", "SepformerWrapper", "DPRNN",
    "RESepformerWrapper", "SkiM", "ConvTasNetWrapper",
    "BinauralConvTasNetWrapper", "SepformerSeparation"])
def test_separation_entry_points_default_to_cuda_and_raise_without_it(name):
    """The separation modules and ``SepformerSeparation`` are built on the
    card unless asked otherwise, and raise where there is none."""
    if _cuda_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        _separation_entry_points()[name]()


def _enhancement_entry_points():
    from speechbrain_tpu_torch.inference.enhancement import (
        SpectralMaskEnhancement,
        WaveformEnhancement,
    )
    from speechbrain_tpu_torch.lobes.models import MaskingSE
    from speechbrain_tpu_torch.lobes.models.EnhanceResnet import (
        EnhanceResnet,
    )
    from speechbrain_tpu_torch.lobes.models.transformer.TransformerSE import (
        CNNTransformerSE,
    )
    from speechbrain_tpu_torch.nnet.normalization import InstanceNorm1d
    from speechbrain_tpu_torch.processing.features import ISTFT, STFT
    from speechbrain_tpu_torch.processing.signal_processing import (
        notch_filter,
    )

    lin = torch.nn.Linear(2, 2)
    return {
        "InstanceNorm1d": lambda: InstanceNorm1d(4, affine=True),
        "STFT": lambda: STFT(16000),
        "ISTFT": lambda: ISTFT(16000),
        "notch_filter": lambda: notch_filter(0.25),
        "WaveFCNMapper": lambda: MaskingSE.WaveFCNMapper(4, 1, 5),
        "BLSTMMasker": lambda: MaskingSE.BLSTMMasker(9, 4, 1, 4),
        "FCN2DMasker": lambda: MaskingSE.FCN2DMasker(9, 2, 1, (3, 3)),
        "FCN2DBLSTMMasker": lambda: MaskingSE.FCN2DBLSTMMasker(
            9, 2, 1, (3, 3), 4, 1, 4),
        "CNNTransformerSE": lambda: CNNTransformerSE(
            d_model=8, num_layers=1, nhead=2, d_ffn=8, output_size=9),
        "EnhanceResnet": lambda: EnhanceResnet(9, channels=(2,),
                                               blocks_per_stage=1),
        "SpectralMaskEnhancement": lambda: SpectralMaskEnhancement(
            modules={"enhance_model": lin},
            hparams={"compute_stft": None, "compute_istft": None}),
        "WaveformEnhancement": lambda: WaveformEnhancement(
            modules={"enhance_model": lin}),
    }


@pytest.mark.parametrize("name", [
    "InstanceNorm1d", "STFT", "ISTFT", "notch_filter", "WaveFCNMapper",
    "BLSTMMasker", "FCN2DMasker", "FCN2DBLSTMMasker", "CNNTransformerSE",
    "EnhanceResnet", "SpectralMaskEnhancement", "WaveformEnhancement"])
def test_enhancement_entry_points_default_to_cuda_and_raise_without_it(name):
    """The enhancement modules, the STFT pair, the notch filter and both
    enhancement interfaces are built on the card unless asked otherwise,
    and raise where there is none."""
    if _cuda_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        _enhancement_entry_points()[name]()


def _gan_entry_points():
    from speechbrain_tpu_torch.lobes.models import (
        MetricGAN,
        MetricGAN_U,
        segan_model,
    )

    return {
        "segan_Generator": lambda: segan_model.Generator(channels=(4, 8)),
        "segan_Discriminator": lambda: segan_model.Discriminator(
            channels=(4, 8)),
        "LearnableSigmoid": lambda: MetricGAN.LearnableSigmoid(4),
        "EnhancementGenerator": lambda: MetricGAN.EnhancementGenerator(
            4, 4, n_freq=9),
        "MetricDiscriminator": lambda: MetricGAN.MetricDiscriminator(
            base_channels=2),
        "MetricDiscriminator_U": lambda: MetricGAN_U.MetricDiscriminator(
            base_channels=2),
    }


@pytest.mark.parametrize("name", [
    "segan_Generator", "segan_Discriminator", "LearnableSigmoid",
    "EnhancementGenerator", "MetricDiscriminator", "MetricDiscriminator_U"])
def test_gan_entry_points_default_to_cuda_and_raise_without_it(name):
    """The GAN models are built on the card unless asked otherwise, and
    raise where there is none."""
    if _cuda_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        _gan_entry_points()[name]()


GAN_MODULES = [
    "speechbrain_tpu_torch.lobes.models.segan_model",
    "speechbrain_tpu_torch.lobes.models.MetricGAN",
    "speechbrain_tpu_torch.lobes.models.MetricGAN_U",
    "speechbrain_tpu_torch.processing.srmr",
    "speechbrain_tpu_torch.recipes.VoiceBank.enhance.SEGAN.train",
    "speechbrain_tpu_torch.recipes.VoiceBank.enhance.MetricGAN.train",
    "speechbrain_tpu_torch.recipes.VoiceBank.enhance.MetricGAN-U.train",
    "speechbrain_tpu_torch.recipes.VoiceBank.enhancement.train",
    "speechbrain_tpu_torch.recipes.VoiceBank.dereverb.MetricGAN-U.train",
    "speechbrain_tpu_torch.recipes.VoiceBank.MTL.ASR_enhance.train",
    "speechbrain_tpu_torch.recipes.RescueSpeech.ASR.noise-robust.train",
]


@pytest.mark.parametrize("module", GAN_MODULES)
def test_gan_modules_are_checked_for_jax_imports(module):
    """The GAN slice's modules (two twin folders named with a hyphen,
    imported by ``importlib``) are among the files the import checks
    above walk, and import here."""
    path = ROOT / (module.replace(".", "/") + ".py")
    assert path in _port_files()
    assert not set(_imported_roots(path)) & set(FORBIDDEN)
    assert importlib.import_module(module)
