"""The port's hyperparameter files and command lines against the JAX
package's: ``utils/hyperyaml.py`` (every tag, overrides, ``!include``,
shared instances, ``resolve_yaml``, ``deref``) and ``core.py``
``parse_arguments``, whose scalars the port parses without PyYAML. The
same text gives equal trees of plain values on both sides; a scalar on the
command line means what ``yaml.safe_load`` says it means. Exact: the
values are numbers, strings and containers.

Two differences are deliberate (``ROADMAP.md`` Queue C): keys starting
with ``__`` are resolved for their effect in the port (JAX skips them, so
its ``__set_seed`` never runs), and the port's ``resolve_yaml`` writes no
document-end marker after an overridden scalar (JAX's file does not load
again)."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import fractions
import functools
import math
import sys
import textwrap

import pytest
import torch
import yaml

from speechbrain_tpu.core import parse_arguments as jax_parse_arguments
from speechbrain_tpu.utils import hyperyaml as jax_hyperyaml
from speechbrain_tpu_torch.core import _parse_scalar, parse_arguments
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.utils import hyperyaml

SUB = """\
width: 3
scale: !PLACEHOLDER
area: !ref <width> * <scale>
label: !ref w<width>
__hidden: 5
"""

MAIN = """\
seed: 7
n: 40
half: !ref <n> / 2
double: !ref <n> * 2
mixed: !ref (<n> + 2) * <half> - 1
ratio: !ref <n> / 8
folder: !PLACEHOLDER
save: !ref <folder>/save/<n>
pairs: !tuple (1, 2)
nested: !tuple ((1, 3), (2, 4))
words: !tuple (a, b, 3.5)
frac: !new:fractions.Fraction
    numerator: !ref <n>
    denominator: 6
frac_args: !new:fractions.Fraction [3, 9]
same_frac: !ref <frac>
triple: !name:operator.mul [3]
rounded: !name:builtins.round
    ndigits: 1
just_fn: !name:math.floor
math_mod: !module:math
root: !apply:math.sqrt [!ref <n>]
table:
    rows: [!ref <n>, 2, {deep: [10, 20, !ref <half>]}]
    name: !ref <folder>
picked: !ref <table[rows][2][deep][1]>
dotted: !ref <table.name>
frac_num: !ref <frac.numerator>
copied: !copy <table>
flag: true
nothing: null
sub: !include:sub.yaml
    scale: !ref <n>
"""

OVERRIDES = {"folder": "results/x", "n": 12, "flag": False,
             "extra": "!ref <n> * 3", "table.name": "renamed"}


def _plain(value):
    """A tree of plain values: containers recursively, an object as its
    type and value, a partial as its function and arguments, a module as
    its name."""
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(v) for v in value)
    if isinstance(value, functools.partial):
        return ("partial", value.func.__name__, _plain(value.args),
                _plain(value.keywords))
    if isinstance(value, type(math)):
        return ("module", value.__name__)
    if callable(value):
        return ("callable", value.__name__)
    if isinstance(value, fractions.Fraction):
        return ("Fraction", value.numerator, value.denominator)
    return value


@pytest.fixture()
def files(tmp_path):
    (tmp_path / "sub.yaml").write_text(SUB)
    (tmp_path / "main.yaml").write_text(MAIN)
    return tmp_path


def _load(module, path, overrides):
    with open(path) as f:
        return module.load_hyperpyyaml(f, overrides)


@pytest.mark.parametrize("overrides", [
    {"folder": "results/x"}, OVERRIDES,
    "folder: out\nn: 8\nframe: !tuple (5, 6)",
], ids=["placeholder_only", "dict", "yaml_text"])
def test_every_tag_loads_to_equal_trees(files, overrides):
    jax_tree = _load(jax_hyperyaml, files / "main.yaml", overrides)
    tree = _load(hyperyaml, files / "main.yaml", overrides)
    assert _plain(tree) == _plain(jax_tree)
    assert tree["same_frac"] is tree["frac"]
    assert tree["copied"] == tree["table"]
    assert tree["copied"] is not tree["table"]
    assert "__hidden" not in tree["sub"]
    assert tree["sub"]["area"] == tree["sub"]["width"] * tree["n"]


def test_some_values_by_hand(files):
    tree = _load(hyperyaml, files / "main.yaml", OVERRIDES)
    assert (tree["half"], tree["double"], tree["mixed"]) == (6.0, 24, 83.0)
    assert tree["save"] == "results/x/save/12"
    assert tree["nested"] == ((1, 3), (2, 4))
    assert tree["words"] == ("a", "b", 3.5)
    assert tree["picked"] == 20 and tree["dotted"] == "renamed"
    assert tree["triple"](3) == 9 and tree["rounded"](3.14159) == 3.1
    assert tree["root"] == math.sqrt(12)
    assert tree["extra"] == 36 and tree["flag"] is False
    assert tree["sub"] == {"width": 3, "scale": 12, "area": 36,
                           "label": "w3"}


def test_a_placeholder_left_raises_on_both_sides(files):
    for module in (jax_hyperyaml, hyperyaml):
        with pytest.raises(ValueError, match="PLACEHOLDER"):
            _load(module, files / "main.yaml", None)


def test_new_builds_a_port_class_on_the_cpu_once():
    text = textwrap.dedent("""\
        device: cuda
        seed: 3
        __set_seed: !apply:speechbrain_tpu_torch.utils.seed.seed_everything [!ref <seed>]
        head: !new:speechbrain_tpu_torch.nnet.linear.Linear
            n_neurons: 4
            input_size: 6
            device: !ref <device>
        modules:
            head: !ref <head>
        also: !ref <head>
        """)
    a = hyperyaml.load_hyperpyyaml(text, {"device": "cpu"})
    b = hyperyaml.load_hyperpyyaml(text, {"device": "cpu"})
    assert isinstance(a["head"], Linear)
    assert a["head"].weight.device.type == "cpu"
    assert a["modules"]["head"] is a["head"] is a["also"]
    # __set_seed ran before the weights were drawn: one seed, one set
    torch.testing.assert_close(a["head"].weight, b["head"].weight,
                               rtol=0, atol=0)
    c = hyperyaml.load_hyperpyyaml(text, {"device": "cpu", "seed": 4})
    assert not torch.equal(a["head"].weight, c["head"].weight)
    assert "__set_seed" not in a


def test_an_import_error_inside_a_module_names_its_cause(tmp_path,
                                                          monkeypatch):
    (tmp_path / "broken_module_for_yaml.py").write_text(
        "import a_package_that_is_not_there\nclass Thing:\n    pass\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    with pytest.raises(ImportError, match="Cannot import") as info:
        hyperyaml.load_hyperpyyaml("x: !new:broken_module_for_yaml.Thing")
    assert "a_package_that_is_not_there" in str(info.value.__cause__)
    sys.modules.pop("broken_module_for_yaml", None)


def test_resolve_yaml_and_deref(files):
    text = (files / "main.yaml").read_text()
    assert hyperyaml.resolve_yaml(text) == jax_hyperyaml.resolve_yaml(text)
    overrides = {"folder": "out", "n": 12, "new_key": [1, 2]}
    resolved = hyperyaml.resolve_yaml(text, overrides)
    jax_lines = [ln for ln in jax_hyperyaml.resolve_yaml(
        text, overrides).splitlines() if ln != "..."]
    assert resolved.splitlines() == jax_lines
    (files / "resolved.yaml").write_text(resolved)
    tree = _load(hyperyaml, files / "resolved.yaml", None)
    assert (tree["folder"], tree["n"], tree["new_key"]) == ("out", 12,
                                                            [1, 2])
    assert tree["save"] == "out/save/12"
    raw = yaml.load(text.replace("!PLACEHOLDER", "out"),
                    Loader=hyperyaml._make_loader())
    jax_raw = yaml.load(text.replace("!PLACEHOLDER", "out"),
                        Loader=jax_hyperyaml._make_loader())
    assert hyperyaml.deref(raw["save"], raw) == jax_hyperyaml.deref(
        jax_raw["save"], jax_raw) == "out/save/40"


COMMAND_LINES = [
    ["h.yaml"],
    ["h.yaml", "--debug"],
    ["h.yaml", "--debug", "--device=cpu", "--data_folder=/data/x"],
    ["h.yaml", "--lr_adam=0.0008", "--lr_small=8e-4", "--n=12"],
    ["h.yaml", "--batch_size", "4", "--precision", "bf16"],
    ["h.yaml", "--debug_batches=2", "--debug_epochs=1", "--nhead=4"],
    ["h.yaml", "--flag=yes", "--other=Off", "--none=~", "--empty="],
    ["h.yaml", "--out=results/<seed>", "--seed=3", "--octal=010"],
    ["h.yaml", "--max_grad_norm=5.", "--ckpt_interval_minutes=.5"],
    ["h.yaml", "--big=1_000_000", "--hexa=0x1F", "--time=1:30"],
    ["h.yaml", "--skip_nonfinite_grads", "--grad_accumulation_factor=2"],
]


@pytest.mark.parametrize("argv", COMMAND_LINES,
                         ids=[str(i) for i in range(len(COMMAND_LINES))])
def test_parse_arguments_matches_jax(argv):
    got = parse_arguments(argv)
    assert got == jax_parse_arguments(argv)
    assert all(type(v) is type(w) for a, b in zip(
        got[1:], jax_parse_arguments(argv)[1:])
        for v, w in zip(a.values(), b.values()))


def test_parse_arguments_refuses_a_stray_word():
    with pytest.raises(ValueError, match="Cannot parse"):
        parse_arguments(["h.yaml", "--a=1", "stray", "words"])


SCALARS = [
    "0", "5", "-5", "+7", "010", "09", "0b101", "-0b11", "0x1F", "1_000",
    "1:30", "0.0008", "8e-4", "1.0e-4", "1.e+5", "1e5", ".5", "-.5", "1.",
    "1:30.5", ".inf", "-.inf", "true", "True", "TRUE", "tRue", "yes", "No",
    "on", "OFF", "y", "null", "Null", "~", "", "None", "cpu", "cuda:0",
    "results/<seed>", "1.2.3", "  42  ", "bf16",
]


@pytest.mark.parametrize("text", SCALARS, ids=[repr(s) for s in SCALARS])
def test_parse_scalar_matches_yaml_safe_load(text):
    want = yaml.safe_load(text)
    got = _parse_scalar(text)
    assert type(got) is type(want)
    assert got == want or (math.isnan(got) and math.isnan(want))


def test_parse_scalar_nan():
    assert math.isnan(_parse_scalar(".nan"))
    assert math.isnan(yaml.safe_load(".nan"))
