"""HyperPyYAML hyperparameter files (port of
``speechbrain_tpu/utils/hyperyaml.py``), on PyYAML.

The tags recipes use:

* ``!new:pkg.Class`` — instantiate an object (mapping or sequence args)
* ``!name:pkg.fn``   — a partial / class reference (no call)
* ``!module:pkg``    — import and return a module
* ``!apply:pkg.fn``  — call at load time and store the result
* ``!ref <key>``     — reference another key; supports nested
  ``<enc[layer][0]>`` access, arithmetic (``!ref <a> * 2``) and string
  interpolation (``!ref <folder>/save``)
* ``!copy <key>``    — deep copy of a reference
* ``!tuple (a, b)``  — python tuple
* ``!PLACEHOLDER``   — must be overridden
* ``!include:file.yaml`` — splice another yaml file

Two ``!ref`` to the same ``!new:`` node yield the *same* instance.
Overrides are applied before resolution and may themselves use tags.
Keys starting with ``__`` are resolved in file order, for their effect,
and left out of the result, as HyperPyYAML does (the JAX package's loader
skips them unresolved, so a ``__set_seed`` never runs there).

PyYAML is imported by the functions that parse or write YAML, never when
this module is imported: machines without it can import the package and
build hyperparameters in Python. ``_import_target`` chains the first
import error it met, so that an error inside a module names its cause.
"""

import copy
import functools
import importlib
import re
from io import StringIO

__all__ = ["load_hyperpyyaml", "resolve_yaml", "deref", "RefTag", "Placeholder"]


# ---------------------------------------------------------------------------
# Tag node classes (parse stage)
# ---------------------------------------------------------------------------

class _TagNode:
    pass


class NewTag(_TagNode):
    """!new: instantiate a class with args/kwargs."""
    def __init__(self, target, args, kwargs):
        self.target = target
        self.args = args
        self.kwargs = kwargs


class NameTag(_TagNode):
    """!name: partial-apply a callable."""
    def __init__(self, target, args, kwargs):
        self.target = target
        self.args = args
        self.kwargs = kwargs


class ApplyTag(_TagNode):
    """!apply: call a callable immediately."""
    def __init__(self, target, args, kwargs):
        self.target = target
        self.args = args
        self.kwargs = kwargs


class ModuleTag(_TagNode):
    """!module: import a module by dotted path."""
    def __init__(self, target):
        self.target = target


class RefTag(_TagNode):
    """!ref: reference another yaml node (with arithmetic)."""
    def __init__(self, expression, do_copy=False):
        self.expression = expression
        self.do_copy = do_copy


class TupleTag(_TagNode):
    """!tuple: build a python tuple."""
    def __init__(self, text):
        self.text = text


class IncludeTag(_TagNode):
    """!include:file.yaml — load another hparams file as a sub-scope.

    The optional mapping value provides overrides whose tags resolve in
    the PARENT scope (the reference's recipe idiom,
    e.g. ref recipes/WHAMandWHAMR/enhancement/hparams/
    cnntransformer-wham-DM.yaml:141 ``MaskNet: !include:models/
    CNNTransformer.yaml`` with ``N_fft: !ref <N_fft>``). The included
    file's own ``!ref``s resolve in its own scope, after overrides."""

    def __init__(self, path, overrides):
        self.path = path
        self.overrides = overrides


class Placeholder(_TagNode):
    """!PLACEHOLDER: must be overridden before load."""
    pass


# ---------------------------------------------------------------------------
# YAML loader with multi-constructors
# ---------------------------------------------------------------------------

def _make_loader(base_dir=None):
    import yaml

    class HyperLoader(yaml.SafeLoader):
        pass

    HyperLoader.hyperyaml_base_dir = base_dir

    def construct_args(loader, node):
        if isinstance(node, yaml.MappingNode):
            kwargs = loader.construct_mapping(node, deep=True)
            return [], kwargs
        if isinstance(node, yaml.SequenceNode):
            return loader.construct_sequence(node, deep=True), {}
        value = loader.construct_scalar(node)
        if value is None or value == "":
            return [], {}
        return [value], {}

    def new_constructor(loader, suffix, node):
        args, kwargs = construct_args(loader, node)
        return NewTag(suffix, args, kwargs)

    def name_constructor(loader, suffix, node):
        args, kwargs = construct_args(loader, node)
        return NameTag(suffix, args, kwargs)

    def apply_constructor(loader, suffix, node):
        args, kwargs = construct_args(loader, node)
        return ApplyTag(suffix, args, kwargs)

    def module_constructor(loader, suffix, node):
        return ModuleTag(suffix)

    def ref_constructor(loader, node):
        return RefTag(loader.construct_scalar(node))

    def copy_constructor(loader, node):
        return RefTag(loader.construct_scalar(node), do_copy=True)

    def tuple_constructor(loader, node):
        return TupleTag(loader.construct_scalar(node))

    def placeholder_constructor(loader, node):
        return Placeholder()

    def include_constructor(loader, suffix, node):
        import os

        path = suffix
        base = getattr(loader, "hyperyaml_base_dir", None)
        if base and not os.path.isabs(path):
            path = os.path.join(base, path)
        overrides = {}
        if isinstance(node, yaml.MappingNode):
            overrides = loader.construct_mapping(node, deep=True)
        return IncludeTag(path, overrides)

    HyperLoader.add_multi_constructor("!new:", new_constructor)
    HyperLoader.add_multi_constructor("!name:", name_constructor)
    HyperLoader.add_multi_constructor("!apply:", apply_constructor)
    HyperLoader.add_multi_constructor("!module:", module_constructor)
    HyperLoader.add_multi_constructor("!include:", include_constructor)
    HyperLoader.add_constructor("!ref", ref_constructor)
    HyperLoader.add_constructor("!copy", copy_constructor)
    HyperLoader.add_constructor("!tuple", tuple_constructor)
    HyperLoader.add_constructor("!PLACEHOLDER", placeholder_constructor)
    return HyperLoader


_REF_PATTERN = re.compile(r"<([^>]*)>")


def _import_target(target):
    """Import ``pkg.mod.attr`` (attr may be nested)."""
    parts = target.split(".")
    first_error = None
    for split in range(len(parts) - 1, 0, -1):
        try:
            module = importlib.import_module(".".join(parts[:split]))
        except ImportError as e:
            first_error = first_error or e
            continue
        obj = module
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
        except AttributeError as e:
            first_error = first_error or e
            continue
        return obj
    # maybe it's a bare module
    try:
        return importlib.import_module(target)
    except ImportError as e:
        raise ImportError(f"Cannot import {target}") from (first_error or e)


class _Resolver:
    """Resolves a parsed tag-tree into live python objects with shared-ref
    memoization (two refs to one !new: node give the same instance)."""

    def __init__(self, root):
        self.root = root
        self.memo = {}

    def resolve(self, node):
        node_id = id(node)
        if node_id in self.memo:
            return self.memo[node_id]
        result = self._resolve_uncached(node)
        self.memo[node_id] = result
        return result

    def _resolve_uncached(self, node):
        if isinstance(node, dict):
            return {k: self.resolve(v) for k, v in node.items()}
        if isinstance(node, list):
            return [self.resolve(v) for v in node]
        if isinstance(node, NewTag):
            cls = _import_target(node.target)
            args = [self.resolve(a) for a in node.args]
            kwargs = {k: self.resolve(v) for k, v in node.kwargs.items()}
            return cls(*args, **kwargs)
        if isinstance(node, NameTag):
            fn = _import_target(node.target)
            args = [self.resolve(a) for a in node.args]
            kwargs = {k: self.resolve(v) for k, v in node.kwargs.items()}
            if args or kwargs:
                return functools.partial(fn, *args, **kwargs)
            return fn
        if isinstance(node, ApplyTag):
            fn = _import_target(node.target)
            args = [self.resolve(a) for a in node.args]
            kwargs = {k: self.resolve(v) for k, v in node.kwargs.items()}
            return fn(*args, **kwargs)
        if isinstance(node, ModuleTag):
            return importlib.import_module(node.target)
        if isinstance(node, RefTag):
            value = self._resolve_ref_expression(node.expression)
            return copy.deepcopy(value) if node.do_copy else value
        if isinstance(node, IncludeTag):
            import os

            import yaml

            # override values resolve in the PARENT scope first
            overrides = {
                k: self.resolve(v) for k, v in node.overrides.items()
            }
            loader = _make_loader(base_dir=os.path.dirname(node.path))
            with open(node.path, encoding="utf-8") as f:
                subtree = yaml.load(f, Loader=loader)
            if not isinstance(subtree, dict):
                return subtree
            subtree.update(overrides)
            return _resolve_tree(subtree)
        if isinstance(node, TupleTag):
            # literal_eval handles NESTED tuples — e.g. HiFiGAN's
            # resblock_dilation_sizes ((1, 3, 5), (1, 3, 5)) — which a
            # flat comma split would shred into strings
            import ast

            text = node.text.strip()
            try:
                value = ast.literal_eval(text)
                return value if isinstance(value, tuple) else (value,)
            except (ValueError, SyntaxError):
                import yaml

                inner = text
                if inner.startswith("(") and inner.endswith(")"):
                    inner = inner[1:-1]
                return tuple(
                    yaml.safe_load(part.strip())
                    for part in inner.split(",") if part.strip()
                )
        if isinstance(node, Placeholder):
            raise ValueError(
                "A !PLACEHOLDER value was not overridden. Provide it via "
                "overrides or the command line."
            )
        return node

    def _lookup(self, path):
        """Look up ``a[b][0]`` or ``a.b`` style paths in the raw tree."""
        # split into segments: name then [key] accessors
        m = re.match(r"^([^\[\]\.]+)((\[[^\[\]]+\])*|(\.[^\[\]\.]+)*)$", path.strip())
        if not m:
            raise KeyError(f"Cannot parse reference path: {path}")
        base = m.group(1)
        node = self.root[base]
        rest = path.strip()[len(base):]
        for seg in re.findall(r"\[([^\[\]]+)\]|\.([^\[\]\.]+)", rest):
            key = seg[0] or seg[1]
            node = self._index(node, key)
        return node

    def _index(self, node, key):
        resolved = self.resolve(node)
        try:
            return resolved[key]
        except (TypeError, KeyError):
            try:
                return resolved[int(key)]
            except (TypeError, ValueError, KeyError, IndexError):
                return getattr(resolved, key)

    def _resolve_ref_expression(self, expression):
        expr = expression.strip()
        # single pure reference: return the object itself (any type)
        single = _REF_PATTERN.fullmatch(expr)
        if single:
            return self.resolve(self._lookup(single.group(1)))

        # substitute each <path> with its resolved value
        values = []

        def sub(m):
            val = self.resolve(self._lookup(m.group(1)))
            values.append(val)
            return repr(val) if isinstance(val, (int, float)) else str(val)

        substituted = _REF_PATTERN.sub(sub, expr)
        all_numeric = values and all(
            isinstance(v, (int, float)) and not isinstance(v, bool) for v in values
        )
        if all_numeric and re.fullmatch(r"[\d\s\.\+\-\*\/\(\)eE%]+", substituted):
            try:
                result = eval(  # arithmetic only: guarded by the regex above
                    substituted, {"__builtins__": {}}, {}
                )
                if isinstance(result, float) and result.is_integer() and "/" not in expr:
                    return int(result)
                return result
            except Exception:
                pass
        return substituted


def _apply_overrides(tree, overrides, must_match=True):
    import yaml

    loader = _make_loader()
    if isinstance(overrides, str):
        overrides = yaml.load(overrides, Loader=loader) or {}
    for key, value in (overrides or {}).items():
        if isinstance(value, str) and (
            value.startswith("!") or "<" in value and ">" in value
        ):
            value = yaml.load(value, Loader=loader)
        _set_path(tree, key, value)
    return tree


def _set_path(tree, key, value):
    parts = key.split(".")
    node = tree
    for p in parts[:-1]:
        node = node[p]
    node[parts[-1]] = value


def load_hyperpyyaml(yaml_stream, overrides=None, overrides_must_match=True,
                     base_dir=None):
    """Load HyperPyYAML: returns a dict of resolved, instantiated objects.
    A relative ``!include:`` path is taken from ``base_dir``, else from
    the stream's file's folder, else from the working directory.

    Example
    -------
    >>> import io
    >>> out = load_hyperpyyaml(io.StringIO('''
    ... n: 40
    ... double: !ref <n> * 2
    ... path: !ref results/<n>
    ... '''))
    >>> out["double"], out["path"]
    (80, 'results/40')
    """
    import os

    import yaml

    if isinstance(yaml_stream, str):
        yaml_stream = StringIO(yaml_stream)

    name = getattr(yaml_stream, "name", None)
    if base_dir is None and name:
        base_dir = os.path.dirname(name)
    loader = _make_loader(base_dir=None if base_dir is None
                          else str(base_dir))
    tree = yaml.load(yaml_stream, Loader=loader)
    if tree is None:
        return {}
    if overrides:
        _apply_overrides(tree, overrides, overrides_must_match)
    return _resolve_tree(tree)


def _resolve_tree(tree):
    """Resolve every top-level key in file order; keys starting with
    ``__`` are resolved for their effect (``__set_seed: !apply:...``) and
    left out of the result."""
    resolver = _Resolver(tree)
    resolved = {}
    for key, node in tree.items():
        value = resolver.resolve(node)
        if not str(key).startswith("__"):
            resolved[key] = value
    return resolved


def resolve_yaml(yaml_string, overrides=None):
    """Return the yaml text with overrides applied (for freezing into the
    experiment directory). Objects are not instantiated."""
    if not overrides:
        return yaml_string
    # textual top-level key replacement keeps tags intact
    lines = yaml_string.splitlines()
    done = set()
    for key, value in overrides.items():
        if "." in key:
            continue  # nested overrides are recorded as a trailer
        pattern = re.compile(rf"^{re.escape(key)}\s*:")
        for i, line in enumerate(lines):
            if line is None:  # removed block line from a prior override
                continue
            if pattern.match(line):
                # replace scalar value; block values are replaced wholesale
                indent_next = i + 1
                while indent_next < len(lines) and (
                    lines[indent_next].startswith((" ", "\t"))
                    or not lines[indent_next].strip()
                ):
                    lines[indent_next] = None
                    indent_next += 1
                lines[i] = f"{key}: {_to_yaml_value(value)}"
                done.add(key)
                break
    lines = [ln for ln in lines if ln is not None]
    trailer = [
        f"{key}: {_to_yaml_value(value)}"
        for key, value in overrides.items()
        if key not in done and "." not in key
    ]
    return "\n".join(lines + trailer) + "\n"


def _to_yaml_value(value):
    import yaml

    if isinstance(value, str) and value.startswith("!"):
        return value
    text = yaml.safe_dump(value, default_flow_style=True).strip()
    # a scalar is dumped as a document of its own, "value\n...": the end
    # marker would end the resolved file there (the JAX package writes it)
    return text[:-len("\n...")] if text.endswith("\n...") else text


def deref(ref, full_tree):
    """Resolve one !ref expression against a raw tree (utility)."""
    return _Resolver(full_tree)._resolve_ref_expression(ref.expression)
