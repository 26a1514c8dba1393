"""Declarative data-transform pipelines built on a dependency graph
(a copy of ``speechbrain_tpu/utils/data_pipeline.py``, which imports
nothing of JAX; the port keeps its own): functions declare the keys they
*take* and *provide*; the pipeline orders them and computes only the
requested output keys. It runs on the host, on numpy and Python values;
tensors reach the device at the batch boundary.

Example
-------
>>> lowercase = {"func": lambda t: t.lower(), "takes": ["raw"], "provides": "lower"}
>>> pipeline = DataPipeline(["raw"], dynamic_items=[lowercase], output_keys=["lower"])
>>> pipeline({"raw": "Hello THERE"})
{'lower': 'hello there'}
"""

import inspect

from speechbrain_tpu_torch.utils.depgraph import DependencyGraph


class DynamicItem:
    """A data-transform node: callable with declared inputs and outputs.

    Arguments
    ---------
    takes : list
        Keys of the inputs, in positional order.
    func : callable
        The transform.
    provides : list
        Keys of the outputs.
    """

    def __init__(self, takes=(), func=None, provides=()):
        self.takes = list(takes)
        self.func = func
        self.provides = list(provides)

    def __call__(self, *args):
        return self.func(*args)

    # Generators override these to support multi-stage evaluation:
    def next_takes(self):
        return self.takes

    def next_provides(self):
        return self.provides

    def provided_in_order(self):
        """List of keys-lists, one per evaluation stage."""
        return [self.provides]

    def reset(self):
        pass


class GeneratorDynamicItem(DynamicItem):
    """A generator-based transform that yields multiple keys in stages.

    Each ``yield`` provides the next group of keys declared in
    ``provides``; inputs are consumed by the first call only.

    Example
    -------
    >>> @takes("sentence")
    ... @provides("words", "chars")
    ... def split(sentence):
    ...     pieces = sentence.split()
    ...     yield pieces
    ...     yield [ch for w in pieces for ch in w]
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._gen = None
        self._stage = 0

    def _mid_evaluation(self):
        return self._gen is not None or self._stage > 0

    def __call__(self, *args):
        # first stage opens the generator; each stage pulls one yield
        gen = self._gen if self._gen is not None else self.func(*args)
        value = next(gen)
        self._stage += 1
        if self._stage < len(self.provides):
            self._gen = gen
        else:
            gen.close()
            self._gen, self._stage = None, 0
        return value

    def next_takes(self):
        # inputs are consumed when the generator is opened (stage 0 only)
        return [] if self._mid_evaluation() else self.takes

    def next_provides(self):
        return [self.provides[self._stage]]

    def provided_in_order(self):
        return [[key] for key in self.provides]

    def reset(self):
        if self._gen is not None:
            self._gen.close()
        self._gen, self._stage = None, 0


def _declare(obj, field, keys):
    """Shared body of the takes/provides decorators: wrap a bare callable
    into the right DynamicItem flavor (generator functions get staged
    evaluation), or fill the named spec on an existing one."""
    if not isinstance(obj, DynamicItem):
        cls = (
            GeneratorDynamicItem
            if inspect.isgeneratorfunction(obj) else DynamicItem
        )
        return cls(func=obj, **{field: keys})
    if getattr(obj, field):
        raise ValueError(f"Can't overwrite existing {field}-spec.")
    setattr(obj, field, list(keys))
    return obj


def takes(*argkeys):
    """Decorator declaring the input keys of a dynamic item."""
    return lambda obj: _declare(obj, "takes", argkeys)


def provides(*output_keys):
    """Decorator declaring the output keys of a dynamic item."""
    return lambda obj: _declare(obj, "provides", output_keys)


class DataPipeline:
    """Computes requested output keys from static data + dynamic items.

    Dynamic items form a DAG through their takes/provides declarations;
    only the transforms needed for the currently-set output keys run.
    """

    def __init__(self, static_data_keys, dynamic_items=(), output_keys=()):
        self.graph = DependencyGraph()
        self._order_cache = None
        self.key_to_node = {}
        self.unaccounted_keys = {}
        self.dynamic_items = []
        self.output_mapping = {}
        self.add_static_keys(static_data_keys)
        for spec in dynamic_items:
            self.add_dynamic_item(**spec) if isinstance(spec, dict) \
                else self.add_dynamic_item(spec)
        self.set_output_keys(output_keys)

    def add_static_keys(self, static_keys):
        for key in static_keys:
            self.key_to_node[key] = self.graph.add_node(data=StaticItem(key))

    def add_dynamic_item(self, func, takes=None, provides=None):
        """Add one transform. ``func`` may already be a decorated DynamicItem."""
        if isinstance(func, DynamicItem):
            if takes is not None or provides is not None:
                raise ValueError(
                    "If providing a DynamicItem, don't also pass takes/provides."
                )
            self._register_item(func)
            return
        takes = [takes] if isinstance(takes, str) else takes
        provides = [provides] if isinstance(provides, str) else provides
        self._register_item(
            _declare(_declare(func, "provides", provides), "takes", takes)
        )

    def _register_item(self, obj):
        if not obj.provides:
            raise ValueError("Dynamic item must provide at least one key.")
        for depended in obj.takes:
            if depended not in self.key_to_node:
                self.unaccounted_keys.setdefault(depended, []).append(obj.provides)
        # One graph node per provide-stage (generators yield keys in stages;
        # plain functions have a single stage). Stage k depends on stage k-1;
        # the takes-edges attach to stage 0, where inputs are consumed.
        prev_node = None
        for stage_idx, stage_keys in enumerate(obj.provided_in_order()):
            node_id = self.graph.add_node(data=obj)
            if prev_node is not None:
                self.graph.add_edge(node_id, prev_node)
            for provided in stage_keys:
                self.key_to_node[provided] = node_id
                if provided in self.unaccounted_keys:
                    for dependent_provides in self.unaccounted_keys[provided]:
                        dependent_node = self.key_to_node[dependent_provides[0]]
                        self.graph.add_edge(dependent_node, node_id)
                    del self.unaccounted_keys[provided]
            if stage_idx == 0:
                for depended in obj.takes:
                    if depended in self.key_to_node:
                        self.graph.add_edge(node_id, self.key_to_node[depended])
            prev_node = node_id
        self.dynamic_items.append(obj)
        self._order_cache = None

    def set_output_keys(self, keys):
        """Set which keys to compute. Accepts a list or a {out_name: key} map."""
        self.output_mapping = self._output_keys_to_mapping(keys)
        self._order_cache = None

    @staticmethod
    def _output_keys_to_mapping(keys):
        if keys is None:
            return {}
        if isinstance(keys, dict):
            return keys
        return {key: key for key in keys}

    def compute_outputs(self, data):
        """Compute the currently-set output keys for one data point."""
        if self._order_cache is None:
            self._plan_run(data)
        return self._run_order(data, self._order_cache, self.output_mapping)

    def __call__(self, data):
        return self.compute_outputs(data)

    def _run_order(self, data, order, output_mapping):
        missing = [key for key in self.unaccounted_keys if key not in data]
        if missing:
            raise RuntimeError(
                f"Pipeline needs keys not provided anywhere: {missing}"
            )

        computed = {}

        def lookup(key):
            return data[key] if key in data else computed[key]

        for node in order:
            item = node.data
            if isinstance(item, StaticItem):
                if item.key not in data:
                    raise KeyError(f"Expected key {item.key} in data.")
                computed[item.key] = data[item.key]
                continue
            stage_keys = item.next_provides()
            result = item(*(lookup(k) for k in item.next_takes()))
            if len(stage_keys) == 1:
                computed[stage_keys[0]] = result
            else:
                computed.update(zip(stage_keys, result))
        for item in self.dynamic_items:
            item.reset()
        return {out: lookup(src) for out, src in output_mapping.items()}

    def get_selected_node_ids(self, selected_keys):
        return [self.key_to_node[key] for key in selected_keys]

    def _plan_run(self, data):
        self._order_cache = list(
            self.graph.get_evaluation_order(
                self.get_selected_node_ids(self.output_mapping.values())
            )
        )


class StaticItem:
    """Marker node for a key that comes directly from the loaded data."""

    def __init__(self, key):
        self.key = key
