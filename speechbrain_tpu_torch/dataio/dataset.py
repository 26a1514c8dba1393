"""Dynamic-item datasets (a copy of ``DynamicItemDataset`` and its
filtered, sorted views from ``speechbrain_tpu/dataio/dataset.py``, whose
code imports nothing of JAX; the port keeps its own). A dataset is a dict
of dicts plus a DataPipeline; each ``__getitem__`` computes only the
requested output keys, on the host.
"""

import contextlib
import copy

from speechbrain_tpu_torch.dataio.dataio import load_data_json
from speechbrain_tpu_torch.utils.data_pipeline import DataPipeline


class DynamicItemDataset:
    """Dataset of data points with lazily-computed dynamic items.

    Arguments
    ---------
    data : dict
        {data_id: {key: value}}; keys must not include "id".
    dynamic_items : list
        dicts {"func", "takes", "provides"} or decorated DynamicItems.
    output_keys : list
        Keys to produce in ``__getitem__``.

    Example
    -------
    >>> data = {"u1": {"text": "hi"}, "u2": {"text": "yo"}}
    >>> ds = DynamicItemDataset(data)
    >>> ds.add_dynamic_item(lambda t: t.upper(), takes="text", provides="up")
    >>> ds.set_output_keys(["id", "up"])
    >>> ds[0]
    {'id': 'u1', 'up': 'HI'}
    """

    def __init__(self, data, dynamic_items=(), output_keys=()):
        self.data = data
        self.data_ids = list(data.keys())
        static_keys = list(data[self.data_ids[0]].keys())
        if "id" in static_keys:
            raise ValueError("The key 'id' is reserved for the data point id.")
        static_keys.append("id")
        self.pipeline = DataPipeline(static_keys, dynamic_items)
        self.set_output_keys(output_keys)

    def __len__(self):
        return len(self.data_ids)

    def __getitem__(self, index):
        data_id = self.data_ids[index]
        data_point = self.data[data_id]
        return self.pipeline.compute_outputs({"id": data_id, **data_point})

    def add_dynamic_item(self, func, takes=None, provides=None):
        """Register a new transform; see DataPipeline.add_dynamic_item."""
        self.pipeline.add_dynamic_item(func, takes, provides)

    def set_output_keys(self, keys):
        """Set which keys __getitem__ returns."""
        self.pipeline.set_output_keys(keys)

    @contextlib.contextmanager
    def output_keys_as(self, keys):
        """Temporarily switch output keys (not thread-safe, like reference)."""
        saved_output = self.pipeline.output_mapping
        self.pipeline.set_output_keys(keys)
        try:
            yield self
        finally:
            self.pipeline.output_mapping = saved_output
            self.pipeline._order_cache = None

    def filtered_sorted(
        self,
        key_min_value=None,
        key_max_value=None,
        key_test=None,
        sort_key=None,
        reverse=False,
        select_n=None,
    ):
        """Return a filtered and/or sorted view (shares data + pipeline).

        Arguments mirror the reference: per-key min/max bounds, arbitrary
        predicates, sorting by a computed key, and truncation to n items.
        """
        filtered_sorted_ids = self._filtered_sorted_ids(
            key_min_value, key_max_value, key_test, sort_key, reverse, select_n
        )
        return FilteredSortedDynamicItemDataset(self, filtered_sorted_ids)

    def _filtered_sorted_ids(
        self,
        key_min_value=None,
        key_max_value=None,
        key_test=None,
        sort_key=None,
        reverse=False,
        select_n=None,
    ):
        key_min_value = key_min_value or {}
        key_max_value = key_max_value or {}
        key_test = key_test or {}

        def combined_filter(computed):
            for key, limit in key_min_value.items():
                if computed[key] < limit:
                    return False
            for key, limit in key_max_value.items():
                if computed[key] > limit:
                    return False
            for key, func in key_test.items():
                if not bool(func(computed[key])):
                    return False
            return True

        temp_keys = set(key_min_value) | set(key_max_value) | set(key_test) | (
            {sort_key} if sort_key is not None else set()
        )
        filtered_ids = []
        with self.output_keys_as(list(temp_keys)):
            for i, data_id in enumerate(self.data_ids):
                if select_n is not None and len(filtered_ids) == select_n:
                    break
                data_point = self.data[data_id]
                computed = self.pipeline.compute_outputs({"id": data_id, **data_point})
                if combined_filter(computed):
                    if sort_key is not None:
                        filtered_ids.append((computed[sort_key], i, data_id))
                    else:
                        filtered_ids.append(data_id)
        if sort_key is not None:
            return [t[2] for t in sorted(filtered_ids, reverse=reverse)]
        return filtered_ids

    @classmethod
    def from_json(cls, json_path, replacements=None, dynamic_items=(), output_keys=()):
        data = load_data_json(json_path, replacements or {})
        return cls(data, dynamic_items, output_keys)


class FilteredSortedDynamicItemDataset(DynamicItemDataset):
    """A view of a DynamicItemDataset with a fixed id order (shares the
    underlying data dict; deep-copies the pipeline so output keys are
    independent, mirroring the reference's semantics)."""

    def __init__(self, from_dataset, data_ids):
        self.data = from_dataset.data
        self.data_ids = list(data_ids)
        self.pipeline = copy.deepcopy(from_dataset.pipeline)

    @classmethod
    def from_json(cls, *args, **kwargs):
        raise TypeError("Cannot create views directly from data files.")

