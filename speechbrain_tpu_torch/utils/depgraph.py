"""A dependency graph with topological ordering and cycle detection (a
copy of ``speechbrain_tpu/utils/depgraph.py``, which imports nothing of
JAX; the port keeps its own). The data pipeline evaluates dynamic items
in its order.

Example
-------
>>> g = DependencyGraph()
>>> _ = g.add_node("a")
>>> _ = g.add_node("b")
>>> g.add_edge("b", "a")  # b depends on a
>>> [node.key for node in g.get_evaluation_order()]
['a', 'b']
"""

import collections
import uuid


class CircularDependencyError(ValueError):
    """Raised when the graph has a cycle, so no valid evaluation order exists."""


DGNode = collections.namedtuple("DGNode", ["key", "edges", "data"])
# key: hashable identifier; edges: list of keys this node depends on;
# data: arbitrary payload attached to the node.


class DependencyGraph:
    """Directed acyclic graph for dependency resolution.

    ``add_edge(from_key, to_key)`` declares that *from_key* depends on
    *to_key*; evaluation order then yields *to_key* before *from_key*.
    Nodes may be added implicitly by edges; adding data to an
    implicitly-created node later is allowed once.
    """

    def __init__(self):
        self._nodes = {}  # key -> {"data": ..., "edges": set(), "explicit": bool}
        self._order = []  # insertion order of keys, for stable output

    @staticmethod
    def get_unique_key():
        """Return a key guaranteed not to collide with user keys."""
        return uuid.uuid4()

    def add_node(self, key=None, data=None):
        """Add a node explicitly. Returns the key.

        If ``key`` is None a unique key is generated. Re-adding an
        implicitly-created node attaches data; re-adding an explicit node
        raises ValueError.
        """
        if key is None:
            key = self.get_unique_key()
        if key in self._nodes:
            entry = self._nodes[key]
            if entry["explicit"]:
                raise ValueError(f"Node {key} already added explicitly.")
            entry["data"] = data
            entry["explicit"] = True
            return key
        self._nodes[key] = {"data": data, "edges": set(), "explicit": True}
        self._order.append(key)
        return key

    def _ensure_node(self, key):
        if key not in self._nodes:
            self._nodes[key] = {"data": None, "edges": set(), "explicit": False}
            self._order.append(key)

    def add_edge(self, from_key, to_key):
        """Declare that ``from_key`` depends on ``to_key``."""
        self._ensure_node(from_key)
        self._ensure_node(to_key)
        self._nodes[from_key]["edges"].add(to_key)

    def is_valid(self):
        """True iff the graph has no cycles."""
        try:
            list(self.get_evaluation_order())
            return True
        except CircularDependencyError:
            return False

    def get_node(self, key):
        entry = self._nodes[key]
        return DGNode(key, sorted(entry["edges"], key=self._sort_key), entry["data"])

    def _sort_key(self, key):
        return self._order.index(key)

    def get_evaluation_order(self, selected_keys=None):
        """Yield ``DGNode``s in an order where dependencies come first.

        Arguments
        ---------
        selected_keys : iterable, optional
            If given, only these nodes and their transitive dependencies
            are yielded.
        """
        yielded = set()
        # iterative DFS with a WIP marker for cycle detection
        VISITING, DONE = 1, 2
        state = {}
        roots = list(selected_keys) if selected_keys is not None else list(self._order)
        for root in roots:
            if root not in self._nodes:
                raise KeyError(f"Node {root} not in graph.")
            stack = [(root, iter(sorted(self._nodes[root]["edges"], key=self._sort_key)))]
            if state.get(root) == DONE:
                continue
            state[root] = VISITING
            while stack:
                key, it = stack[-1]
                advanced = False
                for dep in it:
                    st = state.get(dep)
                    if st == VISITING:
                        raise CircularDependencyError(
                            f"Circular dependency around {dep}"
                        )
                    if st != DONE:
                        state[dep] = VISITING
                        stack.append(
                            (dep, iter(sorted(self._nodes[dep]["edges"], key=self._sort_key)))
                        )
                        advanced = True
                        break
                if advanced:
                    continue
                stack.pop()
                state[key] = DONE
                if key not in yielded:
                    yielded.add(key)
                    entry = self._nodes[key]
                    yield DGNode(
                        key, sorted(entry["edges"], key=self._sort_key), entry["data"]
                    )
