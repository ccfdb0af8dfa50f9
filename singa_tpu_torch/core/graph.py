"""Generic named-node DAG with topological sort and JSON dump.

The PyTorch port's own copy of `singa_tpu/core/graph.py`.

Capability parity with the reference graph utility
(SINGA's include/utils/graph.h, src/utils/graph.cc): named nodes,
DFS topological sort (graph.cc:66-101), and a node-link JSON dump for
visualization (graph.cc:4-59).  The reference's mutation helpers
(InsertSliceNode/InsertConcateNode/InsertSplitNode/InsertBridgeNode,
graph.cc:105-146) exist there to rewrite the layer graph for partitioned
execution; in the TPU build that role is played by sharding annotations
(see the JAX package's parallel/partition.py), so here the graph stays a pure
dependency structure.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence


class GraphError(ValueError):
    pass


class Graph:
    def __init__(self):
        self._edges: Dict[str, List[str]] = {}   # node -> dst list
        self._nodes: List[str] = []              # insertion order
        self._attrs: Dict[str, dict] = {}

    def add_node(self, name: str, **attrs) -> None:
        if name in self._edges:
            raise GraphError(f"duplicate node {name!r}")
        self._edges[name] = []
        self._nodes.append(name)
        self._attrs[name] = attrs

    def add_edge(self, src: str, dst: str) -> None:
        for n in (src, dst):
            if n not in self._edges:
                raise GraphError(f"edge references unknown node {n!r}")
        self._edges[src].append(dst)

    def nodes(self) -> List[str]:
        return list(self._nodes)

    def attrs(self, name: str) -> dict:
        return self._attrs[name]

    def srcs_of(self, name: str) -> List[str]:
        return [n for n in self._nodes if name in self._edges[n]]

    def dsts_of(self, name: str) -> List[str]:
        return list(self._edges[name])

    def topo_sort(self) -> List[str]:
        """Kahn's algorithm, stable in insertion order; raises on cycles
        (the reference asserts visited==nnodes, graph.cc:96-100)."""
        indeg = {n: 0 for n in self._nodes}
        for n, dsts in self._edges.items():
            for d in dsts:
                indeg[d] += 1
        ready = [n for n in self._nodes if indeg[n] == 0]
        order: List[str] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for d in self._edges[n]:
                indeg[d] -= 1
                if indeg[d] == 0:
                    ready.append(d)
        if len(order) != len(self._nodes):
            cyc = [n for n in self._nodes if n not in order]
            raise GraphError(f"cycle detected among {cyc}")
        return order

    def to_json(self) -> str:
        """Node-link dump in the reference's vis format (graph.cc:4-59):
        {"nodes": [{"id": ...}], "links": [{"source": i, "target": j}]}."""
        idx = {n: i for i, n in enumerate(self._nodes)}
        return json.dumps({
            "nodes": [{"id": n, **self._attrs[n]} for n in self._nodes],
            "links": [{"source": idx[s], "target": idx[d]}
                      for s in self._nodes for d in self._edges[s]],
        }, indent=2)
