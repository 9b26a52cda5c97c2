"""Per-rank, per-step cost of a traced step: the port's counterpart of the
reference's ``repro/launch/hlo_analysis.py``.

The reference compiles each step for 512 placeholder devices and parses
the per-chip HLO text. The port traces one rank's step into an aten graph
on fake ``cuda`` tensors of that rank's blocks
(``analysis/plan_audit.trace_cell`` with a traced mesh), its collectives
counted on ``core/comm.TraceGroup`` stand-ins instead of sent. No HLO is
parsed. From the graph and the counts:

* ``flops``: ``analysis/cost_audit.graph_cost``'s ceiling side — 2·M·N·K
  for every product, one FLOP an element for element-wise work and an
  input element for reductions, and each hand-written kernel node through
  its module's ``work()`` (the reference counts 1 a result element for
  everything but dots and convolutions) — less the element a view
  (``select``, ``view``, ``transpose``...) is charged there;
* ``hbm_bytes``: the same pass's reuse-free traffic, every node's operand
  and result bytes (eager PyTorch launches each op as its own kernel,
  so each is a trip to HBM; the reference counts top-level ops of unfused
  computations), less what it charges the views, which move nothing (a
  layer's slice of a stacked parameter would otherwise charge the whole
  stack once a layer);
* ``collectives``: bytes by kind from ``comm.STATS["traffic"]``, under
  the reference's conventions (an all-gather its result, an all-reduce
  twice its result, a reduce-scatter its result times the group), and
  ``collective_calls`` by kind;
* ``memory``: argument, output, temp and alias bytes and the peak of a
  liveness walk over the graph (``plan_audit.graph_peak_bytes``: inputs
  resident, every node's output held from the node that makes it to its
  last use, in the CUDA caching allocator's 512-byte blocks, plus cuBLAS's
  workspace where a product runs through it).

All values are per rank per step. Where the reference weights a loop body
by its trip count (``_cond_trip_count``), the dry run traces a stack at one
and two periods of its layer pattern and extrapolates linearly
(:func:`extrapolate`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Sequence, Tuple

from torch.fx import GraphModule

from repro_torch.analysis.cost_audit import _MOVEMENT, _PRODUCTS, _REDUCE, graph_cost
from repro_torch.analysis.plan_audit import (aliases_input, alloc_bytes, graph_peak_bytes,
                                             inplace_output_bytes, is_mutation, iter_calls,
                                             node_val, op_name, output_nodes, placeholders,
                                             tensors, value_bytes)

# ops graph_cost prices apart from element-wise work
_COUNTED_APART = _MOVEMENT | _REDUCE | frozenset(_PRODUCTS)
MEMORY_KEYS = ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "peak_estimate_bytes")


@dataclass
class GraphCost:
    """One rank's step: FLOPs, HBM bytes, collective bytes by kind (the
    reference's conventions) and calls by kind, and memory."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: Dict[str, float] = field(default_factory=dict)
    collective_calls: Dict[str, float] = field(default_factory=dict)
    memory: Dict[str, float] = field(default_factory=dict)

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.collectives.values()))

    @property
    def collective_count(self) -> float:
        return float(sum(self.collective_calls.values()))

    def to_dict(self) -> Dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": self.collective_bytes, "collectives": dict(self.collectives),
                "collective_count": self.collective_count,
                "collective_calls": dict(self.collective_calls)}


def memory_of(gm: GraphModule) -> Dict[str, float]:
    """The graph's memory under the reference's record keys: the peak of
    the liveness walk is ``argument + temp + output - alias``."""
    argument = sum(alloc_bytes(node_val(n)) for n in placeholders(gm))
    alias = inplace_output_bytes(gm)
    output = sum(alloc_bytes(node_val(o)) for o in dict.fromkeys(output_nodes(gm))) - alias
    peak = graph_peak_bytes(gm)
    return {"argument_bytes": argument, "output_bytes": output,
            "temp_bytes": peak - argument - output + alias, "alias_bytes": alias,
            "peak_estimate_bytes": peak}


def analyze(gm: GraphModule, stats: Mapping[str, Mapping[str, float]]) -> GraphCost:
    """The cost of one traced step ``gm`` whose collectives ``stats`` (a
    snapshot of ``comm.STATS`` over the trace) counted."""
    cost = graph_cost(gm)
    view_bytes = view_flops = 0.0
    for n in iter_calls(gm):
        if aliases_input(n) and not is_mutation(n) and op_name(n) != "getitem":
            view_bytes += value_bytes(node_val(n)) + sum(value_bytes(node_val(a))
                                                         for a in n.all_input_nodes)
            if op_name(n) not in _COUNTED_APART:
                view_flops += sum(t.numel() for t in tensors(node_val(n)))
    return GraphCost(flops=cost.flops_hi - view_flops, hbm_bytes=cost.node_bytes - view_bytes,
                     collectives={k: float(v) for k, v in stats.get("traffic", {}).items()},
                     collective_calls={k: float(v) for k, v in stats.get("calls", {}).items()},
                     memory=memory_of(gm))


def combine(terms: Sequence[Tuple[float, GraphCost]]) -> GraphCost:
    """``sum(coef * cost)`` of every count, key by key."""
    out = GraphCost()
    for coef, c in terms:
        out.flops += coef * c.flops
        out.hbm_bytes += coef * c.hbm_bytes
        for mine, theirs in ((out.collectives, c.collectives),
                             (out.collective_calls, c.collective_calls),
                             (out.memory, c.memory)):
            for k, v in theirs.items():
                mine[k] = mine.get(k, 0.0) + coef * v
    for d in (out.collectives, out.collective_calls):
        for k in [k for k, v in d.items() if v == 0]:
            del d[k]
    return out


def extrapolate(base: GraphCost, per_period: Sequence[Tuple[GraphCost, float]]) -> GraphCost:
    """Every count of a stack at full depth from traces that differ by one
    period of a layer pattern: ``base`` (each stack at its first periods)
    plus, for each ``(trace with one more period of a stack, periods still
    to add)``, that difference times its periods."""
    terms = [(1.0, base)]
    for more, n in per_period:
        terms += [(n, more), (-n, base)]
    return combine(terms)
