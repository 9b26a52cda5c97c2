"""PyTorch port, ``launch/graph_analysis.py``: the per-rank cost of a
traced step, checked on small graphs whose counts are known by hand — a
product, a repeated layer and its extrapolation from two depths, a kernel
node (its module's ``work()``), each collective kind over a trace group
under the reference's conventions (an all-gather its result, an
all-reduce twice its result, a reduce-scatter its result times the
group), views charged nothing, and the memory keys of a liveness walk.
Traced on fake CPU tensors, as the dry run traces where PyTorch has no
CUDA.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.plan_audit import trace_step  # noqa: E402
from repro_torch.core import comm  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import graph_analysis as GA  # noqa: E402


def _fake(*shapes, dtype=torch.float32):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return [torch.empty(s, dtype=dtype) for s in shapes]


def _cost(fn, *args):
    comm.reset_stats()
    trace = trace_step(fn, list(args))
    stats = {k: dict(c) for k, c in comm.STATS.items()}
    comm.reset_stats()
    return GA.analyze(trace.gm, stats)


def test_product_flops_and_bytes():
    m, k, n = 16, 32, 8
    cost = _cost(lambda a, b: a @ b, *_fake((m, k), (k, n)))
    assert cost.flops == 2 * m * n * k
    assert cost.hbm_bytes == 4 * (m * k + k * n + m * n)
    assert cost.collective_count == 0 and cost.collective_bytes == 0


def test_repeated_layer_extrapolates_exactly():
    d = 24

    def net(layers):
        def f(x, w):
            for i in range(layers):
                x = torch.tanh(x @ w[i])        # w[i] is a view: no FLOPs, no traffic
            return x
        return f

    costs = {n: _cost(net(n), *_fake((4, d), (n, d, d))) for n in (2, 3, 7)}
    one_layer = 2 * 4 * d * d + 4 * d
    assert costs[3].flops - costs[2].flops == one_layer
    got = GA.extrapolate(costs[2], [(costs[3], 5)])
    assert got.flops == costs[7].flops == 7 * one_layer
    assert got.hbm_bytes == costs[7].hbm_bytes
    assert got.memory["argument_bytes"] == costs[7].memory["argument_bytes"]


def test_kernel_node_counts_its_work():
    b, s, h, p, n = 1, 64, 2, 16, 16
    x, dt, bm, cm, a, d = _fake((b, s, h, p), (b, s, h), (b, s, n), (b, s, n), (h,), (h,))
    cost = _cost(lambda *t: kops.ssd(*t), x, dt, a, bm, cm, d)
    work = _build.WORK["repro_torch::ssd_scan"](x, dt, a, bm, cm, d)
    assert cost.flops == work.flops
    assert cost.hbm_bytes == work.bytes


@pytest.mark.parametrize("kind", ["all_gather", "all_reduce", "reduce_scatter"])
def test_each_collective_under_the_reference_convention(kind):
    group = comm.TraceGroup(4, 1)
    ops = {"all_gather": lambda t: comm.all_gather_dim(t, 1, group),
           "all_reduce": lambda t: comm.all_reduce_(t.clone(), group=group),
           "reduce_scatter": lambda t: comm.reduce_scatter_dim(t, 0, group)}
    (t,) = _fake((8, 6))
    cost = _cost(ops[kind], t)
    n = 8 * 6 * 4
    want = {"all_gather": 4 * n, "all_reduce": 2 * n, "reduce_scatter": n}[kind]
    assert cost.collective_calls == {kind: 1}
    assert cost.collectives == {kind: want}
    out_shape = {"all_gather": (8, 24), "all_reduce": (8, 6), "reduce_scatter": (2, 6)}[kind]
    assert tuple(trace_step(ops[kind], [t]).out.shape) == out_shape


def test_trace_group_values_are_deterministic_on_real_tensors():
    group = comm.TraceGroup(2, 1)
    t = torch.arange(6.0).view(2, 3)
    assert torch.equal(comm.all_gather_dim(t, 0, group), torch.cat([t, t]))
    assert torch.equal(comm.reduce_scatter_dim(t, 0, group), t[1:])
    assert torch.equal(comm.all_reduce_(t.clone(), group=group), t)
    assert comm.block_of(t, 1, comm.TraceGroup(3, 2)).tolist() == [[2.0], [5.0]]


def test_memory_keys_add_up_to_the_peak():
    cost = _cost(lambda a: torch.relu(a * 2.0).sum(0), *_fake((64, 64)))
    mem = cost.memory
    assert set(mem) == set(GA.MEMORY_KEYS)
    assert mem["peak_estimate_bytes"] == (mem["argument_bytes"] + mem["temp_bytes"]
                                          + mem["output_bytes"] - mem["alias_bytes"])
    assert mem["argument_bytes"] == 64 * 64 * 4
    assert mem["temp_bytes"] >= 64 * 64 * 4
