"""PyTorch port, the train step over a pod mesh (``("pod", "data",
"model")``: pod and data together are the data axes, the batch, FSDP's
blocks and the data group spanning both pod-major), against the
reference's single-device step on the same weights and global batch
(``tests/_torch_train_ref.py``'s tolerances). ``yi-6b-smoke`` on 4 gloo
CPU ranks as a (2, 1, 2) mesh under the planner's ``DP_TP`` and
``FSDP_TP`` plans, with sequence parallelism under FSDP_TP.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_ranks import run_ranks  # noqa: E402
from _torch_train_ref import ARCH, BATCH, SEQ, STEPS, check_case, reference  # noqa: E402

torch.set_num_threads(2)
MESH = (2, 1, 2)
DP_TP, FSDP_TP = "dp_tensor_parallel", "fsdp_tensor_parallel"
CASES = [(DP_TP, "sgd", 1e-3, 1.0, 1, False), (FSDP_TP, "sgd", 1e-3, 1.0, 1, True),
         (FSDP_TP, "adam", 1e-4, 1.0, 2, False)]


@pytest.fixture(scope="module")
def rank_run(tmp_path_factory):
    init = reference(ARCH, "sgd", 1e-3, 1.0, 1)[0]
    return run_ranks("pod_train_case", 4, tmp_path_factory.mktemp("pod"), ARCH, init, CASES,
                     STEPS, BATCH, SEQ, MESH)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-sp{c[5]}-micro{c[4]}")
def test_pod_mesh_step_equals_reference_single_device_step(rank_run, case):
    strategy, opt, lr, clip, micro, sp = case
    _init, want_mets, want_params = reference(ARCH, opt, lr, clip, micro)
    outs = [r[CASES.index(case)] for r in rank_run]
    for out in outs:
        name, over_data, batch_axes, tp, seq_shard = out["plan"]
        assert (name, over_data, tp, seq_shard) == (strategy, strategy == FSDP_TP, True, sp)
        assert tuple(batch_axes) == ("pod", "data")
        assert out["metrics"] == outs[0]["metrics"]
        assert out["calls"]["all_reduce"] > 0
    check_case(outs[0], want_mets, want_params, opt, lr)
