"""Quickstart — the paper's §2 worked example, end to end; the port's twin
of ``examples/quickstart.py``.

A softmax classifier declared Keras-style, compiled through ``Keras2Plan``
(the Keras2DML analogue): generates the DML script, trains with minibatch
SGD and scores. On the card its affine forward runs the hand-written matmul
kernel (``nn/layers.affine`` -> ``ops.matmul``).

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

Runs on the card unless ``--device`` names another device; asserts a test
accuracy above 0.8 and prints ``OK``.
"""

from __future__ import annotations

import argparse
from typing import Tuple

from repro_torch.data import SyntheticClassification
from repro_torch.frontend import Keras2Plan

# the example's model, data and hyperparameters
SPEC = [
    {"kind": "affine", "units": 10},
    {"kind": "softmax"},
]
META = {"input_shape": (50,), "num_classes": 10}
TRAIN_ROWS, TEST_ROWS = 4096, 512
HYPERS = dict(optimizer="sgd", lr=0.5, batch_size=32, epochs=2, train_algo="minibatch",
              test_algo="allreduce")


def main(argv=None) -> Tuple[Keras2Plan, float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; fails without a card)")
    args = ap.parse_args(argv)

    # --- data (NumPy in, like the paper's fit(X, Y)) ----------------------
    data = SyntheticClassification(num_features=50, num_classes=10, seed=0)
    x_train, y_train = data.batch(TRAIN_ROWS)
    x_test, y_test = data.batch(TEST_ROWS, step=1)

    # --- declare the model (Keras Sequential analogue) --------------------
    model = Keras2Plan(SPEC, META, device=args.device, **HYPERS)

    print("=== generated DML script (paper §2) ===")
    print(model.dml_script)
    print()

    # --- train -------------------------------------------------------------
    model.fit(x_train, y_train)
    print(f"loss: {model.history[0]:.3f} -> {model.history[-1]:.3f} "
          f"({len(model.history)} minibatch steps)")
    print(f"input format decision: X stored {model.format_decisions['X']}")

    # --- score -------------------------------------------------------------
    acc = model.score(x_test, y_test)
    print(f"test accuracy: {acc:.3f} on {model.device}")
    if not acc > 0.8:
        raise SystemExit(f"quickstart should reach >80% accuracy, got {acc:.3f}")
    print("OK")
    return model, acc


if __name__ == "__main__":
    main()
