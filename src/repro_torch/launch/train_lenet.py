"""LeNet (one of the paper's demo models) trained with the port's
manual-backward NN library through ``Keras2Plan`` on synthetic image
classification — the port's twin of ``examples/train_lenet.py``. Conv, pool
and dropout layers flow as linearized (N, C*H*W) matrices, the conv and
affine forward products through the hand-written CUDA kernels on the card.

    PYTHONPATH=src python -m repro_torch.launch.train_lenet [--device cpu]
        [--epochs N] [--size 28]

Runs on the card unless ``--device`` names another device; asserts a test
accuracy above 0.6 and prints ``OK``.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.lenet import make_spec
from repro_torch.frontend import Keras2Plan


def synthetic_images(n, num_classes=5, size=16, seed=0):
    """Classes are distinguishable blob patterns + noise (a copy of the
    example's generator)."""
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, num_classes, n)
    xs = rng.standard_normal((n, 1, size, size)).astype(np.float32) * 0.3
    for i, y in enumerate(ys):
        r, c = divmod(int(y), 3)
        xs[i, 0, 4 * r + 2:4 * r + 6, 4 * c + 2:4 * c + 6] += 2.0
    onehot = np.eye(num_classes, dtype=np.float32)[ys]
    return xs.reshape(n, -1), onehot  # linearized (N, C*H*W)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--size", type=int, default=16,
                    help="image side (16 as the example; 28 is the paper's MNIST width)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; fails without a card)")
    args = ap.parse_args(argv)

    spec, meta = make_spec(input_shape=(1, args.size, args.size), num_classes=5)
    x, y = synthetic_images(args.n, size=args.size)
    xt, yt = synthetic_images(256, size=args.size, seed=1)

    model = Keras2Plan(spec, meta, optimizer="sgd_momentum", lr=0.01,
                       batch_size=32, epochs=args.epochs, device=args.device)
    model.fit(x, y)
    print(f"loss: {model.history[0]:.3f} -> {model.history[-1]:.3f}")
    acc = model.score(xt, yt)
    print(f"test accuracy: {acc:.3f} on {model.device}")
    if not acc > 0.6:
        raise SystemExit(f"test accuracy {acc:.3f} is not above 0.6")
    print("OK")


if __name__ == "__main__":
    main()
