"""LeNet — one of the paper's own demo models ("we support a variety of deep
learning models in SystemML such as LeNet, feedforward nets, ...").

Defined as a declarative layer spec consumed by
``repro_torch.frontend.Keras2Plan`` and by the ``repro_torch.nn``
manual-backward library, exactly as the paper's Keras2DML path generates a
DML script using the NN library. A copy of ``repro.configs.lenet``;
``tests/test_torch_boundaries.py`` holds the two specs equal.
"""


def make_spec(input_shape=(1, 28, 28), num_classes=10):
    """Returns the layer spec list for the frontend (Keras2DML analogue)."""
    c, h, w = input_shape
    return [
        {"kind": "conv2d", "filters": 32, "kernel": 5, "pad": 2, "stride": 1},
        {"kind": "relu"},
        {"kind": "max_pool2d", "pool": 2, "stride": 2},
        {"kind": "conv2d", "filters": 64, "kernel": 5, "pad": 2, "stride": 1},
        {"kind": "relu"},
        {"kind": "max_pool2d", "pool": 2, "stride": 2},
        {"kind": "affine", "units": 512},
        {"kind": "relu"},
        {"kind": "dropout", "p": 0.5},
        {"kind": "affine", "units": num_classes},
        {"kind": "softmax"},
    ], {"input_shape": (c, h, w), "num_classes": num_classes}
