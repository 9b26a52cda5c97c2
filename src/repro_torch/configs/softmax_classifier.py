"""Softmax classifier — the paper's Section 2 worked example (affine →
softmax → cross-entropy trained with minibatch SGD). A copy of
``repro.configs.softmax_classifier``, held equal to it by a test."""


def make_spec(num_features=784, num_classes=10):
    return [
        {"kind": "affine", "units": num_classes},
        {"kind": "softmax"},
    ], {"input_shape": (num_features,), "num_classes": num_classes}
