"""The paper's six optimizers (§2: "6 optimizers, namely Adagrad, Adam,
RMSprop, SGD, SGD with momentum, and SGD with Nesterov momentum"); port of
``repro/nn/optim.py``.

Each optimizer follows the SystemML ``nn/optim/*.dml`` interface:

    init(param)                          -> state
    update(param, grad, state, hypers)   -> new_param, new_state

and operates leaf-wise; :func:`tree_update` maps it over a tree of tensors
(nested lists, tuples and dicts), as the reference maps over a pytree. A
state leaf may live in a reduced dtype (opt-state compression). Updates
return new tensors; nothing is updated in place.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch


def _zeros_like(p, dtype=None):
    return torch.zeros_like(p, dtype=dtype or p.dtype)


class sgd:
    slots = 0

    @staticmethod
    def init(p, dtype=None):
        return ()

    @staticmethod
    def update(p, g, state, lr=0.01, **_):
        return p - lr * g, ()


class sgd_momentum:
    slots = 1

    @staticmethod
    def init(p, dtype=None):
        return (_zeros_like(p, dtype),)

    @staticmethod
    def update(p, g, state, lr=0.01, mu=0.9, **_):
        (v,) = state
        v = (mu * v - lr * g).to(v.dtype)
        return p + v, (v,)


class sgd_nesterov:
    slots = 1

    @staticmethod
    def init(p, dtype=None):
        return (_zeros_like(p, dtype),)

    @staticmethod
    def update(p, g, state, lr=0.01, mu=0.9, **_):
        (v,) = state
        v_prev = v
        v = (mu * v - lr * g).to(v.dtype)
        return p - mu * v_prev + (1 + mu) * v, (v,)


class adagrad:
    slots = 1

    @staticmethod
    def init(p, dtype=None):
        return (_zeros_like(p, dtype),)

    @staticmethod
    def update(p, g, state, lr=0.01, eps=1e-6, **_):
        (c,) = state
        c = (c + g * g).to(c.dtype)
        return p - lr * g / (torch.sqrt(c.to(g.dtype)) + eps), (c,)


class rmsprop:
    slots = 1

    @staticmethod
    def init(p, dtype=None):
        return (_zeros_like(p, dtype),)

    @staticmethod
    def update(p, g, state, lr=0.01, decay=0.99, eps=1e-8, **_):
        (c,) = state
        c = (decay * c + (1 - decay) * g * g).to(c.dtype)
        return p - lr * g / (torch.sqrt(c.to(g.dtype)) + eps), (c,)


class adam:
    slots = 2

    @staticmethod
    def init(p, dtype=None):
        return (_zeros_like(p, dtype), _zeros_like(p, dtype))

    @staticmethod
    def update(p, g, state, lr=0.001, beta1=0.9, beta2=0.999, eps=1e-8, t=1, **_):
        m, v = state
        m = (beta1 * m + (1 - beta1) * g).to(m.dtype)
        v = (beta2 * v + (1 - beta2) * g * g).to(v.dtype)
        mhat = m.to(g.dtype) / (1 - beta1**t)
        vhat = v.to(g.dtype) / (1 - beta2**t)
        return p - lr * mhat / (torch.sqrt(vhat) + eps), (m, v)


OPTIMIZERS: Dict[str, Any] = {
    "sgd": sgd,
    "sgd_momentum": sgd_momentum,
    "sgd_nesterov": sgd_nesterov,
    "adagrad": adagrad,
    "rmsprop": rmsprop,
    "adam": adam,
}


OPTIMIZER_SLOTS: Dict[str, int] = {k: v.slots for k, v in OPTIMIZERS.items()}


def get_optimizer(name: str):
    if name not in OPTIMIZERS:
        raise KeyError(f"unknown optimizer {name!r}; known: {list(OPTIMIZERS)}")
    return OPTIMIZERS[name]


# ---------------------------------------------------------------------------
# tree-level helpers over nested lists, tuples and dicts of tensors
# ---------------------------------------------------------------------------


def _leaves(tree) -> List[torch.Tensor]:
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for key in tree for leaf in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def _leaves_up_to(struct, tree) -> list:
    """The subtrees of ``tree`` at the positions of ``struct``'s tensors
    (``jax.tree`` ``flatten_up_to``)."""
    if torch.is_tensor(struct):
        return [tree]
    if isinstance(struct, dict):
        return [s for key in struct for s in _leaves_up_to(struct[key], tree[key])]
    if len(struct) != len(tree):
        raise ValueError(f"tree structures differ: {len(struct)} vs {len(tree)} children")
    return [s for a, b in zip(struct, tree) for s in _leaves_up_to(a, b)]


def _rebuild(struct, leaves: list):
    """``struct`` with its tensors replaced, in order, by ``leaves``."""
    it = iter(leaves)

    def build(node):
        if torch.is_tensor(node):
            return next(it)
        if isinstance(node, dict):
            return {key: build(node[key]) for key in node}
        return type(node)(build(sub) for sub in node)

    return build(struct)


def tree_map(fn: Callable, tree):
    return _rebuild(tree, [fn(leaf) for leaf in _leaves(tree)])


def tree_init(name: str, params, dtype=None):
    """Each tensor of ``params`` replaced by its optimizer state tuple."""
    opt = get_optimizer(name)
    return tree_map(lambda p: opt.init(p, dtype=dtype), params)


def tree_update(name: str, params, grads, state, **hypers):
    opt = get_optimizer(name)
    flat_p = _leaves(params)
    flat_g = _leaves_up_to(params, grads)
    flat_s = _leaves_up_to(params, state)
    new_p, new_s = [], []
    for p, g, s in zip(flat_p, flat_g, flat_s):
        np_, ns = opt.update(p, g, s, **hypers)
        new_p.append(np_.to(p.dtype))
        new_s.append(ns)
    return _rebuild(params, new_p), _rebuild(params, new_s)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum((x.float() ** 2).sum() for x in _leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    n = global_norm(tree)
    scale = torch.clamp(max_norm / (n + 1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), tree), n
