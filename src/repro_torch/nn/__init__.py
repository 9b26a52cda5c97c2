"""repro_torch.nn — the SystemML NN library analogue (manual backward);
port of ``repro.nn``."""

from repro_torch.nn import layers, loss, optim
from repro_torch.nn.module import Sequential
from repro_torch.nn.optim import OPTIMIZERS, get_optimizer, tree_init, tree_update

__all__ = ["layers", "loss", "optim", "Sequential", "OPTIMIZERS",
           "get_optimizer", "tree_init", "tree_update"]
