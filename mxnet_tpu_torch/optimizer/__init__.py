"""The port's optimizers (see `optimizer.optimizer`)."""
from .optimizer import (SGD, Adam, Optimizer, Test, Updater, create,
                        get_updater, register)

__all__ = ["Optimizer", "SGD", "Adam", "Test", "Updater", "get_updater",
           "register", "create"]
