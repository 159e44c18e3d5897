"""The port's optimizers (see `optimizer.optimizer`)."""
from .optimizer import (DCASGD, FTML, LBSGD, NAG, SGD, SGLD, AdaDelta,
                        AdaGrad, Adam, Adamax, AdamW, Ftrl, Nadam, Optimizer,
                        RMSProp, Signum, Test, Updater, create, get_updater,
                        register)

__all__ = ["Optimizer", "SGD", "Signum", "FTML", "DCASGD", "NAG", "SGLD",
           "Adam", "AdamW", "AdaGrad", "RMSProp", "AdaDelta", "Ftrl",
           "Adamax", "Nadam", "LBSGD", "Test", "Updater", "get_updater",
           "register", "create"]
