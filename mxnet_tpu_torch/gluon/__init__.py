"""The port's gluon: so far the `Trainer`."""
from .trainer import Trainer

__all__ = ["Trainer"]
