"""Training substrate: the train step and the fault-tolerant trainer loop."""

from .train_step import TrainConfig, init_train_state, make_train_step  # noqa: F401
from .trainer import Trainer, TrainerConfig  # noqa: F401
