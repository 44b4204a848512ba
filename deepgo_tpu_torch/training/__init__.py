"""Training: optimizers, the train and eval steps."""

from .optimizers import adagrad, sgd  # noqa: F401
from .steps import (  # noqa: F401
    make_eval_step,
    make_train_step,
    make_train_step_many,
)
