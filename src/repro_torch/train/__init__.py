"""Training: loss, step, trainer loop, straggler mitigation (port of
``repro.train``)."""
from .step import ce_loss, loss_fn, make_eval_step, make_train_step  # noqa: F401
from .trainer import SimCluster, TrainConfig, Trainer  # noqa: F401
