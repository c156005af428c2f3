"""The port's training side: the hybrid step (:mod:`.hybrid`), the eval
steps (:mod:`.step`), checkpoints (:mod:`.checkpoint`) and the harness,
:class:`Trainer` (:mod:`.loop`)."""

from tpurec_torch.train.reg import reg_coef_tree, regularization_loss
from tpurec_torch.train.step import (
    bce_with_logits,
    make_eval_step,
    TrainState,
)
from tpurec_torch.train.loop import Trainer
