from anystereo_tpu_torch.train.loss import (  # noqa: F401
    sequence_loss,
    sequence_loss_queries,
    init_disp_loss,
)
from anystereo_tpu_torch.train.optimizer import make_optimizer, one_cycle_schedule  # noqa: F401
from anystereo_tpu_torch.train.state import TrainState, create_train_state  # noqa: F401
from anystereo_tpu_torch.train.step import make_train_step, make_eval_step  # noqa: F401
