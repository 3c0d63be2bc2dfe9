from eco_tpu_torch.train.checkpoint import (
    load_model,
    restore,
    restore_weights,
    save_model,
    snapshot,
)
from eco_tpu_torch.train.loop import Trainer, polyak_average, solver_config_from_prototxt
from eco_tpu_torch.train.lr_policies import learning_rate
from eco_tpu_torch.train.solver import (
    SolverConfig,
    TrainState,
    init_train_state,
    make_eval_step,
    make_train_step,
    param_multipliers,
)
