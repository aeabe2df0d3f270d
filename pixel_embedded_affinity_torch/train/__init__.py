from .train_step import TrainState, TrainStep2D, deep_weight_factors, make_eval_step_2d
from .optim import AMSGrad
from .checkpoint import save_checkpoint, load_checkpoint, latest_checkpoint, restore
from .loop import train, init_state, validate_2d, ScalarLogger, check_train_config
