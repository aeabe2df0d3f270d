from .train_step import (TrainState, TrainStep2D, TrainStep3D, deep_weight_factors,
                         make_eval_step_2d)
from .optim import SGD, AMSGrad, make_optimizer, make_schedule
from .checkpoint import (save_checkpoint, load_checkpoint, latest_checkpoint, restore,
                         save_checkpoint_dcp, load_checkpoint_dcp)
from .loop import (train, init_state, validate_2d, validate_3d, valid_geometry_3d,
                   ScalarLogger, build_dataset, call_freqs, check_train_config,
                   make_train_step)
from .graph_step import GraphedStep
