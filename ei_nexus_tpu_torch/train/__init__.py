"""Training of the port: batch preparation, freezing, optimizers and
schedules, the training state, the stage-1 and stage-2 steps and
checkpoints. Counterpart of `ei_nexus_tpu/train/`."""

from .optim import (PlateauController, build_optimizer, build_schedule,
                    get_learning_rate, is_host_driven, set_learning_rate)
from .state import TrainState, create_train_state
from .checkpoint import (load_stage1_event_extractor, load_stage2_matcher,
                         restore_any_checkpoint, restore_checkpoint,
                         save_checkpoint)

__all__ = ["build_optimizer", "build_schedule", "is_host_driven",
           "PlateauController", "set_learning_rate", "get_learning_rate",
           "TrainState", "create_train_state", "save_checkpoint",
           "restore_checkpoint", "restore_any_checkpoint",
           "load_stage1_event_extractor", "load_stage2_matcher"]
