from ssdn_tpu_torch.train.step import (
    TrainState,
    TrainStep,
    blind_reg_schedule,
    init_state,
    lr_schedule,
    make_train_step,
    pipeline_blindspot,
    state_from_params,
)

__all__ = ["TrainState", "TrainStep", "blind_reg_schedule", "init_state",
           "lr_schedule", "make_train_step", "pipeline_blindspot",
           "state_from_params"]
