from acezero_tpu_torch.training.buffer import BufferConfig, fill_training_buffer
from acezero_tpu_torch.training.loss import ReproLossConfig, repro_loss
from acezero_tpu_torch.training.optim import AdamWState, adamw_init, adamw_update
from acezero_tpu_torch.training.schedule import (
    ScheduleConfig,
    ScheduleState,
    init_schedule,
    schedule_lr,
    schedule_update,
)
from acezero_tpu_torch.training.trainer import MappingTrainer, TrainConfig

__all__ = [
    "ReproLossConfig", "repro_loss", "ScheduleConfig", "ScheduleState", "init_schedule", "schedule_lr",
    "schedule_update", "AdamWState", "adamw_init", "adamw_update", "BufferConfig",
    "fill_training_buffer", "TrainConfig", "MappingTrainer",
]
