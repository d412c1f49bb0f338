from repro_torch.train.optimizer import AdamW, OptState  # noqa: F401
from repro_torch.train.train_step import compiled_train_step, make_train_step  # noqa: F401
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: F401
