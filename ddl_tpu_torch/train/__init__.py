from .config import TrainConfig
from .trainer import SingleChipTrainer, TrainResult

__all__ = ["TrainConfig", "SingleChipTrainer", "TrainResult"]
