from pytorchrec_tpu_torch.training.callbacks import (
    Callback,
    CallbackList,
    History,
    Progbar,
    ProgbarLogger,
)
from pytorchrec_tpu_torch.training.quantized_trainer import QuantizedEmbeddingTrainer
from pytorchrec_tpu_torch.training.sparse_trainer import SparseEmbeddingTrainer
from pytorchrec_tpu_torch.training.state import QuantizedTrainState, SparseTrainState, TrainState
from pytorchrec_tpu_torch.training.trainer import Trainer

__all__ = ["Callback", "CallbackList", "History", "Progbar", "ProgbarLogger",
           "QuantizedEmbeddingTrainer", "QuantizedTrainState", "SparseEmbeddingTrainer",
           "SparseTrainState", "TrainState", "Trainer"]
