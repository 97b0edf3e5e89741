from pytorchrec_tpu_torch.training.callbacks import (
    Callback,
    CallbackList,
    CSVLogger,
    EarlyStopping,
    History,
    ModelCheckpoint,
    Progbar,
    ProgbarLogger,
    TerminateOnNaN,
)
from pytorchrec_tpu_torch.training.checkpoint import (
    CheckpointCallback,
    CheckpointManager,
    PreemptionGuard,
)
from pytorchrec_tpu_torch.training.quantized_trainer import QuantizedEmbeddingTrainer
from pytorchrec_tpu_torch.training.rl_trainer import RLTrainer, SparseRLTrainer
from pytorchrec_tpu_torch.training.sparse_trainer import SparseEmbeddingTrainer
from pytorchrec_tpu_torch.training.state import (
    QuantizedTrainState,
    RLTrainState,
    SparseRLTrainState,
    SparseTrainState,
    TrainState,
)
from pytorchrec_tpu_torch.training.trainer import Trainer

__all__ = ["Callback", "CallbackList", "CheckpointCallback", "CheckpointManager", "CSVLogger",
           "EarlyStopping", "History", "ModelCheckpoint", "PreemptionGuard", "Progbar",
           "ProgbarLogger", "QuantizedEmbeddingTrainer", "QuantizedTrainState", "RLTrainState",
           "RLTrainer", "SparseEmbeddingTrainer", "SparseRLTrainState", "SparseRLTrainer",
           "SparseTrainState", "TerminateOnNaN", "TrainState", "Trainer"]
