from pytorchrec_tpu_torch.training.callbacks import History
from pytorchrec_tpu_torch.training.quantized_trainer import QuantizedEmbeddingTrainer
from pytorchrec_tpu_torch.training.sparse_trainer import SparseEmbeddingTrainer
from pytorchrec_tpu_torch.training.state import QuantizedTrainState, SparseTrainState, TrainState
from pytorchrec_tpu_torch.training.trainer import Trainer

__all__ = ["History", "QuantizedEmbeddingTrainer", "QuantizedTrainState",
           "SparseEmbeddingTrainer", "SparseTrainState", "TrainState", "Trainer"]
