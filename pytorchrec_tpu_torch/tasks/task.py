"""Task: one experiment, train, pick the best epoch, test (port of
``pytorchrec_tpu/tasks/task.py``).

``Task`` seeds, takes a reader and a model (or builds both from registry
names: ``Task.from_config``, the path the CLI takes), wires
``ModelCheckpoint``, ``CSVLogger`` and ``EarlyStopping``, fits, restores the
best epoch's weights, evaluates the test split with a ``CSVLogger`` of its
own and returns ``(best_epoch, best_dev_logs, test_logs)``.

Trainer routing, as the JAX task's: ``"auto"`` gives the dense ``Trainer``
for f32 models and ``QuantizedEmbeddingTrainer(packed_tables=
model.table_packed)`` for models with quantized tables; ``"quantized"``
the latter for any model; ``"sparse"`` ``SparseEmbeddingTrainer(
packed_tables=True)``; ``"dense"`` the dense ``Trainer``, which raises on a
quantized model. A ``ValueRLModel`` goes to ``RLTrainer`` under ``"auto"``
with an f32 network (``"dense"`` too) and to ``SparseRLTrainer`` under
``"auto"`` with a quantized one, and under ``"sparse"`` and ``"quantized"``
with any. ``trainer_kwargs`` reach the sparse and quantized trainers and
raise where the route is a dense one.

``device`` (None: the card; ``"cpu"`` where asked) is where the trainer
runs. ``mesh`` is taken for the JAX signature and raises on anything but
None: multi-device runs are not ported. The best model's file is
``Model/<filename>.pt``, written by ``torch.save``
(``training/checkpoint.py``), where the JAX task writes msgpack.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional, Tuple

from pytorchrec_tpu_torch.data.readers.base import DataReader
from pytorchrec_tpu_torch.data.schema import SplitMode, TrainMode
from pytorchrec_tpu_torch.training import (
    CallbackList,
    CSVLogger,
    EarlyStopping,
    ModelCheckpoint,
    QuantizedEmbeddingTrainer,
    RLTrainer,
    SparseEmbeddingTrainer,
    SparseRLTrainer,
    Trainer,
)
from pytorchrec_tpu_torch.models.rl import ValueRLModel
from pytorchrec_tpu_torch.utils import constants as C
from pytorchrec_tpu_torch.utils.argument import ArgumentDescription, WithArguments

logger = logging.getLogger(__name__)

MODEL_SUFFIX = ".pt"
TRAINER_ROUTES = ("auto", "dense", "sparse", "quantized")


class ITask(WithArguments):
    """Abstract task."""

    def run(self):  # pragma: no cover
        raise NotImplementedError


class Task(ITask):
    @classmethod
    def get_argument_descriptions(cls):
        """The task's declared flags, the same ones the CLI's parser holds."""
        from pytorchrec_tpu_torch.loss import loss_name_list
        from pytorchrec_tpu_torch.models import model_name_list
        from pytorchrec_tpu_torch.optim import optimizer_name_list
        from pytorchrec_tpu_torch.utils.enum_utils import get_enum_values

        return [
            ArgumentDescription("debug", bool, "run without writing artifacts",
                                default_value=False),
            ArgumentDescription("model_name", str, "model name",
                                legal_value_list=model_name_list),
            ArgumentDescription("random_seed", int, "random seed",
                                default_value=2020, lower_closed_bound=0),
            ArgumentDescription("metrics", str, "comma separated, e.g. ndcg@10,hit@5",
                                default_value="ndcg@10"),
            ArgumentDescription("train_mode", str, "training mode",
                                default_value=TrainMode.POINT_WISE.value,
                                legal_value_list=get_enum_values(TrainMode)),
            ArgumentDescription("epoch", int, "training epochs",
                                default_value=100, lower_closed_bound=1),
            ArgumentDescription("batch_size", int, "batch size",
                                default_value=128, lower_closed_bound=1),
            ArgumentDescription("optimizer", str, "optimizer name",
                                default_value="adam",
                                legal_value_list=optimizer_name_list),
            ArgumentDescription("lr", float, "learning rate",
                                default_value=1e-3, lower_open_bound=0),
            ArgumentDescription("l2", float, "weight decay",
                                default_value=0.0, lower_closed_bound=0),
            ArgumentDescription("loss", str, "loss name", default_value="bce",
                                legal_value_list=loss_name_list),
            ArgumentDescription("dev_freq", int, "dev-eval cadence (epochs)",
                                default_value=1, lower_closed_bound=1),
            ArgumentDescription("patience", int, "early-stop patience",
                                default_value=10, lower_closed_bound=0),
            ArgumentDescription("trainer", str,
                                "trainer routing (auto picks the quantized "
                                "trainer for quantized-table models)",
                                default_value="auto", legal_value_list=list(TRAINER_ROUTES)),
        ]

    @classmethod
    def check_argument_values(cls, arguments):
        """Check and normalise: the metric names parse, and ``train_mode``
        becomes the enum."""
        super().check_argument_values(arguments)
        if isinstance(arguments.get("metrics"), str):
            arguments["metrics"] = arguments["metrics"].split(",")
        from pytorchrec_tpu_torch.metric import get_metric

        for name in arguments["metrics"]:
            get_metric(name)  # raises on malformed names
        if isinstance(arguments.get("train_mode"), str):
            arguments["train_mode"] = TrainMode(arguments["train_mode"])

    def __init__(
        self,
        data_reader: DataReader,
        model: Any,
        debug: bool = False,
        random_seed: int = 2020,
        metrics: Optional[List[str]] = None,
        train_mode: Optional[TrainMode] = None,
        epoch: int = 100,
        batch_size: int = 128,
        optimizer: str = "adam",
        lr: float = 1e-3,
        l2: float = 0.0,
        loss: str = "bce",
        dev_freq: int = 1,
        filename: Optional[str] = None,
        monitor: Optional[str] = None,
        monitor_mode: str = "max",
        patience: int = 10,
        verbose: int = 1,
        mesh=None,
        trainer: str = "auto",
        trainer_kwargs=None,
        device=None,
    ):
        if mesh is not None:
            raise NotImplementedError("a mesh (multi-device runs) is not ported yet")
        if trainer not in TRAINER_ROUTES:
            raise ValueError(f"trainer must be one of {TRAINER_ROUTES}, got {trainer!r}")
        self.debug = debug
        self.random_seed = random_seed
        self.metrics = list(metrics or ["ndcg@10"])
        if isinstance(train_mode, str):  # the enum's string value
            train_mode = TrainMode(train_mode)
        self.train_mode = train_mode or data_reader.train_mode
        self.data_reader = data_reader
        self.model = model
        self.epoch = epoch
        self.batch_size = batch_size
        self.optimizer = optimizer
        self.lr = lr
        self.l2 = l2
        self.loss = loss
        self.dev_freq = dev_freq
        self.filename = filename or f"{type(model).__name__}_{data_reader.dataset}_{random_seed}"
        self.monitor = monitor or self.metrics[0]
        self.monitor_mode = monitor_mode
        self.patience = patience
        self.verbose = verbose
        self.mesh = mesh

        tkw = dict(trainer_kwargs or {})  # e.g. {"table_lr": 0.02}
        inner = getattr(model, "qnet", model)  # the RL wrapper holds the network
        quantized = bool(getattr(inner, "quantized_table", False)
                         or getattr(inner, "quantized_embedding", False))
        if trainer == "dense" and quantized:
            raise ValueError("trainer='dense' on a model with quantized byte-row tables: the "
                             "dense trainer cannot differentiate them; use trainer='auto', "
                             "'sparse' or 'quantized'")
        if isinstance(model, ValueRLModel):
            use_sparse = trainer in ("sparse", "quantized") or (trainer == "auto" and quantized)
            if not use_sparse and tkw:
                raise ValueError(f"trainer_kwargs {sorted(tkw)} given but routing resolved to the "
                                 f"dense RLTrainer (trainer={trainer!r}); pass trainer='sparse' "
                                 f"or drop the kwargs")
            self.trainer = (SparseRLTrainer(model, device=device, **tkw) if use_sparse
                            else RLTrainer(model, device=device))
        elif trainer == "quantized" or (trainer == "auto" and quantized):
            tkw.setdefault("packed_tables", bool(getattr(model, "table_packed", True)))
            self.trainer = QuantizedEmbeddingTrainer(model, device=device, **tkw)
        elif trainer == "sparse":
            tkw.setdefault("packed_tables", True)
            self.trainer = SparseEmbeddingTrainer(model, device=device, **tkw)
        else:
            if tkw:
                raise ValueError(f"trainer_kwargs {sorted(tkw)} given but routing resolved to the "
                                 f"dense Trainer (trainer={trainer!r}); pass trainer='sparse' or "
                                 f"'quantized', or drop the kwargs")
            self.trainer = Trainer(model, device=device)

    @classmethod
    def from_config(cls, model_name: str, dataset: str,
                    reader_kwargs: Optional[Dict[str, Any]] = None,
                    model_kwargs: Optional[Dict[str, Any]] = None, device=None,
                    **task_kwargs) -> "Task":
        """Assemble a task from registry names, its model built on
        ``device``."""
        from pytorchrec_tpu_torch.tasks.builder import (
            build_model,
            build_reader,
            default_reader_kwargs,
        )

        reader_kwargs = default_reader_kwargs(model_name, **(reader_kwargs or {}))
        reader_kwargs.setdefault("random_seed", task_kwargs.get("random_seed", 2020))
        reader_kwargs.setdefault("train_mode", task_kwargs.get("train_mode", TrainMode.POINT_WISE))
        reader = build_reader(model_name, dataset, **reader_kwargs)
        model = build_model(model_name, reader, device=device, **(model_kwargs or {}))
        return cls(data_reader=reader, model=model, device=device, **task_kwargs)

    def run(self) -> Tuple[int, Dict[str, float], Dict[str, float]]:
        user_sample_n = 1 + self.data_reader.neg_sample_n \
            if self.data_reader.split_mode == SplitMode.LEAVE_K_OUT else 1
        if user_sample_n == 1 and any("@" in m for m in self.metrics):
            raise ValueError("ranking metrics (ndcg@k/hit@k) need candidate lists, which only "
                             "LEAVE_K_OUT provides; with SEQUENTIAL_SPLIT use point-wise metrics "
                             "(auc, logloss)")
        self.trainer.compile(optimizer=self.optimizer, loss=self.loss, metrics=self.metrics,
                             lr=self.lr, weight_decay=self.l2, user_sample_n=user_sample_n)

        # debug: no file, but the best weights are still kept in host memory
        # (filepath=None), so the test evaluation runs at the best dev epoch
        model_checkpoint = ModelCheckpoint(
            filepath=None if self.debug else os.path.join(C.model_dir(),
                                                          self.filename + MODEL_SUFFIX),
            monitor=self.monitor, mode=self.monitor_mode, save_best_only=True)
        csv_logger = CSVLogger(os.path.join(C.log_dir(), f"{self.filename}.csv"))
        early_stopping = EarlyStopping(monitor=self.monitor, mode=self.monitor_mode,
                                       patience=self.patience)
        callbacks = ([model_checkpoint, early_stopping] if self.debug
                     else [model_checkpoint, csv_logger, early_stopping])

        history = self.trainer.fit(self.data_reader, batch_size=self.batch_size,
                                   epochs=self.epoch, train_mode=self.train_mode,
                                   verbose=self.verbose, callbacks=callbacks, shuffle=True,
                                   drop_last=True, dev_freq=self.dev_freq, seed=self.random_seed)
        self.history = history  # the per-epoch logs, for inspection

        best_epoch, best_dev_logs = history.get_best_epoch_logs(self.monitor, self.monitor_mode)
        if self.trainer.best_params is not None:
            self.trainer.load_best_weights()

        test_cb_list = None
        if not self.debug:
            test_cb_list = CallbackList(
                [CSVLogger(os.path.join(C.log_dir(), f"{self.filename}.test.csv"))],
                trainer=self.trainer)
            test_cb_list.on_train_begin()  # opens the CSV file
        test_logs = self.trainer.evaluate(self.data_reader, split="test",
                                          batch_size=self.batch_size, verbose=self.verbose,
                                          callbacks=test_cb_list)
        if test_cb_list is not None:
            test_cb_list.on_epoch_end(0, test_logs)
            test_cb_list.set_params({"epochs": 1})
            test_cb_list.on_train_end()

        logger.info("task %s: best_epoch=%d dev=%s test=%s", self.filename, best_epoch,
                    best_dev_logs, test_logs)
        return best_epoch, best_dev_logs, test_logs
