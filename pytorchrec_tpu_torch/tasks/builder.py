"""Build readers and models by registry name, wiring feature columns (port
of ``pytorchrec_tpu/tasks/builder.py``, with its recipes): the CLI and the
harness tasks (``RepeatTask``, ``GridSearch``) assemble experiments from
strings through it.

* The single-task CTR models (lr, fm, deepfm, dcn, dcnv2, dlrm) read every
  categorical column but the labels and bookkeeping ones, and not the
  ``conversion`` label of a multi-task dataset, and every numeric column.
* The multi-task models take ``task_labels`` (default ``("label",
  "conversion")``) as targets and leave them out of the fields; a dataset
  without them raises.
* The value-based RL names build their Q-network over the ``value_rl``
  reader's state, next-state and candidate columns (the uid column for the
  long branch of ``lsrl``, ``lsrl_l`` and ``lsrl_lps``, the negative
  streams for ``deers``, ``lsrl`` and ``lsrl_psns``) inside a
  ``ValueRLModel`` whose reward is the rating column; ``gamma`` and
  ``update_freq`` are hyperparameters of the wrapper.

``device`` (None: the card) is where the model is built.
"""

from __future__ import annotations

from typing import Any, Dict

from pytorchrec_tpu_torch.data.readers import get_data_reader_type
from pytorchrec_tpu_torch.data.readers.base import DataReader
from pytorchrec_tpu_torch.feature_column import CategoricalColumnWithIdentity, NumericColumn
from pytorchrec_tpu_torch.models import get_data_reader_name, get_model_type
from pytorchrec_tpu_torch.models.rl import QNet, ValueRLModel
from pytorchrec_tpu_torch.utils import constants as C

# interaction columns that are labels or bookkeeping, never model inputs
_NON_FEATURE = {C.LABEL, C.RATE, C.TIME, C.INDEX}

RL_MODELS = {"dqn", "deers", "lsrl", "lsrl_l", "lsrl_ps", "lsrl_lps", "lsrl_psns"}
MULTI_TASK_MODELS = ("shared_bottom", "mmoe", "ple", "esmm")


def is_rl_model(model_name: str) -> bool:
    return model_name.lower() in RL_MODELS


def build_reader(model_name: str, dataset: str, **reader_kwargs) -> DataReader:
    """Construct the reader family registered for ``model_name``."""
    reader_type = get_data_reader_type(get_data_reader_name(model_name))
    return reader_type(dataset, **reader_kwargs)


def build_model(model_name: str, reader: DataReader, device=None, **hparams) -> Any:
    """Instantiate a model on ``device`` with its feature columns pulled
    from the reader."""
    name = model_name.lower()
    columns = reader.get_feature_column_dict()
    factory = get_model_type(name)
    hparams = dict(hparams, device=device)
    if name in RL_MODELS:
        return _build_rl_model(name, factory, columns, **hparams)

    if name in ("funksvd", "ncf", "two_tower"):
        return factory(uid_column=columns[C.UID], iid_column=columns[C.IID],
                       label_column=columns[C.LABEL], **hparams)
    if name == "svdpp":
        return factory(uid_column=columns[C.UID], iid_column=columns[C.IID],
                       iids_column=columns[C.IIDS], label_column=columns[C.LABEL], **hparams)
    if name in ("gru4rec", "sasrec"):
        return factory(iid_column=columns[C.IID], his_column=columns[C.POS_HIS],
                       his_len_column=columns[C.POS_HIS_LEN], label_column=columns[C.LABEL],
                       **hparams)
    if name == "din":
        return factory(uid_column=columns[C.UID], iid_column=columns[C.IID],
                       his_column=columns[C.POS_HIS], his_len_column=columns[C.POS_HIS_LEN],
                       label_column=columns[C.LABEL], **hparams)
    dense = [col for col in columns.values() if isinstance(col, NumericColumn)]
    if name in ("lr", "fm", "deepfm", "dcn", "dcnv2", "dlrm"):
        sparse = [col for key, col in columns.items()
                  if isinstance(col, CategoricalColumnWithIdentity)
                  and key not in _NON_FEATURE and col.category_num > 0
                  and key != "conversion"]  # a label on multi-task datasets
        return factory(sparse_columns=tuple(sparse), dense_columns=tuple(dense),
                       label_column=columns[C.LABEL], **hparams)
    if name in MULTI_TASK_MODELS:
        # the task label columns (default: click and conversion) are targets,
        # not input fields
        task_labels = tuple(hparams.pop("task_labels", (C.LABEL, "conversion")))
        missing = [t for t in task_labels if t not in columns]
        if missing:
            raise ValueError(f"multi-task model {model_name!r} needs label columns {missing} in "
                             f"the dataset (generate_synthetic_ctr(with_conversion=True) plants "
                             f"a conversion funnel)")
        sparse = [col for key, col in columns.items()
                  if isinstance(col, CategoricalColumnWithIdentity)
                  and key not in _NON_FEATURE and key not in task_labels
                  and col.category_num > 0]
        return factory(sparse_columns=tuple(sparse), dense_columns=tuple(dense),
                       label_column=columns[C.LABEL],
                       task_columns=tuple(columns[t] for t in task_labels), **hparams)
    raise ValueError(f"no build recipe for model {model_name!r}")


def _build_rl_model(name: str, factory, columns: Dict[str, Any], gamma: float = 0.9,
                    update_freq: int = 10, **hparams) -> ValueRLModel:
    if name == "dqn":
        qnet: QNet = factory(
            iid_column=columns[C.IID], state_column=columns[C.POS_STATE],
            state_len_column=columns[C.POS_STATE_LEN],
            next_state_column=columns[C.POS_NEXT_STATE],
            next_state_len_column=columns[C.POS_NEXT_STATE_LEN],
            rl_sample_column=columns[C.RL_SAMPLE], **hparams)
    else:
        kwargs: Dict[str, Any] = dict(
            iid_column=columns[C.IID], pos_state_column=columns[C.POS_STATE],
            pos_state_len_column=columns[C.POS_STATE_LEN],
            pos_next_state_column=columns[C.POS_NEXT_STATE],
            pos_next_state_len_column=columns[C.POS_NEXT_STATE_LEN],
            rl_sample_column=columns[C.RL_SAMPLE])
        if name in ("lsrl", "lsrl_l", "lsrl_lps"):  # the long branch reads the uid
            kwargs["uid_column"] = columns[C.UID]
        if name in ("deers", "lsrl", "lsrl_psns"):  # the neg branch reads the neg states
            kwargs.update(neg_state_column=columns[C.NEG_STATE],
                          neg_state_len_column=columns[C.NEG_STATE_LEN],
                          neg_next_state_column=columns[C.NEG_NEXT_STATE],
                          neg_next_state_len_column=columns[C.NEG_NEXT_STATE_LEN])
        qnet = factory(**kwargs, **hparams)
    return ValueRLModel(qnet, reward_column=columns[C.REWARD], gamma=gamma,
                        update_freq=update_freq)


def default_reader_kwargs(model_name: str, **overrides) -> Dict[str, Any]:
    """Reader kwargs a model family needs beyond the shared flags (the RL
    models with a negative branch need negative state streams)."""
    kwargs: Dict[str, Any] = {}
    if model_name.lower() in ("deers", "lsrl", "lsrl_psns"):
        kwargs["use_neg_state"] = True
    kwargs.update(overrides)
    return kwargs
