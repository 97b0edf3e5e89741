"""The offline processing pipeline (port of ``pytorchrec_tpu/data/process``)
over numpy frames (``io.py``): splits, dev/test negatives, histories and
next-state arrays, dataset discovery, the synthetic generators and raw
formatters (``datasets/``) and pandas' text reading without pandas
(``text.py``), and the value-RL candidate sets (``rl_sample.py``)."""

from pytorchrec_tpu_torch.data.process.splits import (
    check_leave_k_out_split,
    check_sequential_split,
    generate_leave_k_out_split,
    generate_sequential_split,
)
from pytorchrec_tpu_torch.data.process.vt_negative_sample import (
    check_vt_negative_sample,
    generate_vt_negative_sample,
)
from pytorchrec_tpu_torch.data.process.history import (
    check_interaction_history_list,
    check_interaction_next_state_list,
    generate_interaction_history_list,
    generate_interaction_next_state_list,
)
from pytorchrec_tpu_torch.data.process.dataset_info import check_dataset_info
from pytorchrec_tpu_torch.data.process.rl_sample import (
    check_rl_next_item_sample,
    generate_rl_next_item_sample,
)

__all__ = [
    "generate_sequential_split",
    "check_sequential_split",
    "generate_leave_k_out_split",
    "check_leave_k_out_split",
    "generate_vt_negative_sample",
    "check_vt_negative_sample",
    "generate_interaction_history_list",
    "check_interaction_history_list",
    "generate_interaction_next_state_list",
    "check_interaction_next_state_list",
    "check_dataset_info",
    "generate_rl_next_item_sample",
    "check_rl_next_item_sample",
]
