"""CLI entry point (port of ``pytorchrec_tpu/console_main.py``): the same
arguments, choices and defaults, and one more, ``--device`` (default
``cuda``; ``cpu`` where asked). Experiments assemble from registry names:

    python -m pytorchrec_tpu_torch.console_main --task_name normal \\
        --model_name funksvd --dataset ML100K --epoch 50 --batch_size 256 \\
        --lr 0.01 --loss bce --metrics ndcg@10,hit@10 --train_mode pair_wise \\
        --reader neg_sample_n=99 --model emb_size=64

(or the ``pytorchrec-tpu-torch`` script). ``--reader k=v`` / ``--model k=v``
(repeatable) pass typed overrides to the reader and model constructors
(values parsed as Python literals, else kept as strings). The work dir is
``PYTORCHREC_TPU_WORK_DIR``.
"""

from __future__ import annotations

import argparse
import ast
import logging
import sys
from typing import Any, Dict, List, Optional

from pytorchrec_tpu_torch.data.schema import SplitMode, TrainMode
from pytorchrec_tpu_torch.utils.system import init_console_logger


def _parse_overrides(pairs: List[str]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for pair in pairs or []:
        if "=" not in pair:
            raise SystemExit(f"override {pair!r} must look like key=value")
        key, raw = pair.split("=", 1)
        try:
            out[key] = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            out[key] = raw
    return out


def build_parser() -> argparse.ArgumentParser:
    from pytorchrec_tpu_torch.models import model_name_list
    from pytorchrec_tpu_torch.loss import loss_name_list
    from pytorchrec_tpu_torch.optim import optimizer_name_list
    from pytorchrec_tpu_torch.tasks import task_name_list
    from pytorchrec_tpu_torch.utils.enum_utils import get_enum_values

    parser = argparse.ArgumentParser(
        prog="pytorchrec-tpu-torch",
        description="recommender framework on PyTorch and CUDA",
    )
    parser.add_argument("--task_name", default="normal", choices=task_name_list)
    parser.add_argument("--model_name", required=True, choices=model_name_list)
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--debug", action="store_true",
                        help="run without writing model/log artifacts")
    parser.add_argument("--random_seed", type=int, default=2020)
    parser.add_argument("--metrics", default="ndcg@10",
                        help="comma separated, e.g. ndcg@10,hit@5,auc")
    parser.add_argument("--train_mode", default=TrainMode.POINT_WISE.value,
                        choices=get_enum_values(TrainMode))
    parser.add_argument("--split_mode", default=SplitMode.LEAVE_K_OUT.value,
                        choices=get_enum_values(SplitMode))
    parser.add_argument("--epoch", type=int, default=100)
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--optimizer", default="adam", choices=optimizer_name_list)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--l2", type=float, default=0.0)
    parser.add_argument("--loss", default="bce", choices=loss_name_list)
    parser.add_argument("--dev_freq", type=int, default=1)
    parser.add_argument("--patience", type=int, default=10)
    parser.add_argument("--monitor", default=None,
                        help="metric to monitor (default: first of --metrics)")
    parser.add_argument("--monitor_mode", default="max", choices=("max", "min"))
    parser.add_argument("--verbose", type=int, default=1)
    parser.add_argument("--trainer", default="auto",
                        choices=("auto", "dense", "sparse", "quantized"),
                        help="trainer routing (auto picks the quantized "
                             "trainer for quantized-table models)")
    parser.add_argument("--repeat_num", type=int, default=5,
                        help="repeat task only")
    parser.add_argument("--reader", action="append", metavar="K=V",
                        help="reader constructor override (repeatable)")
    parser.add_argument("--model", action="append", metavar="K=V",
                        help="model constructor override (repeatable)")
    parser.add_argument("--grid_model", action="append", metavar="K=V1,V2,...",
                        help="grid_search: model hyperparameter axis (repeatable)")
    parser.add_argument("--grid_lr", default=None, metavar="V1,V2,...",
                        help="grid_search: learning-rate axis")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the run trains (cuda: the card)")
    return parser


def _parse_grid_axis(pair: str):
    if "=" not in pair:
        raise SystemExit(f"grid axis {pair!r} must look like key=v1,v2,...")
    key, raw = pair.split("=", 1)
    values = []
    for item in raw.split(","):
        try:
            values.append(ast.literal_eval(item))
        except (ValueError, SyntaxError):
            values.append(item)
    return key, values


def main(argv: Optional[List[str]] = None) -> int:
    init_console_logger()
    args = build_parser().parse_args(argv)
    from pytorchrec_tpu_torch.tasks import RepeatTask, Task

    reader_kwargs = _parse_overrides(args.reader)
    reader_kwargs.setdefault("split_mode", SplitMode(args.split_mode))
    model_kwargs = _parse_overrides(args.model)
    task_kwargs = dict(
        random_seed=args.random_seed,
        metrics=args.metrics.split(","),
        train_mode=TrainMode(args.train_mode),
        epoch=args.epoch,
        batch_size=args.batch_size,
        optimizer=args.optimizer,
        lr=args.lr,
        l2=args.l2,
        loss=args.loss,
        dev_freq=args.dev_freq,
        patience=args.patience,
        monitor=args.monitor,
        monitor_mode=args.monitor_mode,
        verbose=args.verbose,
        trainer=args.trainer,
        device=args.device,
    )

    if args.task_name == "repeat":
        task = RepeatTask(
            repeat_num=args.repeat_num,
            model_name=args.model_name,
            dataset=args.dataset,
            reader_kwargs=reader_kwargs,
            model_kwargs=model_kwargs,
            **task_kwargs,
        )
        task.run()
    elif args.task_name == "grid_search":
        from pytorchrec_tpu_torch.data.process.io import frame_rows
        from pytorchrec_tpu_torch.tasks import GridSearch, create_params_list

        if not args.grid_model and not args.grid_lr:
            raise SystemExit(
                "grid_search needs at least one axis: --grid_model k=v1,v2 "
                "and/or --grid_lr v1,v2"
            )
        model_axes = dict(_parse_grid_axis(p) for p in (args.grid_model or []))
        model_grid = create_params_list(model_kwargs, model_axes)
        lr_values = (
            [ast.literal_eval(v) for v in args.grid_lr.split(",")]
            if args.grid_lr else [args.lr]
        )
        optim_grid = create_params_list({}, {"lr": lr_values})
        task_kwargs.pop("lr", None)
        task = GridSearch(
            model_name=args.model_name,
            dataset=args.dataset,
            model_params_list=model_grid,
            optimizer_params_list=optim_grid,
            reader_kwargs=reader_kwargs,
            **task_kwargs,
        )
        frame = task.run()
        logging.getLogger(__name__).info(
            "grid search done: %d combos -> %s", frame_rows(frame), task.log_filename
        )
    else:
        task = Task.from_config(
            args.model_name,
            args.dataset,
            reader_kwargs=reader_kwargs,
            model_kwargs=model_kwargs,
            debug=args.debug,
            **task_kwargs,
        )
        best_epoch, best_dev, test = task.run()
        logging.getLogger(__name__).info(
            "done: best_epoch=%s dev=%s test=%s", best_epoch, best_dev, test
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
