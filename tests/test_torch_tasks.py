"""The normal entry point, the port against the JAX package on the CPU: the
registries, the builder, the trainer routing, ``Task.run``, the repeat and
grid-search harnesses, the CLI, the flags and the profiling helpers.

Each package generates the same synthetic dataset in a work dir of its own
(``PYTORCHREC_TPU_WORK_DIR``) and reads it with its own reader, as
``tests/test_torch_reader_fit.py`` does. The CTR dataset is
``generate_synthetic_ctr(n_rows=900, n_dense=3, vocab (50, 8, 200),
with_conversion=True)``, split sequentially (``warm_n=1``, ``vt_ratio=0.1``).

Runs compared with JAX's start from the same weights: each package's
``Task.run`` is wrapped (``same_start``) so that the JAX task's trainer is
compiled, initialised from its seed and its leaves spread
(``tests/test_torch_reader_fit.py::_spread``: kernels N(0, 2 / fan_in),
tables N(0, 0.5), so that gradients stay out of Adam's eps window), and
the port's task, run next under the same file name, loads those leaves
(``params_from_jax``). Then ``best_epoch`` is equal, and the dev and test
logs and every value of the CSV and TSV files rtol 1e-4 (f32 after N steps,
``ROADMAP.md``).
"""

import csv
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import pytorchrec_tpu_torch
from pytorchrec_tpu import console_main as jax_console
from pytorchrec_tpu import loss as jax_loss
from pytorchrec_tpu import models as jax_models
from pytorchrec_tpu import optim as jax_optim
from pytorchrec_tpu import tasks as jax_tasks
from pytorchrec_tpu.data.process.datasets.synthetic import (
    generate_synthetic_ctr as jax_generate_ctr,
    generate_synthetic_ml as jax_generate_ml,
)
from pytorchrec_tpu.data.schema import SplitMode as JaxSplitMode
from pytorchrec_tpu.tasks.task import Task as JaxTask
from pytorchrec_tpu_torch import console_main, data, loss, models, optim, tasks
from pytorchrec_tpu_torch.data import SplitMode, TrainMode
from pytorchrec_tpu_torch.tasks import GridSearch, RepeatTask, Task
from pytorchrec_tpu_torch.training import (
    QuantizedEmbeddingTrainer,
    RLTrainer,
    SparseEmbeddingTrainer,
    SparseRLTrainer,
    Trainer,
)
from pytorchrec_tpu_torch.utils import constants as C
from pytorchrec_tpu_torch.utils import params_from_jax
from pytorchrec_tpu_torch.utils.argument import ArgumentDescription, WithArguments, str2bool
from pytorchrec_tpu_torch.utils.convert import UNREAD_LEAVES, leaves_of
from pytorchrec_tpu_torch.utils.profiling import (
    TorchProfiler,
    disable_nan_debugging,
    enable_nan_debugging,
)
import torch_mesh_workers
from test_torch_reader_fit import _spread

WORK_DIR = "PYTORCHREC_TPU_WORK_DIR"
RTOL = 1e-4
CTR = dict(n_rows=900, n_dense=3, sparse_vocab_sizes={"c_0": 50, "c_1": 8, "c_2": 200}, seed=5,
           with_conversion=True)
CTR_READER = dict(split_mode=SplitMode.SEQUENTIAL_SPLIT, warm_n=1, vt_ratio=0.1)
JAX_CTR_READER = dict(CTR_READER, split_mode=JaxSplitMode.SEQUENTIAL_SPLIT)
ML_READERS = {"simple": dict(neg_sample_n=9), "history": dict(neg_sample_n=9, max_his_len=5),
              "svdpp": dict(neg_sample_n=9, limit=8)}
CTR_ARGV = ["--dataset", "TaskCtr", "--epoch", "2", "--batch_size", "64", "--lr", "0.01",
            "--split_mode", "sequential_split", "--reader", "warm_n=1", "--reader",
            "vt_ratio=0.1", "--verbose", "0", "--model", "emb_size=4"]


def _flat(tree):
    tree = jax.device_get(tree)
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def _tree(flat):
    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                         for k, v in flat.items()})


@pytest.fixture
def dirs(tmp_path, monkeypatch):
    """The CTR dataset generated by each package into its own work dir; the
    port's is current."""
    out = {}
    for tag, generate in (("jax", jax_generate_ctr), ("port", data.generate_synthetic_ctr)):
        out[tag] = tmp_path / tag
        monkeypatch.setenv(WORK_DIR, str(out[tag]))
        generate("TaskCtr", **CTR)
    return out


@pytest.fixture
def same_start(monkeypatch):
    """Both packages' ``Task.run`` start from JAX's spread leaves (see the
    module docstring); returns the leaves by task file name."""
    starts = {}
    jax_run, port_run = JaxTask.run, Task.run

    def compile_and_init(task):
        task.trainer.compile(optimizer=task.optimizer, loss=task.loss, metrics=task.metrics,
                             lr=task.lr, weight_decay=task.l2, user_sample_n=1)
        task.trainer.init_state(task.data_reader.get_batch("train", np.arange(2)),
                                seed=task.random_seed)

    def jax_start(self):
        compile_and_init(self)
        flat = _spread(_flat(self.trainer.state.params), self.model.emb_size,
                       seed=self.random_seed)
        self.trainer.state = self.trainer.state.replace(params=_tree(flat))
        starts[self.filename] = flat
        return jax_run(self)

    def port_start(self):
        compile_and_init(self)
        params_from_jax(starts[self.filename], self.trainer)
        return port_run(self)

    monkeypatch.setattr(JaxTask, "run", jax_start)
    monkeypatch.setattr(Task, "run", port_start)
    return starts


def _close_logs(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)


def _read_table(path):
    with open(path, newline="") as f:
        return list(csv.reader(f, delimiter="\t"))


def _tables_close(got_path, want_path):
    """Two tab-separated files: the same header and, cell by cell, the same
    text, or numbers rtol 1e-4."""
    got, want = _read_table(got_path), _read_table(want_path)
    assert got[0] == want[0] and len(got) == len(want)
    for got_row, want_row in zip(got[1:], want[1:]):
        assert len(got_row) == len(want_row)
        for column, g, w in zip(want[0], got_row, want_row):
            try:
                w_value = float(w)
            except ValueError:
                assert g == w, (column, g, w)
                continue
            if w.lstrip("-").isdigit():
                assert g == w, (column, g, w)  # ints, the index and the best epoch
            else:
                np.testing.assert_allclose(float(g), w_value, rtol=RTOL, err_msg=column)


# ---------------------------------------------------------------------------
# registries, flags and the builder
# ---------------------------------------------------------------------------


def test_registries_match_jax():
    assert len(models.model_name_list) == 24
    assert models.model_name_list == list(jax_models.model_name_list)
    assert tasks.task_name_list == list(jax_tasks.task_name_list)
    assert optim.optimizer_name_list == list(jax_optim.optimizer_name_list)
    assert loss.loss_name_list == list(jax_loss.loss_name_list)
    for name in jax_models.model_name_list:
        assert models.get_data_reader_name(name) == jax_models.get_data_reader_name(name), name
    assert tasks.get_task_type("normal") is Task
    assert tasks.get_task_type("repeat") is RepeatTask
    assert tasks.get_task_type("grid_search") is GridSearch
    assert pytorchrec_tpu_torch.Task is Task and "Task" in dir(pytorchrec_tpu_torch)


def test_parser_matches_jax_plus_device():
    def actions(parser):
        return {a.dest: (a.default, a.choices, a.required, type(a).__name__)
                for a in parser._actions if a.dest != "help"}

    got, want = actions(console_main.build_parser()), actions(jax_console.build_parser())
    assert got.pop("device") == ("cuda", ("cuda", "cpu"), False, "_StoreAction")
    assert got == want


def test_flags_match_jax():
    from pytorchrec_tpu.utils import argument as jax_argument

    def described(cls):
        return [(d.name, d.type, d.default_value, d.legal_value_list, d.lower_closed_bound,
                 d.lower_open_bound) for d in cls.get_argument_descriptions()]

    assert described(Task) == described(JaxTask)
    for value in ("yes", "T", "1", "n", "False", "0", True):
        assert str2bool(value) == jax_argument.str2bool(value)
    with pytest.raises(Exception):
        str2bool("maybe")
    arguments = {"model_name": "mmoe", "metrics": "auc/0,auc/1", "train_mode": "point_wise"}
    Task.check_argument_values(arguments)
    assert arguments["metrics"] == ["auc/0", "auc/1"] and arguments["epoch"] == 100
    assert arguments["train_mode"] is TrainMode.POINT_WISE
    for bad in ({"model_name": "nope"}, {"model_name": "mmoe", "lr": 0.0},
                {"model_name": "mmoe", "metrics": "auc@x"}):
        with pytest.raises(ValueError):
            Task.check_argument_values(dict(bad))
    with pytest.raises(ValueError, match="required"):
        WithArguments.check_argument_values.__func__(
            type("T", (WithArguments,), {"get_argument_descriptions": classmethod(
                lambda cls: [ArgumentDescription("x", int)])}), {})


def _readers(tmp_path, monkeypatch):
    """Each package's readers by family, over its own datasets."""
    out = {}
    for tag, generate_ml, generate_ctr, package in (
            ("jax", jax_generate_ml, jax_generate_ctr, jax_tasks),
            ("port", data.generate_synthetic_ml, data.generate_synthetic_ctr, tasks)):
        monkeypatch.setenv(WORK_DIR, str(tmp_path / tag))
        generate_ml("BuildML", n_users=30, n_items=80, seed=1)
        generate_ctr("TaskCtr", **CTR)
        family = {"funksvd": "simple", "svdpp": "svdpp", "din": "history", "dcnv2": "ctr"}
        readers = {}
        for name, kind in family.items():
            if kind == "ctr":
                readers[kind] = package.build_reader(
                    name, "TaskCtr", **(JAX_CTR_READER if tag == "jax" else CTR_READER))
            else:
                readers[kind] = package.build_reader(name, "BuildML", **ML_READERS[kind])
        out[tag] = readers
    return out


def test_builder_leaves_match_jax(tmp_path, monkeypatch):
    """Every non-RL name, built from each package's reader: the flax paths
    and shapes of the port's leaves are JAX's (less the leaves a JAX CTR
    tree declares and never reads, ``UNREAD_LEAVES``)."""
    readers = _readers(tmp_path, monkeypatch)
    names = [n for n in jax_models.model_name_list if not jax_tasks.is_rl_model(n)]
    assert len(names) == 17
    for name in names:
        kind = jax_models.get_data_reader_name(name)
        jax_reader, port_reader = readers["jax"][kind], readers["port"][kind]
        jax_model = jax_tasks.build_model(name, jax_reader)
        params = jax_model.init(jax.random.PRNGKey(0), jax_reader.get_batch("train", np.arange(2)))
        want = {k: v.shape for k, v in _flat(params["params"]).items()}
        port_model = tasks.build_model(name, port_reader, device="cpu")
        got = {k: tuple(v.shape) for k, v in leaves_of(port_model).items()}
        extra = set(want) - set(got)
        assert extra <= UNREAD_LEAVES, (name, extra)
        assert got == {k: want[k] for k in got}, name
    with pytest.raises(ValueError, match="label columns"):
        tasks.build_model("mmoe", readers["port"]["simple"], device="cpu")


RL_READER = dict(neg_sample_n=9, max_state_len=5, rl_sample_len=4)
RL_ARGV = ["--dataset", "BuildML", "--epoch", "6", "--batch_size", "16", "--dev_freq", "3",
           "--loss", "mse", "--metrics", "ndcg@5,hit@5", "--verbose", "0", "--reader",
           "neg_sample_n=9", "--reader", "max_state_len=5", "--reader", "rl_sample_len=4",
           "--model", "emb_size=4", "--model", "hidden_size=4", "--device", "cpu"]


@pytest.mark.parametrize("name", ["dqn", "deers", "lsrl", "lsrl_l", "lsrl_ps", "lsrl_lps",
                                  "lsrl_psns"])
def test_rl_names_build_and_run(name, tmp_path, monkeypatch):
    """Each value-based RL name builds from both packages' ``value_rl``
    readers with JAX's leaf paths and shapes, and the CLI trains it on the
    CPU (6 batch-"epochs", dev metrics every 3) and writes its log."""
    assert tasks.is_rl_model(name) and models.get_data_reader_name(name) == "value_rl"
    built = {}
    for tag, generate, package in (("jax", jax_generate_ml, jax_tasks),
                                   ("port", data.generate_synthetic_ml, tasks)):
        monkeypatch.setenv(WORK_DIR, str(tmp_path / tag))
        generate("BuildML", n_users=30, n_items=80, seed=1)
        built[tag] = package.build_reader(
            name, "BuildML", **package.default_reader_kwargs(name, **RL_READER))
    assert isinstance(built["port"], data.ValueRLDataReader)
    assert built["port"].use_neg_next_state == (name in ("deers", "lsrl", "lsrl_psns"))
    jax_model = jax_tasks.build_model(name, built["jax"], emb_size=4, hidden_size=4,
                                      update_freq=5)
    params = jax_model.init(jax.random.PRNGKey(0), built["jax"].get_batch("train", np.arange(2)))
    port_model = tasks.build_model(name, built["port"], device="cpu", emb_size=4, hidden_size=4,
                                   update_freq=5)
    assert type(port_model).__name__ == type(jax_model).__name__ == "ValueRLModel"
    assert port_model.update_freq == 5 and port_model.gamma == jax_model.gamma
    got = {k: tuple(v.shape) for k, v in leaves_of(port_model.qnet).items()}
    assert got == {k: v.shape for k, v in _flat(params["params"]).items()}
    assert console_main.main(["--model_name", name, *RL_ARGV]) == 0
    logs = os.listdir(tmp_path / "port" / "Log")
    assert any(f.endswith(".csv") and not f.endswith(".test.csv") for f in logs), logs
    assert any(f.endswith(".test.csv") for f in logs), logs


def test_rl_trainer_routing(tmp_path, monkeypatch):
    """A ``ValueRLModel``: ``auto`` gives ``RLTrainer`` for an f32 network
    and ``SparseRLTrainer`` for a quantized one; ``sparse`` and
    ``quantized`` give ``SparseRLTrainer`` (with the kwargs); kwargs on the
    dense route raise."""
    monkeypatch.setenv(WORK_DIR, str(tmp_path))
    data.generate_synthetic_ml("BuildML", n_users=30, n_items=80, seed=1)
    reader = tasks.build_reader("dqn", "BuildML", **RL_READER)

    def routed(route, trainer_kwargs=None, **model_kwargs):
        model = tasks.build_model("dqn", reader, device="cpu", emb_size=4, **model_kwargs)
        return Task(reader, model, trainer=route, trainer_kwargs=trainer_kwargs,
                    device="cpu").trainer

    assert type(routed("auto")) is RLTrainer and type(routed("dense")) is RLTrainer
    assert type(routed("auto", quantized_table=True)) is SparseRLTrainer
    t = routed("sparse", trainer_kwargs={"packed_tables": True})
    assert type(t) is SparseRLTrainer and t.packed_tables
    t = routed("quantized", trainer_kwargs={"table_lr": 0.02}, quantized_table=True)
    assert type(t) is SparseRLTrainer and t._table_lr_override == 0.02
    assert type(routed("sparse")) is SparseRLTrainer and not routed("sparse").packed_tables
    with pytest.raises(ValueError, match="trainer_kwargs"):
        routed("auto", trainer_kwargs={"table_lr": 0.02})
    with pytest.raises(ValueError, match="dense"):
        routed("dense", quantized_table=True)


# ---------------------------------------------------------------------------
# trainer routing
# ---------------------------------------------------------------------------


def test_trainer_routing(dirs, monkeypatch):
    reader = tasks.build_reader("dcnv2", "TaskCtr", **CTR_READER)

    def routed(route, trainer_kwargs=None, **model_kwargs):
        model = tasks.build_model("mmoe", reader, device="cpu", emb_size=4, **model_kwargs)
        return Task(reader, model, trainer=route, trainer_kwargs=trainer_kwargs,
                    device="cpu").trainer

    unified = dict(unified_embedding=True)
    int8 = dict(unified, quantized_embedding=True, table_packed=True)
    classic = dict(unified, quantized_embedding=True)
    assert type(routed("auto")) is Trainer
    assert type(routed("dense")) is Trainer
    t = routed("auto", **int8)
    assert type(t) is QuantizedEmbeddingTrainer and t.packed_tables
    t = routed("auto", **classic)
    assert type(t) is QuantizedEmbeddingTrainer and not t.packed_tables
    t = routed("quantized", trainer_kwargs={"table_lr": 0.02}, **int8)
    assert type(t) is QuantizedEmbeddingTrainer and t._table_lr_override == 0.02
    t = routed("sparse", **unified)
    assert type(t) is SparseEmbeddingTrainer and t.packed_tables
    t = routed("sparse", trainer_kwargs={"packed_tables": False}, **unified)
    assert type(t) is SparseEmbeddingTrainer and not t.packed_tables
    with pytest.raises(ValueError, match="dense"):
        routed("dense", **int8)
    with pytest.raises(ValueError, match="trainer_kwargs"):
        routed("dense", trainer_kwargs={"table_lr": 0.02})
    with pytest.raises(ValueError, match="trainer_kwargs"):
        routed("auto", trainer_kwargs={"table_lr": 0.02})
    with pytest.raises(ValueError, match="trainer must be"):
        routed("fast")
    model = tasks.build_model("dcnv2", reader, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        Task(reader, model, mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Task.from_config("dcnv2", "TaskCtr", reader_kwargs=CTR_READER)


def test_task_runs_on_a_mesh_as_in_one_process(tmp_path, monkeypatch):
    """``Task.from_config("dcnv2", ..., mesh=make_mesh(2, 1))`` for one epoch
    on two gloo ranks (``torch_mesh_workers.task_rank``): both ranks end at
    the one process's step with its dev and test metrics, and rank 0 alone
    wrote the best model and the logs."""
    monkeypatch.setenv(WORK_DIR, str(tmp_path / "work"))
    data.generate_synthetic_ctr("MeshCtr", **CTR)
    tasks.build_reader("dcnv2", "MeshCtr", **CTR_READER)  # the split files, made once
    kwargs = dict(epoch=1, batch_size=64, lr=0.01, metrics=["auc", "logloss"], verbose=0)
    inputs = dict(dataset="MeshCtr", reader=CTR_READER, model=dict(emb_size=4), task=kwargs)
    (tmp_path / "world").mkdir()
    torch.save(inputs, tmp_path / "world" / "inputs.pt")
    ranks = torch_mesh_workers.run_world(torch_mesh_workers.task_rank, 2, tmp_path / "world")
    written = sorted(os.listdir(C.model_dir())), sorted(os.listdir(C.log_dir()))
    for kind in ("Model", "Log"):
        shutil.rmtree(tmp_path / "work" / kind)
    task = Task.from_config("dcnv2", "MeshCtr", reader_kwargs=CTR_READER,
                            model_kwargs=dict(emb_size=4), device="cpu", **kwargs)
    best_epoch, dev, test = task.run()
    assert (sorted(os.listdir(C.model_dir())), sorted(os.listdir(C.log_dir()))) == written
    for got in ranks:
        assert got["best_epoch"] == best_epoch and got["step"] == task.trainer.state.step
        for want, logs in ((dev, got["dev"]), (test, got["test"])):
            assert set(logs) == set(want)
            for name, value in want.items():
                np.testing.assert_allclose(logs[name], value, rtol=1e-4)


# ---------------------------------------------------------------------------
# Task.run, the harnesses and the CLI against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["auto", "sparse"])
def test_task_run_matches_jax(route, dirs, same_start, monkeypatch):
    model_kwargs = dict(emb_size=4, num_cross_layers=2, layers=(8,),
                        unified_embedding=route == "sparse")
    task_kwargs = dict(metrics=["auc", "logloss"], epoch=2, batch_size=64, lr=1e-2, verbose=0,
                       trainer=route, model_kwargs=model_kwargs)
    monkeypatch.setenv(WORK_DIR, str(dirs["jax"]))
    want = JaxTask.from_config("dcnv2", "TaskCtr", reader_kwargs=JAX_CTR_READER,
                               **task_kwargs).run()
    monkeypatch.setenv(WORK_DIR, str(dirs["port"]))
    task = Task.from_config("dcnv2", "TaskCtr", device="cpu", reader_kwargs=CTR_READER,
                            **task_kwargs)
    got = task.run()
    assert got[0] == want[0]
    _close_logs(got[1], want[1])
    _close_logs(got[2], want[2])
    name = task.filename
    for suffix in (".csv", ".test.csv"):
        _tables_close(dirs["port"] / "Log" / (name + suffix), dirs["jax"] / "Log" / (name + suffix))
    assert os.path.getsize(dirs["port"] / "Model" / f"{name}.pt") > 0
    assert (dirs["jax"] / "Model" / f"{name}.msgpack").exists()

    # debug: the same run writes no file, and tests at the best epoch still
    before = sorted(p.name for p in dirs["port"].rglob("*"))
    debug = Task.from_config("dcnv2", "TaskCtr", device="cpu", debug=True,
                             reader_kwargs=CTR_READER, filename="DebugRun", **task_kwargs)
    same_start["DebugRun"] = same_start[name]
    assert debug.run()[0] == want[0]
    assert sorted(p.name for p in dirs["port"].rglob("*")) == before


def _both_mains(argv, dirs, monkeypatch):
    monkeypatch.setenv(WORK_DIR, str(dirs["jax"]))
    assert jax_console.main(argv) == 0
    monkeypatch.setenv(WORK_DIR, str(dirs["port"]))
    assert console_main.main(argv + ["--device", "cpu"]) == 0


def test_cli_matches_jax(dirs, same_start, monkeypatch):
    argv = ["--model_name", "mmoe", "--trainer", "sparse", "--metrics", "auc/0,auc/1",
            "--optimizer", "adamw", "--l2", "1e-4", "--model", "unified_embedding=True",
            "--model", "expert_layers=(8,4)", "--model", "tower_layers=(4,)",
            "--model", "n_experts=3"] + CTR_ARGV
    _both_mains(argv, dirs, monkeypatch)
    (name,) = same_start
    for suffix in (".csv", ".test.csv"):
        _tables_close(dirs["port"] / "Log" / (name + suffix), dirs["jax"] / "Log" / (name + suffix))
    with pytest.raises(SystemExit):
        console_main.main(["--model_name", "nope", "--dataset", "TaskCtr", "--device", "cpu"])
    with pytest.raises(SystemExit):
        console_main.main(["--model_name", "mmoe", "--dataset", "TaskCtr", "--device", "tpu"])


def test_repeat_and_grid_search_tables_match_jax(dirs, same_start, monkeypatch):
    repeat = ["--task_name", "repeat", "--repeat_num", "2", "--model_name", "dcnv2",
              "--metrics", "auc,logloss", "--optimizer", "adagrad"] + CTR_ARGV
    _both_mains(repeat, dirs, monkeypatch)
    grid = ["--task_name", "grid_search", "--grid_lr", "0.01,0.001", "--model_name", "esmm",
            "--loss", "esmm", "--metrics", "auc/0,auc/1",
            "--model", "bottom_layers=(8,)"] + CTR_ARGV
    _both_mains(grid, dirs, monkeypatch)
    assert len(same_start) == 4
    tables = {"RepeatTask": "dcnv2_TaskCtr_bce_repeat_2.csv",
              "GridSearch": "esmm_TaskCtr_esmm_grid_search.csv"}
    for folder, filename in tables.items():
        _tables_close(dirs["port"] / folder / filename, dirs["jax"] / folder / filename)
        header = _read_table(dirs["port"] / folder / filename)[0]
        assert header[0] == "" and "best_epoch" in header
    monkeypatch.setenv(WORK_DIR, str(dirs["port"]))
    frame = GridSearch("esmm", "TaskCtr", tasks.create_params_list({"bottom_layers": (8,),
                                                                     "emb_size": 4}, {}),
                       tasks.create_params_list({}, {"lr": [0.01]}), reader_kwargs=CTR_READER,
                       device="cpu", loss="esmm", metrics=["auc/0"], epoch=1,
                       batch_size=64, verbose=0).run()
    assert list(frame)[:5] == ["model", "dataset", "seed", "lr", "best_epoch"]
    assert frame["seed"].tolist() == [2020] and np.isfinite(frame["test_auc/0"]).all()


def test_create_params_list_matches_jax():
    base, search = {"emb_size": 4, "layers": [8]}, {"emb_size": [4, 8], "dropout": [0.0, 0.1]}
    assert tasks.create_params_list(base, search) == jax_tasks.create_params_list(base, search)


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


class _Reader:
    train_mode = TrainMode.POINT_WISE

    def __init__(self, rows=256, seed=0):
        rng = np.random.default_rng(seed)
        self.frame = {f"c_{i}": rng.integers(0, 20, rows).astype(np.int32) for i in range(2)}
        self.frame["d_0"] = rng.normal(size=rows).astype(np.float32)
        self.frame["label"] = rng.integers(0, 2, rows).astype(np.int32)

    def get_dataset_size(self, split):
        return len(self.frame["label"])

    def get_train_dataset_size(self):
        return self.get_dataset_size("train")

    def get_batch(self, split, indices):
        return {k: v[indices] for k, v in self.frame.items()}


def _small_trainer():
    from pytorchrec_tpu_torch import feature_column as tfc

    model = models.DCNv2(
        sparse_columns=[tfc.CategoricalColumnWithIdentity(f"c_{i}", 20) for i in range(2)],
        dense_columns=[tfc.NumericColumn("d_0")],
        label_column=tfc.CategoricalColumnWithIdentity("label", 2), emb_size=4,
        num_cross_layers=1, layers=(8,), device="cpu")
    trainer = Trainer(model, device="cpu")
    trainer.compile(metrics=("auc",))
    return trainer


def test_torch_profiler_writes_a_trace(tmp_path):
    trainer = _small_trainer()
    profiler = TorchProfiler(str(tmp_path / "trace"), start_batch=1, num_batches=2)
    trainer.fit(_Reader(), batch_size=32, epochs=1, verbose=0, callbacks=[profiler])
    assert profiler.trace_path is not None and os.path.getsize(profiler.trace_path) > 0
    with open(profiler.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_nan_debugging_raises_under_fit():
    trainer = _small_trainer()
    reader = _Reader()
    trainer.fit(reader, batch_size=32, epochs=1, verbose=0)  # finite: no raise
    with torch.no_grad():
        trainer.model.deep.layers[0].linear.weight[0, 0] = float("nan")
    enable_nan_debugging()
    try:
        assert torch.is_anomaly_enabled() and not trainer._captures()
        with pytest.raises(RuntimeError, match="nan"):
            trainer.fit(reader, batch_size=32, epochs=1, verbose=0)
    finally:
        disable_nan_debugging()
    assert not torch.is_anomaly_enabled()
    trainer.fit(reader, batch_size=32, epochs=1, verbose=0)  # NaN losses, no raise
    assert not bool(torch.isfinite(trainer.step_losses).any())
