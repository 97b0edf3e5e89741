"""The port's small utilities against the JAX package's, on the CPU:
``Timer``, the constants under ``PYTORCHREC_TPU_WORK_DIR``,
``check_dir_and_mkdir``, the nested-structure helpers, ``get_enum_values``
and the split and train modes, ``StepTimer.stats`` and
``environment_summary``."""

import os
import time
from collections import namedtuple

import numpy as np
import pytest
import torch

from pytorchrec_tpu.data.schema import SplitMode as JaxSplitMode
from pytorchrec_tpu.data.schema import TrainMode as JaxTrainMode
from pytorchrec_tpu.utils import constants as JC
from pytorchrec_tpu.utils import system as jax_system
from pytorchrec_tpu.utils.enum_utils import get_enum_values as jax_enum_values
from pytorchrec_tpu.utils.profiling import StepTimer as JaxStepTimer
from pytorchrec_tpu_torch.data import SplitMode, TrainMode
from pytorchrec_tpu_torch.utils import Timer, environment_summary
from pytorchrec_tpu_torch.utils import constants as C
from pytorchrec_tpu_torch.utils import data_structure as ds
from pytorchrec_tpu_torch.utils import system
from pytorchrec_tpu_torch.utils.enum_utils import get_enum_values
from pytorchrec_tpu_torch.utils.profiling import StepTimer


def test_timer_prints_and_keeps_the_elapsed_time(capsys):
    with Timer("step", divided_by=4) as timer:
        time.sleep(0.01)
    assert timer.elapsed >= 0.01
    out = capsys.readouterr().out
    assert out.startswith("[step] elapsed: ") and "s each)" in out
    with Timer() as timer:
        pass
    assert capsys.readouterr().out.startswith("[timer] elapsed: ") and timer.elapsed >= 0.0


def test_constants_match_the_jax_package(monkeypatch, tmp_path):
    monkeypatch.setenv("PYTORCHREC_TPU_WORK_DIR", str(tmp_path))
    dirs = ("work_dir", "raw_data_dir", "dataset_dir", "log_dir", "model_dir",
            "grid_search_dir", "repeat_task_dir", "checkpoint_dir")
    for name in dirs:
        assert getattr(C, name)() == getattr(JC, name)(), name
    assert C.work_dir() == str(tmp_path) and C.checkpoint_dir() == str(tmp_path / "Checkpoint")
    names = {k: v for k, v in vars(JC).items() if k.isupper()}
    # the port's tables are numpy frames (data/process/io.py): four names more
    names.update(BASE_INTERACTION_FRAME="base_interaction.npz", INTERACTION_FRAME="interaction.npz",
                 ITEM_FRAME="item.npz", USER_FRAME="user.npz")
    assert {k: v for k, v in vars(C).items() if k.isupper()} == names
    monkeypatch.delenv("PYTORCHREC_TPU_WORK_DIR")  # read at each call
    monkeypatch.chdir(tmp_path)
    assert C.work_dir() == JC.work_dir() == os.path.join(str(tmp_path), "workdir")


def test_dirs_are_made(monkeypatch, tmp_path):
    system.check_dir_and_mkdir(str(tmp_path / "a" / "b" / "file.txt"))  # a file: its parent
    assert (tmp_path / "a" / "b").is_dir() and not (tmp_path / "a" / "b" / "file.txt").exists()
    system.check_dir_and_mkdir(str(tmp_path / "c" / "d"))
    assert (tmp_path / "c" / "d").is_dir()
    system.check_dir_and_mkdir("")  # nothing to make
    monkeypatch.setenv("PYTORCHREC_TPU_WORK_DIR", str(tmp_path / "wd"))
    system.check_important_dirs_and_mkdir()
    made = sorted(os.listdir(tmp_path / "wd"))
    monkeypatch.setenv("PYTORCHREC_TPU_WORK_DIR", str(tmp_path / "jax_wd"))
    jax_system.check_important_dirs_and_mkdir()
    assert made == sorted(os.listdir(tmp_path / "jax_wd")) and "Checkpoint" in made


Pair = namedtuple("Pair", "first second")


def test_nested_structures():
    structure = {"a": [np.arange(3), (torch.tensor(2.5), 7)], "b": Pair(torch.ones(2), "x")}
    doubled = ds.map_structure(lambda x: x * 2 if not isinstance(x, str) else x, structure)
    assert isinstance(doubled["a"], list) and isinstance(doubled["a"][1], tuple)
    assert isinstance(doubled["b"], Pair) and doubled["b"].second == "x"
    np.testing.assert_array_equal(doubled["a"][0], [0, 2, 4])
    assert doubled["a"][1][1] == 14
    host = ds.to_numpy(structure)
    assert isinstance(host["a"][1][0], np.ndarray) and host["a"][1][0] == 2.5
    assert isinstance(host["b"].first, np.ndarray) and host["a"][1][1] == 7
    scalars = ds.to_python_scalars({"loss": torch.tensor(0.5), "auc": np.float32(0.7),
                                    "v": np.zeros(2), "n": 3})
    assert scalars["loss"] == 0.5 and isinstance(scalars["loss"], float)
    assert isinstance(scalars["v"], np.ndarray) and scalars["n"] == 3
    moved = ds.to_device({"ids": np.arange(4, dtype=np.int32), "name": "x"}, "cpu")
    assert isinstance(moved["ids"], torch.Tensor) and moved["ids"].dtype == torch.int32
    assert moved["name"] == "x"


def test_enums_match_the_jax_package():
    assert get_enum_values(SplitMode) == jax_enum_values(JaxSplitMode) == [
        "sequential_split", "leave_k_out"]
    assert get_enum_values(TrainMode) == jax_enum_values(JaxTrainMode) == [
        "point_wise", "pair_wise"]
    assert TrainMode("pair_wise") is TrainMode.PAIR_WISE


def _drive(timer, gaps):
    timer.on_train_begin()
    for b, gap in enumerate(gaps):
        timer.on_train_batch_begin(b)
        time.sleep(gap)
        timer.on_train_batch_end(b, {"loss": 0.5})
    timer.on_train_end()


def test_step_timer_stats():
    gaps = [0.02, 0.0, 0.0, 0.004, 0.006, 0.008]
    timer, jax_timer = StepTimer(batch_size=64, skip_first=3), JaxStepTimer(batch_size=64,
                                                                            skip_first=3)
    assert timer.stats() == {}
    _drive(timer, gaps)
    _drive(jax_timer, gaps)
    stats = timer.stats()
    assert list(stats) == list(jax_timer.stats()) == ["steps", "mean_s", "p50_s", "p99_s",
                                                      "examples_per_sec"]
    assert stats["steps"] == 3 and len(timer.times) == 3  # the first 3 left out
    assert 0.004 <= stats["mean_s"] < 0.02 and stats["p50_s"] <= stats["p99_s"]
    times = np.asarray(timer.times)
    assert stats["mean_s"] == pytest.approx(times.mean())
    assert stats["examples_per_sec"] == pytest.approx(64 / times.mean())
    assert timer.implements_train_batch_hooks()
    assert "examples_per_sec" not in _stats_without_batch_size()


def _stats_without_batch_size():
    timer = StepTimer(skip_first=0)
    _drive(timer, [0.0])
    return timer.stats()


def test_environment_summary():
    summary = environment_summary()
    assert summary["torch"] == torch.__version__
    assert set(summary) == {"torch", "cuda", "backend", "devices", "compute_capability",
                            "n_devices"}
    if not torch.cuda.is_available():
        assert summary["backend"] == "cpu" and summary["n_devices"] == "0"
