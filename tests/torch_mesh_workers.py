"""Spawned ranks for the port's mesh tests (``tests/test_torch_mesh.py``,
``tests/test_torch_mesh_trainers.py``, ``tests/test_torch_tasks.py``).

A spawned child imports the module that holds its target, so this module
imports only torch, numpy and the port at top level: never JAX, which only
the tests' own process runs. ``run_world(fn, world, tmp)`` starts ``world``
processes over gloo with a ``file://`` store under ``tmp`` (no TCP port
shared between test workers), each with one thread and a 60 s collective
timeout; it joins them against a deadline, kills every child left, and
returns each rank's result (``fn(rank, world, tmp)``, saved by the child
with ``torch.save``). A rank that fails raises in the parent with its
traceback.

``train(inputs, mesh, tmp)`` is one training scenario (a model by name, a
trainer kind, the leaves to start from, the batches, an eval split, a
save-and-restore check) run the same way in a rank (``train_rank``) and in
the tests' process with no mesh, so each mesh run is held against the
port's one-process run of the same inputs.
"""

from __future__ import annotations

import os
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from pytorchrec_tpu_torch.data.schema import TrainMode
from pytorchrec_tpu_torch.feature_column import CategoricalColumnWithIdentity, NumericColumn
from pytorchrec_tpu_torch.parallel import initialize_distributed, make_mesh
from pytorchrec_tpu_torch.training import (
    Callback,
    PreemptionGuard,
    QuantizedEmbeddingTrainer,
    SparseEmbeddingTrainer,
    Trainer,
)
from pytorchrec_tpu_torch.utils import params_from_jax

DEADLINE = 240.0  # seconds a world may take before its ranks are killed


def _entry(fn, rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    try:
        initialize_distributed(device="cpu", init_method=f"file://{tmp}/store",
                               world_size=world, rank=rank, timeout=timedelta(seconds=60))
        result = fn(rank, world, tmp)
        torch.save(result, os.path.join(tmp, f"result_{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn, world: int, tmp) -> list:
    """``fn(rank, world, tmp)`` on ``world`` spawned gloo ranks; their
    results in rank order."""
    tmp = str(tmp)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, rank, world, tmp)) for rank in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + DEADLINE
    try:
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
    errors = []
    for rank, p in enumerate(procs):
        path = os.path.join(tmp, f"error_{rank}.txt")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {rank}:\n{f.read()}")
    if errors:
        raise RuntimeError("\n".join(errors))
    if alive:
        raise TimeoutError(f"ranks {[procs.index(p) for p in alive]} passed the "
                           f"{DEADLINE:.0f} s deadline")
    if any(p.exitcode for p in procs):
        raise RuntimeError(f"exit codes {[p.exitcode for p in procs]}")
    return [torch.load(os.path.join(tmp, f"result_{rank}.pt"), weights_only=False)
            for rank in range(world)]


# ---------------------------------------------------------------------------
# models and data
# ---------------------------------------------------------------------------

USERS, ITEMS = 63, 256  # 63 user rows: a table that no model axis of 2 divides
FIELDS = {"c_0": 64, "c_1": 32}  # the unified table's 96 rows divide 2


def label_column():
    return CategoricalColumnWithIdentity(feature_name="label", category_num=2)


def funk_svd(device, **kwargs):
    from pytorchrec_tpu_torch.models import FunkSVD

    return FunkSVD(uid_column=CategoricalColumnWithIdentity(feature_name="uid",
                                                            category_num=USERS),
                   iid_column=CategoricalColumnWithIdentity(feature_name="iid",
                                                            category_num=ITEMS),
                   label_column=label_column(), emb_size=8, device=device, **kwargs)


def dcnv2(device, **kwargs):
    from pytorchrec_tpu_torch.models import DCNv2

    sparse = tuple(CategoricalColumnWithIdentity(feature_name=k, category_num=v)
                   for k, v in FIELDS.items())
    return DCNv2(sparse_columns=sparse, dense_columns=(NumericColumn(feature_name="d_0"),),
                 label_column=label_column(), emb_size=4, num_cross_layers=2, layers=(8,),
                 device=device, **kwargs)


MODELS = {"funk_svd": funk_svd, "dcnv2": dcnv2}


def funk_svd_batch(rng, rows: int) -> dict:
    return {"uid": rng.integers(0, USERS, size=rows).astype(np.int32),
            "iid": rng.integers(0, ITEMS, size=rows).astype(np.int32),
            "label": rng.integers(0, 2, size=rows).astype(np.int32)}


def dcnv2_batch(rng, rows: int, unique: bool = False) -> dict:
    """``unique``: no id twice in the batch (each field a draw without
    replacement; the unified ids differ across fields by their offsets)."""
    batch = {}
    for name, vocab in FIELDS.items():
        ids = rng.permutation(vocab)[:rows] if unique else rng.integers(0, vocab, size=rows)
        batch[name] = ids.astype(np.int32)
    batch["d_0"] = rng.normal(size=rows).astype(np.float32)
    batch["label"] = rng.integers(0, 2, size=rows).astype(np.int32)
    return batch


class ArrayReader:
    """A reader over in-memory splits (dicts of arrays), as the trainers'
    ``fit``, ``evaluate`` and ``predict`` read one."""

    train_mode = TrainMode.POINT_WISE

    def __init__(self, splits: dict):
        self.splits = splits

    def get_dataset_size(self, split: str) -> int:
        return len(next(iter(self.splits[split].values())))

    def get_train_dataset_size(self) -> int:
        return self.get_dataset_size("train")

    def get_batch(self, split: str, indices) -> dict:
        return {k: v[np.asarray(indices)] for k, v in self.splits[split].items()}


def make_trainer(inputs: dict, mesh, device: str = "cpu"):
    model = MODELS[inputs["model"]](device, **inputs.get("model_kwargs", {}))
    kind, kwargs = inputs["trainer"], dict(inputs.get("trainer_kwargs", {}))
    cls = {"dense": Trainer, "sparse": SparseEmbeddingTrainer,
           "quantized": QuantizedEmbeddingTrainer}[kind]
    trainer = cls(model, device=device, mesh=mesh, **kwargs)
    trainer.compile(metrics=("auc", "logloss"), **inputs["compile"])
    return trainer


def _same(a, b) -> bool:
    """Bit-equal nested dicts of tensors (and plain values)."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a, b))
    return a == b


def train(inputs: dict, mesh, tmp: str) -> dict:
    """The scenario ``inputs`` on ``mesh`` (None: one process): init from
    ``seed`` (then the ``leaves``, where given), a ``train_step`` a batch,
    the whole state (``checkpoint_state``), the eval split's metrics and
    predictions, and with ``save_load`` whether a restore gives back the
    saved state after a further step."""
    trainer = make_trainer(inputs, mesh)
    batches = inputs["batches"]
    trainer.init_state(batches[0], seed=inputs.get("seed", 0))
    if inputs.get("leaves") is not None:
        params_from_jax(inputs["leaves"], trainer)
    losses = [float(trainer.train_step(batch)) for batch in batches]
    out = {"losses": losses, "state": trainer.checkpoint_state()}
    if inputs.get("eval") is not None:
        reader = ArrayReader({"test": inputs["eval"]})
        out["metrics"] = trainer.evaluate(reader, split="test", batch_size=inputs["eval_batch"],
                                          verbose=0)
        out["predictions"] = trainer.predict(reader, split="test",
                                             batch_size=inputs["eval_batch"])
    if inputs.get("save_load"):
        path = os.path.join(tmp, "state.pt")
        trainer.save_checkpoint(path)
        trainer.save_weights(os.path.join(tmp, "weights.pt"))
        trainer.train_step(batches[0])
        trainer.restore_checkpoint(path)
        out["restored"] = _same(out["state"], trainer.checkpoint_state())
        trainer.train_step(batches[0])
        trainer.load_weights(os.path.join(tmp, "weights.pt"))
        out["weights_restored"] = _same(out["state"]["params"],
                                        trainer.checkpoint_state()["params"])
    return out


def train_rank(rank: int, world: int, tmp: str) -> dict:
    """``train`` on the mesh ``inputs["mesh"]`` (``inputs.pt`` under
    ``tmp``)."""
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    data, model = inputs["mesh"]
    return train(inputs, make_mesh(data=data, model=model, device="cpu"), tmp)


# ---------------------------------------------------------------------------
# the mesh's parts
# ---------------------------------------------------------------------------


def layout_rank(rank: int, world: int, tmp: str) -> dict:
    """A (2, 2) mesh's place of this rank and its groups' ranks."""
    mesh = make_mesh(data=2, model=2, device="cpu")
    return {"at": (mesh.data_index, mesh.model_index),
            "model_group": dist.get_process_group_ranks(mesh.model_group),
            "data_group": dist.get_process_group_ranks(mesh.data_group)}


def lookup_rank(rank: int, world: int, tmp: str) -> dict:
    """``masked_psum_lookup`` of a [64, 4] table row-sharded over a (2, 2)
    mesh: the vectors of 12 ids and the shard's gradient of ``sum(vectors *
    w)``."""
    from pytorchrec_tpu_torch.parallel import masked_psum_lookup, shard_params

    mesh = make_mesh(data=2, model=2, device="cpu")
    gen = torch.Generator().manual_seed(3)
    table = torch.randn((64, 4), generator=gen)
    ids = torch.randint(0, 64, (12,), generator=gen)
    w = torch.randn((12, 4), generator=gen)
    shard = shard_params({"t/embedding": table}, mesh)["t/embedding"].requires_grad_()
    vectors = masked_psum_lookup(shard, ids, mesh)
    (vectors * w).sum().backward()
    return {"vectors": vectors.detach(), "grad": shard.grad, "table": table, "ids": ids, "w": w}


def preemption_rank(rank: int, world: int, tmp: str) -> dict:
    """``fit`` on a (2, 1) mesh with a ``PreemptionGuard(sync_every=4)``
    whose flag rank 1 alone sets after its fifth batch: the step each rank
    stops at, and the checkpoint files."""
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    mesh = make_mesh(data=2, model=1, device="cpu")
    trainer = make_trainer(inputs, mesh)
    guard = PreemptionGuard(os.path.join(tmp, "ckpt"), sync_every=4)

    class Flag(Callback):
        def on_train_batch_end(self, batch, logs=None):
            if rank == 1 and batch == 4:
                guard.preempted = True

    reader = ArrayReader({"train": inputs["train"]})
    trainer.fit(reader, batch_size=16, epochs=1, verbose=0, callbacks=[Flag(), guard],
                eval_dev=False, seed=0)
    return {"step": trainer.state.step, "files": sorted(os.listdir(os.path.join(tmp, "ckpt")))}


def dryrun_rank(rank: int, world: int, tmp: str) -> dict:
    from pytorchrec_tpu_torch.parallel.dryrun import dryrun_multichip

    loss, shape, ids_shape = dryrun_multichip(device="cpu")
    return {"loss": loss, "shape": shape, "ids_shape": ids_shape}


def task_rank(rank: int, world: int, tmp: str) -> dict:
    """``Task.from_config("dcnv2", ...)`` for one epoch on a (2, 1) mesh
    (``inputs.pt``: the dataset, its reader's and the task's arguments);
    the work dir is the parent's, whose reader made the split files."""
    from pytorchrec_tpu_torch.tasks import Task

    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    mesh = make_mesh(data=2, model=1, device="cpu")
    task = Task.from_config("dcnv2", inputs["dataset"], reader_kwargs=inputs["reader"],
                            model_kwargs=inputs["model"], device="cpu", mesh=mesh,
                            **inputs["task"])
    best_epoch, dev, test = task.run()
    return {"best_epoch": best_epoch, "dev": dev, "test": test,
            "step": task.trainer.state.step}
