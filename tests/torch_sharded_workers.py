"""Spawned ranks for the sharded trainer's tests
(``tests/test_torch_sharded_engine.py``,
``tests/test_torch_sharded_trainer.py``); like ``torch_mesh_workers.py``
this module imports torch, numpy and the port, never JAX.

``engine_rank`` runs the exchanges of ``parallel/embedding_engine.py`` on
each rank's slice of whole numpy inputs; ``scenarios_rank`` trains a list
of scenarios (a model by name, the sharded trainer's arguments, the leaves
to start from, the batches) on one mesh and returns each one's gathered
state; ``one_process`` runs a scenario's twin in the calling process with
no mesh.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pytorchrec_tpu_torch.feature_column import CategoricalColumnWithIdentity, NumericColumn
from pytorchrec_tpu_torch.parallel import (
    all_to_all_lookup,
    all_to_all_rowgrad,
    data_sharding,
    grid_lookup,
    grid_rowgrad,
    make_hot_cold_lookup,
    make_mesh,
    make_sharded_lookup,
    two_hop_lookup,
    two_hop_rowgrad,
)
from pytorchrec_tpu_torch.parallel.embedding_engine import GRID
from pytorchrec_tpu_torch.training import (
    QuantizedEmbeddingTrainer,
    ShardedSparseEmbeddingTrainer,
    SparseEmbeddingTrainer,
)
from pytorchrec_tpu_torch.utils import params_from_jax

from filelock import FileLock

USERS, ITEMS = 60, 200  # FunkSVD's tables
FIELDS = {"c_0": 64, "c_1": 32}  # DCN-v2's unified table
DLRM_VOCAB, DLRM_FIELDS = 80, 3  # DLRM's unified int8 or bf16 table: 240 rows
ROW_MULTIPLE = 4  # every table's rows divide the (2, 2) grid


def shared_result(tmp_path_factory, name: str, compute):
    """``compute()``'s result, computed once for the whole test run: a
    module fixture runs again on every xdist worker that takes one of its
    tests, so the first worker saves the result under the workers' common
    temporary dir and the others load it."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if base.name.startswith("popen-gw") else base
    path = root / f"{name}.pt"
    with FileLock(str(path) + ".lock"):
        if path.is_file():
            return torch.load(path, weights_only=False)
        result = compute()
        torch.save(result, path)
        return result


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _shard_of(table: np.ndarray, mesh, axis) -> torch.Tensor:
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    rows = table.shape[0] // n
    return torch.from_numpy(table[i * rows:(i + 1) * rows].copy())


def engine_case(case: dict, mesh) -> tuple:
    """One exchange on this rank: the data index's rows of ``ids`` (and
    ``grads``), its shard of ``table``."""
    rows = data_sharding(mesh).rows(len(case["ids"]))
    ids = torch.from_numpy(case["ids"][rows].copy())
    grads = None if case.get("grads") is None else torch.from_numpy(case["grads"][rows].copy())
    fn, cap = case["fn"], case.get("capacity")
    if fn == "lookup":
        return (all_to_all_lookup(_shard_of(case["table"], mesh, "model"), ids, mesh, "model",
                                  capacity=cap, out_cols=case.get("out_cols")),)
    if fn == "rowgrad":
        return all_to_all_rowgrad(ids, grads, case["rows_per_shard"], mesh, "model",
                                  capacity=cap)
    if fn == "grid_lookup":
        return (grid_lookup(_shard_of(case["table"], mesh, GRID), ids, mesh, GRID,
                            capacity=cap, out_cols=case.get("out_cols")),)
    if fn == "grid_rowgrad":
        return grid_rowgrad(ids, grads, case["rows_per_shard"], mesh, GRID, capacity=cap)
    if fn == "two_hop_rowgrad":
        return two_hop_rowgrad(ids, grads, case["rows_per_shard"], mesh, GRID, capacity2=cap)
    if fn == "two_hop_lookup":
        return (two_hop_lookup(_shard_of(case["table"], mesh, GRID), ids, mesh, GRID,
                               capacity2=cap, out_cols=case.get("out_cols")),)
    whole_ids = torch.from_numpy(case["ids"])  # the whole-array lookups take whole arrays
    if fn == "make_sharded_lookup":
        return (make_sharded_lookup(mesh, case["strategy"])(torch.from_numpy(case["table"]),
                                                            whole_ids),)
    if fn == "make_hot_cold_lookup":
        return (make_hot_cold_lookup(mesh)(*(torch.from_numpy(case[k])
                                             for k in ("hot", "cold", "perm")), whole_ids),)
    raise ValueError(fn)


def engine_rank(rank: int, world: int, tmp: str) -> dict:
    """Every case of ``inputs.pt`` on the mesh ``inputs["mesh"]``: each
    one's outputs as numpy arrays."""
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    data, model = inputs["mesh"]
    mesh = make_mesh(data=data, model=model, device="cpu")
    return {name: tuple(t.numpy() for t in engine_case(case, mesh))
            for name, case in inputs["cases"].items()}


# ---------------------------------------------------------------------------
# models and batches
# ---------------------------------------------------------------------------


def _label():
    return CategoricalColumnWithIdentity(feature_name="label", category_num=2)


def funk_svd(device, **kwargs):
    from pytorchrec_tpu_torch.models import FunkSVD

    return FunkSVD(uid_column=CategoricalColumnWithIdentity(feature_name="uid",
                                                            category_num=USERS),
                   iid_column=CategoricalColumnWithIdentity(feature_name="iid",
                                                            category_num=ITEMS),
                   label_column=_label(), emb_size=8, table_row_multiple=ROW_MULTIPLE,
                   device=device, **kwargs)


def dcnv2(device, **kwargs):
    from pytorchrec_tpu_torch.models import DCNv2

    sparse = tuple(CategoricalColumnWithIdentity(feature_name=k, category_num=v)
                   for k, v in FIELDS.items())
    return DCNv2(sparse_columns=sparse, dense_columns=(NumericColumn(feature_name="d_0"),),
                 label_column=_label(), emb_size=4, num_cross_layers=2, layers=(8,),
                 unified_embedding=True, table_row_multiple=ROW_MULTIPLE, device=device,
                 **kwargs)


def dlrm(device, **kwargs):
    from pytorchrec_tpu_torch.models import DLRM

    sparse = tuple(CategoricalColumnWithIdentity(feature_name=f"c_{i}", category_num=DLRM_VOCAB)
                   for i in range(DLRM_FIELDS))
    return DLRM(sparse_columns=sparse, dense_columns=(NumericColumn(feature_name="d_0"),),
                label_column=_label(), emb_size=8, bottom_layers=(16,), top_layers=(16,),
                unified_embedding=True, table_row_multiple=8, device=device, **kwargs)


MODELS = {"funk_svd": funk_svd, "dcnv2": dcnv2, "dlrm": dlrm}


def batch(model: str, rng, rows: int) -> dict:
    if model == "funk_svd":
        out = {"uid": rng.integers(0, USERS, size=rows), "iid": rng.integers(0, ITEMS, size=rows)}
    elif model == "dcnv2":
        out = {k: rng.integers(0, v, size=rows) for k, v in FIELDS.items()}
        out["d_0"] = rng.normal(size=rows).astype(np.float32)
    else:
        out = {f"c_{i}": rng.integers(0, DLRM_VOCAB, size=rows) for i in range(DLRM_FIELDS)}
        out["d_0"] = rng.normal(size=rows).astype(np.float32)
    out = {k: v.astype(np.int32) if v.dtype.kind == "i" else v for k, v in out.items()}
    out["label"] = rng.integers(0, 2, size=rows).astype(np.int32)
    return out


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


def _train(trainer, scenario: dict, leaves) -> dict:
    trainer.compile(optimizer="adam", loss="bce", metrics=("auc",), lr=scenario["lr"])
    batches = scenario["batches"]
    trainer.init_state(batches[0], seed=scenario.get("seed", 0))
    if leaves is not None:
        params_from_jax(leaves, trainer)
    losses = [float(trainer.train_step(b)) for b in batches]
    return {"losses": losses, "state": trainer.checkpoint_state(),
            "predictions": trainer.make_serving_fn()(scenario["eval"]).cpu().numpy()}


def sharded_run(scenario: dict, mesh) -> dict:
    """A scenario on ``mesh`` under ``ShardedSparseEmbeddingTrainer``: each
    step's loss, the whole state (the JAX layout), ``merged_params`` and
    the eval batch's scores."""
    model = MODELS[scenario["model"]]("cpu", **scenario.get("model_kwargs", {}))
    trainer = ShardedSparseEmbeddingTrainer(model, mesh=mesh, **scenario["trainer_kwargs"])
    out = _train(trainer, scenario, scenario["leaves"])
    out["merged"] = trainer.merged_params()
    if scenario.get("save_load"):
        path = os.path.join(scenario["tmp"], "state.pt")
        trainer.save_checkpoint(path)
        trainer.train_step(scenario["batches"][0])
        trainer.restore_checkpoint(path)
        again = trainer.checkpoint_state()
        out["restored"] = all(torch.equal(again["params"][k], v)
                              for k, v in out["state"]["params"].items())
    return out


def scenarios_rank(rank: int, world: int, tmp: str) -> dict:
    """Every scenario of ``inputs.pt`` on the mesh ``inputs["mesh"]``."""
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    data, model = inputs["mesh"]
    mesh = make_mesh(data=data, model=model, device="cpu")
    return {name: sharded_run(dict(s, tmp=tmp), mesh) for name, s in inputs["scenarios"].items()}


def one_process(scenario: dict, merged_leaves: dict) -> dict:
    """The scenario's one-process twin from the merged starting leaves:
    ``SparseEmbeddingTrainer`` with the same table format, or the packed
    ``QuantizedEmbeddingTrainer`` for int8 rows."""
    model = MODELS[scenario["model"]]("cpu", **scenario.get("model_kwargs", {}))
    kwargs = scenario["trainer_kwargs"]
    if scenario.get("model_kwargs", {}).get("quantized_embedding"):
        trainer = QuantizedEmbeddingTrainer(model, device="cpu", packed_tables=True,
                                            table_lr=kwargs.get("table_lr"))
    else:
        trainer = SparseEmbeddingTrainer(
            model, device="cpu", table_optimizer=kwargs.get("table_optimizer", "adam"),
            packed_tables=kwargs.get("packed_tables", False),
            packed_dtype=kwargs.get("packed_dtype"), table_lr=kwargs.get("table_lr"))
    return _train(trainer, scenario, merged_leaves)


# ---------------------------------------------------------------------------
# the Criteo example's twin on a mesh
# ---------------------------------------------------------------------------


def criteo_rank(rank: int, world: int, tmp: str) -> dict:
    """Each command line of ``inputs.pt`` through the example's
    ``run_from_args`` in its work dir (rank 0 formats, the others wait):
    what the rank printed, its step losses, held-out AUC, launches and the
    merged tables and dense leaves."""
    import contextlib
    import io

    from pytorchrec_tpu_torch.examples import criteo_end_to_end as twin

    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    os.environ["PYTORCHREC_TPU_WORK_DIR"] = inputs["work_dir"]
    out = {}
    for name, argv in inputs["runs"].items():
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            result = twin.run_from_args(twin.parse_args(argv))
        out[name] = {"printed": printed.getvalue(), "losses": result["step_losses"],
                     "auc": result["heldout_auc"], "launches": result["launches"],
                     "leaves": result["trainer"].merged_params()}
    return out
