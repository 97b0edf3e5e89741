"""Spawned ranks for the sharded trainer's tests
(``tests/test_torch_sharded_engine.py``,
``tests/test_torch_sharded_trainer.py``, ``tests/test_torch_sharded_two_tower.py``,
``tests/test_torch_sharded_retrieval.py``); like ``torch_mesh_workers.py``
this module imports torch, numpy and the port, never JAX.

``engine_rank`` runs the exchanges of ``parallel/embedding_engine.py`` on
each rank's slice of whole numpy inputs; ``scenarios_rank`` trains a list
of scenarios (a model by name, the sharded trainer's arguments, the leaves
to start from, the batches) on one mesh and returns each one's gathered
state; ``one_process`` runs a scenario's twin in the calling process with
no mesh; ``tt_data4_rank`` runs the two-tower model's cross-replica forward
and backward on a data axis of 4, ``retrieval_rank`` the corpus-sharded
retrieval.
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


def two_tower(device, **kwargs):
    from pytorchrec_tpu_torch.models import TwoTower

    return TwoTower(uid_column=CategoricalColumnWithIdentity(feature_name="uid",
                                                             category_num=TT_USERS),
                    iid_column=CategoricalColumnWithIdentity(feature_name="iid",
                                                             category_num=TT_ITEMS),
                    label_column=_label(), emb_size=8, layers=(16, 8), table_row_multiple=2,
                    device=device, **kwargs)


MODELS = {"funk_svd": funk_svd, "dcnv2": dcnv2, "dlrm": dlrm, "two_tower": two_tower}
TT_USERS, TT_ITEMS, TT_CANDIDATES = 64, 120, 3  # the two-tower tables; iid [B, 3] positive first
TT_Q_KEY = "__two_tower_q"  # TwoTower.Q_KEY


def two_tower_batch(rng, rows: int, pointwise: bool = False) -> dict:
    """``uid [B]`` and ``iid [B, 3]`` positive first, a raw sampling
    probability a row under the logQ key, and duplicate positives planted
    within each quarter of the batch and across its halves (accidental
    hits for the mask, on one rank and across ranks); ``pointwise``:
    ``iid [B]`` and a label."""
    out = {"uid": rng.integers(0, TT_USERS, size=rows).astype(np.int32)}
    if pointwise:
        out["iid"] = rng.integers(0, TT_ITEMS, size=rows).astype(np.int32)
        out["label"] = rng.integers(0, 2, size=rows).astype(np.int32)
        return out
    iid = rng.integers(0, TT_ITEMS, size=(rows, TT_CANDIDATES)).astype(np.int32)
    iid[1, 0] = iid[0, 0]
    iid[rows // 2 + 1, 0] = iid[2, 0]
    out["iid"] = iid
    out[TT_Q_KEY] = rng.uniform(1e-3, 1e-1, size=rows).astype(np.float32)
    return out


def batch(model: str, rng, rows: int) -> dict:
    if model == "two_tower":
        return two_tower_batch(rng, rows)
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
    trainer.compile(optimizer="adam", loss=scenario.get("loss", "bce"), metrics=("auc",),
                    lr=scenario["lr"])
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
    ``QuantizedEmbeddingTrainer`` for int8 rows; its model takes
    ``one_process_model_kwargs`` where given (local negatives over the
    whole batch for a model with cross-replica ones)."""
    model_kwargs = scenario.get("one_process_model_kwargs", scenario.get("model_kwargs", {}))
    model = MODELS[scenario["model"]]("cpu", **model_kwargs)
    kwargs = scenario["trainer_kwargs"]
    if model_kwargs.get("quantized_embedding") or model_kwargs.get("quantized_table"):
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


# ---------------------------------------------------------------------------
# the two-tower model's forward on a data axis of 4
# ---------------------------------------------------------------------------


def tt_data4_rank(rank: int, world: int, tmp: str) -> dict:
    """A (4, 1) mesh: the two-tower model with cross-replica negatives
    (unnormalized) from JAX's leaves, this data index's rows of the batch
    and of the injected rows, the forward inside ``bound(mesh)``, then the
    backward of ``sum(prediction * w)``: the prediction, the rows'
    gradients and the parameters' gradients summed over the ranks (flax
    layout)."""
    from pytorchrec_tpu_torch.parallel import bound
    from pytorchrec_tpu_torch.utils.convert import _port_key, flax_path

    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    mesh = make_mesh(data=world, model=1, device="cpu")
    rows = data_sharding(mesh).rows(len(inputs["batch"]["uid"]))
    model = two_tower("cpu", global_negatives_axis="data", mask_accidental_hits=True,
                      normalize=False)
    params_from_jax(inputs["leaves"], model)
    batch = {k: torch.from_numpy(v[rows].copy()) for k, v in inputs["batch"].items()}
    cands = inputs["batch"]["iid"].shape[1]
    injected = {k: torch.from_numpy(v.reshape(-1, cands if k.endswith("_i") else 1, v.shape[-1])
                                    [rows].reshape(-1, v.shape[-1]).copy()).requires_grad_()
                for k, v in inputs["rows"].items()}
    with bound(mesh):
        prediction, _ = model({**batch, **injected}, train=True)
    (prediction * torch.from_numpy(inputs["w"][rows])).sum().backward()
    grads = {}
    for name, p in model.named_parameters():
        if p.grad is None:  # the tables: their rows are injected
            continue
        g = mesh.psum(p.grad.clone(), "data")
        path = flax_path(name)
        grads[path] = (g.t() if _port_key(path)[1] == "transpose" else g).numpy()
    return {"prediction": prediction.detach().numpy(),
            "grad_rows": {k: v.grad.numpy() for k, v in injected.items()}, "grad_params": grads}



# ---------------------------------------------------------------------------
# corpus-sharded retrieval
# ---------------------------------------------------------------------------


def retrieval_model(n_items: int):
    """``tests/test_two_tower.py::_make_model(n_items=..., normalize=False,
    emb_size=16)``'s twin: 50 users, towers (16, 8), dot-product scores."""
    from pytorchrec_tpu_torch.models import TwoTower

    return TwoTower(uid_column=CategoricalColumnWithIdentity(feature_name="uid", category_num=50),
                    iid_column=CategoricalColumnWithIdentity(feature_name="iid",
                                                             category_num=n_items),
                    label_column=_label(), emb_size=16, layers=(16, 8), normalize=False,
                    device="cpu")


def retrieval_rank(rank: int, world: int, tmp: str) -> dict:
    """Every case of ``inputs.pt`` on the mesh ``inputs["mesh"]``: the index
    (JAX's, as numpy) sharded over the case's corpus axis, then the exact
    (chunks of 128 items) and the fused (B7, one chunk a super-chunk)
    sharded retrieval of the same queries; each one's scores and ids, the
    shard's rows and how many queries the user tower scored a call."""
    from pytorchrec_tpu_torch.serving import make_sharded_retrieve_fn, shard_item_index

    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    mesh = make_mesh(*inputs["mesh"], device="cpu")
    out = {}
    for name, case in inputs["cases"].items():
        model = params_from_jax(case["leaves"], retrieval_model(case["n_items"]))
        scored = []
        tower = model.user_vectors
        model.user_vectors = lambda ids: (scored.append(ids.shape[0]), tower(ids))[1]
        shard = shard_item_index(torch.from_numpy(case["index"]), mesh, case["corpus_axis"])
        result = {"shard": shard.numpy()}
        for mode, kwargs in (("exact", dict(chunk_items=128)),
                             ("fused", dict(approx="fused", fused_group=1))):
            retrieve = make_sharded_retrieve_fn(model, mesh, num_items=case["n_items"],
                                                corpus_axis=case["corpus_axis"], **kwargs)
            scores, ids = retrieve(shard, torch.from_numpy(inputs["uids"]), inputs["k"])
            result[mode] = (scores.numpy(), ids.numpy())
        result["scored"] = scored
        out[name] = result
    return out
