"""Paths 1 and 7 of the repository's ``__graft_entry__.py::dryrun_multichip``
on the port: one sharded train step and one sharded eval step of a tiny
DCN-v2, then corpus-sharded two-tower retrieval.

Every rank of an initialised world calls ``dryrun_multichip()``: the mesh
takes a model axis of 2 where the world is even and at least 4, the rest of
the ranks on the data axis. Path 1: the DCN-v2 of per-field tables (3 fields
of 64 ids, E=8, 2 dense fields) trains one step under the dense ``Trainer``
with its tables row-sharded over the model axis and the batch over the data
axis. Path 7: a two-tower model of 100 items (E=8, one tower layer of 8)
builds its item index, shards it over the model axis and answers 8 queries
at k=5 (``make_sharded_retrieve_fn``, chunks of 32 items).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch.distributed as dist

from pytorchrec_tpu_torch.parallel.mesh import make_mesh


def _columns(n_sparse: int = 3, vocab: int = 64, n_dense: int = 2):
    from pytorchrec_tpu_torch.feature_column import CategoricalColumnWithIdentity, NumericColumn

    sparse = [CategoricalColumnWithIdentity(feature_name=f"c_{i}", category_num=vocab)
              for i in range(n_sparse)]
    dense = [NumericColumn(feature_name=f"d_{i}") for i in range(n_dense)]
    return sparse, dense, CategoricalColumnWithIdentity(feature_name="label", category_num=2)


def _batch(batch_size: int, sparse, dense, seed: int = 1):
    rng = np.random.default_rng(seed)
    batch = {c.feature_name: rng.integers(0, c.category_num, size=batch_size).astype(np.int32)
             for c in sparse}
    for c in dense:
        batch[c.feature_name] = rng.normal(size=batch_size).astype(np.float32)
    batch["label"] = rng.integers(0, 2, size=batch_size).astype(np.int32)
    return batch


def sharded_retrieval(mesh, label, n_items: int = 100) -> tuple:
    """Path 7 on ``mesh``: the ids' shape of 8 queries at k=5 over a
    100-item index sharded over the model axis. Raises where an id is past
    the corpus."""
    import torch

    from pytorchrec_tpu_torch.feature_column import CategoricalColumnWithIdentity
    from pytorchrec_tpu_torch.models import TwoTower
    from pytorchrec_tpu_torch.serving import (
        build_item_index,
        make_sharded_retrieve_fn,
        shard_item_index,
    )

    model = TwoTower(uid_column=CategoricalColumnWithIdentity(feature_name="uid", category_num=40),
                     iid_column=CategoricalColumnWithIdentity(feature_name="iid",
                                                              category_num=n_items),
                     label_column=label, emb_size=8, layers=(8,), device=mesh.device,
                     generator=torch.Generator(device=mesh.device).manual_seed(0))
    index = shard_item_index(build_item_index(model, n_items, batch_size=64), mesh, "model")
    retrieve = make_sharded_retrieve_fn(model, mesh, num_items=n_items, chunk_items=32)
    _, ids = retrieve(index, torch.arange(8), 5)
    if tuple(ids.shape) != (8, 5) or int(ids.min()) < 0 or int(ids.max()) >= n_items:
        raise RuntimeError(f"sharded retrieval gave ids {ids.tolist()}")
    return tuple(ids.shape)


def dryrun_multichip(device=None) -> Tuple[float, tuple, tuple]:
    """Paths 1 and 7 on this world's mesh; returns (the loss, the
    prediction's shape, the retrieved ids' shape). Raises where the loss is
    not finite, the prediction is not ``[batch]`` or an id is past the
    corpus."""
    from pytorchrec_tpu_torch.models import DCNv2
    from pytorchrec_tpu_torch.training import Trainer

    n = dist.get_world_size()
    model_axis = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = make_mesh(data=n // model_axis, model=model_axis, device=device)
    sparse, dense, label = _columns()
    model = DCNv2(sparse_columns=sparse, dense_columns=dense, label_column=label, emb_size=8,
                  device=mesh.device)
    batch_size = 8 * mesh.data
    batch = _batch(batch_size, sparse, dense)
    trainer = Trainer(model, mesh=mesh)
    trainer.compile(optimizer="adam", lr=1e-3, loss="bce", metrics=("auc",))
    trainer.init_state(batch, seed=0)
    loss = float(trainer.train_step(batch))
    if not np.isfinite(loss):
        raise RuntimeError(f"the sharded step's loss is {loss}")
    prediction, _ = trainer._eval_step(batch)
    if tuple(prediction.shape) != (batch_size,):
        raise RuntimeError(f"the sharded eval step scored {tuple(prediction.shape)}, not "
                           f"({batch_size},)")
    return loss, tuple(prediction.shape), sharded_retrieval(mesh, label)
