"""One sharded train step and one sharded eval step of a tiny DCN-v2 (the
port of path 1 of the repository's ``__graft_entry__.py::dryrun_multichip``).

Every rank of an initialised world calls ``dryrun_multichip()``: the mesh
takes a model axis of 2 where the world is even and at least 4, the rest of
the ranks on the data axis; the DCN-v2 of per-field tables (3 fields of 64 ids,
E=8, 2 dense fields) trains one step under the dense ``Trainer`` with its
tables row-sharded over the model axis and the batch over the data axis.
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


def dryrun_multichip(device=None) -> Tuple[float, tuple]:
    """One step and one eval step on this world's mesh; returns (the loss,
    the prediction's shape). Raises where the loss is not finite or the
    prediction is not ``[batch]``."""
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
    return loss, tuple(prediction.shape)
