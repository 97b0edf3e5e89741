"""The value-based RL family of the port against the JAX package's, on the
CPU: the seven Q-networks (DQN, DEERS, LSRL and its four ablations), their
rows injection and ``ValueRLModel``'s Bellman target.

Both packages read the synthetic set of ``tests/test_trainer.py`` (50
users, 120 items, seed 11, each package in a work dir of its own) through
their ``value_rl`` readers (leave-one-out with 9 negatives, states of 5,
negative states, 4 next candidates), whose batches are equal
(``tests/test_torch_readers.py``). Each network is built by name
(``tasks.build_model``, E = hidden = 8, dropout 0, as JAX's and the port's
masks cannot match) and initialised in JAX; table rows and normal-drawn
weights are scaled to N(0, 0.1) (``scaled``) so that scores are of order
1e-2 to 1, and the leaves go through ``params_from_jax``. Both networks then
score the same batches, the train rows' ``[B]`` candidates and the dev
rows' ``[B, 10]``, and the next candidates, at rtol 1e-5 / atol 1e-7 (f32
sums in another order); ``ValueRLModel.apply``'s ``(main_q, target_q)``
with a target tree of its own the same. The int8 item table (``i_q``) is
checked for DQN and LSRL.

Then, the port alone: rows injected under the networks' keys (the eval
network's ``I_*`` keys from ``sharded_table_specs``, the target's ``N_*``
keys from ``sharded_target_specs``) score bit for bit as the networks'
own gathers, the target network takes no gradient and draws no dropout
mask, and ``load_pretrain_embedding`` warm-starts DQN's item table from a
FunkSVD's weights file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pytorchrec_tpu import data as jax_data
from pytorchrec_tpu import tasks as jax_tasks
from pytorchrec_tpu.data.process.datasets.synthetic import generate_synthetic_ml as jax_generate_ml
from pytorchrec_tpu_torch import data, tasks
from pytorchrec_tpu_torch.models import FunkSVD, ValueRLModel
from pytorchrec_tpu_torch.training import Trainer
from pytorchrec_tpu_torch.utils import params_from_jax
from pytorchrec_tpu_torch.utils.convert import leaves_of, load_leaves
from pytorchrec_tpu_torch.utils import constants as C

DATASET = "Synthetic-ML-RL"
ML_ARGS = dict(n_users=50, n_items=120, seed=11)
WORK_DIR = "PYTORCHREC_TPU_WORK_DIR"
E = H = 8
RTOL, ATOL = 1e-5, 1e-7
WEIGHT_SCALE = 10.0  # rows and normal-drawn weights N(0, 0.1)
RL_NAMES = ("dqn", "deers", "lsrl", "lsrl_l", "lsrl_ps", "lsrl_lps", "lsrl_psns")
ITEM_TABLE = {"dqn": "i_embedding/embedding"}  # the branch networks': i_embeddings


def reader_kwargs(package, **over):
    kwargs = dict(split_mode=package.SplitMode.LEAVE_K_OUT, warm_n=5, leave_k=1, neg_sample_n=9,
                  train_mode=package.TrainMode.POINT_WISE, random_seed=2020, max_state_len=5,
                  use_neg_state=True, rl_sample_len=4)
    kwargs.update(over)
    return kwargs


@pytest.fixture(scope="module")
def readers(tmp_path_factory):
    """Each package's ``value_rl`` reader, from a work dir of its own."""
    root = tmp_path_factory.mktemp("rl")
    built = {}
    with pytest.MonkeyPatch.context() as mp:
        for tag, package, generate in (("jax", jax_data, jax_generate_ml),
                                       ("port", data, data.generate_synthetic_ml)):
            mp.setenv(WORK_DIR, str(root / tag))
            generate(DATASET, **ML_ARGS)
            built[tag] = package.ValueRLDataReader(DATASET, **reader_kwargs(package))
    return built


def hparams(name, **over):
    out = dict(emb_size=E, hidden_size=H)
    if name != "dqn":
        out["dropout"] = 0.0
    out.update(over)
    return out


def flat(tree):
    tree = jax.device_get(tree)
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def as_tree(leaves):
    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                         for k, v in leaves.items()})


def scaled(leaves):
    """Table rows and normal-drawn weights times ``WEIGHT_SCALE`` (the GRUs'
    uniform draws and the u8 tables stay)."""
    return {k: (v * WEIGHT_SCALE if v.dtype == np.float32 and "rnn/" not in k else v)
            for k, v in leaves.items()}


def to_torch(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def jax_model(name, reader, **over):
    return jax_tasks.build_model(name, reader, **hparams(name, **over))


def port_model(name, reader, **over) -> ValueRLModel:
    return tasks.build_model(name, reader, device="cpu", **hparams(name, **over))


def init_leaves(model, batch, seed=0):
    """JAX's initial leaves of ``model`` (a ``ValueRLModel``), scaled."""
    return scaled(flat(model.init(jax.random.PRNGKey(seed), batch)["params"]))


def jax_q(model, leaves, batch, method):
    qnet = model.qnet
    return np.asarray(qnet.apply({"params": as_tree(leaves)}, batch,
                                 method=getattr(qnet, method)))


def batches(reader):
    return {"train": reader.get_batch("train", np.arange(16)),
            "dev": reader.get_batch("dev", np.arange(8))}


@pytest.mark.parametrize("name", RL_NAMES)
def test_leaves_and_forwards_match_jax(readers, name):
    jax_reader, port_reader = readers["jax"], readers["port"]
    model = jax_model(name, jax_reader)
    samples = batches(jax_reader)
    leaves = init_leaves(model, samples["train"])
    port = port_model(name, port_reader)
    got_shapes = {k: tuple(v.shape) for k, v in leaves_of(port.qnet).items()}
    assert got_shapes == {k: v.shape for k, v in leaves.items()}
    params_from_jax(leaves, port.qnet)
    for split, batch in samples.items():
        got = port.qnet.q_values(to_torch(batch)).detach().numpy()
        want = jax_q(model, leaves, batch, "forward")
        assert got.shape == want.shape == ((16,) if split == "train" else (8, 10))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=split)
        got = port.qnet.next_forward(to_torch(batch)).detach().numpy()
        want = jax_q(model, leaves, batch, "next_forward")
        assert got.shape == (len(batch[C.UID]), 4)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=f"{split} next")
    scores, target = port.qnet(to_torch(samples["dev"]))
    assert torch.equal(target[:, 0], torch.ones(8)) and float(target[:, 1:].sum()) == 0.0
    assert port.qnet(to_torch(samples["train"]))[1] is None


@pytest.mark.parametrize("name", ["dqn", "lsrl", "deers"])
@pytest.mark.parametrize("table", ["f32", "int8"])
def test_value_rl_apply_matches_jax(readers, name, table):
    """``(main_q, target_q)`` with a target tree other than the params."""
    over = {"quantized_table": True} if table == "int8" else {}
    jax_reader, port_reader = readers["jax"], readers["port"]
    model = jax_model(name, jax_reader, **over)
    batch = batches(jax_reader)["train"]
    leaves = init_leaves(model, batch, seed=0)
    target_leaves = init_leaves(model, batch, seed=1)
    port = port_model(name, port_reader, **over)
    params_from_jax(leaves, port.qnet)
    target = port.make_target()
    load_leaves(target_leaves, target)
    main_q, target_q = port.apply(to_torch(batch), target)
    want_main, want_target = model.apply({"params": as_tree(leaves)},
                                         {"params": as_tree(target_leaves)}, batch)
    np.testing.assert_allclose(main_q.detach().numpy(), np.asarray(want_main), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(target_q.numpy(), np.asarray(want_target), rtol=RTOL, atol=ATOL)
    assert main_q.requires_grad and not target_q.requires_grad
    reward = batch[C.REWARD].astype(np.float32)
    assert not np.allclose(target_q.numpy(), reward)  # the discounted max reaches it


def _injected(qnet, batch, spec_fn, source):
    """``batch`` with the rows of each spec of ``spec_fn`` gathered from
    ``source``'s tables (dequantized from its ``i_q``) and injected."""
    out = dict(batch)
    for spec in spec_fn(batch).values():
        ids = spec["ids"].reshape(-1)
        if "quantized" in spec:
            out[spec["rows_key"]] = source._item_vec(ids)
        else:
            out[spec["rows_key"]] = source.get_parameter(
                spec["path"].replace("/", ".")).index_select(0, ids)
    return out


@pytest.mark.parametrize("name", RL_NAMES)
@pytest.mark.parametrize("table", ["f32", "int8"])
def test_injected_rows_score_as_the_networks_gathers(readers, name, table):
    over = {"quantized_table": True} if table == "int8" else {}
    port = port_model(name, readers["port"], **over)
    generator = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for param in port.qnet.parameters():
            param.normal_(0.0, 0.1, generator=generator)
    target = port.make_target()
    with torch.no_grad():
        for param in target.parameters():
            param.mul_(-1.0)  # a target tree other than the network's
    for split, batch in batches(readers["port"]).items():
        batch = to_torch(batch)
        with torch.no_grad():
            own = port.qnet.q_values(batch)
            injected = port.qnet.q_values(_injected(port.qnet, batch,
                                                    port.qnet.sharded_table_specs, port.qnet))
            assert torch.equal(own, injected), split
            own_next = target.next_forward(batch)
            next_batch = _injected(target, batch, port.qnet.sharded_target_specs, target)
            assert torch.equal(own_next, target.next_forward(next_batch)), split
            # the eval network's keys do not feed the target's next step, nor
            # the target's keys the eval network's forward
            assert torch.equal(own, port.qnet.q_values(next_batch)), split
        main_q, target_q = port.apply(next_batch, target)
        assert torch.equal(target_q, port.apply(batch, target)[1]), split
    keys = {spec["rows_key"] for spec in port.qnet.sharded_table_specs(batch).values()}
    next_keys = {spec["rows_key"] for spec in port.qnet.sharded_target_specs(batch).values()}
    assert keys and next_keys and not keys & next_keys


def test_target_network_takes_no_gradient_and_no_dropout(readers):
    port = port_model("lsrl", readers["port"], dropout=0.5)
    target = port.make_target()
    assert not any(p.requires_grad for p in target.parameters())
    assert all(p.requires_grad for p in port.qnet.parameters())
    assert not target.training
    batch = to_torch(batches(readers["port"])["train"])
    generator = torch.Generator().manual_seed(0)
    first = port.apply(batch, target, train=True, generator=generator)
    state = generator.get_state()
    second = port.apply(batch, target, train=True, generator=generator)
    assert not torch.equal(first[0], second[0])  # the network draws new masks
    assert torch.equal(first[1], second[1])  # the target draws none
    generator.set_state(state)
    third = port.apply(batch, target, train=True, generator=generator)
    assert torch.equal(second[0], third[0])
    assert torch.equal(port.apply(batch, target)[0], port.apply(batch, target)[0])


def test_load_pretrain_embedding_from_a_port_funksvd(readers, tmp_path):
    reader = readers["port"]
    columns = reader.get_feature_column_dict()
    funk = FunkSVD(uid_column=columns[C.UID], iid_column=columns[C.IID],
                   label_column=columns[C.LABEL], emb_size=E, device="cpu")
    pre = Trainer(funk, device="cpu")
    pre.compile(optimizer="adam", lr=0.05, loss="bce", metrics=("ndcg@5",), user_sample_n=10)
    pre.fit(reader, batch_size=32, epochs=1, verbose=0, eval_dev=False)
    path = str(tmp_path / "pretrain.pt")
    pre.save_weights(path)
    table = funk.i_embeddings.embedding.detach().clone()
    port = port_model("dqn", reader)
    before = port.qnet.out.weight.detach().clone()
    assert ValueRLModel.load_pretrain_embedding(port.qnet, path) is port.qnet
    assert torch.equal(port.qnet.i_embedding.embedding.detach(), table)
    assert torch.equal(port.qnet.out.weight.detach(), before)
    with pytest.raises(KeyError):
        ValueRLModel.load_pretrain_embedding(port.qnet, path, source_path="missing/embedding")
    lsrl = port_model("lsrl", reader)
    with pytest.raises(ValueError):  # the user table's rows are not the item table's
        ValueRLModel.load_pretrain_embedding(lsrl.qnet, path, source_path="u_embeddings/embedding",
                                             target_path="i_embeddings/embedding")
