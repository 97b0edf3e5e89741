"""The serving export on the CPU: ``export_serving``/``load_serving``, the
bundle and the Python-free server.

* ``load_serving(export_serving(...))`` against the live scorer
  (``make_serving_fn``) at rtol 1e-6 for DCN-v2, DeepFM and DIN under
  ``Trainer``, DCN-v2 under ``SparseEmbeddingTrainer`` with unpacked,
  packed f32, bf16 and byte rows and under ``QuantizedEmbeddingTrainer``
  with packed int8 and classic int8 tables, each trained two steps. The
  program takes the batch keys the scores read (no label) and holds the
  scoring ops, not an autograd Function.
* Against JAX on the same parameters (``params_from_jax``): JAX's
  ``export_serving`` + ``load_serving`` against the port's, f32 rel 1e-5
  (atol 1e-8 for scores near zero; f32 sums in another order), for DCN-v2,
  DeepFM, DIN and int8 DCN-v2.
* One bundle of a small DCN-v2 against JAX's ``export_serving_bundle`` on
  the same batch: equal ``input`` lines (names, order, dtypes, dims, the
  label dropped), ``expected`` lines equal in dtype and dims with values
  within 1e-5, input files equal to the batch's columns byte for byte. The
  server (``native/serving/aoti_serving.cpp``, built with ``g++`` against
  the CPU wheel) passes ``--dry`` on it, fails on a truncated tensor file or
  a missing ops library, and scores it on the CPU through the ops library's
  plain versions.
* The packed f32 export's weight bytes are within 10% of the unpacked
  tables' (the whole ``[V, 64]`` buffer would be 4 times).

The bundle (one AOTInductor compile) is built once, in a module fixture.
"""

import concurrent.futures
import os
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from pytorchrec_tpu import feature_column as jfc
from pytorchrec_tpu.models import DCNv2 as JaxDCNv2
from pytorchrec_tpu.models import DeepFM as JaxDeepFM
from pytorchrec_tpu.models.din import DIN as JaxDIN
from pytorchrec_tpu.serving import export_serving_bundle as jax_export_serving_bundle
from pytorchrec_tpu.training.quantized_trainer import QuantizedEmbeddingTrainer as JaxQuantized
from pytorchrec_tpu.training.trainer import Trainer as JaxTrainer
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch.models import DIN, DCNv2, DeepFM
from pytorchrec_tpu_torch.ops.kernels import build
from pytorchrec_tpu_torch.serving import export_serving_bundle, shim_binary_path
from pytorchrec_tpu_torch.training import (
    QuantizedEmbeddingTrainer,
    SparseEmbeddingTrainer,
    Trainer,
)
from pytorchrec_tpu_torch.utils import params_from_jax

VOCAB, N_SPARSE, N_DENSE, BATCH = 50, 3, 2, 16
USERS, ITEMS, S = 50, 200, 5
LOAD_RTOL = 1e-6
JAX_RTOL, JAX_ATOL = 1e-5, 1e-8


def _ctr_columns(fc):
    return dict(
        sparse_columns=tuple(fc.CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                              category_num=VOCAB)
                             for i in range(N_SPARSE)),
        dense_columns=tuple(fc.NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)),
        label_column=fc.CategoricalColumnWithIdentity(feature_name="label", category_num=2))


def _din_columns(fc):
    col = fc.CategoricalColumnWithIdentity
    return dict(uid_column=col(feature_name="uid", category_num=USERS),
                iid_column=col(feature_name="iid", category_num=ITEMS),
                his_column=col(feature_name="pos_his", category_num=ITEMS),
                his_len_column=col(feature_name="pos_his_len", category_num=S + 1),
                label_column=col(feature_name="label", category_num=2))


DCN = dict(emb_size=4, num_cross_layers=2, layers=(8,))
FM = dict(emb_size=4, layers=(8,))
DIN_SIZES = dict(emb_size=8, att_hidden_units=(16, 8), mlp_layers=(16, 8))
UNIFIED = dict(unified_embedding=True)
INT8 = dict(unified_embedding=True, quantized_embedding=True, table_packed=True)


def _ctr_batch(seed=0):
    rng = np.random.default_rng(seed)
    batch = {f"c_{i}": rng.integers(0, VOCAB, BATCH).astype(np.int32) for i in range(N_SPARSE)}
    batch.update({f"d_{i}": rng.normal(size=BATCH).astype(np.float32) for i in range(N_DENSE)})
    batch["label"] = rng.integers(0, 2, BATCH).astype(np.int32)
    return batch


def _din_batch(seed=0, candidates=100, rows=4):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, S + 1, size=rows).astype(np.int32)
    his = rng.integers(1, ITEMS, size=(rows, S)).astype(np.int32)
    his[np.arange(S)[None, :] >= lengths[:, None]] = 0
    return {"uid": rng.integers(0, USERS, size=rows).astype(np.int32),
            "iid": rng.integers(0, ITEMS, size=(rows, candidates)).astype(np.int32),
            "pos_his": his, "pos_his_len": lengths,
            "label": rng.integers(0, 2, size=rows).astype(np.int32)}


def _port_model(kind, **kwargs):
    gen = torch.Generator().manual_seed(0)
    if kind == "din":
        return DIN(**_din_columns(tfc), **DIN_SIZES, device="cpu", generator=gen, **kwargs)
    cls, sizes = (DCNv2, DCN) if kind == "dcnv2" else (DeepFM, FM)
    return cls(**_ctr_columns(tfc), **sizes, device="cpu", generator=gen, **kwargs)


# case -> (model kind, model kwargs, trainer)
CASES = {
    "dcnv2": ("dcnv2", {}, lambda m: Trainer(m, device="cpu")),
    "deepfm": ("deepfm", {}, lambda m: Trainer(m, device="cpu")),
    "din": ("din", {}, lambda m: Trainer(m, device="cpu")),
    "sparse_unpacked": ("dcnv2", UNIFIED, lambda m: SparseEmbeddingTrainer(m, device="cpu")),
    "sparse_packed_f32": ("dcnv2", UNIFIED,
                          lambda m: SparseEmbeddingTrainer(m, device="cpu", packed_tables=True)),
    "sparse_bf16": ("dcnv2", UNIFIED,
                    lambda m: SparseEmbeddingTrainer(m, device="cpu", packed_tables=True,
                                                     packed_dtype="bfloat16")),
    "sparse_bytes": ("dcnv2", UNIFIED,
                     lambda m: SparseEmbeddingTrainer(m, device="cpu", packed_bytes=True)),
    "int8_packed": ("dcnv2", INT8,
                    lambda m: QuantizedEmbeddingTrainer(m, device="cpu", packed_tables=True)),
    "int8_classic": ("dcnv2", dict(unified_embedding=True, quantized_embedding=True),
                     lambda m: QuantizedEmbeddingTrainer(m, device="cpu")),
}


def _trained(case, batch, steps=2):
    kind, kwargs, make = CASES[case]
    trainer = make(_port_model(kind, **kwargs))
    trainer.compile(optimizer="adam", lr=1e-2, loss="bce", metrics=())
    trainer.init_state(batch, seed=0)
    for _ in range(steps):
        trainer.train_step(batch)
    return trainer


def _weight_bytes(program):
    tensors = list(program.state_dict.values()) + list(program.constants.values())
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("case", list(CASES))
def test_load_serving_matches_the_live_scorer(case, tmp_path):
    batch = _din_batch() if CASES[case][0] == "din" else _ctr_batch()
    trainer = _trained(case, batch)
    path = str(tmp_path / "scorer.pt2")
    trainer.export_serving(path, batch)
    serve = Trainer.load_serving(path)
    assert "label" not in serve.keys and serve.keys == sorted(serve.keys)
    want = trainer.make_serving_fn()(batch)
    got = serve(batch)
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=LOAD_RTOL, atol=0)
    program, keys = trainer.export_program(batch)
    assert keys == serve.keys
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    op = {"dcnv2": "cross_network", "deepfm": "fm_interaction",
          "din": "din_attention_pool"}[CASES[case][0]]
    assert targets.count(f"pytorchrec.{op}.default") == 1
    assert not any("autograd" in t.lower() for t in targets)


def test_export_leaves_the_trainers_tables_in_place():
    """The packed trainer's export swaps in contiguous copies and puts the
    model's own table (a view of the packed buffer) back."""
    batch = _ctr_batch()
    trainer = _trained("sparse_packed_f32", batch)
    table = trainer.model.unified_emb.embedding
    trainer.export_program(batch)
    assert trainer.model.unified_emb.embedding is table
    assert table.data_ptr() == next(iter(trainer.state.packed.values())).data_ptr()


def test_packed_f32_weight_bytes_match_the_unpacked_tables():
    batch = _ctr_batch()
    packed, _ = _trained("sparse_packed_f32", batch).export_program(batch)
    unpacked, _ = _trained("sparse_unpacked", batch).export_program(batch)
    assert abs(_weight_bytes(packed) - _weight_bytes(unpacked)) <= 0.1 * _weight_bytes(unpacked)


# ---------------------------------------------------------------------- JAX

JAX_CASES = {
    "dcnv2": (JaxDCNv2, DCN, {}, JaxTrainer, "dcnv2",
              lambda m: Trainer(m, device="cpu")),
    "deepfm": (JaxDeepFM, FM, {}, JaxTrainer, "deepfm", lambda m: Trainer(m, device="cpu")),
    "din": (JaxDIN, DIN_SIZES, {}, JaxTrainer, "din", lambda m: Trainer(m, device="cpu")),
    "int8_dcnv2": (JaxDCNv2, DCN, INT8, lambda m: JaxQuantized(m, packed_tables=True), "dcnv2",
                   lambda m: QuantizedEmbeddingTrainer(m, device="cpu", packed_tables=True)),
}


def _jax_pair(case, batch):
    """A JAX trainer and the port's trainer holding its parameters."""
    cls, sizes, kwargs, make_jax, kind, make_port = JAX_CASES[case]
    columns = _din_columns(jfc) if kind == "din" else _ctr_columns(jfc)
    jax_trainer = make_jax(cls(**columns, **sizes, **kwargs))
    jax_trainer.compile(optimizer="adam", lr=1e-3, loss="bce", metrics=())
    jax_trainer.init_state(batch, seed=0)
    if case == "int8_dcnv2":
        jax_trainer._train_step(batch)  # rows away from their initial values
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        jax.device_get(jax_trainer.state.params), sep="/").items()}
    port = make_port(_port_model(kind, **kwargs))
    port.compile(optimizer="adam", lr=1e-3, loss="bce", metrics=())
    port.init_state(batch, seed=0)
    return jax_trainer, params_from_jax(flat, port)


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_export_matches_jax_export(case, tmp_path):
    batch = _din_batch(seed=1) if JAX_CASES[case][4] == "din" else _ctr_batch(seed=1)
    serve_batch = {k: v for k, v in batch.items() if k != "label"}
    jax_trainer, port = _jax_pair(case, batch)
    jax_trainer.export_serving(str(tmp_path / "jax.stablehlo"), serve_batch)
    want = np.asarray(JaxTrainer.load_serving(str(tmp_path / "jax.stablehlo"))(serve_batch))
    port.export_serving(str(tmp_path / "port.pt2"), serve_batch)
    got = Trainer.load_serving(str(tmp_path / "port.pt2"))(serve_batch).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=JAX_RTOL, atol=JAX_ATOL)


# ------------------------------------------------------- bundle and server


def _manifest(bundle):
    with open(os.path.join(bundle, "manifest.txt")) as f:
        return [line.split() for line in f.read().splitlines() if line]


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """The port's bundle of a small DCN-v2 and JAX's of the same parameters
    on the same batch, and the server; the server and the ops library build
    while the port exports."""
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        server = pool.submit(shim_binary_path)
        pool.submit(build.serving_ops_library, False)
        batch = _ctr_batch(seed=2)
        jax_trainer, port = _jax_pair("dcnv2", batch)
        root = tmp_path_factory.mktemp("bundles")
        jax_bundle = jax_export_serving_bundle(jax_trainer, batch, str(root / "jax"),
                                               plugin_path="/none", env={}, client_options=[])
        bundle = export_serving_bundle(port, batch, str(root / "port"))
        return {"port": bundle, "jax": jax_bundle, "batch": batch, "server": server.result()}


def test_bundle_lines_match_jax(bundles):
    port, jax_lines = _manifest(bundles["port"]), _manifest(bundles["jax"])
    inputs = [line for line in port if line[0] == "input"]
    assert inputs == [line for line in jax_lines if line[0] == "input"]
    assert "label" not in {line[4] for line in inputs}
    kinds = [line[0] for line in port]
    assert kinds[:2] == ["program", "ops_library"] and kinds[-1] == "tolerance"
    assert [line for line in port if line[0] == "op"] == [["op", "cross_network", "0"]]
    for line in inputs:
        got = np.fromfile(os.path.join(bundles["port"], line[3]), dtype=np.uint8).tobytes()
        assert got == np.ascontiguousarray(bundles["batch"][line[4]]).tobytes()
    port_expected = [line for line in port if line[0] == "expected"]
    jax_expected = [line for line in jax_lines if line[0] == "expected"]
    assert [line[:3] for line in port_expected] == [line[:3] for line in jax_expected]
    for mine, theirs in zip(port_expected, jax_expected):
        got = np.fromfile(os.path.join(bundles["port"], mine[3]), dtype=np.float32)
        want = np.fromfile(os.path.join(bundles["jax"], theirs[3]), dtype=np.float32)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for name in ("model.pt2", "serving_ops.so"):
        assert os.path.getsize(os.path.join(bundles["port"], name)) > 0


def _serve(bundles, bundle, *args):
    return subprocess.run([bundles["server"], bundle, *args], capture_output=True, text=True,
                          timeout=300)


def test_server_dry_passes_on_the_bundle(bundles):
    run = _serve(bundles, bundles["port"], "--dry")
    assert run.returncode == 0, run.stderr
    assert "DRY OK" in run.stdout


def test_server_dry_fails_on_a_truncated_tensor(bundles, tmp_path):
    broken = tmp_path / "broken"
    shutil.copytree(bundles["port"], broken)
    with open(broken / "input_0.bin", "r+b") as f:
        f.truncate(os.path.getsize(broken / "input_0.bin") - 4)
    run = _serve(bundles, str(broken), "--dry")
    assert run.returncode != 0
    assert "mismatch" in run.stderr


def test_server_fails_without_its_ops_library(bundles, tmp_path):
    broken = tmp_path / "no_ops"
    shutil.copytree(bundles["port"], broken)
    os.remove(broken / "serving_ops.so")
    run = _serve(bundles, str(broken), "--dry")
    assert run.returncode != 0 and "ops library" in run.stderr


def test_server_scores_the_cpu_bundle(bundles):
    """With no Python: the ops library's CPU ops (the plain versions) under
    the AOTInductor package, within the manifest's tolerance of the live
    scorer's scores, no kernel launched."""
    run = _serve(bundles, bundles["port"], "--reps", "3")
    assert run.returncode == 0, run.stdout + run.stderr
    assert "SERVING VERIFICATION PASSED" in run.stdout
    assert '"launches": {"cross_network": 0}' in run.stdout
