"""The port as a package: what it imports, where it runs, and its small
modules (feature columns, embedding, MLP) against the JAX package's."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pytorchrec_tpu import feature_column as jfc
from pytorchrec_tpu.loss import losses as jax_losses
from pytorchrec_tpu.ops.embedding import Embedding as JaxEmbedding
from pytorchrec_tpu.ops.mlp import MLP as JaxMLP
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch.loss import get_loss
from pytorchrec_tpu_torch.models import DCNv2
from pytorchrec_tpu_torch.ops.embedding import Embedding
from pytorchrec_tpu_torch.ops.mlp import MLP
from pytorchrec_tpu_torch.training import Trainer
from pytorchrec_tpu_torch.utils import params_from_jax, resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "pytorchrec_tpu_torch"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PORT)], "pytorchrec_tpu_torch."))


def test_every_training_module_is_walked():
    modules = set(_modules())
    assert {"pytorchrec_tpu_torch.loss.losses", "pytorchrec_tpu_torch.optim.optimizers",
            "pytorchrec_tpu_torch.training.state", "pytorchrec_tpu_torch.training.sparse_trainer",
            "pytorchrec_tpu_torch.training.callbacks", "pytorchrec_tpu_torch.ops.kernels.seg_scan",
            "pytorchrec_tpu_torch.ops.kernels.scatter", "pytorchrec_tpu_torch.ops.kernels.quantize",
            "pytorchrec_tpu_torch.ops.quantized_packed", "pytorchrec_tpu_torch.utils.rng",
            "pytorchrec_tpu_torch.training.quantized_trainer",
            "pytorchrec_tpu_torch.ops.kernels.fm", "pytorchrec_tpu_torch.ops.kernels.din_attention",
            "pytorchrec_tpu_torch.ops.attention", "pytorchrec_tpu_torch.ops.seq_utils",
            "pytorchrec_tpu_torch.models.din", "pytorchrec_tpu_torch.models.two_tower",
            "pytorchrec_tpu_torch.serving", "pytorchrec_tpu_torch.serving.retrieval",
            "pytorchrec_tpu_torch.ops.kernels.retrieval_topk", "pytorchrec_tpu_torch.metric",
            "pytorchrec_tpu_torch.metric.metrics", "pytorchrec_tpu_torch.data.loader",
            "pytorchrec_tpu_torch.utils.graphs", "pytorchrec_tpu_torch.training.checkpoint",
            "pytorchrec_tpu_torch.data.schema", "pytorchrec_tpu_torch.utils.constants",
            "pytorchrec_tpu_torch.utils.data_structure", "pytorchrec_tpu_torch.utils.enum_utils",
            "pytorchrec_tpu_torch.utils.profiling", "pytorchrec_tpu_torch.utils.system",
            "pytorchrec_tpu_torch.utils.timer", "pytorchrec_tpu_torch.utils.version",
            "pytorchrec_tpu_torch.ops.gru", "pytorchrec_tpu_torch.models.funk_svd",
            "pytorchrec_tpu_torch.models.svdpp", "pytorchrec_tpu_torch.models.ncf",
            "pytorchrec_tpu_torch.models.gru4rec", "pytorchrec_tpu_torch.models.sasrec",
            "pytorchrec_tpu_torch.native", "pytorchrec_tpu_torch.utils.registry",
            "pytorchrec_tpu_torch.data.adapter", "pytorchrec_tpu_torch.data.process.io",
            "pytorchrec_tpu_torch.data.process.splits",
            "pytorchrec_tpu_torch.data.process.vt_negative_sample",
            "pytorchrec_tpu_torch.data.process.history",
            "pytorchrec_tpu_torch.data.process.features",
            "pytorchrec_tpu_torch.data.process.dataset_info",
            "pytorchrec_tpu_torch.data.process.datasets.synthetic",
            "pytorchrec_tpu_torch.data.readers.base", "pytorchrec_tpu_torch.data.readers.history",
            "pytorchrec_tpu_torch.data.readers.svdpp", "pytorchrec_tpu_torch.console_main",
            "pytorchrec_tpu_torch.tasks", "pytorchrec_tpu_torch.tasks.builder",
            "pytorchrec_tpu_torch.tasks.task", "pytorchrec_tpu_torch.tasks.repeat",
            "pytorchrec_tpu_torch.tasks.grid_search", "pytorchrec_tpu_torch.tasks.results",
            "pytorchrec_tpu_torch.models.multitask",
            "pytorchrec_tpu_torch.utils.argument",
            "pytorchrec_tpu_torch.serving.bundle"} <= modules


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in ['pytorchrec_tpu_torch'] + {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'pytorchrec_tpu', 'pandas',\n"
        "              'pyarrow'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert run.stdout.startswith("ok")


def test_no_port_source_imports_pandas_and_only_one_function_pyarrow():
    """The card's machine has neither: pandas is imported nowhere in the
    port, pyarrow only inside ``data/process/io.py::frames_from_feather``."""
    pattern = re.compile(r"^(\s*)(import|from)\s+(pandas|pyarrow)\b", re.MULTILINE)
    sources = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    found = {str(p.relative_to(ROOT)): [(m.group(1), m.group(3)) for m in
                                        pattern.finditer(p.read_text())] for p in sources}
    found = {path: hits for path, hits in found.items() if hits}
    assert found == {"pytorchrec_tpu_torch/data/process/io.py": [("        ", "pyarrow")]}
    io_source = (PORT / "data" / "process" / "io.py").read_text()
    function = io_source[io_source.index("def frames_from_feather"):]
    assert "from pyarrow import" in function[:function.index("\ndef ")]


def test_no_port_source_names_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|pytorchrec_tpu)\b",
                         re.MULTILINE)
    sources = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(p.relative_to(ROOT)) for p in sources if pattern.search(p.read_text())]
    assert not offenders
    kernels = {"cross", "seg_scan", "scatter", "requantize", "fm", "din_attention",
               "retrieval_topk", "quantize"}
    assert {p.stem for p in (PORT / "csrc").glob("*.cu")} == kernels
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert all(f'"{kernel}"' in smoke for kernel in kernels)  # chip_smoke builds every one


def test_no_cpp_source_includes_jax_or_pjrt():
    """The port's C++ and CUDA sources include nothing of JAX, XLA or PJRT,
    nor of the JAX package's native code."""
    pattern = re.compile(r'^\s*#\s*include\s+[<"]([^>"]+)[>"]', re.MULTILINE)
    sources = [p for p in PORT.rglob("*") if p.suffix in (".cpp", ".h", ".cu", ".cuh")]
    assert {p.name for p in sources} >= {"serving_ops.cpp", "serving_plans.h",
                                         "aoti_serving.cpp", "cross.cu", "fastrec.cpp"}
    offenders = {str(p.relative_to(ROOT)): hit for p in sources
                 for hit in pattern.findall(p.read_text())
                 if re.search(r"jax|xla|pjrt|pytorchrec_tpu/", hit, re.IGNORECASE)}
    assert not offenders


def test_serving_exports():
    from pytorchrec_tpu_torch import serving
    from pytorchrec_tpu_torch.ops import kernels

    assert {"export_serving_bundle", "shim_binary_path", "build_item_index",
            "make_retrieve_fn"} <= set(serving.__all__)
    assert {"NAMESPACE", "SCHEMAS", "define_op"} <= set(kernels.__all__)
    assert callable(Trainer.export_serving) and callable(Trainer.load_serving)
    assert callable(Trainer.export_program)


def _small_model(device):
    return DCNv2(sparse_columns=[tfc.CategoricalColumnWithIdentity("c_0", 10)],
                 dense_columns=[tfc.NumericColumn("d_0")], emb_size=2,
                 num_cross_layers=1, layers=(4,), device=device,
                 generator=torch.Generator().manual_seed(0))


def test_entry_points_raise_without_a_card(monkeypatch):
    """No device means the card; with no card that is an error, never the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = _small_model("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _small_model(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    assert Trainer(model, device="cpu").device == torch.device("cpu")


def test_numeric_column_modes_match_jax():
    values = np.random.default_rng(0).normal(3.0, 2.0, size=50).astype(np.float32)
    for mode in ("NOP", "MAX_MIN", "Z_SCORE"):
        jcol = jfc.NumericColumn.from_array("x", values, getattr(jfc.NormalizationMode, mode))
        tcol = tfc.NumericColumn.from_array("x", values, getattr(tfc.NormalizationMode, mode))
        batch = {"x": values}
        got = tcol.get_feature_data(batch)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(jcol.get_feature_data(batch)),
                                   rtol=1e-6, atol=1e-7)
    assert tfc.NumericColumn("x").get_feature_data({}) is None


def test_categorical_and_crossed_columns_match_jax():
    rng = np.random.default_rng(1)
    a, b = rng.integers(0, 7, 20).astype(np.int32), rng.integers(2, 5, 20).astype(np.int32)
    jcols = [jfc.CategoricalColumnWithIdentity.from_array(n, v) for n, v in (("a", a), ("b", b))]
    tcols = [tfc.CategoricalColumnWithIdentity.from_array(n, v) for n, v in (("a", a), ("b", b))]
    for jc, tc in zip(jcols, tcols):
        assert (jc.category_num, jc.get_info("min_value"), jc.get_info("max_value")) == (
            tc.category_num, tc.get_info("min_value"), tc.get_info("max_value"))
    batch = {"a": a, "b": b}
    jcross, tcross = jfc.CrossedColumn(jcols), tfc.CrossedColumn(tcols)
    assert (tcross.feature_name, tcross.category_num, tcross.coefs) == (
        jcross.feature_name, jcross.category_num, jcross.coefs)
    got = tcross.get_feature_data(batch)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcross.get_feature_data(batch)))
    assert tcross.get_feature_data({"a": a}) is None
    with pytest.raises(ValueError):
        tfc.CrossedColumn(tcols[:1])


def test_embedding_gather_matches_flax():
    rng = np.random.default_rng(2)
    table = rng.normal(size=(30, 5)).astype(np.float32)
    ids = rng.integers(0, 30, size=(4, 3)).astype(np.int32)
    want = JaxEmbedding(30, 5).apply({"params": {"embedding": jnp.asarray(table)}},
                                     jnp.asarray(ids))
    emb = Embedding(30, 5, device="cpu", generator=torch.Generator().manual_seed(0))
    assert 0.005 < float(emb.embedding.detach().std()) < 0.02  # normal(0, 0.01) init
    emb.load_state_dict({"embedding": torch.from_numpy(table)})
    got = emb(tfc.base.as_int(ids))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


@pytest.mark.parametrize("activation", ["relu", "gelu", "tanh", "sigmoid", "identity"])
def test_mlp_matches_flax(activation):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 7)).astype(np.float32)
    jax_mlp = JaxMLP((5, 3), activation=activation)
    variables = jax_mlp.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jax_mlp.apply(variables, jnp.asarray(x)))
    flat = traverse_util.flatten_dict(variables["params"], sep="/")

    holder = torch.nn.Module()
    holder.deep = MLP(7, (5, 3), activation=activation, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    params_from_jax({f"deep/{k}": np.asarray(v) for k, v in flat.items()}, holder)
    with torch.no_grad():
        got = holder.deep(torch.from_numpy(x), train=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


def test_dropout_only_when_training():
    mlp = MLP(4, (64,), activation="identity", dropout=0.5, device="cpu",
              generator=torch.Generator().manual_seed(0))
    x = torch.ones(8, 4)
    with torch.no_grad():
        assert torch.equal(mlp(x), mlp(x))  # serving: no dropout
        assert (mlp(x, train=True) == 0).any()


def test_dropout_draws_from_the_given_generator():
    mlp = MLP(4, (4096,), activation="identity", dropout=0.25, device="cpu",
              generator=torch.Generator().manual_seed(0))
    x = torch.ones(2, 4)
    with torch.no_grad():
        want = mlp(x)  # serving: no dropout
        a = mlp(x, train=True, generator=torch.Generator().manual_seed(5))
        b = mlp(x, train=True, generator=torch.Generator().manual_seed(5))
        c = mlp(x, train=True, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert 0.7 < float(kept.float().mean()) < 0.8
    torch.testing.assert_close(a[kept], (want / 0.75)[kept])  # flax scales kept values


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("name", ["bce", "mse"])
def test_losses_match_jax(name, reduction):
    rng = np.random.default_rng(7)
    prediction = (rng.normal(size=64) * 30).astype(np.float32)  # large logits: stable form
    target = rng.integers(0, 2, 64).astype(np.float32)
    want = getattr(jax_losses, f"{name}_loss")(jnp.asarray(prediction), jnp.asarray(target),
                                                reduction=reduction)
    got = get_loss(name)(torch.from_numpy(prediction), torch.from_numpy(target),
                         reduction=reduction)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_bpr_loss_matches_jax(reduction):
    """BPR on [B, 2] (positive, negative) scores, large ones included (the
    stable softplus); rtol 1e-5 / atol 1e-6."""
    prediction = (np.random.default_rng(8).normal(size=(64, 2)) * 30).astype(np.float32)
    want = jax_losses.bpr_loss(jnp.asarray(prediction), None, reduction=reduction)
    got = get_loss("bpr")(torch.from_numpy(prediction), None, reduction=reduction)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        get_loss("bpr")(torch.zeros(64), None)


def test_new_exports():
    from pytorchrec_tpu_torch import loss, models, serving
    from pytorchrec_tpu_torch.ops.kernels import retrieval_topk

    assert {"TwoTower", "FunkSVD", "SVDPP", "NCF", "GRU4Rec", "SASRec"} <= set(models.__all__)
    assert {"softmax_ce_loss"} <= set(loss.__all__)
    from pytorchrec_tpu_torch import ops

    assert {"MaskedGRU", "SASRecBlock", "sasrec_encoder",
            "scaled_dot_product_attention"} <= set(ops.__all__)
    assert {"build_item_index", "make_retrieve_fn"} <= set(serving.__all__)
    assert retrieval_topk.bin_max_scores.launches >= 0 and get_loss("softmax") is not None
    assert (retrieval_topk.LANES, retrieval_topk.DEFAULT_TC, retrieval_topk.DEFAULT_GROUP,
            retrieval_topk.PAD_SCORE) == (128, 2048, 16, -1e30)
    from pytorchrec_tpu_torch.ops import sparse_update
    from pytorchrec_tpu_torch.ops.kernels import quantize
    from pytorchrec_tpu_torch.training import quantized_trainer

    assert quantize.stochastic_quantize_rows.launches >= 0
    assert callable(quantize.stochastic_quantize_rows_plain)
    assert callable(quantize.rounding_bits_i32) and callable(sparse_update.dedup_row_grads)
    assert sparse_update.SparseRowGrad._fields == ("ids", "rows", "mask")
    assert callable(quantized_trainer.classic_quantized_update)
    from pytorchrec_tpu_torch import data
    from pytorchrec_tpu_torch.data import process
    from pytorchrec_tpu_torch.data.process import datasets
    from pytorchrec_tpu_torch.utils import constants

    assert {"DatasetDescription", "FeatureMeta", "DataReader", "SimpleDataReader",
            "HistoryDataReader", "SVDPPDataReader", "CTRDataReader", "READERS",
            "data_reader_name_list", "get_data_reader_type", "generate_synthetic_ml",
            "generate_synthetic_ctr", "frames_from_feather", "read_frame",
            "write_frame"} <= set(data.__all__)
    assert set(datasets.__all__) == {"generate_synthetic_ml", "generate_synthetic_ctr"}
    assert {"generate_sequential_split", "generate_leave_k_out_split",
            "generate_vt_negative_sample", "generate_interaction_history_list",
            "check_dataset_info"} <= set(process.__all__)
    assert (constants.BASE_INTERACTION_FRAME, constants.INTERACTION_FRAME, constants.ITEM_FRAME,
            constants.USER_FRAME) == ("base_interaction.npz", "interaction.npz", "item.npz",
                                      "user.npz")


def test_unported_losses_raise():
    """Every loss of the JAX registry is ported (top1 and esmm last); a name
    outside it raises, as the JAX registry's lookup does."""
    assert get_loss("top1") is not None and get_loss("esmm") is not None
    with pytest.raises(ValueError, match="unknown loss"):
        get_loss("top2")


def test_task_layer_exports():
    """The task layer's surface: the top-level names load on first use (as
    the JAX package's do), the registries and the multi-task family are
    exported, and importing the top level alone loads no task module."""
    import pytorchrec_tpu_torch
    from pytorchrec_tpu_torch import loss, models, optim, tasks
    from pytorchrec_tpu_torch.utils import profiling

    assert {"Task", "RepeatTask", "GridSearch", "Trainer", "SparseEmbeddingTrainer",
            "QuantizedEmbeddingTrainer", "SplitMode", "TrainMode"} <= set(dir(pytorchrec_tpu_torch))
    assert pytorchrec_tpu_torch.Task is tasks.Task
    with pytest.raises(AttributeError):
        pytorchrec_tpu_torch.NoSuchName
    assert {"SharedBottom", "MMoE", "PLE", "ESMM", "ExpertBank", "MODELS", "model_name_list",
            "get_model_type", "get_data_reader_name"} <= set(models.__all__)
    assert {"Task", "RepeatTask", "GridSearch", "TASKS", "task_name_list", "get_task_type",
            "build_model", "build_reader", "create_params_list"} <= set(tasks.__all__)
    assert {"OPTIMIZERS", "build_optimizer", "get_optimizer",
            "optimizer_name_list"} <= set(optim.__all__)
    assert {"top1_loss", "esmm_loss", "loss_name_list"} <= set(loss.__all__)
    assert callable(profiling.TorchProfiler) and callable(profiling.enable_nan_debugging)
    run = subprocess.run([sys.executable, "-c",
                          "import sys, pytorchrec_tpu_torch\n"
                          "assert 'pytorchrec_tpu_torch.tasks' not in sys.modules\n"
                          "print(pytorchrec_tpu_torch.Task.__module__)"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip() == "pytorchrec_tpu_torch.tasks.task"
