"""The port's twin of ``examples/criteo_end_to_end.py`` against the JAX
script's own pieces, at the example's widths and a small size: 2,000 rows,
hash_bucket 1,000, batch 256, 6 steps, f32 (JAX on the CPU ignores bf16).

* ``synth_raw_tsv`` writes the JAX script's bytes (two sizes and seeds);
* ``format_criteo`` and ``StreamingBatchSource`` give the JAX package's
  batches (the port over ``.npz`` shards, JAX over parquet);
* from the same parameters (``params_from_jax``), the port's ``fit_steps``
  against JAX's packed ``SparseEmbeddingTrainer.fit_steps`` over those
  batches: the first step's loss within rtol 1e-5, each later one's within
  1e-4; the table, its Adam moments and every dense parameter after 6 steps
  within rtol 1e-4 / atol 1e-6 (f32 sums run in another order), but for
  table values whose gradients summed to nearly nothing: where
  ``sqrt(v_hat) < 1e-5`` (the eps window of
  ``tests/test_torch_fit_steps_stepped.py``, 1e-6, widened tenfold for 6
  free steps of drift, ``ROADMAP.md`` C7) Adam's step turns on the last
  bits of those gradients, and such a value is held to within 1% of lr
  (4 of the 416,000 table values here, each off by at most 0.33% of lr);
  the held-out scores within rtol 1e-5 / atol 1e-7 and the AUC within
  1e-6.

A subprocess with pandas and pyarrow blocked formats a TSV, streams
``.npz`` and ``.csv`` shards and runs the twin with ``--cpu``.
"""

import importlib.util
import os
import subprocess
import sys
from itertools import islice
from pathlib import Path

import jax
import numpy as np
import pytest
from flax import traverse_util

from pytorchrec_tpu.data.process.datasets import format_criteo as jax_format_criteo
from pytorchrec_tpu.data.streaming import StreamingBatchSource as JaxSource
from pytorchrec_tpu.feature_column import CategoricalColumnWithIdentity, NumericColumn
from pytorchrec_tpu.metric import AUC as JaxAUC
from pytorchrec_tpu.models import DCNv2
from pytorchrec_tpu.training.sparse_trainer import SparseEmbeddingTrainer
from pytorchrec_tpu_torch.examples import criteo_end_to_end as twin
from pytorchrec_tpu_torch.metric import AUC
from pytorchrec_tpu_torch.utils import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
ROWS, HASH_BUCKET, BATCH, STEPS = 2000, 1000, 256, 6
TABLE = "unified_emb/embedding"
E, LR, ADAM_B2, DRIFT_WINDOW = 16, 1e-3, 0.999, 1e-5


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_criteo_example", ROOT / "examples" / "criteo_end_to_end.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("rows,seed", [(ROWS, 0), (777, 3)])
def test_synth_raw_tsv_writes_the_jax_bytes(tmp_path, rows, seed):
    _jax_example().synth_raw_tsv(str(tmp_path / "jax.txt"), rows, seed=seed)
    twin.synth_raw_tsv(str(tmp_path / "port.txt"), rows, seed=seed)
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


def _jax_model():
    sparse = tuple(CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                 category_num=HASH_BUCKET) for i in range(26))
    return DCNv2(sparse_columns=sparse,
                 dense_columns=tuple(NumericColumn(feature_name=f"d_{i}") for i in range(13)),
                 label_column=CategoricalColumnWithIdentity(feature_name="label",
                                                            category_num=2),
                 emb_size=16, num_cross_layers=3, layers=(256, 128), unified_embedding=True)


def _flat(params):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(params), sep="/").items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both pipelines from the same raw file: (port data, jax shards, the
    train batches of each, JAX's trainer after 6 steps and its losses, the
    port's trainer after 6 steps)."""
    root = tmp_path_factory.mktemp("twin")
    previous = os.environ.get("PYTORCHREC_TPU_WORK_DIR")
    try:
        os.environ["PYTORCHREC_TPU_WORK_DIR"] = str(root / "port")
        data = twin.prepare(ROWS, HASH_BUCKET, log=lambda *a: None)
        os.environ["PYTORCHREC_TPU_WORK_DIR"] = str(root / "jax")
        raw = root / "jax" / "RawData" / twin.RAW_NAME
        raw.parent.mkdir(parents=True)
        raw.write_bytes(Path(root / "port" / "RawData" / twin.RAW_NAME).read_bytes())
        per_shard = ROWS // 4
        jax_dir = jax_format_criteo("Criteo-Demo", twin.RAW_NAME, hash_bucket=HASH_BUCKET,
                                    rows_per_shard=per_shard, chunk_rows=per_shard // 2)
    finally:
        if previous is None:
            os.environ.pop("PYTORCHREC_TPU_WORK_DIR", None)
        else:
            os.environ["PYTORCHREC_TPU_WORK_DIR"] = previous
    jax_shards = sorted(str(p) for p in Path(jax_dir, "shards").glob("*.parquet"))
    port_batches = list(islice(twin.train_source(data, BATCH).batches(), STEPS))
    jax_batches = list(islice(JaxSource(jax_shards[:-1], batch_size=BATCH,
                                        chunk_rows=twin.SCAN_CHUNK_ROWS, seed=1).batches(),
                              STEPS))

    jax_trainer = SparseEmbeddingTrainer(_jax_model(), packed_tables=True)
    jax_trainer.compile(optimizer="adam", lr=1e-3, loss="bce", metrics=("auc",))
    jax_trainer.init_state(jax_batches[0], seed=2020)
    start = _flat(jax_trainer.state.params)
    history = jax_trainer.fit_steps(iter(jax_batches), steps=STEPS, log_every=1, verbose=0)

    sparse, _, _ = twin.vocab_transform(data["train"], BATCH, 0, HASH_BUCKET)
    port = twin.make_trainer(twin.make_model(sparse, "cpu"), "cpu", matmul_precision=None)
    port.init_state(port_batches[0], seed=2020)
    params_from_jax(start, port)
    port.fit_steps(iter(port_batches), steps=STEPS, log_every=max(STEPS // 4, 1))
    return dict(data=data, jax_shards=jax_shards, port_batches=port_batches,
                jax_batches=jax_batches, jax=jax_trainer, jax_losses=history.history["loss"],
                port=port)


def test_shards_and_batches_match_jax(runs):
    from pytorchrec_tpu_torch.data.process.io import read_frame
    import pandas as pd

    assert [Path(p).stem for p in runs["data"]["shards"]] == \
        [Path(p).stem for p in runs["jax_shards"]]
    for port_shard, jax_shard in zip(runs["data"]["shards"], runs["jax_shards"]):
        got, want = read_frame(port_shard), pd.read_parquet(jax_shard)
        assert list(got) == list(want.columns)
        for column in want.columns:
            assert got[column].dtype == want[column].dtype
            np.testing.assert_array_equal(got[column], want[column].to_numpy())
    for got, want in zip(runs["port_batches"], runs["jax_batches"]):
        assert list(got) == list(want)
        for key in want:
            assert got[key].dtype == want[key].dtype and got[key].shape == (BATCH,)
            np.testing.assert_array_equal(got[key], want[key])


def test_training_matches_jax(runs):
    got = runs["port"].step_losses.numpy()
    want = np.asarray(runs["jax_losses"])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    flat = _flat(runs["jax"].state.params)
    port = runs["port"]
    got_rows, want_rows = port.state.packed[TABLE].numpy(), flat[TABLE]
    np.testing.assert_allclose(got_rows[:, E:], want_rows[:, E:], rtol=1e-4, atol=1e-6)
    v_hat = want_rows[:, 2 * E:3 * E] / (1.0 - ADAM_B2 ** STEPS)
    window = (v_hat > 0) & (np.sqrt(v_hat) < DRIFT_WINDOW)
    err = np.abs(got_rows[:, :E] - want_rows[:, :E])
    outside = err > 1e-4 * np.abs(want_rows[:, :E]) + 1e-6
    assert not (outside & ~window).any(), f"{int((outside & ~window).sum())} table values"
    assert (err[window] <= 1e-2 * LR).all() and int(outside.sum()) <= 5
    state = port.model.state_dict()
    reference = twin.make_model(twin.vocab_transform(runs["data"]["train"], BATCH, 0,
                                                     HASH_BUCKET)[0], "cpu")
    for key, want_value in params_from_jax(flat, reference).state_dict().items():
        if key == "unified_emb.embedding":  # the table, a view of the packed rows
            continue
        np.testing.assert_allclose(state[key].numpy(), want_value.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=key)


def test_heldout_scores_match_jax(runs):
    scores, labels = twin.heldout_scores(runs["port"], runs["data"], BATCH)
    serve = runs["jax"].make_serving_fn()
    heldout = JaxSource([runs["jax_shards"][-1]], batch_size=BATCH,
                        chunk_rows=twin.SCAN_CHUNK_ROWS, shuffle_files=False, seed=2)
    want, want_labels = [], []
    for batch in islice(heldout.batches(epochs=1), twin.HELDOUT_BATCHES):
        want.append(np.asarray(serve(batch)))
        want_labels.append(batch["label"])
    want, want_labels = np.concatenate(want), np.concatenate(want_labels)
    assert len(scores) == len(want) == (ROWS // 4 // BATCH) * BATCH
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_allclose(scores, want, rtol=1e-5, atol=1e-7)
    assert abs(AUC()(scores, labels) - JaxAUC()(want, want_labels)) <= 1e-6


NO_PANDAS = r"""
import os, sys
sys.modules["pandas"] = None
sys.modules["pyarrow"] = None
import numpy as np
from pytorchrec_tpu_torch.data.process.datasets import format_criteo
from pytorchrec_tpu_torch.data.streaming import StreamingBatchSource
from pytorchrec_tpu_torch.examples import criteo_end_to_end as twin
from pytorchrec_tpu_torch.utils import constants as C

raw = os.path.join(C.raw_data_dir(), "tiny", "train.txt")
twin.synth_raw_tsv(raw, 600)
out = format_criteo("Tiny", "tiny/train.txt", hash_bucket=50, rows_per_shard=200,
                    chunk_rows=100, sample_rows=100)
shards = sorted(os.path.join(out, "shards", s) for s in os.listdir(os.path.join(out, "shards")))
npz = list(StreamingBatchSource(shards, batch_size=64, chunk_rows=50).batches(epochs=1))
csv = os.path.join(out, "part.csv")
with open(csv, "w") as f:
    f.write("a,b\n" + "".join(f"{i},{i * 0.5}\n" for i in range(100)))
rows = list(StreamingBatchSource([csv], batch_size=10, chunk_rows=30).batches(epochs=1))
assert len(npz) == 9 and len(rows) == 10 and rows[0]["b"].dtype == np.float64
for extra in ([], ["--vocab_cap", "40"]):
    twin.main(["--rows", "2000", "--steps", "6", "--batch", "256", "--hash_bucket", "1000",
               "--cpu", *extra])
loaded = sorted(m for m, v in sys.modules.items() if v is not None
                and m.split(".")[0] in ("pandas", "pyarrow", "jax", "pytorchrec_tpu"))
assert not loaded, loaded
print("ok")
"""


def test_formatter_streaming_and_twin_need_no_pandas(tmp_path):
    env = {**os.environ, "PYTORCHREC_TPU_WORK_DIR": str(tmp_path)}
    run = subprocess.run([sys.executable, "-c", NO_PANDAS], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.rstrip().endswith("ok"), run.stdout[-2000:]
    assert run.stdout.count("held-out AUC:") == 2 and "mean coverage" in run.stdout


def test_mesh_and_hot_mass_raise():
    for flags in (["--mesh", "2,2"], ["--hot_mass", "0.5"]):
        with pytest.raises(NotImplementedError, match="A10"):
            twin.main(["--cpu", *flags])
