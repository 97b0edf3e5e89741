"""The serving export on the card.

Marked ``gpu``; each test skips where no card is present. On a machine with
one, run them alone (``tests/conftest.py`` imports JAX, which the card's
machine need not have):

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_serving_gpu.py

* Each scoring op (``torch.ops.pytorchrec``) on CUDA tensors launches its
  kernel once and agrees with its plain version: rtol 1e-4 / atol 1e-6 for
  the cross network and DIN pooling (f32 sums in another order), the FM
  forward within 1e-5 of its terms' magnitude plus 1e-7.
* A small DCN-v2 trained on the card, exported with
  ``export_serving_bundle`` and scored by the server with no Python: exit
  0, scores within the manifest's tolerance, launches (1 + N) times the
  request's; ``load_serving`` of the same scorer matches the live one at
  rtol 1e-6 and launches the kernel.
* A bundle whose ops library is missing, or is the CPU build (no kernels),
  makes the server exit non-zero: nothing stands in for the kernels.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from pytorchrec_tpu_torch.feature_column import CategoricalColumnWithIdentity, NumericColumn
from pytorchrec_tpu_torch.models import DCNv2
from pytorchrec_tpu_torch.ops.kernels import build, cross, din_attention, fm
from pytorchrec_tpu_torch.serving import export_serving_bundle, shim_binary_path
from pytorchrec_tpu_torch.training import Trainer

RTOL, ATOL = 1e-4, 1e-6
REPS = 3


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _f32(rng, *shape, scale=0.1):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 5, 1000, 8192])
def test_cross_op_matches_plain(batch):
    _need_card()
    rng = np.random.default_rng(batch)
    x0, ws, bs = _f32(rng, batch, 429), _f32(rng, 3, 429, 429, scale=0.05), _f32(rng, 3, 429)
    before = cross.cross_network.launches
    got = cross.CROSS_OP(x0, ws, bs)
    torch.cuda.synchronize()
    assert cross.cross_network.launches == before + 1
    torch.testing.assert_close(got, cross.cross_network_plain(x0, ws, bs), rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 33, 32768])
def test_fm_op_matches_plain(batch):
    _need_card()
    v = _f32(np.random.default_rng(batch), batch, 39, 16, scale=0.01)
    before = fm.fm_interaction.launches
    got = fm.FM_OP(v)
    torch.cuda.synchronize()
    assert fm.fm_interaction.launches == before + 1
    magnitude = 0.5 * (v.sum(dim=1).square() + v.square().sum(dim=1)).sum(dim=-1)
    assert bool(((got - fm.fm_interaction_plain(v)).abs() <= 1e-7 + 1e-5 * magnitude).all())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1), (4, 2), (64, 100)])
def test_din_op_matches_plain(shape):
    _need_card()
    rng = np.random.default_rng(shape[0])
    b, n = shape
    e, s, dims = 64, 20, [256, 80, 40, 1]
    params = []
    for i in range(len(dims) - 1):
        params += [_f32(rng, dims[i], dims[i + 1]), _f32(rng, dims[i + 1])]
    his, tgt = _f32(rng, b, s, e), _f32(rng, b, n, e)
    valid = torch.from_numpy((rng.random((b, s)) < 0.8).astype(np.int32)).cuda()
    valid[:, 0] = 1
    before = din_attention.din_attention_pool.launches
    got = din_attention.DIN_OP(his, tgt, valid, params, "sigmoid")
    torch.cuda.synchronize()
    assert din_attention.din_attention_pool.launches == before + 1
    want = din_attention.din_attention_pool_plain(his, tgt, valid, params, "sigmoid")
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def card_bundle(tmp_path_factory):
    """A small DCN-v2 (fused-form batch of 8192 rows) trained two steps on
    the card, its bundle, its trainer and request."""
    _need_card()
    rng = np.random.default_rng(0)
    sparse = [CategoricalColumnWithIdentity(feature_name=f"c_{i}", category_num=1000)
              for i in range(4)]
    dense = [NumericColumn(feature_name=f"d_{i}") for i in range(3)]
    label = CategoricalColumnWithIdentity(feature_name="label", category_num=2)
    model = DCNv2(sparse_columns=sparse, dense_columns=dense, label_column=label, emb_size=16,
                  num_cross_layers=2, layers=(64,), unified_embedding=True, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(0))
    batch = {f"c_{i}": rng.integers(0, 1000, 8192).astype(np.int32) for i in range(4)}
    batch.update({f"d_{i}": rng.normal(size=8192).astype(np.float32) for i in range(3)})
    batch["label"] = rng.integers(0, 2, 8192).astype(np.int32)
    trainer = Trainer(model, device="cuda")
    trainer.compile(optimizer="adam", lr=1e-2, loss="bce", metrics=())
    trainer.init_state(batch, seed=0)
    for _ in range(2):
        trainer.train_step(batch)
    request = {k: v for k, v in batch.items() if k != "label"}
    out = export_serving_bundle(trainer, request, str(tmp_path_factory.mktemp("card") / "b"))
    return {"bundle": out, "trainer": trainer, "request": request, "server": shim_binary_path()}


def _serve(server, bundle, *args):
    return subprocess.run([server, bundle, *args], capture_output=True, text=True, timeout=600)


@pytest.mark.gpu
def test_server_scores_the_card_bundle(card_bundle):
    run = _serve(card_bundle["server"], card_bundle["bundle"], "--reps", str(REPS))
    assert run.returncode == 0, run.stdout + run.stderr
    assert "SERVING VERIFICATION PASSED" in run.stdout
    assert f'"launches": {{"cross_network": {1 + REPS}}}' in run.stdout


@pytest.mark.gpu
def test_load_serving_on_the_card(card_bundle, tmp_path):
    trainer, request = card_bundle["trainer"], card_bundle["request"]
    path = str(tmp_path / "scorer.pt2")
    trainer.export_serving(path, request)
    serve = Trainer.load_serving(path)
    want = trainer.make_serving_fn()(request)
    before = cross.cross_network.launches
    got = serve(request)
    torch.cuda.synchronize()
    assert cross.cross_network.launches == before + 1 and got.device.type == "cuda"
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("library", ["missing", "cpu_build"])
def test_server_fails_without_the_kernels(card_bundle, tmp_path, library):
    broken = tmp_path / library
    shutil.copytree(card_bundle["bundle"], broken)
    os.remove(broken / "serving_ops.so")
    if library == "cpu_build":
        shutil.copyfile(build.serving_ops_library(False), broken / "serving_ops.so")
    run = _serve(card_bundle["server"], str(broken), "--reps", "1")
    assert run.returncode != 0
    assert "SERVING VERIFICATION PASSED" not in run.stdout
