"""The port's ``BatchPacker`` against the JAX package's, on the CPU: the same
slots in the same sorted-key order, byte-equal packed buffers, and
``unpack`` views that give the batch back (ids as int32, floats as float32,
as the packer casts them), for a DCN-v2, a DIN and a two-tower batch."""

import numpy as np
import pytest
import torch

from pytorchrec_tpu.data.packing import BatchPacker as JaxBatchPacker
from pytorchrec_tpu_torch.data import BatchPacker, batch_signature

B, N, S = 128, 4, 20


def _dcnv2(rng):
    batch = {f"c_{i}": rng.integers(0, 100_000, B).astype(np.int64) for i in range(5)}
    batch.update({f"d_{i}": rng.normal(size=B) for i in range(3)})  # float64: cast to f32
    batch["label"] = rng.integers(0, 2, B).astype(np.int32)
    return batch


def _din(rng):
    return {"uid": rng.integers(0, 65_536, B).astype(np.int32),
            "iid": rng.integers(1, 1 << 20, (B, N)).astype(np.int32),
            "pos_his": rng.integers(0, 1 << 20, (B, S)).astype(np.int64),
            "pos_his_len": rng.integers(1, S + 1, B).astype(np.int32),
            "label": rng.integers(0, 2, B).astype(np.int32)}


def _two_tower(rng):
    return {"uid": rng.integers(0, 1_000_000, B).astype(np.int32),
            "iid": rng.integers(0, 1_000_000, (B, 1)).astype(np.int32),
            "q": rng.uniform(1e-6, 1e-2, B).astype(np.float32),
            "flag": rng.integers(0, 2, B).astype(bool)}


@pytest.mark.parametrize("make", [_dcnv2, _din, _two_tower])
def test_packer_matches_the_jax_packer(make):
    rng = np.random.default_rng(0)
    example, batch = make(rng), make(rng)
    want, got = JaxBatchPacker(example), BatchPacker(example)
    assert got.int_slots == want.int_slots and got.float_slots == want.float_slots
    assert (got.int_size, got.float_size) == (want.int_size, want.float_size)
    want_ints, want_floats = want.pack(batch)
    ints, floats = got.pack(batch)
    assert ints.dtype == torch.int32 and floats.dtype == torch.float32
    assert ints.numpy().tobytes() == want_ints.tobytes()
    assert floats.numpy().tobytes() == want_floats.tobytes()
    views = got.unpack(ints, floats)
    assert sorted(views) == sorted(batch)
    for key, value in batch.items():
        cast = value.astype(np.float32 if np.issubdtype(value.dtype, np.floating) else np.int32)
        assert views[key].shape == value.shape
        np.testing.assert_array_equal(views[key].numpy(), cast, err_msg=key)
        assert views[key].data_ptr() in range(min(ints.data_ptr(), floats.data_ptr()),
                                              max(ints.data_ptr() + ints.nbytes,
                                                  floats.data_ptr() + floats.nbytes))


def test_pack_into_given_buffers_and_tensors_in_the_batch():
    """``pack(batch, out=)`` writes rows of a ``[K, n]`` buffer in place;
    tensor values pack as numpy ones do."""
    rng = np.random.default_rng(1)
    batches = [_dcnv2(rng) for _ in range(3)]
    packer = BatchPacker(batches[0])
    ints = torch.zeros((3, packer.int_size), dtype=torch.int32)
    floats = torch.zeros((3, packer.float_size), dtype=torch.float32)
    for i, batch in enumerate(batches):
        tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
        packer.pack(tensors, out=(ints[i], floats[i]))
        want = JaxBatchPacker(batch).pack(batch)
        assert ints[i].numpy().tobytes() == want[0].tobytes()
        assert floats[i].numpy().tobytes() == want[1].tobytes()


def test_signature_names_shapes_and_kinds():
    rng = np.random.default_rng(2)
    batch = _din(rng)
    assert batch_signature(batch) == batch_signature({k: torch.from_numpy(v)
                                                      for k, v in batch.items()})
    other = dict(batch, label=batch["label"].astype(np.float32))
    assert batch_signature(other) != batch_signature(batch)  # an int column became a float
    assert batch_signature({k: v[:64] for k, v in batch.items()}) != batch_signature(batch)
