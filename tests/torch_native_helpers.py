"""The JAX package's native library for the port's parity tests, built
where no other process writes.

``pytorchrec_tpu/native`` compiles ``fastrec.cpp`` with ``g++ -o`` straight
onto its cached ``.so`` path after an ``os.path.exists`` check, so under
``pytest -n`` a worker that passes the check while another is still writing
the file loads a half-written library, fails, and remembers the failure
(``_TRIED``, ``AVAILABLE = False``) for the rest of its process: the JAX
side then falls back to numpy and the port's tests, which hold the port's
native loops against JAX's, fail. ``private_jax_native`` points the JAX
package's cache at a directory of this worker's own and clears that memo,
so the library is built there by this process alone and loaded whole.
"""

from __future__ import annotations

import pytest

from pytorchrec_tpu import native as jax_native


def private_jax_native(monkeypatch, directory) -> None:
    """Build and load JAX's native library under ``directory`` (private to
    this test process), whatever an earlier try in the process found."""
    monkeypatch.setenv("PYTORCHREC_TPU_NATIVE_CACHE", str(directory))
    monkeypatch.setattr(jax_native, "_TRIED", False)
    monkeypatch.setattr(jax_native, "_LIB", None)
    monkeypatch.setattr(jax_native, "AVAILABLE", None)


@pytest.fixture(scope="session")
def jax_native_dir(tmp_path_factory):
    """One cache directory a test process (each xdist worker has its own
    base temp directory)."""
    return tmp_path_factory.mktemp("jax_native")


@pytest.fixture
def jax_native_private(monkeypatch, jax_native_dir):
    """``private_jax_native`` for one test."""
    private_jax_native(monkeypatch, jax_native_dir)
