"""The JAX package's native library, loaded race-free for the port's parity
tests.

The JAX package compiles ``native/graph_ops.cpp`` straight into a shared
cache file (``$PGT_TPU_DATA`` or ``~/.cache/pgt_tpu``) and loads that file
as soon as it exists.  Test workers started together on a cold cache can
load a file another worker is still writing; the load fails, ``get_lib``
returns None for the rest of the process, and the package falls back to
scipy's reverse Cuthill-McKee, whose ties break differently from the native
order that the port follows.  A comparison with the port's native layer then
fails as a permutation mismatch.

The ``jax_native`` fixture forgets whatever this process loaded, builds the
library into a directory that belongs to this process alone (``PGT_TPU_DATA``
points there only while ``get_lib`` runs, since it also locates the JAX
package's data), and fails with its own message if the library still does
not load.  Test files that compare against the JAX package's native layer or
its reorder import it and mark themselves::

    from _torch_jax_native import jax_native  # noqa: F401
    pytestmark = pytest.mark.usefixtures("jax_native")
"""

import os

import pytest

from pytorch_geometric_temporal_tpu import native as jnative


def load_jax_native(private_dir):
    """Reset the JAX package's native loader and load its library built in
    ``private_dir``; returns the library, or None if it did not load."""
    jnative._LIB, jnative._TRIED = None, False
    old = os.environ.get("PGT_TPU_DATA")
    os.environ["PGT_TPU_DATA"] = str(private_dir)
    try:
        return jnative.get_lib()
    finally:
        if old is None:
            del os.environ["PGT_TPU_DATA"]
        else:
            os.environ["PGT_TPU_DATA"] = old


@pytest.fixture(scope="session")
def jax_native(tmp_path_factory):
    lib = load_jax_native(tmp_path_factory.mktemp("jax_native"))
    assert lib is not None, (
        "JAX native library did not load: the parity tests compare the "
        "port's native layer with it (is PGT_TPU_NO_NATIVE set, or g++ "
        "missing?)")
    return lib
