"""
Both TM-align bindings for the tests that hold the port's TM-scores against
the JAX package's at 1e-12 (tests/test_torch_reconstruction.py,
tests/test_torch_eval.py).

The JAX binding's _load builds its library in place at _SO_PATH and takes a
file that exists as built, so a test process that loads the shared file
while another one rebuilds it reads it half written ("file too short"),
keeps that failure for the rest of its life, and scores with numpy: against
the port's native scores that shows as a 1e-12 mismatch. The jax_tmalign
fixture gives the binding a library of its own in this process, and
assert_both_loaded turns a binding that did not load into a failure that
names the loaders' warnings.
"""
import dataclasses
import io
import logging

import pytest

from foldingdiff_tpu.eval import tmalign_native as jax_native
from foldingdiff_tpu_torch.eval import tmalign_native


@dataclasses.dataclass
class Bindings:
    loaded: tuple  # (port, JAX): whether each loaded its library
    log: str  # the warnings the two loaders logged as they loaded


@pytest.fixture(scope="module")
def jax_tmalign(tmp_path_factory):
    """The JAX package's TM-align binding on a library of its own, built
    and loaded in this process for the module's tests, and the port's
    binding, both loaded here once: each keeps a failed load for the life of
    the process, so its warning is recorded here for every test."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_SO_PATH", str(tmp_path_factory.mktemp("jax_tmalign") / "_tmalign.so"))
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_tried", False)
        stream = io.StringIO()
        handler = logging.StreamHandler(stream)
        handler.setLevel(logging.WARNING)
        root = logging.getLogger()
        root.addHandler(handler)
        try:
            loaded = tmalign_native.available(), jax_native.available()
        finally:
            root.removeHandler(handler)
        yield Bindings(loaded, stream.getvalue())


def assert_both_loaded(bindings: Bindings) -> None:
    """Both native TM-aligns loaded, the port's and the JAX package's; else
    fail with what their loaders logged."""
    assert all(bindings.loaded), f"native TM-align loaded (port, JAX): {bindings.loaded}; {bindings.log}"
