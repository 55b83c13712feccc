"""One native symbolic library for both packages in a test process.

The port and the JAX package load the same native/libbaspacho_symbolic.so
(baspacho_tpu_torch/native.py, baspacho_tpu/native.py). The JAX loader
builds it in place and caches a miss for the life of the process, so in
a run whose workers start together it can read a half-written file and
fall back to the Python analysis, which orders some problems differently
(AMD): the two packages then build different permutations, and results
that the tests compare element for element differ in order.

`one_native_library`, an autouse fixture that every test module of the
port comparing against the JAX package imports, runs
`same_native_library()` before the module's first test: it builds the
library through the port's loader (under its lock, renamed into place
when complete), re-arms a JAX loader that cached a miss in this process,
so that its next call loads the complete file, and fails the module's
tests unless both loaders agree.
"""

import pytest


def same_native_library() -> bool:
    """Whether the native library loads, the same in both packages."""
    from baspacho_tpu import native as jax_native
    from baspacho_tpu_torch import native as port_native

    port = port_native.available()
    if jax_native._LIB is None:
        jax_native._TRIED = False
    ref = jax_native.available()
    if ref != port:
        raise RuntimeError(
            f"the native symbolic library loads in the port ({port}) but "
            f"not in the JAX package ({ref}), or the other way round: the "
            "two would analyse problems differently")
    return port


@pytest.fixture(scope="module", autouse=True)
def one_native_library():
    same_native_library()
