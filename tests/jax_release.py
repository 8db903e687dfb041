"""A module fixture for the port's test files: when a file's tests are done,
drop the compiled programs that JAX holds in this process.

Under ``pytest -n 6 --dist loadfile`` one worker process runs many test
files in turn, the JAX package's and the port's.  The programs that JAX
compiles or loads stay alive in the process's caches, and XLA:CPU can
crash (SIGSEGV) when it later loads a program from the persistent
compilation cache (``tests/conftest.py``) into a process that holds many:
``pytest tests/test_ntt.py tests/test_runtime.py`` segfaults in
``test_runtime.py::test_msm_cached_variants`` in one process, and passes
with ``jax.clear_caches()`` and a collection between the two files.  Each
port test file imports this fixture, so a JAX test that a worker runs
after a port file starts from few live programs.  Nothing that a test
checks changes: a program needed again is compiled or read from the
persistent cache anew.
"""

import gc

import jax
import pytest


@pytest.fixture(scope="module", autouse=True)
def release_jax_programs():
    yield
    jax.clear_caches()
    gc.collect()
