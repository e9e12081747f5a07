"""pytest's setup for the whole repository.

The JAX package builds its native table library (``interpolate_antialiasing_tpu
.native``) at first use onto one shared path.  Under pytest-xdist every
worker collects every test file, so on a fresh checkout all workers would
compile that library at once, and a worker could load a half-written file
and skip ``tests/test_native.py`` as a whole.  The controlling process
builds it once here, before the workers start, so that they find it built.
A failed build aborts nothing: the workers then try for themselves.
"""

import os


def pytest_configure(config):
    if os.environ.get("PYTEST_XDIST_WORKER"):
        return
    try:
        from interpolate_antialiasing_tpu.native import native_available

        native_available()
    except Exception:  # noqa: BLE001 — the workers build or skip as before
        pass
