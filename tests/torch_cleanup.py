"""Remove what the port's tests write, once their assertions are done.

The port's tests save checkpoints of 50-270 MB each. pytest keeps the
temporary directories of its last three runs, so left in place they fill a
disk within a few runs. A test module imports ``remove_tmp_path``, an
autouse fixture that removes each test's ``tmp_path`` when the test ends;
a module-scoped fixture that makes a directory with ``tmp_path_factory``
yields it and calls ``remove_tree`` after the yield.
"""

from __future__ import annotations

import shutil

import pytest


def remove_tree(path) -> None:
    shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(autouse=True)
def remove_tmp_path(request):
    """Remove the test's ``tmp_path`` (where it asked for one) at its end."""
    path = request.getfixturevalue("tmp_path") if "tmp_path" in request.fixturenames else None
    yield
    if path is not None:
        remove_tree(path)
