"""The reference's native runtime, loaded once per test module before the
port's tests compare against it.

``topsy_tpu/native`` compiles its library to one shared temporary path
(``_native.so.tmp``) with no lock.  Under pytest-xdist several workers can
build it at once; the loser's ``os.replace`` fails, it sets
``_build_failed`` and falls back to numpy for the rest of its process, and
a comparison with the port's native kNN then fails by chance.  The fixture
takes a file lock (serialising the port's test modules), retries a failed
load a few times (reference test modules build without the lock), and
asserts that the library loaded before any equality is checked.
"""

import fcntl
import os
import time

import pytest

from topsy_tpu import native as r_native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCK = os.path.join(ROOT, "build", "reference_native.lock")
ATTEMPTS = 5


@pytest.fixture(scope="module", autouse=True)
def reference_native_loaded():
    os.makedirs(os.path.dirname(LOCK), exist_ok=True)
    with open(LOCK, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            for attempt in range(ATTEMPTS):
                if r_native._load() is not None:
                    break
                r_native._build_failed = False
                time.sleep(0.2 * (attempt + 1))
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    assert r_native._load() is not None, \
        "the reference's native runtime did not load"
    return r_native
