"""Data loaders: the reference's host-side, jax-free loaders.

``TestDataLoader`` (the seeded Gaussian-mixture snapshot) and the
``AbstractDataLoader`` contract are numpy code in ``topsy_tpu.loaders``;
the port uses them unchanged.
"""

from topsy_tpu.loaders import AbstractDataLoader, TestDataLoader

__all__ = ["AbstractDataLoader", "TestDataLoader"]
