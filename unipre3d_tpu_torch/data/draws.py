"""The random sources of the real-data readers.

The JAX readers (unipre3d_tpu/data/shapenet.py, scannet.py, transforms.py)
draw from the process-global ``random`` and ``np.random`` states, so under
the loader's thread pool an example's draws depend on which thread runs
when. The port's readers and transforms draw from the ``Draws`` they are
handed instead: a ``np.random.RandomState`` in place of ``np.random`` and
a ``random.Random`` in place of ``random``. Seeded with the same integer
as the globals, they give the same sequences. The loader derives each
example's from (seed, epoch, position in the epoch), which makes the draws
independent of scheduling and a resumed run's equal to an uninterrupted
one's. A batch's collate hook (Mix3d) draws from a generator derived
alike from (seed, epoch, batch index, and the shard of a sharded loader):
``batch_rng``.
"""

from __future__ import annotations

import random
from typing import NamedTuple

import numpy as np


class Draws(NamedTuple):
    np_rng: np.random.RandomState
    py_rng: random.Random

    @classmethod
    def seeded(cls, seed: int) -> "Draws":
        """Both sources seeded with ``seed``, as ``np.random.seed(seed)``
        and ``random.seed(seed)`` seed the globals."""
        return cls(np.random.RandomState(seed), random.Random(seed))


def example_draws(seed: int, epoch: int, position: int) -> Draws:
    """The draws of the example at ``position`` of epoch ``epoch`` of a
    loader seeded ``seed``."""
    key = np.random.SeedSequence([seed, epoch, position])
    return Draws.seeded(int(key.generate_state(1)[0]))


def batch_rng(seed: int, epoch: int, batch: int,
              shard: int = 0) -> np.random.Generator:
    """The generator of the collate hook of batch ``batch`` of epoch
    ``epoch`` of a loader seeded ``seed``; shard ``shard`` > 0 of a sharded
    loader draws from its own."""
    return np.random.default_rng([seed, epoch, batch] + ([shard] if shard
                                                         else []))
