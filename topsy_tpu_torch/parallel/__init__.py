from .mesh import make_mesh  # noqa: F401
from .render_step import (DistributedSplatter, strided_shard,  # noqa: F401
                          unstride)
