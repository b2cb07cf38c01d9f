"""Exchange layer of the port: meshes of shards, the hash-partition
shuffle, the distributed plans and the spilled shuffle."""

from .mesh import (Mesh, make_mesh, make_multislice_mesh,  # noqa: F401
                   shard_table)
from .shuffle import (partition_ids, shuffle_chunks_pipelined,  # noqa: F401
                      shuffle_table_padded)
from .stringplane import explode_strings, reassemble_strings  # noqa: F401
from .distributed import (distributed_cross_join,  # noqa: F401
                          distributed_groupby, distributed_join,
                          distributed_window)
