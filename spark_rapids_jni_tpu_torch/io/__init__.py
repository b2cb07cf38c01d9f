"""Columnar file I/O of the port: Parquet read (host and device-decode routes),
ORC read and write, and single-transfer staging."""

from .parquet import (  # noqa: F401
    ParquetChunkedReader,
    ParquetFile,
    read_parquet,
)
from .orc import ORCChunkedReader, ORCFile, read_orc  # noqa: F401
from .orc_writer import write_orc  # noqa: F401
