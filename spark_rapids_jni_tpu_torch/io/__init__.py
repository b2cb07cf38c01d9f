"""Columnar file I/O of the port: Parquet read (host and device-decode routes,
LIST and STRUCT on the host route) and write, ORC read and write, CSV read
and write, and single-transfer staging."""

from .parquet import (  # noqa: F401
    ParquetChunkedReader,
    ParquetFile,
    read_parquet,
)
from .parquet_writer import write_parquet  # noqa: F401
from .orc import ORCChunkedReader, ORCFile, read_orc  # noqa: F401
from .orc_writer import write_orc  # noqa: F401
from .csv import read_csv, write_csv  # noqa: F401
