"""Columnar file I/O of the port: Parquet read (host and device-decode routes)
and single-transfer staging."""

from .parquet import (  # noqa: F401
    ParquetChunkedReader,
    ParquetFile,
    read_parquet,
)
