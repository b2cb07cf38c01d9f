from .column import Column, PackedByteColumn
from .table import Table

__all__ = ["Column", "PackedByteColumn", "Table"]
