"""HPTMT core on PyTorch: context, tables, the exchange and the operators."""
from . import array_ops, table_ops
from .context import HPTMTContext, local_context, resolve_device
from .operator import Abstraction, Execution, Style, get_operator, list_operators
from .report import OverflowError, OverflowReport
from .table import (RANGE_MARKER, DistTable, Table, hash_columns,
                    partitioning_ascending, partitioning_keys,
                    partitioning_kind, range_partitioning)
