"""The eager DataFrame API over the table operators."""
from .frame import DataFrame
