"""Host utilities of the port (counterpart of ``tpurec/utils``): the JSONL
metric logger the CLI passes as ``log_fn``, step timing and
``torch.profiler`` traces (``utils.profiling``), and the dependency-free
.xlsx matrix writer the CDC engine dumps its matrices with."""

from tpurec_torch.utils.logging import JsonlLogger
from tpurec_torch.utils.xlsx import read_matrix_xlsx, write_matrix_xlsx

__all__ = ["JsonlLogger", "read_matrix_xlsx", "write_matrix_xlsx"]
