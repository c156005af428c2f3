"""Host utilities of the port (counterpart of ``tpurec/utils``): the
dependency-free .xlsx matrix writer the CDC engine dumps its matrices
with."""

from tpurec_torch.utils.xlsx import read_matrix_xlsx, write_matrix_xlsx

__all__ = ["read_matrix_xlsx", "write_matrix_xlsx"]
